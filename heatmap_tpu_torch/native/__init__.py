"""native — the host C++ codecs, loaded with ctypes.

A copy of the parts of ``heatmap_tpu/native/__init__.py`` that the port's
Kafka path, Mongo store and inference engine use: the CRC32C and the
record-batch framing of ``kafka_codec.cpp``, the JSON-lines event decoder
of ``decoder.cpp`` with its persistent intern tables, the BSON update-op
encoders of ``tile_ops.cpp`` and ``positions_ops.cpp``, and the f64 H3
snap of ``h3_snap.cpp`` (``NativeH3Snap``).

The library is built with g++ at first use by ``heatmap_tpu_torch._build``
(``load(NATIVE_LIB)``: ``build/heatmap_tpu_torch/native-<hash>.so``, the
reference's flags).  Unlike the reference there is no fallback: a missing
g++ or a failed compile raises ``KernelBuildError`` from the first call.
The Python codecs stay beside these as their plain versions
(``kafka.records.crc32c_plain``, ``stream.source._decode_json_values``,
``sink.base.Store``'s Python doc paths), reached only when a caller asks.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np

from heatmap_tpu_torch import _build

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_SNAP_ARGS = [_f32p, _f32p, ctypes.c_int64, ctypes.c_int,
              _f64p, _f64p, _f64p,
              ctypes.c_double, ctypes.c_double, ctypes.c_double,
              _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
              ctypes.c_int, _u32p, _u32p]

_SIGNATURES = {
    "dec_new": ([], ctypes.c_void_p),
    "dec_free": ([ctypes.c_void_p], None),
    "dec_intern_count": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int64),
    # void* (not c_char_p): names may contain NUL bytes, so they are read
    # back by explicit length via string_at
    "dec_intern_get": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int64],
                       ctypes.c_void_p),
    "dec_intern_len": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int64],
                       ctypes.c_int64),
    "dec_decode": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                    ctypes.c_int64, _f32p, _f32p, _f32p, _i32p, _i32p,
                    _i32p, ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int64)], ctypes.c_int64),
    "enc_tile_ops": ([_u32p, ctypes.c_int64, ctypes.c_char_p,
                      ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_int32, ctypes.c_int32, _u8p, ctypes.c_int64,
                      _i64p, ctypes.POINTER(ctypes.c_int64)],
                     ctypes.c_int64),
    "kc_crc32c": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32],
                  ctypes.c_uint32),
    "kc_decode_values": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int32, ctypes.c_int32, _u8p,
                          ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
                          _i64p], ctypes.c_int64),
    "enc_position_ops": ([_f32p, _f32p, _i64p, ctypes.c_int64, _u8p, _i64p,
                          _u8p, _i64p, _u8p, ctypes.c_int64, _i64p,
                          ctypes.POINTER(ctypes.c_int64)], ctypes.c_int64),
    "h3_snap_f32": (_SNAP_ARGS, None),
    # the scalar entry: the reference path the AVX-512 block path is held
    # against
    "h3_snap_f32_scalar": (_SNAP_ARGS, None),
}


def _lib():
    """The port's native library, built on first use (raises
    ``_build.KernelBuildError`` when it cannot be built)."""
    lib = _build.load(_build.NATIVE_LIB)
    if not getattr(lib, "_heatmap_bound", False):
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        lib._heatmap_bound = True
    return lib


def crc32c_native(data: bytes, crc: int = 0) -> int:
    """Hardware/sliced CRC32C (kafka_codec.cpp)."""
    return int(_lib().kc_crc32c(data, len(data), crc))


class KafkaValues:
    """Result of kafka_decode_values: record values joined as newline-
    terminated lines, plus the bookkeeping the consumer's partial-take
    logic needs (each value's record offset and its start in ``blob``)."""

    __slots__ = ("blob", "val_off", "val_pos", "next_offset",
                 "skipped_batches", "n_null")

    def __init__(self, blob, val_off, val_pos, next_offset, skipped,
                 n_null):
        self.blob = blob
        self.val_off = val_off
        self.val_pos = val_pos
        self.next_offset = next_offset
        self.skipped_batches = skipped
        self.n_null = n_null

    def __len__(self):
        return len(self.val_off)


def kafka_decode_values(blob: bytes, start_offset: int,
                        verify_crc: bool = True) -> "KafkaValues | None":
    """Decode a Fetch records blob straight to a newline-joined values
    buffer (kafka_codec.cpp).  None when the blob's varints are malformed
    or a value contains raw newlines: the caller then takes the Python
    record path for that blob (kafka.records.decode_batches_tolerant), as
    the reference does."""
    lib = _lib()
    n = len(blob)
    cap_vals = n // 6 + 8
    out = np.empty(n + cap_vals + 16, np.uint8)
    val_off = np.empty(cap_vals, np.int64)
    val_pos = np.empty(cap_vals, np.int64)
    state = np.zeros(5, np.int64)
    nv = lib.kc_decode_values(blob, n, start_offset, int(verify_crc), 0,
                              out, len(out), val_off, val_pos, cap_vals,
                              state)
    if nv < 0 or state[3] > 0:  # malformed varints / newline-bearing values
        return None
    nv = int(nv)
    return KafkaValues(
        out[:int(state[0])].tobytes(), val_off[:nv].copy(),
        val_pos[:nv].copy(), int(state[1]), int(state[2]), int(state[4]),
    )


def decode_lines(dec: "NativeDecoder", values) -> "object":
    """Decode an iterable of raw JSON document byte-strings to columns.

    Values are joined with newlines for the line-oriented scanner.  A value
    containing raw newline bytes (pretty-printed JSON) is validated with
    json.loads, with the exact semantics of the Python codec: valid
    documents are re-serialized compact and batched, invalid ones are
    dropped and counted."""
    from heatmap_tpu_torch.stream.events import columns_from_arrays

    cleaned = []
    pre_dropped = 0
    for v in values:
        if b"\n" in v or b"\r" in v:
            try:
                cleaned.append(json.dumps(json.loads(v)).encode())
            except (json.JSONDecodeError, UnicodeDecodeError):
                pre_dropped += 1
        else:
            cleaned.append(v)
    if not cleaned:
        cols = columns_from_arrays([], [], [], [])
        cols.n_dropped = pre_dropped
        return cols
    cols, _ = dec.decode(b"\n".join(cleaned) + b"\n", final=True)
    cols.n_dropped += pre_dropped
    return cols


class NativeDecoder:
    """Streaming JSON-lines event decoder with persistent string interning.

    ``decode(data)`` accepts a bytes block of newline-separated event JSON
    and returns (EventColumns, consumed_bytes); partial trailing lines are
    left unconsumed so callers can stream chunked reads.  Pass
    ``final=True`` on the last chunk so a complete terminal record without
    a trailing newline is flushed rather than held back.  The columns'
    ``providers``/``vehicles`` are this decoder's intern tables: ids stay
    stable across every batch it decodes.
    """

    def __init__(self):
        self._lib = _lib()
        self._h = ctypes.c_void_p(self._lib.dec_new())
        self._providers: list[str] = []
        self._vehicles: list[str] = []

    def close(self):
        if self._h:
            self._lib.dec_free(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:
            pass

    def _refresh_interns(self):
        for which, cache in ((0, self._providers), (1, self._vehicles)):
            n = self._lib.dec_intern_count(self._h, which)
            for i in range(len(cache), n):
                ln = self._lib.dec_intern_len(self._h, which, i)
                raw = ctypes.string_at(
                    self._lib.dec_intern_get(self._h, which, i), ln)
                # surrogatepass: the C side emits WTF-8 for lone \uD800-style
                # escapes, matching what Python's json preserves in its strs
                try:
                    cache.append(raw.decode("utf-8", "surrogatepass"))
                except UnicodeDecodeError:
                    cache.append(raw.decode("utf-8", "replace"))

    def decode(self, data: bytes, max_events: int | None = None,
               final: bool = False):
        from heatmap_tpu_torch.stream.events import columns_from_arrays

        orig_len = len(data)
        if final and data and not data.endswith(b"\n"):
            # flush mode: at EOF a complete last record may lack the
            # newline the streaming contract waits for
            data = data + b"\n"
        cap = (max_events if max_events is not None
               else max(1, data.count(b"\n") + 1))
        lat = np.empty(cap, np.float32)
        lon = np.empty(cap, np.float32)
        speed = np.empty(cap, np.float32)
        ts = np.empty(cap, np.int32)
        pid = np.empty(cap, np.int32)
        vid = np.empty(cap, np.int32)
        dropped = ctypes.c_int64(0)
        consumed = ctypes.c_int64(0)
        n = self._lib.dec_decode(
            self._h, data, len(data), cap,
            lat, lon, speed, ts, pid, vid,
            ctypes.byref(dropped), ctypes.byref(consumed),
        )
        self._refresh_interns()
        cols = columns_from_arrays(
            lat[:n], lon[:n], speed[:n], ts[:n],
            provider_id=pid[:n], vehicle_id=vid[:n],
            providers=self._providers, vehicles=self._vehicles,
        )
        cols.n_dropped = int(dropped.value)
        return cols, min(int(consumed.value), orig_len)


def _encode_with_resize(call, cap, what):
    """Run a native encoder (``call(out, cap) -> n_docs | -needed_bytes``)
    once; on overflow reallocate to the exact reported size and retry."""
    out = np.empty(cap, np.uint8)
    got = call(out, cap)
    if got < 0:
        cap = int(-got) + 1024
        out = np.empty(cap, np.uint8)
        got = call(out, cap)
        if got < 0:
            raise RuntimeError(
                f"native {what} encode overflow after resize")
    return out, int(got)


class NativeTileOps:
    """Packed-emit rows -> wire-ready BSON update ops (tile_ops.cpp).

    ``encode(body, ...)`` takes the packed emit matrix's BODY rows
    ((E, 13) uint32, i.e. ``packed[1:]``) and returns
    ``(ops_bytes, end_offsets, n_docs)`` where ``ops_bytes`` is the
    concatenated update-op documents for an OP_MSG "updates" document
    sequence and ``end_offsets[i]`` is the byte end of op i (for 1000-op
    chunking).  Rows with valid==0 or count<=0 are skipped, as the
    Python doc path (``sink.base.packed_tile_docs``) skips them.
    """

    # conservative per-doc bound: fixed fields ~430B + _id/cellId strings
    _DOC_BOUND = 640

    def __init__(self):
        self._lib = _lib()

    def encode(self, body: np.ndarray, city: str, grid: str,
               window_s: int, ttl_minutes: int,
               window_minutes_tag: int = 0, with_p95: bool = True):
        body = np.ascontiguousarray(body, np.uint32)
        if body.ndim != 2 or body.shape[1] != 13:
            raise ValueError(f"body must be (E, 13) uint32, got {body.shape}")
        n_rows = body.shape[0]
        offsets = np.empty(max(n_rows, 1), np.int64)
        nbytes = ctypes.c_int64(0)

        def call(out, cap):
            return self._lib.enc_tile_ops(
                body, n_rows, city.encode(), grid.encode(),
                window_s * 1000, ttl_minutes * 60_000,
                window_minutes_tag, int(bool(with_p95)),
                out, cap, offsets, ctypes.byref(nbytes),
            )

        out, n = _encode_with_resize(
            call, n_rows * self._DOC_BOUND + 1024, "tile")
        return out[:int(nbytes.value)].tobytes(), offsets[:n].copy(), n


class NativePositionOps:
    """Columnar changed-vehicle rows -> wire-ready monotonic pipeline-update
    ops (positions_ops.cpp).  ``encode(rows)`` takes a
    sink.base.PositionRows and returns (ops_bytes, end_offsets, n)."""

    # fixed pipeline skeleton ~330B + strings (id appears twice)
    _DOC_BOUND = 420

    def __init__(self):
        self._lib = _lib()

    def encode(self, rows):
        n = len(rows.ts_ms)
        prov = [p.encode("utf-8") for p in rows.providers]
        veh = [v.encode("utf-8") for v in rows.vehicles]
        prov_off = np.zeros(n + 1, np.int64)
        veh_off = np.zeros(n + 1, np.int64)
        np.cumsum([len(p) for p in prov], out=prov_off[1:])
        np.cumsum([len(v) for v in veh], out=veh_off[1:])
        prov_buf = np.frombuffer(b"".join(prov) or b"\0", np.uint8)
        veh_buf = np.frombuffer(b"".join(veh) or b"\0", np.uint8)
        str_bytes = int(prov_off[-1] + veh_off[-1])
        offsets = np.empty(max(n, 1), np.int64)
        nbytes = ctypes.c_int64(0)
        lat = np.ascontiguousarray(rows.lat, np.float32)
        lon = np.ascontiguousarray(rows.lon, np.float32)
        ts_ms = np.ascontiguousarray(rows.ts_ms, np.int64)

        def call(out, cap):
            return self._lib.enc_position_ops(
                lat, lon, ts_ms, n, prov_buf, prov_off, veh_buf, veh_off,
                out, cap, offsets, ctypes.byref(nbytes),
            )

        out, _ = _encode_with_resize(
            call, n * self._DOC_BOUND + 3 * str_bytes + 1024, "position")
        return out[:int(nbytes.value)].tobytes(), offsets[:n].copy(), n


class NativeH3Snap:
    """C++ H3 forward snap over f32 arrays (h3_snap.cpp): computes in f64
    internally, matching the host oracle's rounding rather than the f32
    device snap (points within ~0.4 m of a cell edge at res 9 may differ
    from the f32 snap; both are valid snaps).  The AVX-512 block path runs
    when the CPU has avx512f and avx512dq (checked in the library at run
    time), else the scalar path."""

    def __init__(self):
        import math

        from heatmap_tpu_torch.hexgrid.constants import (
            FACE_CENTER_XYZ,
            M_AP7_ROT_RADS,
            M_SQRT7,
        )
        from heatmap_tpu_torch.hexgrid.device import (
            _DeviceTables,
            _projection_bases,
        )
        from heatmap_tpu_torch.hexgrid.mathlib import (
            _DOWN_AP7,
            _DOWN_AP7R,
            K_AXES_DIGIT,
        )

        self._lib = _lib()
        u1, u2 = _projection_bases()
        T = _DeviceTables()
        self._face_xyz = np.ascontiguousarray(FACE_CENTER_XYZ, np.float64)
        self._u1 = np.ascontiguousarray(u1, np.float64)
        self._u2 = np.ascontiguousarray(u2, np.float64)
        self._rot_cos = float(math.cos(M_AP7_ROT_RADS))
        self._rot_sin = float(math.sin(M_AP7_ROT_RADS))
        self._sqrt7 = float(M_SQRT7)
        self._down_ap7 = np.ascontiguousarray(
            np.asarray(_DOWN_AP7, np.int32).reshape(-1))
        self._down_ap7r = np.ascontiguousarray(
            np.asarray(_DOWN_AP7R, np.int32).reshape(-1))
        self._bc = np.ascontiguousarray(T.face_ijk_bc)
        self._rot = np.ascontiguousarray(T.face_ijk_rot)
        self._pent = np.ascontiguousarray(T.bc_pent)
        self._cw_off = np.ascontiguousarray(T.pent_cw_offset)
        self._ccw_pow = np.ascontiguousarray(T.ccw_pow)
        self._k_digit = int(K_AXES_DIGIT)

    def snap(self, lat_rad, lng_rad, res: int, scalar: bool = False):
        """(N,) f32 radians -> (hi, lo) uint32 arrays, res 0..10 (the
        packed-digit-chain form).  ``scalar=True`` takes the scalar path
        whatever the CPU has (for holding the block path against it)."""
        if not 0 <= res <= 10:
            raise ValueError(f"native snap supports res 0..10, got {res}")
        lat = np.ascontiguousarray(lat_rad, np.float32).reshape(-1)
        lng = np.ascontiguousarray(lng_rad, np.float32).reshape(-1)
        if lng.shape[0] != lat.shape[0]:
            # the C++ loop is sized from lat; a silent mismatch would
            # read past the lng buffer
            raise ValueError(f"lat/lng length mismatch: "
                             f"{lat.shape[0]} vs {lng.shape[0]}")
        n = lat.shape[0]
        hi = np.empty(n, np.uint32)
        lo = np.empty(n, np.uint32)
        fn = (self._lib.h3_snap_f32_scalar if scalar
              else self._lib.h3_snap_f32)
        fn(lat, lng, n, res, self._face_xyz, self._u1, self._u2,
           self._rot_cos, self._rot_sin, float(self._sqrt7 ** res),
           self._down_ap7, self._down_ap7r, self._bc, self._rot,
           self._pent, self._cw_off, self._ccw_pow, self._k_digit,
           hi, lo)
        shape = np.shape(lat_rad)
        return hi.reshape(shape), lo.reshape(shape)

