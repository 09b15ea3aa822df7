"""Binary tile/delta wire protocol + coalesced SSE fan-out.

A copy of ``heatmap_tpu/serve/wire.py``, with the delivery-lineage
sidecar (``Tagged`` frames) and the per-subscriber ``sub_stats`` of
``/debug/delivery``.  The serve tier's JSON wire format is ~10x the
entropy of the data it carries: every feature repeats the property keys
and ships a 7-vertex polygon of ~15-significant-digit coordinate strings
that are a PURE FUNCTION of the cell id.  This module defines the
compact columnar frame the read tier negotiates instead (fixed-point
columnar space-time tile encodings), one schema shared by
``/api/tiles/latest``, ``/api/tiles/delta``, and SSE pushes:

Frame layout (all little-endian)::

    'H' 'W' version=1 flags      flags: bit0 mode=full, bit1 window
                                 present, bit2 naive datetimes
    u64  seq                     the view seq the frame carries
    u16  grid_len + grid utf8
    [i64 ws_us, i64 we_us]       epoch MICROseconds (window present)
    varint n_docs
    u8[n] per-doc flags          bit0 p95, bit1 stddev,
                                 bit2 windowMinutes, bit3 per-doc
                                 window override, bit4 vxKmh,
                                 bit5 vyKmh (inference velocity
                                 field, infer.engine)
    cells   n zigzag varints     delta vs the PREVIOUS cell id (H3
                                 uint64; same-area ids share high
                                 bits, so deltas are short), doc
                                 order preserved — the JSON
                                 reconstruction must be byte-exact,
                                 and feature order is part of it
    counts  n varints
    speeds  u8 enc + n values    enc 0: raw f64; enc 1: fixed-point
                                 x100 zigzag varints — chosen only
                                 when EVERY value round-trips exactly
                                 (v == round(v*100)/100), so decode
                                 is always bit-exact
    p95     u8 enc + values      only docs flagged bit0, doc order
    stddev  u8 enc + values      only docs flagged bit1
    wmin    varints              only docs flagged bit2
    overrides i64 pairs          (ws_us, we_us) for docs flagged bit3
    vx      u8 enc + values      only docs flagged bit4 — APPENDED
    vy      u8 enc + values      only docs flagged bit5, and present
                                 only when some doc carries the flag,
                                 so a velocity-free frame is byte-
                                 identical to the pre-velocity layout
                                 (the count-path differential pin)

``decode(encode(docs))`` reproduces the doc values EXACTLY (datetimes
through integer-µs epoch math, floats bit-for-bit), so rendering the
decoded docs through the serving layer's own pre-serialized feature
fragments reproduces the JSON representation byte-for-byte — the
differential contract the tests pin for /latest, delta replay from
seq 0, and SSE frames.

Encoding raises :class:`ValueError` on docs the compact layout cannot
represent exactly (a non-float p95 extra, a non-int windowMinutes);
the serving layer falls back to JSON for that response rather than
ship bytes that would decode differently.

The second half is :class:`FanoutHub` — the coalesced SSE fan-out:
one broadcaster per (grid, format) channel encodes each view seq
advance EXACTLY ONCE and fans the shared buffer to N subscriber
queues.  Queues are bounded (``HEATMAP_SSE_QUEUE``): a subscriber
that stops draining is marked lagged, its queue is dropped, and its
generator yields ``event: lagged`` + a clean disconnect instead of
wedging the broadcaster — back-pressure never propagates past the
slow client's own queue.
"""

from __future__ import annotations

import collections
import datetime as dt
import struct
import threading
import time

MAGIC0, MAGIC1, VERSION = 0x48, 0x57, 1  # 'H', 'W'
MAGIC1_POS = 0x50                        # 'H', 'P': positions frame
CONTENT_TYPE = "application/vnd.heatmap.tiles"
CONTENT_TYPE_POSITIONS = "application/vnd.heatmap.positions"

_F_FULL = 0x01
_F_WINDOW = 0x02
_F_NAIVE = 0x04

_D_P95 = 0x01
_D_STD = 0x02
_D_WMIN = 0x04
_D_WOVR = 0x08
_D_VX = 0x10   # vxKmh (east) — inference velocity field
_D_VY = 0x20   # vyKmh (north)

ENC_F64 = 0
ENC_FIXED = 1  # x100 zigzag varint; engaged only when exact

_EPOCH_UTC = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)
_EPOCH_NAIVE = dt.datetime(1970, 1, 1)
_US = dt.timedelta(microseconds=1)
_MASK64 = (1 << 64) - 1


def format_etag(etag: str, fmt: str) -> str:
    """Format-keyed strong ETag: the JSON representation keeps the
    view's ETag verbatim (the default path stays byte-identical); the
    binary representation gets a ``.bin`` suffix INSIDE the quotes, so
    a strong ETag can never alias two representations and a JSON ETag
    presented against a binary request can never 304."""
    if fmt != "bin" or not etag.endswith('"'):
        return etag
    return etag[:-1] + '.bin"'


# ------------------------------------------------------------ primitives
def _zigzag(v: int) -> int:
    return ((v << 1) ^ (v >> 63)) & _MASK64


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


def _put_varint(buf: bytearray, u: int) -> None:
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _get_varint(mv, pos: int) -> tuple[int, int]:
    u = 0
    shift = 0
    while True:
        if pos >= len(mv):
            raise ValueError("wire frame truncated in varint")
        b = mv[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            return u, pos
        shift += 7
        if shift > 70:
            raise ValueError("wire frame varint overflow")


def _dt_us(d: dt.datetime) -> int:
    """Exact integer epoch-microseconds (timedelta math — float
    ``timestamp()`` would round near the precision edge)."""
    base = _EPOCH_NAIVE if d.tzinfo is None else _EPOCH_UTC
    return (d - base) // _US


def _us_dt(us: int, naive: bool) -> dt.datetime:
    base = _EPOCH_NAIVE if naive else _EPOCH_UTC
    return base + us * _US


def _fixed_ok(vals: list) -> list | None:
    """The x100 fixed-point ints when EVERY value round-trips exactly
    (same nearest-double on decode), else None -> raw f64 column."""
    out = []
    for v in vals:
        s = round(v * 100.0)
        if not isinstance(s, int) or abs(s) >= 1 << 53 or s / 100.0 != v:
            return None
        out.append(s)
    return out


def _prep_float_col(vals: list) -> tuple[int, list]:
    """(enc, values) for one float column — the ONE decision point the
    Python and native body writers share, so they cannot disagree on
    when fixed-point engages.  An empty column is ENC_FIXED (one enc
    byte, no values) on both paths."""
    fx = _fixed_ok(vals)
    if fx is not None:
        return ENC_FIXED, fx
    return ENC_F64, vals


# -------------------------------------------------------------- encoding
def _column_arrays(docs, ws_dt, we_dt):
    """(flags, cell_deltas, counts, speeds, p95, stddev, wmin,
    overrides, vx, vy) lists for the column section; raises ValueError
    on docs the layout cannot represent exactly."""
    flags: list = []
    deltas: list = []
    counts: list = []
    speeds: list = []
    p95: list = []
    stddev: list = []
    wmin: list = []
    overrides: list = []
    vx: list = []
    vy: list = []
    prev = 0
    for doc in docs:
        f = 0
        cell = int(doc["cellId"], 16)
        if not 0 <= cell <= _MASK64:
            raise ValueError("cellId does not fit u64")
        # u64 difference folded to SIGNED i64: H3 ids carry the top hex
        # digit 8 (> 2^63), but same-area ids differ only in low bits —
        # the two's-complement fold keeps every delta a short zigzag
        # varint regardless of which side of 2^63 the ids sit on
        d = (cell - prev) & _MASK64
        if d >= 1 << 63:
            d -= 1 << 64
        deltas.append(d)
        prev = cell
        c = int(doc.get("count", 0))
        if c < 0:
            raise ValueError("negative count")
        counts.append(c)
        speeds.append(float(doc.get("avgSpeedKmh", 0.0)))
        v = doc.get("p95SpeedKmh")
        if v is not None:
            if type(v) is not float:
                raise ValueError("p95SpeedKmh is not a float")
            f |= _D_P95
            p95.append(v)
        v = doc.get("stddevSpeedKmh")
        if v is not None:
            if type(v) is not float:
                raise ValueError("stddevSpeedKmh is not a float")
            f |= _D_STD
            stddev.append(v)
        v = doc.get("windowMinutes")
        if v is not None:
            if type(v) is not int or v < 0:
                raise ValueError("windowMinutes is not a non-negative "
                                 "int")
            f |= _D_WMIN
            wmin.append(v)
        for key, bit, col in (("vxKmh", _D_VX, vx),
                              ("vyKmh", _D_VY, vy)):
            v = doc.get(key)
            if v is not None:
                if type(v) is not float:
                    raise ValueError(f"{key} is not a float")
                f |= bit
                col.append(v)
        d_ws, d_we = doc["windowStart"], doc["windowEnd"]
        if d_ws != ws_dt or d_we != we_dt:
            if (d_ws.tzinfo is None) != (ws_dt.tzinfo is None):
                raise ValueError("mixed naive/aware window datetimes")
            f |= _D_WOVR
            overrides.append(_dt_us(d_ws))
            overrides.append(_dt_us(d_we))
        flags.append(f)
    return (flags, deltas, counts, speeds, p95, stddev, wmin, overrides,
            vx, vy)


def _encode_float_column(buf: bytearray, vals: list) -> None:
    enc, out = _prep_float_col(vals)
    buf.append(enc)
    if enc == ENC_FIXED:
        for s in out:
            _put_varint(buf, _zigzag(s))
    else:
        buf += struct.pack(f"<{len(out)}d", *out)


def encode(mode: str, seq: int, grid: str, window_start, docs,
           native=None) -> bytes:
    """One wire frame for a /latest snapshot (mode="full"), a delta
    response, or an SSE push — the single schema every binary surface
    shares.  ``native`` is a NativeWireOps (the serve app's); without
    it the Python body writer runs, its byte-identical plain version
    (differential-pinned)."""
    docs = docs if isinstance(docs, list) else list(docs)
    ws_dt = window_start
    if ws_dt is None and docs:
        ws_dt = docs[0]["windowStart"]
    we_dt = docs[0]["windowEnd"] if docs else None
    flags = _F_FULL if mode == "full" else 0
    naive = False
    if ws_dt is not None:
        flags |= _F_WINDOW
        naive = ws_dt.tzinfo is None
        if naive:
            flags |= _F_NAIVE
    head = bytearray()
    head += bytes((MAGIC0, MAGIC1, VERSION, flags))
    head += struct.pack("<Q", int(seq) & _MASK64)
    g = grid.encode("utf-8")
    if len(g) > 0xFFFF:
        raise ValueError("grid label too long for the wire frame")
    head += struct.pack("<H", len(g))
    head += g
    if ws_dt is not None:
        head += struct.pack("<qq", _dt_us(ws_dt),
                            _dt_us(we_dt) if we_dt is not None else 0)
    _put_varint(head, len(docs))
    if not docs:
        return bytes(head)
    cols = _column_arrays(docs, ws_dt, we_dt)
    # the native column writer predates the velocity columns: use it
    # only for frames without them (the count-path common case, which
    # therefore stays byte-identical through the C++ path), and let
    # velocity-carrying frames take the Python writer
    if native is not None and not cols[8] and not cols[9]:
        return bytes(head) + _encode_body_native(native, *cols[:8])
    return bytes(head) + encode_body_py(*cols)


def _encode_body_native(native, flags, deltas, counts, speeds, p95,
                        stddev, wmin, overrides) -> bytes:
    """Marshal the prepared columns into the native column writer
    (native.NativeWireOps) — the fixed-point decision is made HERE by
    the same ``_prep_float_col`` the Python writer uses, so the two
    bodies are byte-identical by construction (and differential-tested).
    Unlike the reference, a native failure raises: there is no fallback
    to the Python writer."""
    import numpy as np

    def col(vals):
        enc, out = _prep_float_col(vals)
        if enc == ENC_F64:
            return enc, np.ascontiguousarray(out, np.float64).view(
                np.int64)
        return enc, np.ascontiguousarray(out, np.int64)

    s_enc, s_arr = col(speeds)
    p_enc, p_arr = col(p95)
    d_enc, d_arr = col(stddev)
    return native.encode_body(
        np.ascontiguousarray(flags, np.uint8),
        np.ascontiguousarray(deltas, np.int64),
        np.ascontiguousarray(counts, np.int64),
        s_enc, s_arr, p_enc, p_arr, d_enc, d_arr,
        np.ascontiguousarray(wmin, np.int64),
        np.ascontiguousarray(overrides, np.int64))


def encode_body_py(flags, deltas, counts, speeds, p95, stddev, wmin,
                   overrides, vx=(), vy=()) -> bytes:
    """The column section, pure Python — the plain version the native
    encoder is differential-tested
    against (byte-identical output required).  The velocity columns
    are appended only when non-empty, so a velocity-free body is
    byte-identical to the pre-velocity layout."""
    buf = bytearray(bytes(flags))
    for d in deltas:
        _put_varint(buf, _zigzag(d))
    for c in counts:
        _put_varint(buf, c)
    _encode_float_column(buf, speeds)
    _encode_float_column(buf, p95)
    _encode_float_column(buf, stddev)
    for w in wmin:
        _put_varint(buf, w)
    if overrides:
        buf += struct.pack(f"<{len(overrides)}q", *overrides)
    if vx:
        _encode_float_column(buf, list(vx))
    if vy:
        _encode_float_column(buf, list(vy))
    return bytes(buf)


# -------------------------------------------------------------- decoding
def _decode_float_column(mv, pos: int, n: int) -> tuple[list, int]:
    if n == 0 and pos >= len(mv):
        # a frame with zero docs has no column section at all
        return [], pos
    enc = mv[pos]
    pos += 1
    if enc == ENC_F64:
        end = pos + 8 * n
        vals = list(struct.unpack_from(f"<{n}d", mv, pos))
        return vals, end
    if enc == ENC_FIXED:
        vals = []
        for _ in range(n):
            u, pos = _get_varint(mv, pos)
            vals.append(_unzigzag(u) / 100.0)
        return vals, pos
    raise ValueError(f"unknown wire float encoding {enc}")


def frame_seq(buf: bytes) -> int:
    """The frame's seq without a full decode — what a polling client
    feeds back as ``since=`` (header offsets are fixed)."""
    if len(buf) < 12 or buf[0] != MAGIC0 or buf[1] != MAGIC1:
        raise ValueError("not a heatmap wire frame")
    return struct.unpack_from("<Q", buf, 4)[0]


def decode(buf: bytes) -> dict:
    """Frame -> {"mode", "seq", "grid", "window_start", "docs"} with
    doc values exactly equal to what the encoder saw — rendering the
    docs through the serving layer's feature fragments reproduces the
    JSON representation byte-for-byte.  Raises ValueError on anything
    that is not a complete well-formed frame."""
    try:
        return _decode(buf)
    except struct.error as e:
        raise ValueError(f"wire frame truncated: {e}") from e


def _decode(buf: bytes) -> dict:
    mv = memoryview(bytes(buf))
    if len(mv) < 12 or mv[0] != MAGIC0 or mv[1] != MAGIC1:
        raise ValueError("not a heatmap wire frame")
    if mv[2] != VERSION:
        raise ValueError(f"unsupported wire frame version {mv[2]}")
    flags = mv[3]
    seq = struct.unpack_from("<Q", mv, 4)[0]
    (glen,) = struct.unpack_from("<H", mv, 12)
    pos = 14
    grid = bytes(mv[pos:pos + glen]).decode("utf-8")
    pos += glen
    naive = bool(flags & _F_NAIVE)
    ws_dt = we_dt = None
    if flags & _F_WINDOW:
        ws_us, we_us = struct.unpack_from("<qq", mv, pos)
        pos += 16
        ws_dt = _us_dt(ws_us, naive)
        we_dt = _us_dt(we_us, naive)
    n, pos = _get_varint(mv, pos)
    dflags = list(mv[pos:pos + n])
    pos += n
    if len(dflags) != n:
        raise ValueError("wire frame truncated in doc flags")
    cells = []
    prev = 0
    for _ in range(n):
        u, pos = _get_varint(mv, pos)
        prev = (prev + _unzigzag(u)) & _MASK64
        cells.append(prev)
    counts = []
    for _ in range(n):
        u, pos = _get_varint(mv, pos)
        counts.append(u)
    n_p95 = sum(1 for f in dflags if f & _D_P95)
    n_std = sum(1 for f in dflags if f & _D_STD)
    n_wmin = sum(1 for f in dflags if f & _D_WMIN)
    n_ovr = sum(1 for f in dflags if f & _D_WOVR)
    n_vx = sum(1 for f in dflags if f & _D_VX)
    n_vy = sum(1 for f in dflags if f & _D_VY)
    speeds, pos = _decode_float_column(mv, pos, n)
    p95, pos = _decode_float_column(mv, pos, n_p95)
    stddev, pos = _decode_float_column(mv, pos, n_std)
    wmin = []
    for _ in range(n_wmin):
        u, pos = _get_varint(mv, pos)
        wmin.append(u)
    if n_ovr:
        overrides = list(struct.unpack_from(f"<{2 * n_ovr}q", mv, pos))
        pos += 16 * n_ovr
    else:
        overrides = []
    vx, pos = _decode_float_column(mv, pos, n_vx) if n_vx else ([], pos)
    vy, pos = _decode_float_column(mv, pos, n_vy) if n_vy else ([], pos)
    docs = []
    ip = sp = wp = op = xp = yp = 0
    for i in range(n):
        f = dflags[i]
        if f & _D_WOVR:
            d_ws = _us_dt(overrides[op], naive)
            d_we = _us_dt(overrides[op + 1], naive)
            op += 2
        else:
            d_ws, d_we = ws_dt, we_dt
        doc = {"cellId": format(cells[i], "x"), "count": counts[i],
               "avgSpeedKmh": speeds[i], "windowStart": d_ws,
               "windowEnd": d_we}
        if f & _D_P95:
            doc["p95SpeedKmh"] = p95[ip]
            ip += 1
        if f & _D_STD:
            doc["stddevSpeedKmh"] = stddev[sp]
            sp += 1
        if f & _D_WMIN:
            doc["windowMinutes"] = wmin[wp]
            wp += 1
        if f & _D_VX:
            doc["vxKmh"] = vx[xp]
            xp += 1
        if f & _D_VY:
            doc["vyKmh"] = vy[yp]
            yp += 1
        docs.append(doc)
    return {"mode": "full" if flags & _F_FULL else "delta", "seq": seq,
            "grid": grid, "window_start": ws_dt, "docs": docs}


# ------------------------------------------------------ positions frame
# The positions endpoint's binary frame.  Same column primitives as
# the tile frame: 'H' 'P' version flags, varint n, per-doc flag
# bytes, lon/lat float columns (fixed-point only when exact), ts as
# zigzag-varint epoch-microseconds for docs that carry a datetime, and
# per-doc length-prefixed provider/vehicleId strings.  decode
# reproduces every field positions_feature_collection renders EXACTLY,
# so the JSON representation rebuilt from the decoded docs is
# byte-identical (differential-pinned); docs the
# layout cannot represent exactly raise ValueError and the serving
# layer falls back to JSON for that response.

_P_PROVIDER = 0x01
_P_VEHICLE = 0x02
_P_TS = 0x04
_P_TS_NAIVE = 0x08


def encode_positions(docs) -> bytes:
    docs = docs if isinstance(docs, list) else list(docs)
    head = bytearray((MAGIC0, MAGIC1_POS, VERSION, 0))
    _put_varint(head, len(docs))
    flags = bytearray()
    lons: list = []
    lats: list = []
    ts_us: list = []
    strs = bytearray()
    for doc in docs:
        f = 0
        try:
            lon, lat = doc["loc"]["coordinates"]
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"position doc has no loc coordinates: "
                             f"{e}") from e
        if type(lon) is not float or type(lat) is not float:
            raise ValueError("position coordinates are not floats")
        lons.append(lon)
        lats.append(lat)
        for key, bit in (("provider", _P_PROVIDER),
                         ("vehicleId", _P_VEHICLE)):
            v = doc.get(key)
            if v is None:
                continue
            if type(v) is not str:
                raise ValueError(f"{key} is not a string")
            f |= bit
            b = v.encode("utf-8")
            _put_varint(strs, len(b))
            strs += b
        v = doc.get("ts")
        if v is not None:
            if type(v) is not dt.datetime:
                raise ValueError("ts is not a datetime")
            f |= _P_TS
            if v.tzinfo is None:
                f |= _P_TS_NAIVE
            ts_us.append(_dt_us(v))
        flags.append(f)
    buf = bytearray(head)
    buf += bytes(flags)
    _encode_float_column(buf, lons)
    _encode_float_column(buf, lats)
    for u in ts_us:
        _put_varint(buf, _zigzag(u))
    buf += strs
    return bytes(buf)


def decode_positions(buf: bytes) -> list:
    """Frame -> position docs with exactly the fields
    ``positions_feature_collection`` renders; ValueError on anything
    that is not a complete well-formed positions frame."""
    try:
        return _decode_positions(buf)
    except struct.error as e:
        raise ValueError(f"positions frame truncated: {e}") from e


def _decode_positions(buf: bytes) -> list:
    mv = memoryview(bytes(buf))
    if len(mv) < 4 or mv[0] != MAGIC0 or mv[1] != MAGIC1_POS:
        raise ValueError("not a heatmap positions frame")
    if mv[2] != VERSION:
        raise ValueError(f"unsupported positions frame version {mv[2]}")
    n, pos = _get_varint(mv, 4)
    dflags = list(mv[pos:pos + n])
    pos += n
    if len(dflags) != n:
        raise ValueError("positions frame truncated in doc flags")
    lons, pos = _decode_float_column(mv, pos, n)
    lats, pos = _decode_float_column(mv, pos, n)
    ts_us = []
    for f in dflags:
        if f & _P_TS:
            u, pos = _get_varint(mv, pos)
            ts_us.append(_unzigzag(u))
    docs = []
    it = 0
    for i in range(n):
        f = dflags[i]
        doc: dict = {"loc": {"type": "Point",
                             "coordinates": [lons[i], lats[i]]}}
        for key, bit in (("provider", _P_PROVIDER),
                         ("vehicleId", _P_VEHICLE)):
            if f & bit:
                ln, pos = _get_varint(mv, pos)
                doc[key] = bytes(mv[pos:pos + ln]).decode("utf-8")
                pos += ln
        if f & _P_TS:
            doc["ts"] = _us_dt(ts_us[it], bool(f & _P_TS_NAIVE))
            it += 1
        docs.append(doc)
    return docs


# --------------------------------------------------- coalesced fan-out
class Lagged:
    """Queue-overflow sentinel delivered to a shed subscriber."""


class Closed:
    """Channel-finished sentinel (view poisoned / query gone)."""


LAGGED = Lagged()
CLOSED = Closed()


class Tagged:
    """A frame with a delivery-lineage sidecar: ``data`` is the exact
    bytes a plain broadcast would carry (the subscriber generator
    yields the SAME object, so the wire is byte-identical), ``meta``
    is the per-(channel, seq) encode stamp the generator completes
    into an end-to-end delivered sample (obs.delivery)."""

    __slots__ = ("data", "meta")

    def __init__(self, data: bytes, meta):
        self.data = data
        self.meta = meta


class _Sub:
    __slots__ = ("cond", "q", "lagged", "closed",
                 "write_begin_mono", "last_write_mono", "writes")

    def __init__(self, depth: int):
        self.cond = threading.Condition()
        self.q: collections.deque = collections.deque(maxlen=depth + 1)
        self.lagged = False
        self.closed = False
        # write-stall surface: the generator stamps monotonic time
        # around each blocking socket write.  A begin without a
        # matching completion is a write IN FLIGHT — its age is the
        # stall a wedged client causes, visible long before the queue
        # fills and the subscriber is shed as lagged.
        self.write_begin_mono: float | None = None
        self.last_write_mono: float | None = None
        self.writes = 0

    def pop(self, timeout: float):
        """Next frame bytes, or LAGGED/CLOSED, or None on timeout."""
        with self.cond:
            if not self.q:
                self.cond.wait(timeout)
            if not self.q:
                return None
            return self.q.popleft()

    def write_stall_s(self, now_mono: float) -> float:
        """Age of the oldest un-returned socket write (0 when idle)."""
        b = self.write_begin_mono
        return max(0.0, now_mono - b) if b is not None else 0.0


class _EvSub:
    """An event-loop subscriber: NO per-subscriber frame queue.  Its
    entire pending state is ``cursor`` (position in the channel's
    shared frame ring) + ``offset`` (bytes of the in-flight frame
    already written) — two integers, which is what makes fan-out
    memory O(channels) instead of O(subscribers).  The stall/lag
    bookkeeping mirrors :class:`_Sub` so ``sub_stats`` and the
    write-stall gauge read both kinds identically."""

    __slots__ = ("cond", "cursor", "offset", "lagged", "closed",
                 "write_begin_mono", "last_write_mono", "writes")

    def __init__(self, cursor: int):
        self.cond = threading.Condition()
        self.cursor = cursor
        self.offset = 0
        self.lagged = False
        self.closed = False
        self.write_begin_mono: float | None = None
        self.last_write_mono: float | None = None
        self.writes = 0

    def write_stall_s(self, now_mono: float) -> float:
        """Age of the in-flight event-loop frame write (0 when idle)."""
        b = self.write_begin_mono
        return max(0.0, now_mono - b) if b is not None else 0.0


class Channel:
    """One coalesced stream: a single pump thread encodes each advance
    once and fans the shared bytes to every subscriber queue."""

    def __init__(self, hub: "FanoutHub", key):
        self.hub = hub
        self.key = key
        self.subs: list[_Sub] = []
        # event-loop side: one shared bounded frame ring (the single
        # copy every _EvSub's cursor indexes into) instead of a queue
        # per subscriber.  next_idx counts frames ever appended; ring
        # base = next_idx - len(ring); a cursor below base is lagged.
        self.ev_subs: list[_EvSub] = []
        self.ring: collections.deque = collections.deque()
        self.next_idx = 0
        self.ev_closed = False
        self.alive = True

    def try_retire(self) -> bool:
        """Retire the channel if no subscribers remain — checked and
        latched under the hub lock, so a concurrent subscribe either
        lands before (and keeps the pump alive) or sees a dead channel
        and mints a fresh one; a subscriber can never attach to a pump
        that already decided to exit."""
        with self.hub._lock:
            if self.subs or self.ev_subs:
                return False
            self.alive = False
            if self.hub._channels.get(self.key) is self:
                self.hub._channels.pop(self.key)
            return True

    def broadcast(self, data: bytes, meta=None) -> None:
        """Push one encoded frame to every subscriber.  A full queue
        means the subscriber stopped draining: it is marked lagged,
        its backlog dropped, and a LAGGED sentinel queued — the
        broadcaster itself NEVER blocks on a slow client.  With
        ``meta`` (a delivery-lineage encode stamp), the frame rides as
        a :class:`Tagged` wrapper around the SAME bytes object — the
        subscriber generator unwraps it, so wire bytes are unchanged."""
        item = Tagged(data, meta) if meta is not None else data
        with self.hub._lock:
            subs = list(self.subs)
            had_ev = bool(self.ev_subs)
            if had_ev:
                # ONE shared append, regardless of subscriber count;
                # trimming past the bound is what sheds laggards
                self.ring.append(item)
                self.next_idx += 1
                while len(self.ring) > self.hub.depth:
                    self.ring.popleft()
        wake = self.hub.ev_wake
        if had_ev and wake is not None:
            wake(self)
        depth = self.hub.depth
        hw = 0
        for s in subs:
            with s.cond:
                if s.lagged or s.closed:
                    continue
                if len(s.q) >= depth:
                    s.lagged = True
                    s.q.clear()
                    s.q.append(LAGGED)
                    if self.hub.on_lagged is not None:
                        self.hub.on_lagged()
                else:
                    s.q.append(item)
                    hw = max(hw, len(s.q))
                s.cond.notify()
        if self.hub.hw_gauge is not None and hw > self.hub.hw_gauge.value:
            self.hub.hw_gauge.set(hw)

    def finish(self, data: bytes | None = None) -> None:
        """Terminal frame + CLOSED to every subscriber; the channel
        stops accepting new ones.  A subscriber whose queue is already
        at the bound is shed as LAGGED instead of receiving the
        terminal frame — appending past the bound would silently evict
        its oldest PENDING frame (the deque's maxlen), turning a
        data frame loss into an invisible gap."""
        with self.hub._lock:
            subs = list(self.subs)
            self.alive = False
            self.hub._channels.pop(self.key, None)
            had_ev = bool(self.ev_subs)
            if had_ev and data is not None:
                self.ring.append(data)
                self.next_idx += 1
                while len(self.ring) > self.hub.depth:
                    self.ring.popleft()
            # event-loop subscribers drain whatever of the ring they
            # can still reach, then see the closed latch
            self.ev_closed = True
        wake = self.hub.ev_wake
        if had_ev and wake is not None:
            wake(self)
        depth = self.hub.depth
        for s in subs:
            with s.cond:
                if data is not None and not s.lagged:
                    if len(s.q) >= depth:
                        s.lagged = True
                        s.q.clear()
                        s.q.append(LAGGED)
                        if self.hub.on_lagged is not None:
                            self.hub.on_lagged()
                    else:
                        s.q.append(data)
                s.q.append(CLOSED)
                s.cond.notify()


class FanoutHub:
    """Channel registry: ``subscribe(key, pump)`` attaches a bounded
    subscriber queue to the key's channel, creating the channel (and
    its pump thread, which runs ``pump(chan)`` until the last
    subscriber detaches) on first use."""

    def __init__(self, depth: int = 64, on_lagged=None, hw_gauge=None):
        self.depth = max(1, int(depth))
        self.on_lagged = on_lagged
        self.hw_gauge = hw_gauge
        self._lock = threading.Lock()
        self._channels: dict = {}
        # set by an EventLoopServer: called with a Channel (outside
        # the hub lock) after each ring advance, so the loop pumps
        # that channel's event-loop subscribers.  One call per frame,
        # never per subscriber.
        self.ev_wake = None

    def subscribe(self, key, pump) -> tuple[Channel, _Sub]:
        sub = _Sub(self.depth)
        with self._lock:
            chan = self._channels.get(key)
            if chan is None or not chan.alive:
                chan = Channel(self, key)
                self._channels[key] = chan
                chan.subs.append(sub)
                t = threading.Thread(target=self._run, args=(chan, pump),
                                     daemon=True,
                                     name=f"sse-fanout-{key}")
                t.start()
            else:
                chan.subs.append(sub)
        return chan, sub

    def subscribe_ev(self, key, pump) -> tuple[Channel, _EvSub]:
        """Event-loop flavour of :meth:`subscribe`: attaches an
        :class:`_EvSub` cursor (no queue) at the channel ring's
        current head.  The pump side is identical — one encode per
        advance, broadcast to the shared ring."""
        with self._lock:
            chan = self._channels.get(key)
            if chan is None or not chan.alive:
                chan = Channel(self, key)
                self._channels[key] = chan
                sub = _EvSub(chan.next_idx)
                chan.ev_subs.append(sub)
                t = threading.Thread(target=self._run, args=(chan, pump),
                                     daemon=True,
                                     name=f"sse-fanout-{key}")
                t.start()
            else:
                sub = _EvSub(chan.next_idx)
                chan.ev_subs.append(sub)
        return chan, sub

    def shed_ev(self, sub: _EvSub) -> None:
        """Latch a fallen-behind event-loop subscriber as lagged (its
        cursor dropped below the ring base) and count the shed."""
        with sub.cond:
            if sub.lagged:
                return
            sub.lagged = True
        if self.on_lagged is not None:
            self.on_lagged()

    def retained_frames(self) -> int:
        """Total frames currently retained across every channel ring —
        the whole fan-out buffer memory, O(channels · depth) no matter
        how many subscribers share them (the
        ``heatmap_sse_fanout_retained_frames`` gauge)."""
        with self._lock:
            return sum(len(c.ring) for c in self._channels.values())

    def sub_stats(self, now_mono: float | None = None) -> list:
        """Per-subscriber delivery state across every live channel:
        queue depth, lag flag, completed write count, and the current
        write-stall age — how long the subscriber's in-flight socket
        write has been blocked (0 when none is in flight).  The wedged
        client's tell: its stall age climbs for the full send-timeout
        window while everyone else's stays ~0, BEFORE lag shedding
        fires."""
        if now_mono is None:
            now_mono = time.monotonic()
        out = []
        with self._lock:
            chans = [(k, list(c.subs),
                      [(s, c.next_idx) for s in c.ev_subs])
                     for k, c in self._channels.items()]
        for key, subs, ev in chans:
            for s in subs:
                with s.cond:
                    out.append({
                        "key": list(key) if isinstance(key, tuple)
                        else key,
                        "queue": len(s.q),
                        "lagged": s.lagged,
                        "writes": s.writes,
                        "stall_s": round(s.write_stall_s(now_mono), 6),
                    })
            for s, head in ev:
                with s.cond:
                    out.append({
                        "key": list(key) if isinstance(key, tuple)
                        else key,
                        # pending = ring head minus cursor: the same
                        # "frames not yet written" a queue length means
                        "queue": max(0, head - s.cursor),
                        "lagged": s.lagged,
                        "writes": s.writes,
                        "stall_s": round(s.write_stall_s(now_mono), 6),
                    })
        return out

    def max_write_stall_s(self) -> float:
        """The worst current write-stall age across all subscribers —
        the ``heatmap_sse_write_stall_seconds`` gauge."""
        now = time.monotonic()
        worst = 0.0
        with self._lock:
            subs = [s for c in self._channels.values()
                    for s in list(c.subs) + list(c.ev_subs)]
        for s in subs:
            worst = max(worst, s.write_stall_s(now))
        return round(worst, 6)

    def unsubscribe(self, chan: Channel, sub) -> None:
        with self._lock:
            try:
                chan.subs.remove(sub)
            except ValueError:
                try:
                    chan.ev_subs.remove(sub)
                except ValueError:
                    pass
            if not chan.ev_subs:
                # last cursor detached: the shared ring is garbage
                chan.ring.clear()
        with sub.cond:
            sub.closed = True
            sub.cond.notify()

    def _run(self, chan: Channel, pump) -> None:
        try:
            pump(chan)
        except Exception:  # noqa: BLE001 - a pump bug must not unwind silently
            import logging

            logging.getLogger(__name__).exception(
                "SSE fan-out pump failed for %r", chan.key)
        finally:
            with self._lock:
                if self._channels.get(chan.key) is chan:
                    self._channels.pop(chan.key, None)
                chan.alive = False
