"""The port's native host codecs (``heatmap_tpu_torch/native``) against the
JAX package's and against the port's own Python codecs, their plain
versions.

Both packages build the same C++ sources into libraries of their own and
load them side by side in this process (ctypes' ``RTLD_LOCAL``: the two
sets of symbols never bind to each other).  The bar everywhere is exact:
the same bytes, the same integers, the same float32 bit patterns.

- CRC32C: the spec check value, and random blobs and seeds, against JAX's
  ``crc32c_native`` and the port's table walk ``crc32c_plain``.
- ``kafka_decode_values`` on record batches that either package's
  ``records.py`` encoded (null values, headers, a start offset inside a
  batch, a truncated tail, a corrupt CRC, a compressed batch), against
  JAX's and against the Python record decoder; blobs that the native
  framing must refuse (a value holding a newline, malformed varints)
  return None in both.
- ``NativeDecoder.decode`` against JAX's and against the port's Python
  parse, column for column, over a corpus with invalid, unicode, NUL-byte,
  lone-surrogate and duplicate events; the intern ids stay stable across
  batches; ``decode_lines`` against JAX's.
- ``enc_tile_ops`` / ``enc_position_ops``: the ops bytes and end offsets
  byte-identical to JAX's on the same packed bodies and position rows.
- No g++: the build raises, and nothing falls back to a Python codec.
"""

import json

import numpy as np
import pytest

from heatmap_tpu import native as jnative
from heatmap_tpu.kafka import records as jrec
from heatmap_tpu_torch import _build
from heatmap_tpu_torch import native as tnative
from heatmap_tpu_torch.kafka import records as trec
from heatmap_tpu_torch.sink.base import PositionRows, TilePackMeta
from heatmap_tpu_torch.stream.source import _decode_raw_values


@pytest.fixture
def rng():
    return np.random.default_rng(20261017)


@pytest.mark.parametrize("seed", [0, 0xDEADBEEF])
def test_crc32c_matches_jax_and_the_plain_version(rng, seed):
    assert trec.crc32c(b"123456789") == 0xE3069283
    assert trec.crc32c_plain(b"123456789") == 0xE3069283
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 1000, 4099):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        want = jnative.crc32c_native(data, seed)
        assert tnative.crc32c_native(data, seed) == want
        assert trec.crc32c(data, seed) == want
        assert trec.crc32c_plain(data, seed) == want


def _records(base, n, null_every=0, headers=False):
    out = []
    for i in range(n):
        null = null_every and i % null_every == 0
        value = None if null else json.dumps(
            {"vehicleId": f"v{base + i}", "lat": 42.0 + i * 1e-4,
             "lon": -71.0, "speedKmh": float(i), "provider": "t",
             "ts": "2024-01-01T00:00:00Z"}).encode()
        out.append((base + i, 1_700_000_000_000 + i,
                    f"v{i}".encode() if i % 3 else None, value,
                    [("h", b"x")] if headers and i % 5 == 0 else []))
    return out


def _blob(pkg, n_batches=4, per_batch=50, base=1000, **kw):
    """Record batches encoded by ``pkg``'s records.py (jax or port)."""
    rec = jrec if pkg == "jax" else trec
    parts, off = [], base
    for _ in range(n_batches):
        recs = [rec.Record(o, t, k, v, h)
                for o, t, k, v, h in _records(off, per_batch, **kw)]
        parts.append(rec.encode_batch(recs, base_offset=off))
        off += per_batch
    return b"".join(parts), off


def _corrupt_crc(blob):
    bad = bytearray(blob)
    bad[len(blob) // 3 + 70] ^= 0xFF    # a record byte of batch 2
    return bytes(bad)


def _compressed(blob):
    bad = bytearray(blob)
    bad[22] |= 0x01                     # attributes: gzip, unsupported
    return bytes(bad)


CASES = {
    "plain": (lambda b: b, {}, 1000),
    "nulls_and_headers": (lambda b: b, dict(null_every=4, headers=True),
                          1000),
    "start_inside_a_batch": (lambda b: b, {}, 1075),
    "truncated_tail": (lambda b: b[:len(b) - 17], {}, 1000),
    "corrupt_crc": (_corrupt_crc, {}, 1000),
    "compressed": (_compressed, {}, 1000),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_kafka_decode_values_matches_jax(encoder, case):
    mutate, kw, start = CASES[case]
    blob, _ = _blob(encoder, n_batches=3, per_batch=40, **kw)
    blob = mutate(blob)
    got = tnative.kafka_decode_values(blob, start)
    want = jnative.kafka_decode_values(blob, start)
    assert got is not None and want is not None
    assert got.blob == want.blob
    np.testing.assert_array_equal(got.val_off, want.val_off)
    np.testing.assert_array_equal(got.val_pos, want.val_pos)
    assert (got.next_offset, got.skipped_batches, got.n_null) == (
        want.next_offset, want.skipped_batches, want.n_null)
    # and against the Python record decoder, value by value
    precs, _, pskip = trec.decode_batches_tolerant(blob, start)
    values = [(r.offset, r.value) for r in precs
              if r.offset >= start and r.value is not None]
    assert got.skipped_batches == pskip
    assert [int(o) for o in got.val_off] == [o for o, _ in values]
    assert got.blob == b"".join(v + b"\n" for _, v in values)
    if case == "corrupt_crc":
        assert got.skipped_batches == 1


_VALID = trec.encode_batch([trec.Record(0, 0, None, b'{"b":2}'),
                            trec.Record(1, 0, None, b'{"c":3}')])


@pytest.mark.parametrize("blob", [
    pytest.param(trec.encode_batch([trec.Record(0, 0, None, b'{"a":\n1}'),
                                    trec.Record(1, 0, None, b'{"b":2}')]),
                 id="newline_value"),
    pytest.param(_VALID[:61] + b"\xff" * 11 + _VALID[72:],
                 id="malformed_varints"),    # the first record's length
])
def test_blobs_the_native_framing_refuses(blob):
    """None in both packages: the caller takes the Python record path for
    this blob (the source's per-blob fallback)."""
    assert jnative.kafka_decode_values(blob, 0, verify_crc=False) is None
    assert tnative.kafka_decode_values(blob, 0, verify_crc=False) is None


def _events(rng, n):
    out = []
    for i in range(n):
        out.append({
            "provider": "mbta" if i % 3 else "opensky",
            "vehicleId": f"veh-{i % 17}",
            "lat": float(rng.uniform(-90, 90)),
            "lon": float(rng.uniform(-180, 180)),
            "speedKmh": float(rng.uniform(0, 200)),
            "ts": (f"2026-07-{i % 28 + 1:02d}T12:{i % 60:02d}:30Z" if i % 2
                   else 1_780_000_000 + i),
        })
    return out


_ODD_LINES = [
    b"not json",
    b'{"broken',
    b'{"provider": null, "vehicleId": "x", "lat": 1.0, "lon": 1.0, '
    b'"ts": 1700000000}',
    b'{"provider": "p", "vehicleId": "x", "lat": 91.0, "lon": 1.0, '
    b'"ts": 1700000000}',
    b'{"provider": "p", "vehicleId": "x", "lat": 1.0, "lon": 1.0, '
    b'"ts": "garbage"}',
    b'{"provider": "p", "vehicleId": "x", "lon": 1.0, "ts": 1700000000}',
    b'{"provider": "p", "vehicleId": "x", "lat": 1.0, "lon": 1.0, '
    b'"ts": 1.7e12}',
    '{"provider": "p", "vehicleId": "Nächster Halt", "lat": 1.0, '
    '"lon": 1.0, "ts": 1700000000}'.encode(),
    b'{"provider": "p", "vehicleId": "a\\u0000x", "lat": 1.0, "lon": 1.0, '
    b'"ts": 1700000000}',
    b'{"provider": "p", "vehicleId": "a\\u0000y", "lat": 1.0, "lon": 1.0, '
    b'"ts": 1700000000}',
    b'{"provider": "p", "vehicleId": "\\ud800", "lat": 1.0, "lon": 1.0, '
    b'"ts": 1700000000}',
    b'{"provider": "p", "vehicleId": "s1", "lat": "42.36", "lon": "-71.06",'
    b' "speedKmh": " 30.5 ", "ts": 1700000000}',
    b'{"provider": 42, "vehicleId": 1711, "lat": 1.0, "lon": 1.0, '
    b'"ts": "2026-07-29T12:00:00+02:00", "extra": {"n": [1, {"a": "b"}]}}',
    b"\xff\xfe",
]


def _corpus(rng, n):
    """JSON lines: valid events, each of the odd lines, and duplicates
    (the same event twice)."""
    lines = [json.dumps(e).encode() for e in _events(rng, n)]
    lines[5:5] = _ODD_LINES
    lines += lines[:7]                  # duplicates
    return lines


def _named(cols):
    return ([cols.providers[i] for i in cols.provider_id],
            [cols.vehicles[i] for i in cols.vehicle_id])


def assert_columns_identical(got, want):
    assert len(got) == len(want) and got.n_dropped == want.n_dropped
    for f in ("lat_deg", "lng_deg", "lat_rad", "lng_rad", "speed_kmh",
              "ts_s"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f
    assert _named(got) == _named(want)


def test_native_decoder_matches_jax_and_the_python_parse(rng):
    """Two batches through one decoder on each side: every column
    bit-identical, the dropped counts equal, the intern ids the same and
    stable across the batches; the port's Python parse agrees event for
    event."""
    tdec, jdec = tnative.NativeDecoder(), jnative.NativeDecoder()
    intern_p, intern_v = {}, {}
    for k in range(2):
        lines = _corpus(rng, 120)
        data = b"\n".join(lines) + b"\n"
        got, consumed = tdec.decode(data)
        want, jconsumed = jdec.decode(data)
        assert consumed == jconsumed == len(data)
        assert_columns_identical(got, want)
        np.testing.assert_array_equal(got.provider_id, want.provider_id)
        np.testing.assert_array_equal(got.vehicle_id, want.vehicle_id)
        assert got.providers == want.providers
        assert got.vehicles == want.vehicles
        plain = _decode_raw_values(None, lines, intern_p, intern_v)
        assert_columns_identical(got, plain)
    assert "a\x00x" in got.vehicles and "\ud800" in got.vehicles


def test_decode_lines_matches_jax():
    pretty = (b'{\n  "provider": "mbta",\n  "vehicleId": "v1",\n'
              b'  "lat": 42.3,\n  "lon": -71.05,\n  "ts": 1700000000\n}')
    compact = (b'{"provider": "mbta", "vehicleId": "v2", "lat": 42.4, '
               b'"lon": -71.0, "ts": 1700000001}')
    broken = b'{"provider":\n'
    values = [pretty, compact, broken]
    got = tnative.decode_lines(tnative.NativeDecoder(), values)
    want = jnative.decode_lines(jnative.NativeDecoder(), values)
    assert_columns_identical(got, want)
    assert _named(got)[1] == ["v1", "v2"] and got.n_dropped == 1


def _body(rng, n):
    """Packed emit body rows (engine.step.pack_emit layout), some with
    valid == 0 or count == 0."""
    body = np.zeros((n, 13), np.uint32)
    body[:, 0] = rng.integers(0, 2**31, n)
    body[:, 1] = rng.integers(0, 2**32, n)
    ws = (1_700_000_000 + rng.integers(0, 864, n) * 100).astype(np.int32)
    body[:, 2] = ws.view(np.uint32)
    body[:, 3] = rng.integers(0, 50, n)
    for col, lo, hi in ((4, -50.0, 5000.0), (5, 0, 1e5), (6, -0.4, 0.4),
                        (7, -0.4, 0.4), (9, 0, 250.0), (10, 0, 200.0),
                        (11, -90.0, 90.0), (12, -180.0, 180.0)):
        body[:, col] = rng.uniform(lo, hi, n).astype(np.float32).view(
            np.uint32)
    body[:, 8] = (rng.random(n) > 0.15).astype(np.uint32)
    return body


@pytest.mark.parametrize("meta", [
    TilePackMeta("bos", "h3r8", 300, 45, 0, True),
    TilePackMeta("bos", "h3r9m1", 60, 45, 1, True),
    TilePackMeta("global-city", "h3r7", 300, 45, 0, False),
])
def test_tile_ops_byte_identical_to_jax(rng, meta):
    for n in (0, 1, 257):
        body = _body(rng, n)
        args = (body, meta.city, meta.grid, meta.window_s, meta.ttl_minutes,
                meta.window_minutes_tag, meta.with_p95)
        ops, ends, k = tnative.NativeTileOps().encode(*args)
        jops, jends, jk = jnative.NativeTileOps().encode(*args)
        assert ops == jops and k == jk
        np.testing.assert_array_equal(ends, jends)


def test_position_ops_byte_identical_to_jax(rng):
    for n in (0, 1, 97):
        rows = PositionRows(
            lat=rng.uniform(-90, 90, n).astype(np.float32),
            lon=rng.uniform(-180, 180, n).astype(np.float32),
            ts_ms=(1_700_000_000_000 + rng.integers(-10**12, 10**6, n)
                   ).astype(np.int64),
            providers=[["mbta", "opensky", "tëst"][i % 3]
                       for i in range(n)],
            vehicles=[f"veh-{i}\x00" if i % 7 == 0 else f"veh-{i}"
                      for i in range(n)])
        ops, ends, k = tnative.NativePositionOps().encode(rows)
        jops, jends, jk = jnative.NativePositionOps().encode(rows)
        assert ops == jops and k == jk == n
        np.testing.assert_array_equal(ends, jends)


def test_the_port_loads_its_own_library():
    """Two libraries, one process: the port's functions come from the
    port's own file under build/heatmap_tpu_torch."""
    lib = _build.load(_build.NATIVE_LIB)
    assert lib._name == str(_build.library_path(_build.NATIVE_LIB))
    assert _build.library_path(_build.NATIVE_LIB).parent == _build.BUILD_DIR
    assert tnative.NativeDecoder()._lib is lib


def test_native_cache_knob_decides_where_the_port_builds(monkeypatch,
                                                        tmp_path):
    """HEATMAP_NATIVE_CACHE names the build directory, read at build time
    as the reference reads it; unset, the libraries go to BUILD_DIR."""
    cache = tmp_path / "native-cache"
    monkeypatch.setenv("HEATMAP_NATIVE_CACHE", str(cache))
    monkeypatch.setattr(_build, "_loaded", {})
    lib = _build.load(_build.NATIVE_LIB)
    path = _build.library_path(_build.NATIVE_LIB)
    assert path.parent == cache and path.is_file()
    assert lib._name == str(path)
    assert _build.library_path("infer/csrc/kalman_rounds.cu").parent == cache
    assert tnative.crc32c_native(b"123456789") == 0xE3069283
    monkeypatch.delenv("HEATMAP_NATIVE_CACHE")
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build.library_path(_build.NATIVE_LIB).parent == _build.BUILD_DIR


def test_missing_gxx_raises_and_nothing_falls_back(monkeypatch, tmp_path):
    """PATH holds no g++ and no library is built yet: the build, the
    decoder and the CRC raise; no Python codec stands in."""
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ not found"):
        _build.build(_build.NATIVE_LIB)
    with pytest.raises(_build.KernelBuildError):
        tnative.NativeDecoder()
    with pytest.raises(_build.KernelBuildError):
        tnative.crc32c_native(b"123456789")
    assert not (tmp_path / "build").exists()


def test_failed_compile_names_the_command(monkeypatch, tmp_path):
    """A g++ that fails: the error carries the command and its output."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "g++"
    fake.write_text("#!/bin/sh\necho 'no such header' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError) as e:
        _build.build(_build.NATIVE_LIB)
    msg = str(e.value)
    assert "no such header" in msg and str(fake) in msg
    assert "kafka_codec.cpp" in msg and " ".join(_build.GXX_FLAGS) in msg
