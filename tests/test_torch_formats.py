"""The port's binary and columnar event formats, and the ingress that
carries them, against the JAX package's.

- ``stream/binfmt.py``: ``encode_event`` byte-identical on a seeded corpus
  (non-finite and missing optional floats, string and numeric ``ts``),
  the same refusals; ``decode_event`` / ``decode_events`` equal on good
  and bad envelopes; ``frame_lp`` byte-identical.
- ``stream/colfmt.py``: ``encode_batch`` (poison events skipped, the
  sorted string table) and ``encode_batch_columns`` byte-identical;
  ``decode_batch`` column for column, extras too, through the port's
  native and Python string-table parsers, with and without the LUT memo,
  across batches that share intern maps, and on refused envelopes
  (truncated, bad magic, an inflated string count, a table running past
  the value); ``decode_batch_dicts`` and ``concat_columns`` equal.
- Native bindings: ``strtab_offsets_native`` equal to JAX's, refusals
  included; ``kafka_decode_values(framing="lp")`` byte-identical to JAX's
  on record batches of binary values (nulls, a start inside a batch, a
  truncated tail, a corrupt CRC) and None on a blob with malformed
  varints in both; ``NativeDecoder.decode_binary`` equal to JAX's and to
  the Python path (``binfmt.decode_events`` + ``parse_events``).
- ``KafkaSource`` for ``HEATMAP_EVENT_FORMAT=binary`` and ``columnar``:
  the port's and JAX's, each on its own mock broker fed the same records,
  poll by poll identical columns, offsets and transport counters, with
  the native codecs and with the Python ones (the port's
  ``decoder="python"``; JAX's native hooks patched out).
- The runtime's carry: columnar values overshoot the batch; both
  runtimes (HEATMAP_H3_IMPL unset: the host snap on the CPU in both) fold
  one topic each to the same docs, every event once, commits only on
  carry-free epochs, and an odd commit cadence is not starved.

The bar is exact everywhere (bytes, integers, float32 bit patterns),
except the runtimes' float doc fields: average, stddev and p95 of speed
within 1e-6 relative and centroids within 1e-5 degrees, the bars of
``test_torch_stream.py``.
"""

import json
import math
import time

import numpy as np
import pytest

from heatmap_tpu import native as jnative
from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.kafka import client as jclient
from heatmap_tpu.kafka import records as jrec
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import binfmt as jbin
from heatmap_tpu.stream import colfmt as jcol
from heatmap_tpu.stream import events as jevents
from heatmap_tpu.stream.source import KafkaSource as JaxKafkaSource
from heatmap_tpu.testing import mock_kafka as jmock
from heatmap_tpu_torch import native as tnative
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.kafka import client as tclient
from heatmap_tpu_torch.kafka import records as trec
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream import binfmt as tbin
from heatmap_tpu_torch.stream import colfmt as tcol
from heatmap_tpu_torch.stream import events as tevents
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import KafkaSource
from heatmap_tpu_torch.testing import mock_kafka as tmock

TOPIC = "mobility.positions.v1"
COLUMN_FIELDS = ("lat_rad", "lng_rad", "lat_deg", "lng_deg", "speed_kmh",
                 "ts_s", "provider_id", "vehicle_id")
INGRESS_KNOBS = ("HEATMAP_EVENT_FORMAT", "HEATMAP_KAFKA_IMPL",
                 "HEATMAP_FETCH_MAX_BYTES", "HEATMAP_FEEDER",
                 "HEATMAP_H3_IMPL")


def assert_columns_equal(a, b):
    if isinstance(a, list) or isinstance(b, list):
        assert a == b == []
        return
    for f in COLUMN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (list(a.providers), list(a.vehicles), a.n_dropped) == \
        (list(b.providers), list(b.vehicles), b.n_dropped)


def events(seed, n, t0=1_700_000_000):
    """Seeded canonical events: string and numeric ts, missing, null and
    non-finite optional floats, unicode names, a few out-of-range rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        e = {"provider": "mbta" if i % 4 else "opensky",
             "vehicleId": f"veh-{int(rng.integers(0, 37))}"
                          + ("-ü" if i % 11 == 0 else ""),
             "lat": float(rng.uniform(42.2, 42.5)),
             "lon": float(rng.uniform(-71.2, -70.9)),
             "speedKmh": float(rng.uniform(0, 120)),
             "bearing": float(rng.uniform(0, 360)),
             "accuracyM": float(rng.uniform(1, 20)),
             "ts": t0 + int(rng.integers(0, 900))}
        if i % 7 == 1:
            e["ts"] = (f"2023-11-14T22:{i % 60:02d}:"
                       f"{int(rng.integers(0, 60)):02d}Z")
        if i % 9 == 2:
            e["speedKmh"] = math.inf
        if i % 13 == 3:
            e.pop("bearing")
            e["accuracyM"] = None
        if i % 17 == 4:
            e["lat"] = 95.0           # rejected at decode
        out.append(e)
    return out


# --- binfmt -----------------------------------------------------------------

def test_binfmt_encode_is_byte_identical():
    evs = events(1, 400)
    got = [tbin.encode_event(e) for e in evs]
    assert got == [jbin.encode_event(e) for e in evs]
    assert tbin.frame_lp(got) == jbin.frame_lp(got)
    assert tbin.HEADER_SIZE == jbin.HEADER_SIZE == 32


@pytest.mark.parametrize("bad", [
    {"provider": "p" * 300, "vehicleId": "v", "lat": 0, "lon": 0, "ts": 1},
    {"provider": "p", "vehicleId": "v", "lat": 0, "lon": 0,
     "ts": "not-a-ts"},
    {"provider": "p", "lat": 0, "lon": 0, "ts": 1},
], ids=["long_name", "bad_ts", "no_vehicle"])
def test_binfmt_refuses_as_jax(bad):
    with pytest.raises(Exception) as want:
        jbin.encode_event(bad)
    with pytest.raises(type(want.value)):
        tbin.encode_event(bad)


def _bad_envelopes(good):
    bad_utf8 = bytearray(good)
    bad_utf8[tbin.HEADER_SIZE] = 0xFF
    return [b"", good[:-1], b"\x00" + good[1:], good + b"x",
            bytes(bad_utf8), good[:1] + b"\x02" + good[2:]]


def test_binfmt_decode_matches_jax():
    vals = [tbin.encode_event(e) for e in events(2, 200)]
    vals[3:3] = _bad_envelopes(vals[0])
    for v in vals:
        assert tbin.decode_event(v) == jbin.decode_event(v)
    assert tbin.decode_events(vals) == jbin.decode_events(vals)
    assert tbin.decode_events(vals)[1] == 6


def test_decode_binary_matches_jax_and_the_python_path():
    """One persistent decoder per package over three lp-framed chunks
    (bad envelopes inside): the same columns, drops and intern ids; and
    the port's Python path on the same values gives the same columns."""
    tdec, jdec = tnative.NativeDecoder(), jnative.NativeDecoder()
    ip, iv = {}, {}
    for seed in (3, 4, 5):
        vals = [tbin.encode_event(e) for e in events(seed, 300)]
        vals[10:10] = _bad_envelopes(vals[0])
        data = tbin.frame_lp(vals)
        got, used = tdec.decode_binary(data)
        want, jused = jdec.decode_binary(data)
        assert used == jused == len(data)
        assert_columns_equal(got, want)
        dicts, dropped = tbin.decode_events(vals)
        plain = tevents.parse_events(dicts, ip, iv)
        plain.n_dropped += dropped
        assert got.n_dropped == plain.n_dropped > 0
        for f in COLUMN_FIELDS[:6]:
            assert getattr(got, f).tobytes() == getattr(plain, f).tobytes()
        names = lambda c: ([c.providers[i] for i in c.provider_id],
                           [c.vehicles[i] for i in c.vehicle_id])
        assert names(got) == names(plain)
    # a partial trailing frame is left unconsumed, as in JAX
    data = tbin.frame_lp([tbin.encode_event(e) for e in events(6, 5)])
    got, used = tdec.decode_binary(data[:-7])
    want, jused = jdec.decode_binary(data[:-7])
    assert used == jused < len(data) - 7
    assert_columns_equal(got, want)
    tdec.close()
    jdec.close()


# --- colfmt -----------------------------------------------------------------

def _poison(evs):
    evs = list(evs)
    evs[5:5] = [{"provider": None, "vehicleId": "x", "lat": 1, "lon": 1,
                 "ts": 1}, {"vehicleId": "x", "lat": 1, "lon": 1, "ts": 1},
                {"provider": "p", "vehicleId": "x", "lat": "nan?",
                 "lon": 1, "ts": 1},
                {"provider": "p", "vehicleId": "x", "lat": 1, "lon": 1,
                 "ts": "never"},
                {"provider": "p", "vehicleId": "x", "lat": 1, "lon": 1,
                 "ts": 2.0 ** 70}]
    return evs


def test_colfmt_encode_batch_is_byte_identical():
    evs = _poison(events(7, 500))
    assert tcol.encode_batch(evs) == jcol.encode_batch(evs)
    assert tcol.encode_batch(evs[::-1]) == jcol.encode_batch(evs[::-1])
    assert tcol.encode_batch([]) == jcol.encode_batch([])


def test_colfmt_encode_batch_columns_is_byte_identical():
    evs = events(8, 700)
    tc = tevents.parse_events(evs)
    jc = jevents.parse_events(evs)
    for lo, hi in ((0, 700), (100, 350), (0, 0)):
        assert tcol.encode_batch_columns(tevents.slice_columns(tc, lo, hi)) \
            == jcol.encode_batch_columns(jevents.slice_columns(jc, lo, hi))
    bad = tevents.slice_columns(tc, 0, 10)
    bad.vehicle_id = bad.vehicle_id.copy()
    bad.vehicle_id[3] = len(bad.vehicles)
    with pytest.raises(ValueError):
        tcol.encode_batch_columns(bad)


def _values():
    """Columnar values: three batches sharing names, an empty batch."""
    vals = [tcol.encode_batch(events(s, 400)) for s in (9, 10, 11)]
    vals.append(tcol.encode_batch(events(9, 400)))   # a LUT-memo hit
    vals.append(tcol.encode_batch([]))
    return vals


@pytest.mark.parametrize("memo", [False, True], ids=["no_memo", "memo"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_colfmt_decode_matches_jax(native, memo):
    tp, tv, jp, jv = {}, {}, {}, {}
    tcache = {} if memo else None
    jcache = {} if memo else None
    for v in _values():
        tx, jx = {}, {}
        got = tcol.decode_batch(v, tp, tv, tcache, extras=tx, native=native)
        want = jcol.decode_batch(v, jp, jv, jcache, extras=jx)
        assert_columns_equal(got, want)
        assert got.n_dropped == want.n_dropped
        for k in ("bearing", "accuracy"):
            assert tx[k].tobytes() == jx[k].tobytes()
    assert tp == jp and tv == jv


def _refused(good):
    n_strings = int.from_bytes(good[8:12], "little")
    inflated = bytearray(good)
    inflated[8:12] = (n_strings + 1000).to_bytes(4, "little")
    past = bytearray(good)
    past[-1:] = b""
    over = bytearray(good)
    # the last string's length prefix claims more bytes than remain
    tab_bytes = int.from_bytes(good[12:16], "little")
    over[len(good) - tab_bytes:len(good) - tab_bytes + 2] = (
        0xFFFF).to_bytes(2, "little")
    return {"short": good[:10], "bad_magic": b"\x00" + good[1:],
            "bad_version": good[:1] + b"\x09" + good[2:],
            "inflated_count": bytes(inflated), "truncated": bytes(past),
            "table_past_value": bytes(over)}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_colfmt_refuses_as_jax(native):
    good = tcol.encode_batch(events(12, 50))
    for name, v in _refused(good).items():
        want = jcol.decode_batch(v, {}, {})
        got = tcol.decode_batch(v, {}, {}, native=native)
        assert (got is None) == (want is None), name
        if want is not None:
            assert_columns_equal(got, want)
    # a memo hit never skips the refusal of an inflated count
    cache = {}
    assert tcol.decode_batch(good, {}, {}, cache, native=native) is not None
    assert tcol.decode_batch(_refused(good)["inflated_count"], {}, {}, cache,
                             native=native) is None


def test_colfmt_dicts_and_concat_match_jax():
    v = tcol.encode_batch(events(13, 300))
    assert tcol.decode_batch_dicts(v) == jcol.decode_batch_dicts(v)
    assert tcol.decode_batch_dicts(b"junk") == jcol.decode_batch_dicts(
        b"junk") == []
    tp, tv, jp, jv = {}, {}, {}, {}
    vals = _values()[:3]
    tparts = [tcol.decode_batch(x, tp, tv) for x in vals]
    jparts = [jcol.decode_batch(x, jp, jv) for x in vals]
    assert_columns_equal(tcol.concat_columns(tparts, tp, tv),
                         jcol.concat_columns(jparts, jp, jv))


# --- native bindings ---------------------------------------------------------

def _strtab(names):
    return tcol._encode_strtab(names)


@pytest.mark.parametrize("case", ["plain", "empty", "unicode", "past_blob",
                                  "count_exceeds_blob", "zero_entries"])
def test_strtab_offsets_native_matches_jax(case):
    names = [f"veh-{i}" for i in range(300)]
    blob, n = _strtab(names), len(names)
    if case == "empty":
        blob, n = _strtab([""] * 5 + ["x"]), 6
    elif case == "unicode":
        blob, n = _strtab(["Nächster", "東京", "a\x00b"]), 3
    elif case == "past_blob":
        blob = blob[:-3]
    elif case == "count_exceeds_blob":
        n = len(blob)
    elif case == "zero_entries":
        n = 0
    try:
        want = jnative.strtab_offsets_native(blob, n)
    except ValueError:
        with pytest.raises(ValueError):
            tnative.strtab_offsets_native(blob, n)
        return
    got = tnative.strtab_offsets_native(blob, n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _binary_blob(pkg, n_batches=3, per_batch=40, base=1000, null_every=0):
    rec = jrec if pkg == "jax" else trec
    evs = events(14, n_batches * per_batch)
    parts, off = [], base
    for b in range(n_batches):
        recs = []
        for i in range(per_batch):
            k = b * per_batch + i
            null = null_every and k % null_every == 0
            value = None if null else tbin.encode_event(evs[k])
            if k == 7:
                value = b"\n\x00" + value[2:]   # newlines do not matter here
            recs.append(rec.Record(off + i, 1_700_000_000_000 + k,
                                   f"v{k}".encode(), value))
        parts.append(rec.encode_batch(recs, base_offset=off))
        off += per_batch
    return b"".join(parts)


def _corrupt_crc(blob):
    bad = bytearray(blob)
    bad[len(blob) // 3 + 70] ^= 0xFF
    return bytes(bad)


LP_CASES = {
    "plain": (lambda b: b, {}, 1000),
    "nulls": (lambda b: b, dict(null_every=4), 1000),
    "start_inside_a_batch": (lambda b: b, {}, 1075),
    "truncated_tail": (lambda b: b[:len(b) - 17], {}, 1000),
    "corrupt_crc": (_corrupt_crc, {}, 1000),
}


@pytest.mark.parametrize("case", sorted(LP_CASES))
@pytest.mark.parametrize("encoder", ["jax", "port"])
def test_kafka_decode_values_lp_matches_jax(encoder, case):
    mutate, kw, start = LP_CASES[case]
    blob = mutate(_binary_blob(encoder, **kw))
    got = tnative.kafka_decode_values(blob, start, framing="lp")
    want = jnative.kafka_decode_values(blob, start, framing="lp")
    assert got is not None and want is not None
    assert got.blob == want.blob
    for f in ("val_off", "val_pos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.next_offset, got.skipped_batches, got.n_null) == (
        want.next_offset, want.skipped_batches, want.n_null)
    precs, _, _ = trec.decode_batches_tolerant(blob, start)
    values = [r.value for r in precs
              if r.offset >= start and r.value is not None]
    assert got.blob == tbin.frame_lp(values)


def test_kafka_decode_values_lp_refuses_as_jax():
    valid = trec.encode_batch([trec.Record(0, 0, None, b"\xb1" * 40),
                               trec.Record(1, 0, None, b"\xb1" * 33)])
    bad = valid[:61] + b"\xff" * 11 + valid[72:]
    assert jnative.kafka_decode_values(bad, 0, verify_crc=False,
                                       framing="lp") is None
    assert tnative.kafka_decode_values(bad, 0, verify_crc=False,
                                       framing="lp") is None
    with pytest.raises(ValueError):
        tnative.kafka_decode_values(valid, 0, framing="crlf")


# --- KafkaSource, each package on its own broker -------------------------------

@pytest.fixture
def ingress_env(monkeypatch):
    for k in INGRESS_KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _produce(client_mod, bootstrap, fmt, evs, seed):
    """The same records into ``client_mod``'s broker: binary values keyed
    by vehicleId (bad envelopes and tombstones among them), or columnar
    values round-robin (a malformed one among them)."""
    rec = trec if client_mod is tclient else jrec
    c = client_mod.KafkaClient(bootstrap)
    n_parts = len(c.partitions(TOPIC))
    rng = np.random.default_rng(seed)
    by_part: dict = {}
    if fmt == "binary":
        for i, e in enumerate(evs):
            key = str(e["vehicleId"]).encode()
            v = tbin.encode_event(e)
            if i % 97 == 5:
                v = b"\x00" + v[1:]
            elif i % 89 == 6:
                v = v[:-3]
            elif i % 83 == 7:
                v = None
            p = client_mod.partition_for_key(key, n_parts)
            by_part.setdefault(p, []).append(rec.Record(0, i, key, v))
        step = 37
    else:
        chunks = [evs[k:k + int(rng.integers(50, 300))]
                  for k in range(0, len(evs), 300)]
        for i, ch in enumerate(chunks):
            v = tcol.encode_batch(ch) if i != 3 else b"\xb2junk"
            by_part.setdefault(i % n_parts, []).append(
                rec.Record(0, i, None, v))
        step = 2
    for p, recs in sorted(by_part.items()):
        for j in range(0, len(recs), step):
            c.produce(TOPIC, p, recs[j:j + step])
    c.close()


def _jax_counters(mine):
    return {k: v for k, v in mine.counters.items()
            if k.startswith("kafka_") and k != "kafka_native_fallback_blobs"}


@pytest.mark.parametrize("decoder", ["native", "python"])
@pytest.mark.parametrize("fmt", ["binary", "columnar"])
def test_kafka_source_polls_as_the_jax_source(ingress_env, fmt, decoder):
    ingress_env.setenv("HEATMAP_EVENT_FORMAT", fmt)
    if decoder == "python":
        ingress_env.setattr(jnative, "maybe_decoder", lambda *a, **k: None)
        ingress_env.setattr(jnative, "strtab_offsets_native",
                            lambda *a, **k: None)
    evs = events(15, 2400)
    with tmock.MockKafkaBroker() as tboot, jmock.MockKafkaBroker() as jboot:
        mine = KafkaSource(tboot, TOPIC, decoder=decoder)
        ref = JaxKafkaSource(jboot, TOPIC, impl="wire")
        assert (ref._impl._dec is None) == (decoder == "python")
        _produce(tclient, tboot, fmt, evs, 15)
        _produce(jclient, jboot, fmt, evs, 15)
        for max_events in [7, 64, 1, 150, 1000, 1000, 1000, 1000, 5]:
            a, b = mine.poll(max_events), ref.poll(max_events)
            assert_columns_equal(a, b)
            assert mine.offset() == ref.offset()
        assert _jax_counters(mine) == ref.counters
        got = mine.counters
        used, unused = (("values_decoded_native", "values_decoded_python")
                        if decoder == "native" else
                        ("values_decoded_python", "values_decoded_native"))
        assert got[used] > 0 and got[unused] == 0
        # a committed map comes back from meta.json with string keys
        committed = json.loads(json.dumps({0: 3, 1: 0, 2: 5}))
        mine.seek(committed)
        ref.seek(committed)
        for _ in range(3):
            assert_columns_equal(mine.poll(500), ref.poll(500))
            assert mine.offset() == ref.offset()
        mine.close()
        ref.close()


# --- the runtime's carry ---------------------------------------------------------

AXES = dict(city="bos", h3_res=9, resolutions=(9,), windows_minutes=(5,),
            tile_minutes=5, batch_size=512, state_capacity_log2=13,
            speed_hist_bins=8)


def _carry_events(n, t0):
    rng = np.random.default_rng(3)
    return [{"provider": "mbta", "vehicleId": f"v{i % 30}",
             "lat": float(rng.uniform(42.3, 42.4)),
             "lon": float(rng.uniform(-71.1, -71.0)),
             "speedKmh": float(rng.uniform(5, 60)), "bearing": 0.0,
             "accuracyM": 4.0, "ts": t0 + (i % 240)} for i in range(n)]


def _publish_columnar(client_mod, bootstrap, evs, per_value):
    rec = trec if client_mod is tclient else jrec
    c = client_mod.KafkaClient(bootstrap)
    n_parts = len(c.partitions(TOPIC))
    for i, k in enumerate(range(0, len(evs), per_value)):
        c.produce(TOPIC, i % n_parts,
                  [rec.Record(0, 0, None,
                              tcol.encode_batch(evs[k:k + per_value]))])
    c.close()


def assert_native_docs_match(ref_docs, docs, n_events):
    """Both runtimes keyed by the host snap: the same (cell, window) set,
    counts and ids exact, floats under the bars of test_torch_stream."""
    key = lambda d: (d["cellId"], int(d["windowStart"].timestamp()))
    ref = {key(d): d for d in ref_docs.values()}
    mine = {key(d): d for d in docs.values()}
    assert mine.keys() == ref.keys()
    assert sum(d["count"] for d in mine.values()) == n_events
    for k, d in mine.items():
        r = ref[k]
        assert d["_id"] == r["_id"] and d["count"] == r["count"], k
        assert d["windowEnd"] == r["windowEnd"]
        for f in ("avgSpeedKmh", "stddevSpeedKmh", "p95SpeedKmh"):
            assert d[f] == pytest.approx(r[f], rel=1e-6, abs=1e-9), (k, f)
        for a, b in zip(d["centroid"]["coordinates"],
                        r["centroid"]["coordinates"]):
            assert abs(a - b) <= 1e-5, (k, a, b)


def test_carry_on_overshoot_matches_jax(tmp_path, ingress_env):
    """500-event columnar values against a 512-row batch: polls overshoot,
    the rows past the batch are carried; both runtimes fold every event
    once to the same docs, and the port commits only carry-free epochs."""
    ingress_env.setenv("HEATMAP_EVENT_FORMAT", "columnar")
    evs = _carry_events(3000, int(time.time()) - 1200)
    with tmock.MockKafkaBroker() as tboot, jmock.MockKafkaBroker() as jboot:
        jcfg = jax_load_config(None, checkpoint_dir=str(tmp_path / "j"),
                               store="memory", **AXES)
        jstore = JaxMemoryStore()
        jrt = JaxRuntime(jcfg, JaxKafkaSource(jboot, TOPIC, impl="wire"),
                         jstore, checkpoint_every=0)
        cfg = load_config({}, checkpoint_dir=str(tmp_path / "t"), **AXES)
        store = MemoryStore()
        rt = MicroBatchRuntime(cfg, KafkaSource(tboot, TOPIC), store,
                               device="cpu", checkpoint_every=1)
        assert rt.snap_impl == "native"
        _publish_columnar(tclient, tboot, evs, 500)
        _publish_columnar(jclient, jboot, evs, 500)
        saw_carry, skipped = False, 0
        for _ in range(40):
            progressed = rt.step_once()
            saw_carry = saw_carry or rt._carry_cols is not None
            if rt._carried_last:
                skipped += 1      # a cadence hit held while carrying
            if not progressed:
                break
        commits = [c["epoch"] for c in rt.commits]
        rt.close()
        for _ in range(40):
            if not jrt.step_once():
                break
        jrt.close()
    assert saw_carry
    assert rt.counters["events_valid"] == 3000
    assert jrt.metrics.counters["events_valid"] == 3000
    assert commits and skipped
    assert len(commits) < rt.counters["batches"]
    assert_native_docs_match(jstore._tiles, store._tiles, 3000)


def test_checkpoint_not_starved_by_systematic_carry(tmp_path, ingress_env):
    """Values exactly 2x the batch make carry-free epochs periodic; an odd
    checkpoint_every still commits (the cadence hit waits for the first
    carry-free step), as in JAX."""
    ingress_env.setenv("HEATMAP_EVENT_FORMAT", "columnar")
    evs = _carry_events(4096, int(time.time()) - 1200)
    with tmock.MockKafkaBroker() as tboot:
        cfg = load_config({}, checkpoint_dir=str(tmp_path / "t"),
                          **dict(AXES, batch_size=256))
        src = KafkaSource(tboot, TOPIC)
        rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                               checkpoint_every=5)
        _publish_columnar(tclient, tboot, evs, 512)
        for _ in range(40):
            if not rt.step_once():
                break
        rt._ckpt_join()
        mid_run = rt.counters["checkpoints"]
        assert mid_run > 0
        meta = rt.ckpt.load_meta()
        rt.close()
    # a committed offset never splits a value: every one is whole
    assert sum(meta["offset"].values()) * 512 <= 4096
    assert meta["epoch"] % 2 == 0
