"""The port's Kafka ingress against the JAX package's.

- Encoding: RecordBatch v2 bytes identical for the same records, CRC32C
  goldens and values, murmur2 partitioning, tolerant decode of a poisoned
  batch.
- Client and broker, across packages: each package's client against each
  package's mock broker (produce, fetch, ListOffsets LATEST/EARLIEST,
  OFFSET_OUT_OF_RANGE, version negotiation against a 4.x table).
- Source: the port's ``KafkaSource`` and the JAX ``KafkaSource`` (wire
  impl, JSON values, its Python decoder: ``heatmap_tpu.native.
  maybe_decoder`` is patched to None for the test) poll one topic to
  identical ``EventColumns``, array for array, and identical counters and
  offsets: malformed and undecodable values, tombstones, millisecond
  timestamps, a seek with string keys, an out-of-range offset reset.
- Parsing: ``parse_events`` and ``parse_ts`` agree on a malformed corpus.
- End to end: both runtimes consume one mock-broker topic to the same docs
  (the bars of ``test_torch_pipelines.py``), and a port run killed after a
  commit resumes from the committed {partition: offset} map (string keys
  in ``meta.json``) to the uninterrupted run's docs.

Every broker binds an ephemeral port.
"""

import datetime as dt
import json
import logging
import socket

import numpy as np
import pytest

from heatmap_tpu import native as jnative
from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.kafka import client as jclient
from heatmap_tpu.kafka import records as jrecords
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import events as jevents
from heatmap_tpu.stream.source import KafkaSource as JaxKafkaSource
from heatmap_tpu.testing import mock_kafka as jmock
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.kafka import KafkaError
from heatmap_tpu_torch.kafka import client as tclient
from heatmap_tpu_torch.kafka import records as trecords
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream import events as tevents
from heatmap_tpu_torch.stream.checkpoint import CheckpointManager
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import KafkaSource, SyntheticSource
from heatmap_tpu_torch.testing import mock_kafka as tmock
from test_torch_pipelines import assert_pair_docs_match, snap_touched
from test_torch_stream import _pin_reference

TOPIC = "mobility.positions.v1"


@pytest.fixture
def python_decoder(monkeypatch):
    """The JAX wire impl on its Python path (no native decoder)."""
    monkeypatch.setattr(jnative, "maybe_decoder", lambda *a, **k: None)
    for k in ("HEATMAP_EVENT_FORMAT", "HEATMAP_KAFKA_IMPL",
              "HEATMAP_FETCH_MAX_BYTES", "HEATMAP_FEEDER"):
        monkeypatch.delenv(k, raising=False)


def produce_values(client_mod, bootstrap, topic, values, keys, batch=64):
    """Produce (key, value) pairs through ``client_mod``'s KafkaClient,
    keyed to partitions by murmur2, in batches of ``batch`` records."""
    c = client_mod.KafkaClient(bootstrap)
    n_parts = len(c.partitions(topic))
    rec = (trecords if client_mod is tclient else jrecords).Record
    by_part: dict = {}
    for i, (k, v) in enumerate(zip(keys, values)):
        p = client_mod.partition_for_key(k, n_parts) if k else i % n_parts
        by_part.setdefault(p, []).append(rec(0, 1_700_000_000_000 + i, k, v))
    for p, recs in sorted(by_part.items()):
        for j in range(0, len(recs), batch):
            c.produce(topic, p, recs[j:j + batch])
    c.close()


# --- encoding ----------------------------------------------------------------

def _records(mod, case):
    R = mod.Record
    if case == "plain":
        return [R(0, 1_700_000_000_000 + i, f"veh-{i}".encode(),
                  json.dumps({"i": i}).encode()) for i in range(5)]
    if case == "nulls_headers":
        return [R(0, 1000, None, b'{"lat": 1}', [("h", b"v"), ("e", b"")]),
                R(1, 999, b"k", None), R(2, 2**40, b"", b"")]
    rng = np.random.default_rng(7)
    return [R(0, int(rng.integers(0, 2**41)), rng.bytes(int(rng.integers(
        0, 40))), rng.bytes(int(rng.integers(0, 400)))) for _ in range(300)]


@pytest.mark.parametrize("case", ["plain", "nulls_headers", "random"])
def test_record_batch_encoding_matches_jax(case):
    mine = trecords.encode_batch(_records(trecords, case), base_offset=41)
    ref = jrecords.encode_batch(_records(jrecords, case), base_offset=41)
    assert mine == ref
    a, b = trecords.decode_batches(ref), jrecords.decode_batches(mine)
    assert [(r.offset, r.timestamp_ms, r.key, r.value, r.headers)
            for r in a] == [(r.offset, r.timestamp_ms, r.key, r.value,
                             r.headers) for r in b]


def test_crc32c_goldens_and_values_match_jax():
    assert trecords.crc32c(b"") == 0
    assert trecords.crc32c(b"123456789") == 0xE3069283
    assert trecords.crc32c(bytes(32)) == 0x8A9136AA
    rng = np.random.default_rng(3)
    for n in (1, 7, 64, 1000, 4099):
        data = rng.bytes(n)
        assert trecords.crc32c(data) == jrecords.crc32c(data)
        assert trecords.crc32c(data, 12345) == jrecords.crc32c(data, 12345)


def test_murmur2_partitioning_matches_jax():
    keys = [f"veh-{i}".encode() for i in range(2000)]
    keys += [bytes(range(n)) for n in range(12)]
    for k in keys:
        assert tclient.murmur2(k) == jclient.murmur2(k)
        for n in (1, 3, 7):
            assert (tclient.partition_for_key(k, n)
                    == jclient.partition_for_key(k, n))
    assert {tclient.partition_for_key(k, 3) for k in keys} == {0, 1, 2}


def test_tolerant_decode_of_a_poisoned_batch_matches_jax():
    R = trecords.Record
    good1 = trecords.encode_batch([R(0, 0, b"a", b"one"),
                                   R(0, 1, b"b", b"two")], base_offset=0)
    bad = bytearray(trecords.encode_batch([R(0, 2, b"c", b"POISON")],
                                          base_offset=2))
    bad[-2] ^= 0xFF  # a record payload byte: CRC mismatch
    good2 = trecords.encode_batch([R(0, 3, b"d", b"three")], base_offset=3)
    blob = bytes(good1) + bytes(bad) + good2 + good2[:-5]  # truncated tail
    recs, next_off, skipped = trecords.decode_batches_tolerant(blob, 0)
    jrecs, jnext, jskipped = jrecords.decode_batches_tolerant(blob, 0)
    assert [r.value for r in recs] == [b"one", b"two", b"three"]
    assert (next_off, skipped) == (jnext, jskipped) == (4, 1)
    assert [(r.offset, r.value) for r in recs] == \
        [(r.offset, r.value) for r in jrecs]
    with pytest.raises(ValueError, match="CRC"):
        trecords.decode_batches(blob)


# --- client and broker, across packages ----------------------------------------

@pytest.mark.parametrize("kip896", [False, True], ids=["legacy", "kip896"])
@pytest.mark.parametrize("client_pkg,broker_pkg", [
    ("port", "jax"), ("jax", "port"), ("port", "port")])
def test_client_and_broker_across_packages(client_pkg, broker_pkg, kip896):
    bmod = tmock if broker_pkg == "port" else jmock
    cmod = tclient if client_pkg == "port" else jclient
    rmod = trecords if client_pkg == "port" else jrecords
    versions = (bmod.API_VERSIONS_KIP896 if kip896
                else bmod.API_VERSIONS_LEGACY)
    with bmod.MockKafkaBroker(api_versions=versions) as bootstrap:
        c = cmod.KafkaClient(bootstrap)
        assert c.partitions("t1") == [0, 1, 2]
        assert c.produce("t1", 0, [rmod.Record(0, 1000, b"a", b"one"),
                                   rmod.Record(0, 1001, b"b", b"two")]) == 0
        assert c.produce("t1", 0, [rmod.Record(0, 1002, b"c", b"three")]) == 2
        c.produce("t1", 2, [rmod.Record(0, 1003, None, None)])
        fr = c.fetch("t1", 0, 0)
        assert fr.high_watermark == 3 and fr.next_offset == 3
        assert [r.value for r in fr.records] == [b"one", b"two", b"three"]
        assert [r.offset for r in fr.records] == [0, 1, 2]
        assert [r.value for r in c.fetch("t1", 0, 2).records] == [b"three"]
        assert [r.value for r in c.fetch("t1", 2, 0).records] == [None]
        assert c.list_offsets("t1", cmod.EARLIEST) == {0: 0, 1: 0, 2: 0}
        assert c.list_offsets("t1", cmod.LATEST) == {0: 3, 1: 0, 2: 1}
        err = KafkaError if client_pkg == "port" else cmod.KafkaError
        with pytest.raises(err, match="OFFSET_OUT_OF_RANGE"):
            c.fetch("t1", 1, 99)
        conn = next(iter(c._conns.values()))
        assert conn._use[0] == 7 and conn._use[1] == 11   # produce, fetch
        assert conn._use[2] == 3 and conn._use[3] == 7    # offsets, metadata
        if client_pkg == "port":
            hw, fr = c.fetch_values("t1", 0, 1)
            assert hw == 3 and [r.value for r in fr.records] == [b"two",
                                                                 b"three"]
        c.close()


def test_dropped_versions_fail_at_connect():
    future = ((0, 12, 15), (1, 17, 20), (2, 10, 12), (3, 13, 15), (18, 0, 5))
    with tmock.MockKafkaBroker(api_versions=future) as bootstrap:
        with pytest.raises(KafkaError, match=r"Produce v12\.\.v15"):
            tclient.KafkaClient(bootstrap)


# --- the source ----------------------------------------------------------------

def _event(i, ts):
    return {"provider": "mbta" if i % 3 else "opensky",
            "vehicleId": f"veh-{i % 11}", "lat": 42.3 + (i % 97) * 1e-3,
            "lon": -71.05 - (i % 89) * 1e-3, "speedKmh": 10.0 + i % 50,
            "bearing": 90.0, "accuracyM": 5.0, "ts": ts}


def corpus(n=400):
    """(keys, values): valid events with ISO, epoch-int and epoch-float
    timestamps, and every kind of reject the reference drops."""
    keys, values = [], []
    t0 = 1_700_000_000
    iso = lambda s: dt.datetime.fromtimestamp(s, dt.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
    for i in range(n):
        kind = i % 23
        e = _event(i, [t0 + i, iso(t0 + i), t0 + i + 0.5][i % 3])
        if kind == 5:
            v = b'{"lat": 42.1, "lon": '          # malformed JSON
        elif kind == 7:
            v = b"\xff\xfe not utf-8"             # undecodable
        elif kind == 9:
            v = None                              # tombstone
        elif kind == 11:
            v = json.dumps(dict(e, ts=(t0 + i) * 1000)).encode()  # ms
        elif kind == 13:
            v = json.dumps(dict(e, lat=95.0)).encode()
        elif kind == 15:
            v = json.dumps(dict(e, vehicleId=None)).encode()
        elif kind == 17:
            v = json.dumps({k: x for k, x in e.items() if k != "lon"}).encode()
        elif kind == 19:
            v = json.dumps(dict(e, speedKmh="fast", ts="not a time")).encode()
        elif kind == 21:
            v = b"[1, 2, 3]"
        else:
            v = json.dumps(e).encode()
        keys.append(e["vehicleId"].encode())
        values.append(v)
    return keys, values


def assert_columns_equal(a, b):
    if isinstance(a, list) or isinstance(b, list):
        assert a == b == []
        return
    for f in ("lat_rad", "lng_rad", "lat_deg", "lng_deg", "speed_kmh", "ts_s",
              "provider_id", "vehicle_id"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (a.providers, a.vehicles, a.n_dropped) == \
        (b.providers, b.vehicles, b.n_dropped)


def test_kafka_source_polls_as_the_jax_source(python_decoder):
    keys, values = corpus()
    with tmock.MockKafkaBroker() as bootstrap:
        mine = KafkaSource(bootstrap, TOPIC)          # both at LATEST
        ref = JaxKafkaSource(bootstrap, TOPIC, impl="wire")
        assert ref._impl._dec is None
        produce_values(tclient, bootstrap, TOPIC, values, keys, batch=50)
        n_polls = 0
        for max_events in [7, 64, 1, 150, 1000, 1000, 5]:
            a, b = mine.poll(max_events), ref.poll(max_events)
            assert_columns_equal(a, b)
            assert mine.offset() == ref.offset()
            n_polls += 1
        assert sum(mine.offset().values()) == len(values)
        assert mine.counters == ref.counters
        assert set(mine.take_spans()) == set(ref.take_spans()) == {
            "fetch", "decode"}
        # a committed map comes back from meta.json with string keys
        committed = json.loads(json.dumps({0: 3, 1: 0, 2: 40}))
        mine.seek(committed)
        ref.seek(committed)
        assert mine.offset() == ref.offset() == {0: 3, 1: 0, 2: 40}
        assert_columns_equal(mine.poll(200), ref.poll(200))
        assert_columns_equal(mine.poll(200), ref.poll(200))
        # an offset past the log: OFFSET_OUT_OF_RANGE resets to earliest
        far = {"1": 10**6}
        mine.seek(far)
        ref.seek(far)
        assert_columns_equal(mine.poll(30), ref.poll(30))
        assert_columns_equal(mine.poll(30), ref.poll(30))
        assert mine.offset() == ref.offset()
        assert mine.counters == ref.counters
        assert mine.counters["kafka_offset_resets"] == 1
        mine.close()
        ref.close()


# --- parsing -------------------------------------------------------------------

PARSE_TS = [None, 0, 1_700_000_000, 1.5e9, "2023-11-14T22:13:20Z",
            "2023-11-14T22:13:20+02:00", "2023-11-14T22:13:20",
            "2023-11-14 22:13:20.250Z", "yesterday", "", [1], {"a": 1},
            dt.datetime(2023, 11, 14, 22, 13, 20),
            dt.datetime(2023, 11, 14, 22, 13, 20,
                        tzinfo=dt.timezone(dt.timedelta(hours=-5)))]


def test_parse_ts_matches_jax():
    for v in PARSE_TS:
        assert tevents.parse_ts(v) == jevents.parse_ts(v), v


def test_parse_events_matches_jax():
    good = _event(1, 1_700_000_000)
    bad = [dict(good, lat="x"), dict(good, lat=None), dict(good, lat=90.5),
           dict(good, lon=-180.0001), dict(good, lat=float("nan")),
           dict(good, lon=float("inf")), dict(good, provider=None),
           dict(good, ts=2**31), dict(good, ts=-1), dict(good, ts=None),
           dict(good, ts=float("nan")), dict(good, ts="soon"),
           {k: v for k, v in good.items() if k != "lat"}, {}, [], 7, None,
           "text"]
    odd_ok = [dict(good, speedKmh=None), dict(good, speedKmh="n/a"),
              dict(good, speedKmh=float("inf")), dict(good, lat="42.5"),
              dict(good, vehicleId=12), dict(good, ts="2023-11-14T22:13:20Z"),
              dict(good, ts=1_700_000_000.9), dict(good, lat=90, lon=180)]
    events = [good] + bad + odd_ok + [_event(i, 1_700_000_000 + i)
                                       for i in range(40)]
    ti, tv, ji, jv = {}, {}, {}, {}
    a = tevents.parse_events(events, ti, tv)
    b = jevents.parse_events(events, ji, jv)
    assert_columns_equal(a, b)
    assert a.n_dropped == len(bad)
    assert len(a) == 1 + len(odd_ok) + 40
    assert (ti, tv) == (ji, jv)


# --- end to end ----------------------------------------------------------------

RES = 9
AXES = dict(city="bos", h3_res=RES, resolutions=(RES,), windows_minutes=(5,),
            tile_minutes=5, batch_size=1024, state_capacity_log2=13,
            speed_hist_bins=64)
N_VALID = 4 * 1024


def stream_events():
    """(keys, values, valid event dicts): the synthetic stream (300
    vehicles, 8 events/s: ~8.5 minutes, so nothing is late) as JSON
    events, every 50th preceded by a malformed value."""
    cols = SyntheticSource(n_events=N_VALID, n_vehicles=300,
                           events_per_second=8).poll(N_VALID)
    keys, values, events = [], [], []
    for i in range(N_VALID):
        e = {"provider": "synthetic", "vehicleId": f"veh-{cols.vehicle_id[i]}",
             "lat": float(cols.lat_deg[i]), "lon": float(cols.lng_deg[i]),
             "speedKmh": float(cols.speed_kmh[i]), "ts": int(cols.ts_s[i])}
        if i % 50 == 0:
            keys.append(e["vehicleId"].encode())
            values.append(b'{"provider": "synthetic", "lat"')
        keys.append(e["vehicleId"].encode())
        values.append(json.dumps(e).encode())
        events.append(e)
    return keys, values, events


def step_until(rt, done, max_steps=200):
    """Step until ``done()``; a bounded loop, so a source that stops
    delivering fails the test instead of hanging it."""
    for _ in range(max_steps):
        if done():
            return
        rt.step_once()
    raise AssertionError(f"not done after {max_steps} steps")


def drain(rt, n_records):
    """Step until the source has read ``n_records`` records, then close."""
    step_until(rt, lambda: sum(rt.source.offset().values()) >= n_records)
    rt.close()


def touched_of(events):
    cols = tevents.parse_events(events)
    return lambda res, win_s: snap_touched(cols.lat_rad, cols.lng_rad,
                                           cols.ts_s, res, win_s)


def test_runtimes_consume_one_topic_to_the_same_docs(tmp_path, monkeypatch,
                                                     python_decoder):
    _pin_reference(monkeypatch, {})
    keys, values, events = stream_events()
    with tmock.MockKafkaBroker() as bootstrap:
        cfg = load_config(None, checkpoint_dir=str(tmp_path / "port"),
                          kafka_bootstrap=bootstrap, **AXES)
        jcfg = jax_load_config(None, checkpoint_dir=str(tmp_path / "jax"),
                               store="memory", kafka_bootstrap=bootstrap,
                               **AXES)
        store, jstore = MemoryStore(), JaxMemoryStore()
        rt = MicroBatchRuntime(cfg, KafkaSource(bootstrap, TOPIC), store,
                               device="cpu")
        jrt = JaxRuntime(jcfg, JaxKafkaSource(bootstrap, TOPIC,
                                              impl="wire"), jstore)
        produce_values(tclient, bootstrap, TOPIC, values, keys, batch=256)
        drain(rt, len(values))
        drain(jrt, len(values))
    m, jc = rt.metrics, jrt.metrics.counters
    assert m["events_valid"] == jc["events_valid"] == N_VALID
    assert m["events_invalid"] == jc["events_invalid"] == len(values) - N_VALID
    for k in ("kafka_fetch_errors", "kafka_offset_resets",
              "kafka_discover_errors"):
        assert m[k] == 0
    assert m["p50_span_ms"]["fetch"] > 0 and m["p50_span_ms"]["decode"] > 0
    assert_pair_docs_match(jstore._tiles, store._tiles, cfg, N_VALID,
                           touched_of(events))


def test_killed_kafka_run_resumes_from_its_committed_offsets(tmp_path):
    keys, values, _ = stream_events()
    with tmock.MockKafkaBroker() as bootstrap:
        def runtime(ckpt, store):
            cfg = load_config(None, checkpoint_dir=str(ckpt),
                              kafka_bootstrap=bootstrap, **AXES)
            return MicroBatchRuntime(cfg, KafkaSource(bootstrap, TOPIC),
                                     store, device="cpu", checkpoint_every=2)

        ref_store, store = MemoryStore(), MemoryStore()
        ref = runtime(tmp_path / "ref", ref_store)
        rt = runtime(tmp_path / "a", store)
        produce_values(tclient, bootstrap, TOPIC, values, keys, batch=256)
        drain(ref, len(values))
        # a commit at epoch 2, one batch more
        step_until(rt, lambda: rt.epoch == 3)
        rt._ckpt_join()                 # the commit lands; the run "dies"
        meta = CheckpointManager(str(tmp_path / "a")).load_meta()
        assert meta["epoch"] == 2 and set(meta["offset"]) == {"0", "1", "2"}
        # a new source starts at LATEST (the log's end); the resume seeks
        # it back to the committed map
        resumed = runtime(tmp_path / "a", store)
        assert resumed.source.offset() == {
            int(p): o for p, o in meta["offset"].items()}
        assert sum(resumed.source.offset().values()) < len(values)
        drain(resumed, len(values))
    assert resumed.counters["events_valid"] + 2 * 1024 >= N_VALID
    assert sum(d["count"] for d in store._tiles.values()) == N_VALID
    no_touch = lambda res, win_s: (set(), 0.0)
    assert_pair_docs_match(ref_store._tiles, store._tiles, ref.cfg, N_VALID,
                           no_touch)


# --- pipelines on the Kafka ingress ---------------------------------------------

def _closed_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def test_kafka_or_synthetic_falls_back_as_jax_does(caplog, python_decoder):
    from heatmap_tpu.models import pipelines as jpipes
    from heatmap_tpu_torch.models import pipelines as tpipes

    bootstrap = _closed_port()
    caplog.set_level(logging.WARNING)
    mine = tpipes._kafka_or_synthetic(
        tpipes.dataclasses.replace(tpipes.get_pipeline("mbta_default").config,
                                   kafka_bootstrap=bootstrap))
    ref = jpipes._kafka_or_synthetic(
        jpipes.dataclasses.replace(jpipes.get_pipeline("mbta_default").config,
                                   kafka_bootstrap=bootstrap))
    assert type(mine).__name__ == type(ref).__name__ == "SyntheticSource"
    assert_columns_equal(mine.poll(500), ref.poll(500))
    warned = [r.getMessage() for r in caplog.records
              if "kafka unreachable" in r.getMessage()]
    assert len(warned) == 2 and all(w.endswith("; using synthetic source")
                                    for w in warned)


def test_kafka_or_synthetic_takes_the_broker(python_decoder):
    from heatmap_tpu_torch.models import pipelines as tpipes

    with tmock.MockKafkaBroker() as bootstrap:
        src = tpipes._kafka_or_synthetic(tpipes.dataclasses.replace(
            tpipes.get_pipeline("hex_pyramid").config,
            kafka_bootstrap=bootstrap))
        assert isinstance(src, KafkaSource)
        assert src.offset() == {0: 0, 1: 0, 2: 0}
        src.close()


@pytest.mark.parametrize("env", [
    {"HEATMAP_FEEDER": "proc"}, {"HEATMAP_EVENT_FORMAT": "binary"},
    {"HEATMAP_EVENT_FORMAT": "columnar"}, {"HEATMAP_KAFKA_IMPL": "confluent"},
    {"HEATMAP_KAFKA_IMPL": "kafka-python"}],
    ids=["feeder_proc", "binary", "columnar", "confluent", "kafka_python"])
def test_unported_ingress_raises_instead_of_falling_back(monkeypatch, env,
                                                        python_decoder):
    from heatmap_tpu_torch.models import pipelines as tpipes

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for bootstrap in (_closed_port(), None):
        with tmock.MockKafkaBroker() as live:
            cfg = tpipes.dataclasses.replace(
                tpipes.get_pipeline("multi_window").config,
                kafka_bootstrap=bootstrap or live)
            with pytest.raises(NotImplementedError):
                tpipes._kafka_or_synthetic(cfg)
