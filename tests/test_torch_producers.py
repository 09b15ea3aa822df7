"""The port's producers (``heatmap_tpu_torch/producers``) and JSONL replay
against the JAX package's: the cases of ``tests/test_producers.py``.

- MBTA and OpenSky normalization of the same fake payloads gives equal
  events (timestamps taken from the wall clock compared by shape: both
  packages stamp the moment they run);
- ``run_poll_loop`` publishes and survives its error tiers (HTTP, network,
  anything else), as in JAX;
- ``fetch`` on an injected session builds the reference's request;
  ``import heatmap_tpu_torch.producers`` needs no ``requests``;
- each package's ``KafkaPublisher`` writes byte-identical record values
  (and keys, partitions) per format, json, binary and columnar, through
  ``publish``/``flush`` and ``publish_columns``, each into its own mock
  broker; ``publish_columns`` refuses a non-columnar publisher;
  ``make_publisher`` picks as in JAX;
- a ``JsonlPublisher`` capture replayed by both packages'
  ``JsonlReplaySource`` gives equal columns and offsets, natively and in
  Python, across a seek and a looped replay;
- the feeder switch: ``HEATMAP_FEEDER=proc``, ``HEATMAP_EVENT_FORMAT=
  binary|columnar`` build the matching source, and with no broker the
  synthetic fallback engages as in JAX.
"""

import json
import socket
import subprocess
import sys

import pytest

import heatmap_tpu.producers as jprod
from heatmap_tpu import native as jnative
from heatmap_tpu.kafka import client as jclient
from heatmap_tpu.producers.base import run_poll_loop as jax_run_poll_loop
from heatmap_tpu.stream.source import JsonlReplaySource as JaxJsonlReplay
from heatmap_tpu.testing import mock_kafka as jmock
from heatmap_tpu_torch import producers as tprod
from heatmap_tpu_torch.kafka import client as tclient
from heatmap_tpu_torch.producers.base import (JsonlPublisher, KafkaPublisher,
                                              MemoryPublisher, make_publisher,
                                              run_poll_loop)
from heatmap_tpu_torch.stream import events as tevents
from heatmap_tpu_torch.stream.source import (JsonlReplaySource, KafkaSource,
                                             SyntheticSource)
from heatmap_tpu_torch.testing import mock_kafka as tmock
from test_producers import MBTA_PAYLOAD, OPENSKY_PAYLOAD
from test_torch_formats import assert_columns_equal, events
from test_torch_stream import REPO

TOPIC = "mobility.positions.v1"


def _same_events(mine, ref):
    """Equal events; a wall-clock ts (both packages stamp when they run)
    is held to its format."""
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.keys() == b.keys()
        for k in a:
            if k == "ts" and a[k] != b[k]:
                assert a[k].endswith("Z") and len(a[k]) == len(b[k])
            else:
                assert a[k] == b[k] and type(a[k]) is type(b[k]), k


class _Session:
    """A fake requests session: records the call, returns a payload."""

    def __init__(self, payload):
        self.payload = payload
        self.calls = []

    def get(self, url, **kw):
        self.calls.append((url, kw))
        payload = self.payload

        class _Resp:
            def raise_for_status(self):
                pass

            def json(self):
                return payload

        return _Resp()


def test_mbta_normalization_matches_jax():
    mine = tprod.MbtaProducer(session=_Session(None)).to_events(MBTA_PAYLOAD)
    ref = jprod.MbtaProducer().to_events(MBTA_PAYLOAD)
    assert len(mine) == 4
    _same_events(mine, ref)
    numeric = {"data": [{"id": "y1", "attributes": {
        "latitude": 42.3, "longitude": -71.0, "label": 1711,
        "updated_at": "2026-07-29T12:00:00Z"}}]}
    _same_events(tprod.MbtaProducer().to_events(numeric),
                 jprod.MbtaProducer().to_events(numeric))
    assert len(tevents.parse_events(mine)) == 4


def test_opensky_normalization_matches_jax():
    mine = tprod.OpenSkyProducer().to_events(OPENSKY_PAYLOAD)
    ref = jprod.OpenSkyProducer().to_events(OPENSKY_PAYLOAD)
    assert len(mine) == 2
    _same_events(mine, ref)
    assert len(tevents.parse_events(mine)) == 2


@pytest.mark.parametrize("which", ["mbta", "opensky"])
def test_fetch_on_an_injected_session(which):
    if which == "mbta":
        s, js = _Session(MBTA_PAYLOAD), _Session(MBTA_PAYLOAD)
        mine = tprod.MbtaProducer("key", session=s).fetch()
        ref = jprod.MbtaProducer("key", session=js).fetch()
    else:
        s, js = _Session(OPENSKY_PAYLOAD), _Session(OPENSKY_PAYLOAD)
        box = (40.0, -75.0, 45.0, -70.0)
        mine = tprod.OpenSkyProducer(box, session=s).fetch()
        ref = jprod.OpenSkyProducer(box, session=js).fetch()
    assert s.calls == js.calls
    _same_events(mine, ref)


def test_producers_import_without_requests():
    code = ("import sys; sys.modules['requests'] = None\n"
            "import heatmap_tpu_torch.producers as p\n"
            "print(len(p.MbtaProducer().to_events({'data': []})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"


def test_poll_loop_and_publishers(tmp_path):
    prod = tprod.MbtaProducer()
    payloads = iter([MBTA_PAYLOAD, MBTA_PAYLOAD])
    mem = MemoryPublisher()
    n = run_poll_loop(lambda: prod.to_events(next(payloads)), mem,
                      period_s=0, max_polls=2)
    assert n == 8 and len(mem.queue) == 8
    jmem = jprod.MemoryPublisher()
    jpayloads = iter([MBTA_PAYLOAD, MBTA_PAYLOAD])
    assert jax_run_poll_loop(lambda: prod.to_events(next(jpayloads)), jmem,
                             period_s=0, max_polls=2) == n


def test_poll_loop_error_tiers(caplog):
    import requests

    def flaky_factory():
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                raise requests.HTTPError("429")
            if len(calls) == 2:
                raise requests.ConnectionError("down")
            if len(calls) == 3:
                raise ValueError("odd payload")
            return [{"vehicleId": "x"}]
        return flaky

    caplog.set_level("ERROR")
    mem = MemoryPublisher()
    n = run_poll_loop(flaky_factory(), mem, period_s=0, max_polls=4,
                      error_backoff_s=0)
    mine = [r.getMessage().split(":")[0] for r in caplog.records]
    caplog.clear()
    jn = jax_run_poll_loop(flaky_factory(), jprod.MemoryPublisher(),
                           period_s=0, max_polls=4, error_backoff_s=0)
    ref = [r.getMessage().split(":")[0] for r in caplog.records]
    assert n == jn == 1
    assert mine == ref == ["HTTP error from API", "network error",
                           "unexpected producer error"]


def _fetch_all(client_mod, bootstrap):
    c = client_mod.KafkaClient(bootstrap)
    out = {}
    for p in c.partitions(TOPIC):
        fr = c.fetch(TOPIC, p, 0, max_bytes=64 << 20, max_wait_ms=0)
        out[p] = [(r.key, r.value) for r in fr.records]
    c.close()
    return out


@pytest.mark.parametrize("fmt", ["json", "binary", "columnar"])
def test_kafka_publishers_write_identical_records(monkeypatch, fmt):
    for k in ("HEATMAP_EVENT_FORMAT", "HEATMAP_KAFKA_IMPL"):
        monkeypatch.delenv(k, raising=False)
    evs = [e for e in events(21, 600) if e["lat"] <= 90]
    cols = SyntheticSource(n_events=20_000, n_vehicles=300).poll(20_000)
    with tmock.MockKafkaBroker() as tboot, jmock.MockKafkaBroker() as jboot:
        mine = KafkaPublisher(tboot, TOPIC, event_format=fmt)
        ref = jprod.base.KafkaPublisher(jboot, TOPIC, impl="wire",
                                        event_format=fmt)
        for pub in (mine, ref):
            pub.publish(evs[:250])
            pub.flush()
            pub.publish(evs[250:])
            pub.flush()
        if fmt == "columnar":
            from heatmap_tpu.stream import events as jevents

            jcols = jevents.columns_from_arrays(
                cols.lat_deg, cols.lng_deg, cols.speed_kmh, cols.ts_s,
                provider_id=cols.provider_id, vehicle_id=cols.vehicle_id,
                providers=cols.providers, vehicles=cols.vehicles)
            assert mine.publish_columns(cols) == ref.publish_columns(jcols) \
                == 20_000
        else:
            with pytest.raises(ValueError):
                mine.publish_columns(cols)
        mine.close()
        ref.close()
        got, want = _fetch_all(tclient, tboot), _fetch_all(jclient, jboot)
    assert got == want
    assert sum(len(v) for v in got.values()) == (
        len(evs) if fmt != "columnar" else 2 + 2)


def test_publish_columns_roundtrip_through_the_source(monkeypatch):
    """publish_columns values come back through the port's columnar source
    as the same rows."""
    monkeypatch.setenv("HEATMAP_EVENT_FORMAT", "columnar")
    monkeypatch.delenv("HEATMAP_KAFKA_IMPL", raising=False)
    cols = SyntheticSource(n_events=40_000, n_vehicles=500).poll(40_000)
    with tmock.MockKafkaBroker() as boot:
        src = KafkaSource(boot, TOPIC)
        pub = KafkaPublisher(boot, TOPIC)
        assert pub.publish_columns(cols) == 40_000
        pub.close()
        rows = []
        for _ in range(20):
            got = src.poll(16_384)
            if len(got):
                rows += list(zip(got.lat_deg.tolist(), got.ts_s.tolist(),
                                 [got.vehicles[v] for v in got.vehicle_id]))
        src.close()
    want = list(zip(cols.lat_deg.tolist(), cols.ts_s.tolist(),
                    [cols.vehicles[v] for v in cols.vehicle_id]))
    assert sorted(rows) == sorted(want)


def _closed_port() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def test_make_publisher_picks_as_jax(tmp_path, monkeypatch):
    from heatmap_tpu.config import load_config as jax_load_config
    from heatmap_tpu_torch.config import load_config

    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("HEATMAP_KAFKA_IMPL", raising=False)
    cfg = load_config({"KAFKA_BOOTSTRAP": _closed_port()})
    jcfg = jax_load_config({"KAFKA_BOOTSTRAP": cfg.kafka_bootstrap})
    for kind in ("memory", "jsonl", "auto"):
        mine = make_publisher(cfg, kind, path=str(tmp_path / "m.jsonl"))
        ref = jprod.make_publisher(jcfg, kind, path=str(tmp_path / "j.jsonl"))
        assert type(mine).__name__ == type(ref).__name__
        mine.close()
        ref.close()
    with pytest.raises(OSError):
        make_publisher(cfg, "kafka")
    monkeypatch.setenv("HEATMAP_KAFKA_IMPL", "confluent")
    with pytest.raises(NotImplementedError):
        make_publisher(cfg, "auto")


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_jsonl_capture_replays_as_in_jax(tmp_path, monkeypatch, decoder):
    if decoder == "python":
        monkeypatch.setattr(jnative, "maybe_decoder", lambda *a, **k: None)
    path = str(tmp_path / "cap.jsonl")
    pub = JsonlPublisher(path)
    pub.publish(tprod.MbtaProducer().to_events(MBTA_PAYLOAD))
    pub.publish(events(22, 500))
    pub.flush()
    pub.close()
    with open(path, "a", encoding="utf-8") as fh:
        fh.write("\nnot json\n{\"broken\n")
    jpath = str(tmp_path / "cap_j.jsonl")
    jpub = jprod.JsonlPublisher(jpath)
    jpub.publish(tprod.MbtaProducer().to_events(MBTA_PAYLOAD))
    jpub.publish(events(22, 500))
    jpub.close()
    with open(jpath, "a", encoding="utf-8") as fh:
        fh.write("\nnot json\n{\"broken\n")
    mine_lines = open(path).read().splitlines()
    ref_lines = open(jpath).read().splitlines()
    assert len(mine_lines) == len(ref_lines)
    assert [json.loads(a) for a in mine_lines[4:-3]] == \
        [json.loads(b) for b in ref_lines[4:-3]]
    mine = JsonlReplaySource(path, decoder=decoder)
    ref = JaxJsonlReplay(path)
    assert (ref._dec is None) == (decoder == "python")
    for n in (3, 100, 1, 500, 50):
        assert_columns_equal(mine.poll(n), ref.poll(n))
        assert mine.offset() == ref.offset()
    assert mine.exhausted and ref.exhausted
    for s in (mine, ref):
        s.seek(7)
    assert_columns_equal(mine.poll(40), ref.poll(40))
    mine.close()
    ref.close()
    mine = JsonlReplaySource(path, loop=True, decoder=decoder)
    ref = JaxJsonlReplay(path, loop=True)
    for n in (400, 400, 400):
        assert_columns_equal(mine.poll(n), ref.poll(n))
        assert mine.offset() == ref.offset()
    assert not mine.exhausted
    mine.close()
    ref.close()


@pytest.fixture
def ingress_env(monkeypatch):
    for k in ("HEATMAP_EVENT_FORMAT", "HEATMAP_KAFKA_IMPL",
              "HEATMAP_FETCH_MAX_BYTES", "HEATMAP_FEEDER"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [
    {"HEATMAP_FEEDER": "proc"}, {"HEATMAP_EVENT_FORMAT": "binary"},
    {"HEATMAP_EVENT_FORMAT": "columnar"},
    {"HEATMAP_FEEDER": "proc", "HEATMAP_EVENT_FORMAT": "columnar"}],
    ids=["feeder_proc", "binary", "columnar", "feeder_proc_columnar"])
def test_pipeline_ingress_knobs_build_their_source(ingress_env, env):
    """The knobs the port raised for before now build the reference's
    source: the feeder process, or the in-process source decoding that
    format; with no broker both packages fall back to synthetic data."""
    from heatmap_tpu.models import pipelines as jpipes
    from heatmap_tpu_torch.models import pipelines as tpipes
    from heatmap_tpu_torch.stream.shmfeed import ShmFeederSource

    for k, v in env.items():
        ingress_env.setenv(k, v)
    closed = _closed_port()
    mine = tpipes._kafka_or_synthetic(tpipes.dataclasses.replace(
        tpipes.get_pipeline("mbta_default").config, kafka_bootstrap=closed))
    ref = jpipes._kafka_or_synthetic(jpipes.dataclasses.replace(
        jpipes.get_pipeline("mbta_default").config, kafka_bootstrap=closed))
    assert type(mine).__name__ == type(ref).__name__ == "SyntheticSource"
    with tmock.MockKafkaBroker() as boot:
        cfg = tpipes.dataclasses.replace(
            tpipes.get_pipeline("mbta_default").config, kafka_bootstrap=boot,
            batch_size=1024)
        src = tpipes._kafka_or_synthetic(cfg)
        try:
            if env.get("HEATMAP_FEEDER") == "proc":
                assert isinstance(src, ShmFeederSource)
                assert src.cap == 1024
                assert src.offset() == {0: 0, 1: 0, 2: 0}
            else:
                assert isinstance(src, KafkaSource)
                assert src._fmt == env["HEATMAP_EVENT_FORMAT"]
        finally:
            src.close()


def test_unknown_event_format_raises(ingress_env):
    ingress_env.setenv("HEATMAP_EVENT_FORMAT", "protobuf")
    with tmock.MockKafkaBroker() as boot:
        with pytest.raises(ValueError, match="HEATMAP_EVENT_FORMAT"):
            KafkaSource(boot, TOPIC)


def test_binary_events_through_publisher_and_source(ingress_env):
    """The port's binary publisher into its own source: every valid event
    once, rejects counted."""
    ingress_env.setenv("HEATMAP_EVENT_FORMAT", "binary")
    evs = events(23, 1200)
    with tmock.MockKafkaBroker() as boot:
        src = KafkaSource(boot, TOPIC)
        pub = KafkaPublisher(boot, TOPIC)
        pub.publish(evs)
        pub.close()
        got, dropped = 0, 0
        for _ in range(20):
            cols = src.poll(1000)
            if not isinstance(cols, list):
                got += len(cols)
                dropped += cols.n_dropped
        src.close()
    want = tevents.parse_events(evs)
    assert got == len(want) and dropped == want.n_dropped > 0
