"""The port's observability pieces against the JAX package's, on the CPU.

Both packages' modules are driven by the same call sequence, with an
injected clock where they read one, and must give equal outputs, dict for
dict:

- ``stream.metrics.Metrics``: counts, tagged drops (the closed
  ``DROP_REASONS``, an unknown reason raising in both), batch and span
  observes, freshness, event age and ring residency; ``snapshot()``,
  ``freshness_summary()`` and ``expose_text()`` equal;
- ``obs.lineage.LineageTracker``: records opened, stamped and closed
  through every stage of ``STAGES``; the tail, the newest committed
  timestamp and the event age equal, and the stages telescope to the
  mean event's age; ``json_safe`` on numpy scalars and containers;
- ``obs.tracebuf.TraceRing``: records and the JSONL export with its
  ``.1`` rotation, file for file;
- ``obs.flightrec.FlightRecorder``: one dump a recorder, a broken
  source contained, the directory's retention, ``dump_snapshot``; and
  ``HEATMAP_FLIGHTREC_ALWAYS`` on a port runtime's clean close;
- ``obs.prof.StackSampler``: frames aggregated, ``hz`` 0 disabling it,
  garbage falling back to 29 Hz, as in the reference.
"""

import json
import os
import time

import numpy as np
import pytest

from heatmap_tpu.obs import flightrec as jflightrec
from heatmap_tpu.obs import lineage as jlineage
from heatmap_tpu.obs import prof as jprof
from heatmap_tpu.obs import tracebuf as jtracebuf
from heatmap_tpu.stream import metrics as jmetrics
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs import flightrec as tflightrec
from heatmap_tpu_torch.obs import lineage as tlineage
from heatmap_tpu_torch.obs import prof as tprof
from heatmap_tpu_torch.obs import tracebuf as ttracebuf
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream import metrics as tmetrics
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import MemorySource


@pytest.fixture(autouse=True)
def _quiesce_port_stack_sampler():
    """Stop the port's process-wide stack sampler after each test, as
    tests/conftest.py stops the JAX package's: a sampler left running
    holds frame references into the later tests of the same worker (an
    exported shared-memory view then blocks a SharedMemory close)."""
    yield
    from heatmap_tpu_torch.obs import prof

    if prof._SAMPLER is not None:
        prof._SAMPLER.stop()


class FakeTime:
    """A stand-in for a module's ``time``: both clocks step by hand."""

    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def time(self):
        return self.t

    def monotonic(self):
        return self.t

    def strftime(self, fmt, *a):
        return time.strftime(fmt, time.gmtime(self.t))


def both(monkeypatch, jmod, tmod):
    """Each module with one shared fake clock."""
    clock = FakeTime()
    for mod in (jmod, tmod):
        monkeypatch.setattr(mod, "time", clock)
    return clock


# ------------------------------------------------------------ Metrics
def drive_metrics(mod, clock):
    m = mod.Metrics()
    m.count("events_valid", 1000)
    m.count("tiles_emitted", 0)
    m.count("events_late_r8m15", 3)
    for reason, n in (("invalid", 7), ("late", 5), ("late", 0),
                      ("handoff", 2), ("out_of_shard", 4)):
        m.drop(reason, n, audit=reason != "handoff")
    for i in range(20):
        clock.t += 0.25
        spans = {"poll": 0.001 * i, "build": 0.002, "pull": 0.01 * (i % 3),
                 "device": 0.03 + 0.001 * i, "sink_submit": 0.004}
        if i >= 5:
            spans["poll_wait"] = 0.0005 * i
        m.observe_batch(0.05 + 0.002 * i, spans)
        m.freshness.add(1.5 + i)
        for bound, age in (("oldest", 3.0 + i), ("mean", 2.0 + i),
                           ("newest", 1.0 + i)):
            m.event_age.labels(bound=bound).observe(age)
        m.ring_residency.observe(0.01 * i)
        m.ring_residency_batches.observe(1 + i % 8)
    m.counters["state_overflow_last_epoch"] = 12
    clock.t += 3.0
    return m


def test_metrics_equal_the_reference(monkeypatch):
    clock = both(monkeypatch, jmetrics, tmetrics)
    assert tmetrics.DROP_REASONS == jmetrics.DROP_REASONS
    assert tmetrics._DROP_LEGACY == jmetrics._DROP_LEGACY
    assert tmetrics.GAUGE_NAMES == jmetrics.GAUGE_NAMES
    t0 = clock.t
    jm = drive_metrics(jmetrics, clock)
    clock.t = t0
    tm = drive_metrics(tmetrics, clock)
    assert tm.snapshot() == jm.snapshot()
    assert tm.freshness_summary() == jm.freshness_summary()
    assert tm.counters == jm.counters
    extra = {"tiles_written": 9, "sink_backpressure_ms": 1}
    assert (tm.expose_text(extra_counters=extra, extra_lines=["# x"])
            == jm.expose_text(extra_counters=extra, extra_lines=["# x"]))
    # the drop family carries every closed reason from the start
    fam = tm.registry._families["heatmap_events_dropped_total"]
    assert {k[0] for k in fam.children} == set(tmetrics.DROP_REASONS)


@pytest.mark.parametrize("reason", ["bogus", "LATE", ""])
def test_unknown_drop_reason_raises_in_both(reason):
    for mod in (jmetrics, tmetrics):
        m = mod.Metrics()
        with pytest.raises(ValueError, match="closed set"):
            m.drop(reason, 1)
        assert not m.counters


# ------------------------------------------------------------ lineage
def drive_lineage(mod, clock, view_seq=True):
    lt = mod.LineageTracker(capacity=3, clock=clock.time, origin="p0")
    recs = []
    for i in range(5):
        clock.t += 1.0
        rec = lt.open(n_events=100 + i, ev_min_ts=1_699_999_900 + i,
                      ev_max_ts=1_699_999_990 + i,
                      ev_mean_ts=1_699_999_950.5 + i,
                      offset={"p": np.int64(7 + i), "parts": (1, 2)},
                      t_poll=clock.t - 0.25 if i == 3 else None)
        clock.t += 0.5
        lt.dispatched(rec, np.int32(i))
        clock.t += 0.125
        lt.ring_entered(rec)
        recs.append(rec)
    for i, rec in enumerate(recs):
        clock.t += 0.25
        lt.flushed(rec, ring_batches=len(recs) - i if i % 2 else None)
        clock.t += 0.0625
        lt.committed(rec)
        if view_seq:
            clock.t += 0.03125
            lt.view_applied(rec, view_seq=np.int64(40 + i))
    return lt


def test_lineage_equals_the_reference():
    assert tlineage.STAGES == jlineage.STAGES
    jc, tc = FakeTime(), FakeTime()
    jl, tl = drive_lineage(jlineage, jc), drive_lineage(tlineage, tc)
    assert tl.tail(10) == jl.tail(10) and len(tl) == len(jl) == 3
    assert tl.newest_committed_ts == jl.newest_committed_ts
    assert tl.newest_event_age_s() == jl.newest_event_age_s()
    for rec in tl.tail(10):
        # the decomposition telescopes to the mean event's visible age
        assert set(rec["stages"]) == set(tlineage.STAGES)
        assert sum(rec["stages"].values()) == pytest.approx(
            rec["age_s"]["visible"], abs=1e-6)
    json.dumps(tl.tail(10))
    obj = [np.float32(1.5), (np.int16(3), {"a": np.bool_(True)}),
           (1, "x", None), {2: np.arange(2)}]
    assert tlineage.json_safe(obj) == jlineage.json_safe(obj)


def test_lineage_without_a_view_keeps_five_stages():
    tl = drive_lineage(tlineage, FakeTime(), view_seq=False)
    jl = drive_lineage(jlineage, FakeTime(), view_seq=False)
    assert tl.tail() == jl.tail()
    assert all(set(r["stages"]) == set(tlineage.STAGES[:5])
               for r in tl.tail())


# ------------------------------------------------------------ TraceRing
def test_trace_ring_and_its_jsonl_rotation(tmp_path, monkeypatch):
    both(monkeypatch, jtracebuf, ttracebuf)
    rings = {}
    for name, mod in (("jax", jtracebuf), ("port", ttracebuf)):
        path = tmp_path / name / "trace.jsonl"
        path.parent.mkdir()
        ring = mod.TraceRing(capacity=4, env={
            "HEATMAP_TRACE_JSONL": str(path),
            "HEATMAP_TRACE_JSONL_MAX_BYTES": "700"})
        for i in range(10):
            ring.record(i, 0.01 * i, {"poll": 0.001, "device": 0.002 * i},
                        n_events=1024, n_late=i % 2, overflow_groups=0,
                        late_dropped=0, extra_key=i)
        ring.close()
        rings[name] = (ring, path)
    (jr, jp), (tr, tp) = rings["jax"], rings["port"]
    assert tr.recent(10) == jr.recent(10) and len(tr) == 4
    assert tr.recent(2) == jr.recent(2)
    files = {p.name: p.read_text() for p in tp.parent.iterdir()}
    assert files == {p.name: p.read_text() for p in jp.parent.iterdir()}
    assert "trace.jsonl.1" in files
    rolled = tp.with_name("trace.jsonl.1")
    lines = [json.loads(x) for x in rolled.read_text().splitlines()]
    assert lines and set(lines[0]) == {
        "seq", "epoch", "t_wall", "latency_ms", "spans_ms", "n_events",
        "n_late", "overflow_groups", "late_dropped", "extra_key"}


def test_trace_ring_export_failure_is_contained(tmp_path):
    ring = ttracebuf.TraceRing(jsonl_path=str(tmp_path / "no" / "x.jsonl"))
    ring.record(0, 0.1, {"poll": 0.1})
    assert len(ring) == 1 and ring._jsonl_dead


# ------------------------------------------------------------ flightrec
def test_flight_recorder_dumps_once_and_contains_a_broken_source(tmp_path):
    dumps = {}
    for name, mod in (("jax", jflightrec), ("port", tflightrec)):
        rec = mod.FlightRecorder(str(tmp_path / name))
        rec.add_source("trace_tail", lambda: [{"epoch": np.int64(3)}])
        rec.add_source("broken", lambda: 1 / 0)
        path = rec.dump("injected crash")
        assert path and rec.dumped == path
        assert rec.dump("second reason") is None
        d = json.loads(open(path).read())
        assert d.pop("pid") == os.getpid() and d.pop("t_wall") > 0
        dumps[name] = d
    assert dumps["port"] == dumps["jax"]
    assert dumps["port"]["broken"].startswith("<source failed: "
                                              "ZeroDivisionError")
    # a disarmed recorder writes nothing; a spawned one shares sources
    rec = tflightrec.FlightRecorder(str(tmp_path / "d"))
    rec.add_source("x", lambda: 1)
    child = rec.spawn()
    rec.disarm()
    assert rec.dump("late") is None
    assert json.loads(open(child.dump("ok")).read())["x"] == 1


def test_flight_recorder_keeps_the_newest_dumps(tmp_path):
    for mod in (jflightrec, tflightrec):
        d = tmp_path / mod.__name__.split(".")[0]
        for i in range(mod.FlightRecorder.RETAIN + 3):
            assert mod.dump_snapshot(str(d), f"r{i}", {"i": i})
            time.sleep(0.002)  # distinct mtimes
        files = sorted(d.glob("flightrec-*.json"), key=os.path.getmtime)
        assert len(files) == mod.FlightRecorder.RETAIN
        assert json.loads(files[-1].read_text())["i"] == \
            mod.FlightRecorder.RETAIN + 2
    assert tflightrec.from_env({}) is None
    assert tflightrec.from_env({"HEATMAP_FLIGHTREC_DIR": "x"}).dir == "x"


def _events(n, t0):
    return [{"provider": "p", "vehicleId": f"v{i % 7}",
             "lat": 42.0 + (i % 40) * 1e-3, "lon": -71.0,
             "speedKmh": 10.0, "ts": t0} for i in range(n)]


@pytest.mark.parametrize("always", ["1", ""])
def test_clean_close_dumps_only_with_always(tmp_path, monkeypatch, always):
    monkeypatch.setenv("HEATMAP_FLIGHTREC_ALWAYS", always)
    monkeypatch.setenv("HEATMAP_SLO_WATCHDOG_S", "0")
    frdir = tmp_path / "fr"
    cfg = load_config({}, checkpoint_dir=str(tmp_path / "ck"),
                      batch_size=16, state_capacity_log2=8,
                      speed_hist_bins=4, flightrec_dir=str(frdir))
    src = MemorySource(_events(48, int(time.time()) - 5))
    src.finish()
    rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                           checkpoint_every=0)
    rt.run()
    files = list(frdir.glob("flightrec-*.json"))
    if not always:
        assert not files and rt.flightrec.dump("after close") is None
        return
    (f,) = files
    d = json.loads(f.read_text())
    assert d["reason"] == "clean close (HEATMAP_FLIGHTREC_ALWAYS=1)"
    assert d["run_state"]["epoch"] == 3 and len(d["trace_tail"]) == 3
    assert d["config"]["flightrec_dir"] == str(frdir)


# ------------------------------------------------------------ StackSampler
def test_stack_sampler_aggregates_frames():
    s = tprof.StackSampler(hz=200.0)
    try:
        assert s.ensure_started() and s.ensure_started()
        deadline = time.monotonic() + 5.0
        while s.snapshot(5)["samples"] < 5:
            assert time.monotonic() < deadline, "sampler produced nothing"
            time.sleep(0.02)
        snap = s.snapshot(5)
        assert snap["running"] and snap["frames"]
        assert set(snap) == set(jprof.StackSampler(hz=1.0).snapshot(5))
        assert set(snap["frames"][0]) == {"thread", "frame", "count",
                                          "share"}
        assert s.tail(3) == s.snapshot(3)["frames"]
    finally:
        s.stop()
    assert not s.running


@pytest.mark.parametrize("raw", ["0", "-3", "nope", "", "17", "1e6"])
def test_stack_sampler_rate_knob_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv("HEATMAP_STACKPROF_HZ", raw)
    s = tprof.StackSampler()
    assert s.hz == jprof.StackSampler().hz
    if s.hz <= 0:
        assert not s.ensure_started() and not s.running
    assert tprof.get_sampler() is tprof.get_sampler()
