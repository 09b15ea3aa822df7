"""The slice as a whole: each package's runtime over the same events, and
their introspection compared, on the CPU.

A tiny JAX runtime and a tiny port runtime fold the same ``MemorySource``
events (four batches of 1,024, with invalid rows and rows that arrive
after the watermark passed them), with ``HEATMAP_TRACE_JSONL`` and
``HEATMAP_FLIGHTREC_DIR`` set and ``HEATMAP_FLIGHTREC_ALWAYS=1``; a
second pair runs with ``HEATMAP_REDUCERS=count,kalman``.  With both
packages' serve apps attached:

- every family both registries expose has the same type and label names;
  every family only the reference exposes is on ``REFERENCE_ONLY``, which
  names its ROADMAP item; the port exposes none of its own;
- ``/metrics.json`` has the same key set, and the counters both keep are
  equal, ``heatmap_events_dropped_total{reason}`` among them;
- one trace record a batch in the ring and in the JSONL, with the same
  keys, and the same set of ``spans_ms`` keys;
- the lineage records have the same keys and stages, and the same
  ``n_events`` batch by batch;
- the flight record written at close has the same top-level keys;
- ``/trace/recent``, ``/debug/freshness``, ``/debug/profile`` and
  ``/debug/stacks`` answer as the reference's: the statuses, the keys,
  405 on the wrong method, 409 while a window is armed, 400 for a
  ``fields=`` or a ``dir=`` out of bounds;
- ``tools/obs_top.py --once`` renders the port's app, its compile and
  memory rows among the lines.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MemorySource as JaxMemorySource
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.serve import start_background, stop_background
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import MemorySource
from test_torch_serve import call
from test_torch_stream import _pin_reference


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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 1024
AXES = dict(city="bos", h3_res=8, resolutions=(8,), windows_minutes=(5,),
            tile_minutes=5, batch_size=BATCH, state_capacity_log2=12,
            speed_hist_bins=16, emit_flush_k=2)

# families only the reference registers at these settings, each with the
# ROADMAP item that brings it to the port
# every family the reference registers the port registers too (the
# fast-path pin since the governor's slice, A7b; it has no child in the
# one-device port)
REFERENCE_ONLY: dict = {}


def make_events(seed=7):
    """Four batches of events in the reference schema: 100 vehicles over
    ten minutes ending 20 minutes ago, then a batch of rows two hours old
    (late), with invalid rows spread through."""
    rng = np.random.default_rng(seed)
    now = int(time.time())
    n = 4 * BATCH
    ts = now - 1800 + np.sort(rng.integers(0, 600, n))
    ts[3 * BATCH:3 * BATCH + 300] = now - 7200
    lat = rng.uniform(42.30, 42.40, n)
    lon = rng.uniform(-71.12, -71.02, n)
    evs = [{"provider": "mbta", "vehicleId": f"v{i % 100}",
            "lat": float(lat[i]), "lon": float(lon[i]),
            "speedKmh": float(rng.uniform(0, 80)), "ts": int(ts[i])}
           for i in range(n)]
    for i in range(5, n, 97):
        evs[i] = dict(evs[i], lat=95.0)             # out of range
    for i in range(11, n, 211):
        evs[i] = {k: v for k, v in evs[i].items() if k != "vehicleId"}
    return evs


def _run_both(tmp, reducers, env=None):
    mp = pytest.MonkeyPatch()
    _pin_reference(mp, {})
    mp.setenv("HEATMAP_H3_IMPL", "native")
    mp.setenv("HEATMAP_FLIGHTREC_ALWAYS", "1")
    mp.setenv("HEATMAP_SLO_WATCHDOG_S", "0")
    out = {}
    events = make_events()
    try:
        for pkg in ("jax", "port"):
            d = tmp / pkg
            for k, v in (env or {}).items():
                mp.setenv(k, v.format(dir=d))
            mp.setenv("HEATMAP_TRACE_JSONL", str(d / "trace.jsonl"))
            kw = dict(AXES, checkpoint_dir=str(d / "ck"),
                      flightrec_dir=str(d / "fr"), reducers=reducers)
            if pkg == "jax":
                cfg = jax_load_config(None, store="memory", **kw)
                src, store = JaxMemorySource(events), JaxMemoryStore()
                src.finish()
                rt = JaxRuntime(cfg, src, store, checkpoint_every=0)
                app = japi.make_wsgi_app(store, cfg, rt)
            else:
                cfg = load_config(None, **kw)
                src, store = MemorySource(events), MemoryStore()
                src.finish()
                rt = MicroBatchRuntime(cfg, src, store, device="cpu",
                                       checkpoint_every=0)
                app = tapi.make_wsgi_app(store, cfg, rt)
            rt.run()
            out[pkg] = (rt, app, store, cfg, d)
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = _run_both(tmp_path_factory.mktemp("count"), ("count",))
    yield out
    out["jax"][1].close_repl()
    out["port"][1].close()


@pytest.fixture(scope="module")
def kalman_runs(tmp_path_factory):
    out = _run_both(tmp_path_factory.mktemp("kalman"), ("count", "kalman"))
    yield out
    out["jax"][1].close_repl()
    out["port"][1].close()


# the telemetry time machine and the quality observatory on (ROADMAP A6b,
# A5); a scrape period longer than the run, so the recorders scrape only
# at close
KNOBS_ON = {"HEATMAP_TSDB": "1", "HEATMAP_TSDB_DIR": "{dir}/tsdb",
            "HEATMAP_TSDB_SCRAPE_S": "600", "HEATMAP_QUALITY": "1"}


@pytest.fixture(scope="module")
def observed_runs(tmp_path_factory):
    out = _run_both(tmp_path_factory.mktemp("observed"),
                    ("count", "kalman"), KNOBS_ON)
    yield out
    out["jax"][1].close_repl()
    out["port"][1].close()


def registries(r):
    return r["jax"][0].metrics.registry, r["port"][0].registry


def assert_families_match(r):
    jreg, reg = registries(r)
    jf, tf = jreg._families, reg._families
    for name in sorted(jf.keys() & tf.keys()):
        assert ((tf[name].type, tf[name].labelnames)
                == (jf[name].type, jf[name].labelnames)), name
    assert not tf.keys() - jf.keys(), sorted(tf.keys() - jf.keys())
    assert jf.keys() - tf.keys() == REFERENCE_ONLY.keys()
    assert len(jf.keys() & tf.keys()) >= 50


def test_registry_families_match(runs):
    assert_families_match(runs)


def test_kalman_run_registry_and_counters_match(kalman_runs):
    assert_families_match(kalman_runs)
    jrt, trt = kalman_runs["jax"][0], kalman_runs["port"][0]
    for k in ("infer_events_folded", "infer_entities_untracked",
              "infer_handoff_reseed"):
        assert trt.telemetry.counters.get(k) == jrt.metrics.counters.get(k)
    assert trt.telemetry.counters["infer_events_folded"] > 0
    jreg, reg = registries(kalman_runs)
    for name in ("heatmap_infer_entity_events_total",
                 "heatmap_infer_anomalies_total"):
        got = {k: c.value for k, c in reg._families[name].children.items()}
        want = {k: c.value for k, c in jreg._families[name].children.items()}
        assert got == want, name
    assert (reg._families["heatmap_infer_fold_seconds"].count
            == jreg._families["heatmap_infer_fold_seconds"].count == 4)


def test_knobs_on_registry_families_match(observed_runs):
    """With HEATMAP_TSDB=1, HEATMAP_QUALITY=1 and kalman on, the families
    both registries expose (the tsdb, SLO and quality families among
    them) have the same types and labels, and the port exposes none of
    its own."""
    assert_families_match(observed_runs)
    jreg, reg = registries(observed_runs)
    added = {n for n in reg._families
             if n.startswith(("heatmap_tsdb_", "heatmap_slo_",
                              "heatmap_quality_"))}
    assert added == {n for n in jreg._families
                     if n.startswith(("heatmap_tsdb_", "heatmap_slo_",
                                      "heatmap_quality_"))}
    assert len(added) == 18, sorted(added)
    for pkg in ("jax", "port"):
        rt = observed_runs[pkg][0]
        assert rt.tsdb is not None and rt.quality is not None
        assert rt.tsdb.tag == "p0"


def _mjson(r, pkg):
    return json.loads(call(r[pkg][1], "/metrics.json")[2])


@pytest.mark.parametrize("which", ["count", "kalman"])
def test_metrics_json_key_sets_and_counters_match(runs, kalman_runs, which):
    r = runs if which == "count" else kalman_runs
    m, jm = _mjson(r, "port"), _mjson(r, "jax")
    assert m.keys() == jm.keys()
    for k in ("events_valid", "events_invalid", "events_late",
              "tiles_emitted", "positions_emitted", "emit_pulls",
              "emit_pull_batches", "tiles_written", "positions_written",
              "policy_snap_impl", "policy_emit_pull", "policy_merge_banked"):
        assert m.get(k) == jm.get(k), k
    assert m["events_invalid"] > 0 and m["events_late"] > 0


def test_dropped_by_reason_equal(runs):
    jreg, reg = registries(runs)
    name = "heatmap_events_dropped_total"
    got = {k: c.value for k, c in reg._families[name].children.items()}
    want = {k: c.value for k, c in jreg._families[name].children.items()}
    assert got == want
    assert got[("invalid",)] > 0 and got[("late",)] > 0


def _jsonl(d):
    return [json.loads(x) for x in (d / "trace.jsonl").read_text()
            .splitlines()]


def test_one_trace_record_a_batch_with_the_reference_keys(runs):
    (jrt, japp, _, _, jd), (rt, app, _, _, d) = runs["jax"], runs["port"]
    recs, jrecs = rt.tracering.recent(100), jrt.tracering.recent(100)
    assert len(recs) == len(jrecs) == 4
    assert [r["n_events"] for r in recs] == [r["n_events"] for r in jrecs]
    assert {frozenset(r) for r in recs} == {frozenset(r) for r in jrecs}
    spans = set().union(*(r["spans_ms"] for r in recs))
    assert spans == set().union(*(r["spans_ms"] for r in jrecs))
    assert sum(r["n_late"] for r in recs) == sum(r["n_late"] for r in jrecs)
    lines = _jsonl(d)
    assert [x["seq"] for x in lines] == [1, 2, 3, 4]
    assert lines == recs[::-1]
    assert {frozenset(x) for x in lines} == \
        {frozenset(x) for x in _jsonl(jd)}


def test_lineage_records_match(runs):
    jl, tl = runs["jax"][0].lineage.tail(50), runs["port"][0].lineage.tail(50)
    assert [r["n_events"] for r in tl] == [r["n_events"] for r in jl]
    assert len(tl) == 4
    assert [set(r) for r in tl] == [set(r) for r in jl]
    assert [set(r["stages"]) for r in tl] == [set(r["stages"]) for r in jl]
    assert [set(r["age_s"]) for r in tl] == [set(r["age_s"]) for r in jl]
    assert [(r["ev_min_ts"], r["ev_max_ts"]) for r in tl] == \
        [(r["ev_min_ts"], r["ev_max_ts"]) for r in jl]
    for r in tl:
        assert sum(r["stages"].values()) == pytest.approx(
            r["age_s"]["visible"], abs=1e-3)


def test_flight_records_have_the_same_keys(runs):
    keys = {}
    for pkg in ("jax", "port"):
        (f,) = (runs[pkg][4] / "fr").glob("flightrec-*.json")
        d = json.loads(f.read_text())
        assert d["reason"] == "clean close (HEATMAP_FLIGHTREC_ALWAYS=1)"
        keys[pkg] = set(d)
        keys[pkg + "_n"] = (len(d["trace_tail"]), len(d["lineage_tail"]))
        keys[pkg + "_ri"] = set(d["runtimeinfo"])
        keys[pkg + "_rs"] = set(d["run_state"])
    assert keys["port"] == keys["jax"]
    # dumped before the close's drain: every batch has its trace record,
    # while the lineage records of the batches still parked or queued to
    # the writer thread have not closed yet (how many did is the writer's
    # timing)
    for pkg in ("port", "jax"):
        n_trace, n_lineage = keys[pkg + "_n"]
        assert n_trace == 4 and n_lineage <= 4, (pkg, keys[pkg + "_n"])
    assert keys["port_ri"] == keys["jax_ri"]
    assert keys["port_rs"] == keys["jax_rs"]


def both_apps(runs, path, qs="", method="GET"):
    (s, _, b), (js, _, jb) = (call(runs[p][1], path, qs, method=method)
                              for p in ("port", "jax"))
    assert s.split()[0] == js.split()[0], (path, qs, s, js, b, jb)
    return b, jb


def test_introspection_routes_answer_as_the_reference(runs, tmp_path,
                                                      monkeypatch):
    b, jb = both_apps(runs, "/trace/recent", "n=2")
    t, jt = json.loads(b)["traces"], json.loads(jb)["traces"]
    assert len(t) == len(jt) == 2 and [set(x) for x in t] == \
        [set(x) for x in jt]
    b, jb = both_apps(runs, "/trace/recent", "fields=epoch,n_events,nope")
    assert json.loads(b) == json.loads(jb)
    for bad in ("fields=", "fields=a;b", "fields=" + ",".join("x" * 17)):
        both_apps(runs, "/trace/recent", bad)    # 400 in both
    b, jb = both_apps(runs, "/debug/freshness", "n=3")
    f, jf = json.loads(b), json.loads(jb)
    assert f.keys() == jf.keys() and f["stage_order"] == jf["stage_order"]
    assert f["summary"].keys() == jf["summary"].keys()
    assert len(f["records"]) == len(jf["records"]) == 3
    b, jb = both_apps(runs, "/debug/stacks", "n=5")
    assert json.loads(b).keys() == json.loads(jb).keys()
    both_apps(runs, "/debug/stacks", method="POST")       # 405
    # the profiler window: POST only, one window at a time, dir= kept
    # under HEATMAP_PROFILE_DIR
    monkeypatch.setenv("HEATMAP_PROFILE_DIR", str(tmp_path))
    b, jb = both_apps(runs, "/debug/profile")             # 405
    assert json.loads(b) == json.loads(jb)
    both_apps(runs, "/debug/profile", "dir=/etc", method="POST")   # 400
    b, jb = both_apps(runs, "/debug/profile", "batches=2&skip=1&dir="
                      + str(tmp_path / "w"), method="POST")
    p, jp = json.loads(b), json.loads(jb)
    assert p == dict(jp, from_epoch=p["from_epoch"])
    assert p["from_epoch"] == runs["port"][0].epoch + 1
    both_apps(runs, "/debug/profile", "batches=1", method="POST")  # 409
    leftovers = [x for x in os.listdir(os.path.dirname(str(tmp_path)))
                 if x.startswith("heatmap-profile-")]
    assert not leftovers
    for pkg in ("port", "jax"):
        runs[pkg][0].tracer.stop()   # cancel the pending windows


def test_obs_top_renders_the_port_app(runs):
    rt, _, store, cfg, _ = runs["port"]
    httpd, thread, port = start_background(store, cfg, rt, port=0)
    try:
        p = subprocess.run(
            [sys.executable, os.path.join(REPO, "tools", "obs_top.py"),
             "--once", "--url", f"http://127.0.0.1:{port}"],
            capture_output=True, text=True, timeout=60)
    finally:
        stop_background(httpd, thread)
    assert p.returncode == 0, p.stderr
    rows = {line.split()[0]: line for line in p.stdout.splitlines()[2:]
            if line.strip()}
    assert "total 0" in rows["compile"], rows["compile"]
    assert "watermark" in rows["memory"] and " MB" in rows["memory"]
    assert "--" not in rows["memory"].split("ring slab")[0]
