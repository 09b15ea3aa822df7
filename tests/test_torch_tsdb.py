"""The telemetry time machine of the port (heatmap_tpu_torch/obs/tsdb.py)
against the JAX package's (heatmap_tpu/obs/tsdb.py), on the CPU.

- the helpers (``counter_increases``, ``series_key``, ``tsdb_enabled``, the
  downsampler and the healthz transitions) on seeded inputs: equal;
- one scripted member history through both recorders, the same exposition
  texts (counters with a reset, gauges, labeled series, a histogram, a
  garbage line) and /healthz verdicts from a seed, the same injected clock,
  events recorded at the same ticks, flushes due on the clock, the hot
  window and the retention short enough that blocks merge into the
  downsampled tier and age out: the rings, the verdicts, the events and
  the self-accounting counters are equal, and the two directories hold
  the same files byte for byte;
- each package's ``TsdbReader`` reads the other's directory to the same
  members, series, verdicts and events, and ``member_timeline`` and
  ``fleet_timeline`` (with flight records beside them) are equal;
- the reference's ``tools/obs_top.py --replay`` renders the port's
  directory, identically to the JAX one's;
- the port's runtime with ``HEATMAP_TSDB`` off and on over the same events:
  the same docs, the exposition differing by the tsdb and SLO families
  only, and the member's history readable by both packages' readers,
  holding the same event counts as a JAX runtime's over those events;
- a serve-only app under ``HEATMAP_TSDB=1`` runs its own recorder tagged
  ``serve<pid>`` and leaves that member behind at close; the timeline
  routes answer with the reference's shapes.

Every comparison is exact: the recorder is host Python over the same text
and clock.  The reference's wall-clock bar on the scrape's cost
(``tests/test_tsdb.py::test_scrape_overhead_within_budget``) is not ported:
it is load-sensitive here, and the cost is measured on the card
(``chip_smoke.py``'s quality phase).
"""

import importlib.util
import json
import os
import time

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.obs import tsdb as jtsdb
from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MemorySource as JaxMemorySource
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs import tsdb as ttsdb
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import MemorySource
from test_torch_serve import call

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_BASE = 1_000_000.0
SCRAPE_S = 1.0
N_TICKS = 90
# one flush every 5 ticks, raw blocks older than 20 s merge into the
# downsampled tier, anything older than 60 s is dropped
RECORDER_KW = dict(scrape_s=SCRAPE_S, flush_s=5.0, hot_s=20.0,
                   retain_s=60.0)
HZ = ("ok", "degraded", "down")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scripted_history(seed=11, n=N_TICKS):
    """(expositions, verdicts): one member's /metrics texts and /healthz
    payloads tick by tick, from a seed: a valid-events counter that resets
    at tick 37, a gauge, a shed counter per endpoint, a retrace counter,
    an event-age histogram (cumulative buckets), a line no parser takes,
    and a verdict that flips among ok, degraded and down."""
    rng = np.random.default_rng(seed)
    les = ("0.1", "1", "10", "+Inf")
    valid = shed_a = shed_b = retr = 0.0
    buckets = [0.0] * len(les)
    texts, verdicts = [], []
    status = "ok"
    for i in range(n):
        valid = 0.0 if i == 37 else valid + float(rng.integers(0, 500))
        shed_a += float(rng.integers(0, 3) == 0)
        shed_b += float(rng.integers(0, 2))
        retr += float(i in (12, 13, 60))
        obs = np.sort(rng.exponential(2.0, int(rng.integers(0, 8))))
        for j, le in enumerate(les):
            lim = float("inf") if le == "+Inf" else float(le)
            buckets[j] += float((obs <= lim).sum())
        lines = ["# HELP heatmap_events_valid_total valid events",
                 "# TYPE heatmap_events_valid_total counter",
                 f"heatmap_events_valid_total {valid}",
                 "# TYPE heatmap_sink_queue_depth gauge",
                 f"heatmap_sink_queue_depth {float(rng.integers(0, 9))}",
                 "# TYPE heatmap_serve_shed_total counter",
                 f'heatmap_serve_shed_total{{endpoint="tiles"}} {shed_a}',
                 f'heatmap_serve_shed_total{{endpoint="latest"}} {shed_b}',
                 "# TYPE heatmap_retrace_after_warmup_total counter",
                 f"heatmap_retrace_after_warmup_total {retr}",
                 "# TYPE heatmap_event_age_seconds histogram"]
        lines += [f'heatmap_event_age_seconds_bucket{{bound="mean",'
                  f'le="{le}"}} {b}' for le, b in zip(les, buckets)]
        lines += [f'heatmap_event_age_seconds_count{{bound="mean"}} '
                  f"{buckets[-1]}", "this is not a sample", ""]
        texts.append("\n".join(lines))
        if rng.random() < 0.15:
            status = HZ[int(rng.integers(0, 3))]
        checks = {"batch_p50_ms": {"ok": status == "ok"},
                  "sink": {"ok": status != "down"},
                  "note": "not a check block"}
        verdicts.append({"status": status, "checks": checks})
    return texts, verdicts


def drive(mod, reg_cls, dir_path, texts, verdicts, tag="m0"):
    """One recorder of ``mod`` over the scripted history: a scrape a tick,
    an event at every 17th tick, flushes when due, a final flush."""
    i_now = [0]
    clk = [T_BASE]
    reg = reg_cls()
    rec = mod.TsdbRecorder(lambda: texts[i_now[0]], tag=tag,
                           dir_path=str(dir_path),
                           healthz_fn=lambda: verdicts[i_now[0]],
                           registry=reg, clock=lambda: clk[0],
                           **RECORDER_KW)
    for i in range(len(texts)):
        i_now[0] = i
        clk[0] = T_BASE + i * SCRAPE_S
        rec.scrape_once()
        if i % 17 == 5:
            rec.record_event({"kind": "slo_alert", "slo": "freshness_p50",
                              "rule": "fast", "n": i})
    clk[0] += 0.5
    rec.flush()
    return rec, reg


def ring_state(rec):
    return ({k: list(v) for k, v in rec._rings.items()}, dict(rec._parsed),
            dict(rec._types), list(rec._hz), list(rec._events))


def dir_files(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def self_accounting(reg):
    """The recorder's own counters and gauge (the scrape's seconds are
    the host's timing and differ)."""
    fams = reg._families
    return {name: {k: c.value for k, c in fams[name].children.items()}
            for name in ("heatmap_tsdb_scrapes_total", "heatmap_tsdb_series",
                         "heatmap_tsdb_blocks_written_total",
                         "heatmap_tsdb_pruned_blocks_total",
                         "heatmap_tsdb_events_total")}


@pytest.fixture(scope="module")
def histories(tmp_path_factory):
    texts, verdicts = scripted_history()
    root = tmp_path_factory.mktemp("tsdb")
    out = {}
    for pkg, mod, reg_cls in (("jax", jtsdb, JaxRegistry),
                              ("port", ttsdb, Registry)):
        d = root / pkg
        rec, reg = drive(mod, reg_cls, d, texts, verdicts)
        # a second member, degraded from its first verdict on
        bad = [dict(v, status="degraded") for v in verdicts[:30]]
        drive(mod, reg_cls, d, texts[:30], bad, tag="m1")
        fr = d / "fr"
        fr.mkdir()
        for j, t in enumerate((T_BASE + 40.5, T_BASE + 88.0)):
            (fr / f"flightrec-2026010{j}-000000-1-{j}.json").write_text(
                json.dumps({"t_wall": t, "reason": f"slo-burn:x:{j}",
                            "episode_id": None}))
        (fr / "flightrec-broken.json").write_text("{")
        out[pkg] = (rec, reg, d)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    pts = [(float(t), float(v)) for t, v in enumerate(
        rng.integers(0, 20, 40) * (rng.random(40) < 0.8))]
    assert ttsdb.counter_increases(pts) == jtsdb.counter_increases(pts)
    labels = {f"k{int(x)}": str(int(y))
              for x, y in rng.integers(0, 9, (4, 2))}
    assert (ttsdb.series_key("heatmap_x", labels)
            == jtsdb.series_key("heatmap_x", labels))
    assert ttsdb.series_key("x", None) == jtsdb.series_key("x", None)
    raw = sorted([float(t), float(v)] for t, v in rng.random((50, 2)) * 100)
    assert ttsdb._downsample(raw, 7.0) == jtsdb._downsample(raw, 7.0)
    hz = [[float(t), int(s), []] for t, s in
          enumerate(rng.integers(0, 3, 30))]
    assert ttsdb._hz_transitions(hz) == jtsdb._hz_transitions(hz)
    for v in ("", "0", "false", "1", "true", "yes"):
        env = {"HEATMAP_TSDB": v}
        assert ttsdb.tsdb_enabled(env) == jtsdb.tsdb_enabled(env)
    assert ttsdb.EVENT_COUNTERS == jtsdb.EVENT_COUNTERS


def test_recorders_hold_equal_rings(histories):
    (jrec, jreg, _), (rec, reg, _) = histories["jax"], histories["port"]
    assert ring_state(rec) == ring_state(jrec)
    assert self_accounting(reg) == self_accounting(jreg)
    assert len(rec._rings) == 10 and len(rec._hz) == N_TICKS
    assert rec.match("heatmap_serve_shed_total", {"endpoint": "tiles"}) \
        == jrec.match("heatmap_serve_shed_total", {"endpoint": "tiles"})
    key = 'heatmap_serve_shed_total{endpoint="latest"}'
    assert rec.window(key, T_BASE + 50) == jrec.window(key, T_BASE + 50)
    assert rec.latest(key) == jrec.latest(key)


def test_block_files_equal_byte_for_byte(histories):
    mine = dir_files(histories["port"][2])
    ref = dir_files(histories["jax"][2])
    assert mine == ref
    names = sorted(os.path.basename(k) for k in mine)
    # the hot window and the retention took effect: raw blocks merged into
    # the downsampled tier, and tier-1 blocks past retention are gone
    assert any(n.startswith("tier1-") for n in names)
    assert any(n.startswith("block-") for n in names)
    assert histories["port"][0]._m_pruned.value > 0


@pytest.mark.parametrize("reader_pkg", ["port", "jax"])
def test_each_reader_reads_the_others_blocks(histories, reader_pkg):
    mod, other = ((ttsdb, "jax") if reader_pkg == "port"
                  else (jtsdb, "port"))
    mine = mod.TsdbReader(str(histories[other][2]))
    same = (jtsdb if reader_pkg == "port" else ttsdb).TsdbReader(
        str(histories[reader_pkg][2]))
    assert mine.members() == same.members() == ["m0", "m1"]
    for tag in ("m0", "m1"):
        assert mine.meta(tag) == same.meta(tag)
        assert mine.blocks(tag) == same.blocks(tag)
        for since in (None, T_BASE + 45.0):
            assert mine.series(tag, since=since) \
                == same.series(tag, since=since)
            assert mine.healthz(tag, since=since) \
                == same.healthz(tag, since=since)
            assert mine.events(tag, since=since) \
                == same.events(tag, since=since)
        assert mine.series(tag, names=["heatmap_events_valid_total"],
                           until=T_BASE + 70) \
            == same.series(tag, names=["heatmap_events_valid_total"],
                           until=T_BASE + 70)


@pytest.mark.parametrize("since", [None, T_BASE + 30.0])
def test_timelines_equal(histories, since):
    d, jd = histories["port"][2], histories["jax"][2]
    mine = ttsdb.member_timeline(ttsdb.TsdbReader(str(d)), "m0",
                                 since=since, flightrec_dir=str(d / "fr"))
    ref = jtsdb.member_timeline(jtsdb.TsdbReader(str(jd)), "m0",
                                since=since, flightrec_dir=str(jd / "fr"))
    assert mine == ref
    kinds = {e["kind"] for e in mine}
    assert {"healthz", "shed", "retrace", "slo_alert",
            "flight_record"} <= kinds, kinds
    fmine = ttsdb.fleet_timeline(ttsdb.TsdbReader(str(d)), since=since,
                                 flightrec_dir=str(d / "fr"))
    fref = jtsdb.fleet_timeline(jtsdb.TsdbReader(str(jd)), since=since,
                                flightrec_dir=str(jd / "fr"))
    assert fmine == fref
    assert fmine["members"] == ["m0", "m1"]


def test_obs_top_replays_the_port_history(histories, capsys):
    """The reference's obs_top renders the port's retained blocks, as it
    renders its own (tests/test_tsdb.py's replay scheme)."""
    top = _load_tool("obs_top")
    d, jd = str(histories["port"][2]), str(histories["jax"][2])
    for mod in (jtsdb, ttsdb):
        out = top.render_history(mod, d, "m0", 60.0)
        assert out == top.render_history(jtsdb, jd, "m0", 60.0)
        assert "member m0" in out
    assert top.main(["--replay", "--since", "60", "--frames", "3",
                     "--no-clear", "--tsdb-dir", d, "--member", "m0"]) == 0
    got = capsys.readouterr().out
    assert got.count("---\n") == 2 and "member m0" in got
    assert top.main(["--replay", "--since", "60", "--frames", "3",
                     "--no-clear", "--tsdb-dir", jd, "--member", "m0"]) == 0
    assert capsys.readouterr().out == got


# --- the runtime and the serve app -------------------------------------------

def tiny_events(n=64):
    t0 = int(time.time()) - 5
    return [{"provider": "p", "vehicleId": f"v{i % 16}",
             "lat": 42.0 + i * 1e-4, "lon": -71.0, "speedKmh": 1.0,
             "ts": t0 + i // 16} for i in range(n)]


AXES = dict(batch_size=16, state_capacity_log2=8, speed_hist_bins=4,
            serve_port=0)


def run_port(tmp_path, name, env, events):
    cfg = load_config(env, checkpoint_dir=str(tmp_path / f"ck-{name}"),
                      **AXES)
    src = MemorySource(events)
    src.finish()
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, src, store, device="cpu",
                           checkpoint_every=0)
    rt.run()
    return rt, store


def headers(text):
    return {ln for ln in text.splitlines()
            if ln.startswith(("# HELP", "# TYPE"))}


@pytest.fixture
def no_fleet_env(monkeypatch):
    for k in ("HEATMAP_TSDB", "HEATMAP_TSDB_DIR", "HEATMAP_FLEET_TAG",
              "HEATMAP_SUPERVISOR_CHANNEL", "HEATMAP_FLIGHTREC_DIR"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")


def test_runtime_knob_off_is_byte_identical(tmp_path, no_fleet_env):
    """HEATMAP_TSDB=0: no recorder, no tsdb or SLO family, nothing on
    disk; knob on: the same docs, the exposition differing by exactly the
    tsdb and SLO families, and the closed run's member readable by both
    packages' readers."""
    events = tiny_events()
    rt_off, store_off = run_port(tmp_path, "off", {"HEATMAP_TSDB": "0"},
                                 events)
    rt_none, store_none = run_port(tmp_path, "none", {}, events)
    d = tmp_path / "tsdb"
    rt_on, store_on = run_port(tmp_path, "on", {
        "HEATMAP_TSDB": "1", "HEATMAP_TSDB_DIR": str(d),
        "HEATMAP_TSDB_SCRAPE_S": "600"}, events)
    assert rt_off.tsdb is None and rt_off.slo_engine is None
    text_off = rt_off.telemetry.expose_text()
    assert "heatmap_tsdb_" not in text_off and "heatmap_slo_" not in text_off
    assert headers(text_off) == headers(rt_none.telemetry.expose_text())
    assert store_off._tiles == store_none._tiles == store_on._tiles
    assert store_off._positions == store_on._positions
    assert rt_on.tsdb is not None and rt_on.slo_engine is not None
    text_on = rt_on.telemetry.expose_text()
    extra = headers(text_on) - headers(text_off)
    assert extra and all(" heatmap_tsdb_" in ln or " heatmap_slo_" in ln
                         for ln in extra)
    assert not headers(text_off) - headers(text_on)
    for mod in (ttsdb, jtsdb):
        reader = mod.TsdbReader(str(d))
        assert reader.members() == ["p0"]
        assert reader.series("p0")["heatmap_events_valid_total"][-1][1] \
            == len(events)
    # the SLO engine's state beside the blocks
    st = json.loads((d / "p0" / "slo-state.json").read_text())
    assert st["tag"] == "p0" and "freshness_p50" in st["specs"]


def test_runtime_history_matches_a_jax_runtimes(tmp_path, no_fleet_env,
                                                monkeypatch):
    """Both runtimes over the same events with HEATMAP_TSDB=1 leave one
    member each whose recorded event counters are equal."""
    events = tiny_events(96)
    env = {"HEATMAP_TSDB": "1", "HEATMAP_TSDB_SCRAPE_S": "600"}
    rt, _ = run_port(tmp_path, "port", dict(
        env, HEATMAP_TSDB_DIR=str(tmp_path / "port")), events)
    cfg = jax_load_config(dict(env, HEATMAP_TSDB_DIR=str(tmp_path / "jax")),
                          store="memory",
                          checkpoint_dir=str(tmp_path / "ck-jax"), **AXES)
    src = JaxMemorySource(events)
    src.finish()
    jrt = JaxRuntime(cfg, src, JaxMemoryStore(), checkpoint_every=0)
    jrt.run()
    names = ["heatmap_events_valid_total", "heatmap_events_dropped_total",
             "heatmap_batches_total"]
    mine = ttsdb.TsdbReader(str(tmp_path / "port")).series("p0", names)
    ref = jtsdb.TsdbReader(str(tmp_path / "jax")).series("p0", names)
    assert mine.keys() == ref.keys() and mine
    assert ({k: [v for _t, v in pts] for k, pts in mine.items()}
            == {k: [v for _t, v in pts] for k, pts in ref.items()})


def test_serve_only_app_leaves_a_member_behind(tmp_path, no_fleet_env):
    """A serve-only app under HEATMAP_TSDB=1 runs its own recorder and SLO
    engine, tagged serve<pid>; its close takes a last scrape and flushes,
    and the member is there for both packages' readers and for the
    timeline routes, which answer with the reference's keys."""
    d = tmp_path / "tsdb"
    env = {"HEATMAP_TSDB": "1", "HEATMAP_TSDB_DIR": str(d),
           "HEATMAP_TSDB_SCRAPE_S": "600"}
    cfg = load_config(env, checkpoint_dir=str(tmp_path / "ck"))
    app = tapi.make_wsgi_app(MemoryStore(), cfg)
    tag = f"serve{os.getpid()}"
    try:
        assert app.tsdb.tag == tag and app.slo_engine is not None
        s, _, b = call(app, "/api/tiles/latest")
        assert s.startswith("200")
        app.tsdb.scrape_once()
    finally:
        app.close()
    for mod in (ttsdb, jtsdb):
        reader = mod.TsdbReader(str(d))
        assert reader.members() == [tag]
        assert reader.series(tag, names=["heatmap_tsdb_scrapes_total"])
        assert len(reader.healthz(tag)) == 2
    s, _, b = call(app, "/debug/timeline")
    assert s.startswith("200")
    body = json.loads(b)
    assert body["member"] == tag and body["since_s"] == 3600
    s, _, b = call(app, "/fleet/timeline", "since=60")
    fleet = json.loads(b)
    assert fleet["members"] == [tag] and fleet["since_s"] == 60
    # the reference's serve-only app over the same directory answers with
    # the same keys (its own recorder joins as a second member)
    jcfg = jax_load_config(env, store="memory",
                           checkpoint_dir=str(tmp_path / "jck"))
    japp = japi.make_wsgi_app(JaxMemoryStore(), jcfg)
    try:
        js, _, jb = call(japp, "/fleet/timeline", "since=60")
        assert js.startswith("200")
        assert json.loads(jb).keys() == fleet.keys()
        js, _, jb = call(japp, "/debug/timeline")
        assert json.loads(jb).keys() == body.keys()
    finally:
        japp.close_repl()


def test_timeline_routes_answer_503_without_a_directory(tmp_path,
                                                        no_fleet_env):
    """HEATMAP_TSDB=1 without HEATMAP_TSDB_DIR: rings and the SLO engine
    run, nothing persists, and both timeline routes answer the
    reference's 503."""
    env = {"HEATMAP_TSDB": "1", "HEATMAP_TSDB_SCRAPE_S": "600"}
    app = tapi.make_wsgi_app(MemoryStore(),
                             load_config(env, checkpoint_dir=str(tmp_path)))
    japp = japi.make_wsgi_app(
        JaxMemoryStore(), jax_load_config(env, store="memory",
                                          checkpoint_dir=str(tmp_path)))
    try:
        assert app.tsdb is not None and app.tsdb.dir is None
        for path in ("/debug/timeline", "/fleet/timeline"):
            (s, _, b), (js, _, jb) = call(app, path), call(japp, path)
            assert s.startswith("503") and js.startswith("503")
            assert b == jb
    finally:
        app.close()
        japp.close_repl()
