"""The fleet's observation plane of the port (heatmap_tpu_torch/obs/xproc.py
and obs/fleet.py, the member snapshots of the runtime and the serve
workers, the fleet-mode SLO watchdog) against the JAX package's, on the
CPU.

The channel's files are one format: members of either package share one
channel directory.  Every comparison is exact (host Python over the same
files and one injected clock).

- member snapshots written by either package are read by the other's
  ``members_from`` the same way, torn, in-flight, stale, clock-skewed and
  departed members included;
- over one channel directory written by both packages, with seeded audit,
  delivery, quality, lineage and freshness blocks, the port's
  ``FleetAggregator`` gives the same ``metrics_text``, ``healthz``,
  ``freshness``, ``delivery``, ``audit`` and ``quality`` as the JAX
  package's, and a vanished member degrades both;
- episodes are claimed exclusively, joined, followed and cleared as in
  the JAX package, across packages on one channel;
- a serve-only app's ``ServeFleetMember`` publishes ``role="serve"`` and
  follows a JAX member's episode; ``python -m heatmap_tpu_torch.serve
  --workers 2`` publishes one member a worker, tagged ``serve<pid>``, and
  departs cleanly at SIGTERM;
- the reference's ``tools/obs_top.py`` renders a fleet frame from a port
  runtime's and a port serve worker's channel.
"""

import datetime as dt
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np

from heatmap_tpu.obs import audit as jaudit
from heatmap_tpu.obs import fleet as jfleet
from heatmap_tpu.obs import xproc as jxproc
from heatmap_tpu.obs.flightrec import FlightRecorder as JaxFlightRecorder
from heatmap_tpu.obs.runtimeinfo import SloWatchdog as JaxSloWatchdog
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs import audit as taudit
from heatmap_tpu_torch.obs import delivery as tdelivery
from heatmap_tpu_torch.obs import fleet as tfleet
from heatmap_tpu_torch.obs import xproc as txproc
from heatmap_tpu_torch.obs.flightrec import FlightRecorder
from heatmap_tpu_torch.obs.runtimeinfo import SloWatchdog
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.sink.base import UTC
from heatmap_tpu_torch.sink.memory import MemoryStore
from test_torch_audit import seeded_docs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_FIXED = 2_000_000_000.0

RUNTIME_TEXT = """\
# TYPE heatmap_events_valid_total counter
heatmap_events_valid_total {n}
# TYPE heatmap_events_per_sec gauge
heatmap_events_per_sec {rate}
# TYPE heatmap_watermark_age_seconds gauge
heatmap_watermark_age_seconds {wm}
# TYPE heatmap_repl_seq_lag gauge
heatmap_repl_seq_lag {lag}
# TYPE heatmap_event_age_seconds histogram
heatmap_event_age_seconds_bucket{{bound="mean",le="1"}} {b1}
heatmap_event_age_seconds_bucket{{bound="mean",le="10"}} 10
heatmap_event_age_seconds_bucket{{bound="mean",le="+Inf"}} 10
heatmap_event_age_seconds_sum{{bound="mean"}} 14
heatmap_event_age_seconds_count{{bound="mean"}} 10
# TYPE heatmap_batch_latency_seconds histogram
heatmap_batch_latency_seconds_bucket{{le="0.1"}} {b1}
heatmap_batch_latency_seconds_bucket{{le="+Inf"}} 10
heatmap_batch_latency_seconds_sum 2
heatmap_batch_latency_seconds_count 10
"""


def _text(rng):
    return RUNTIME_TEXT.format(
        n=int(rng.integers(0, 10_000)), rate=int(rng.integers(0, 500)),
        wm=round(float(rng.uniform(0, 60)), 3), lag=int(rng.integers(0, 9)),
        b1=int(rng.integers(0, 10)))


def _audit_block(mod, docs, tag, verify_ok=True):
    """A member's audit block: a ledger and the fold's table over
    ``docs``; the view table (the merged-view digest the fleet combines
    against) holds the same docs, or one less when ``verify_ok`` is
    False."""
    aud = mod.AuditState(tag=tag)
    for stage, n in (("polled", 500), ("folded", 480),
                     ("dropped_late", 20), ("docs_emitted", len(docs)),
                     ("docs_committed", len(docs))):
        aud.add(stage, n)
    aud.shard_table(None).apply_docs(docs)
    view = type("View", (), {})()
    view.seq, view.audit_table = 7, mod.DigestTable()
    view.audit_table.apply_docs(docs if verify_ok else docs[1:])
    aud.view = view
    return aud.member_block(now_wall=T_FIXED - 60)


def _delivery_block(mod, seed):
    rng = np.random.default_rng(seed)
    clk = [100300.0]
    tr = mod.DeliveryTracker(clock=lambda: clk[0])
    for i in range(8):
        st = rng.integers(1, 64, size=4) / 64.0
        tr.record_applied(i + 1, [100000.0 + i, 100000.5 + i, float(st[0])],
                          clk[0], clk[0] + st[1])
        clk[0] += st[1]
        meta = tr.encoded(i + 1)
        wb = clk[0] + st[2]
        clk[0] = wb + st[3]
        tr.delivered(meta, wb, clk[0])
    return tr.member_block()


def _lineage(seed, tag):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(6):
        st = {s: round(float(rng.uniform(0, 2)), 3)
              for s in ("poll_wait", "prefetch_queue", "fold", "ring",
                        "sink_commit")}
        ev = 1_999_999_000.0 + i
        recs.append({"lid": f"{tag}-{i}", "ev_mean_ts": ev, "n_events": 64,
                     "stages": st, "t_sink": ev + sum(st.values())})
    return recs


def populate(chan):
    """One channel directory written by both packages: a JAX runtime
    member and two port serve members (seeded blocks), a port child
    freshness file and supervisor channel, and the hazards the readers
    must skip: a torn file, an in-flight tmp file, a clock-skewed, a stale
    and a departed member."""
    rng = np.random.default_rng(11)
    ws0 = dt.datetime.fromtimestamp(T_FIXED - 900, UTC)
    docs = seeded_docs(4, n_cells=10, n_windows=2, ws0=ws0)
    jdocs = seeded_docs(4, n_cells=10, n_windows=2, ws0=ws0, pkg="jax")
    quality = {"scorecards": {"registered": 9, "scored": 5,
                              "expired_unscorable": 1, "pending": 3},
               "nis": {"updates": 400, "coverage": 0.93,
                       "band_error": 0.02},
               "skill": {"h3r8|60": 0.31, "h3r8|300": -0.05},
               "anomaly_rate": {"stopped": 0.5}, "table": {"live": 20}}
    jxproc.publish_member_snapshot(
        chan, "p0", role="runtime", metrics_text=_text(rng),
        freshness={"event_age_p50_s": 0.4, "event_age_p99_s": 2.0},
        healthz={"status": "ok", "checks": {}},
        lineage=jfleet.compact_lineage(_lineage(1, "p0")),
        audit=_audit_block(jaudit, jdocs, "p0"), quality=quality,
        infer={"entities": 20})
    for i, tag in enumerate(("serve101", "serve102")):
        txproc.publish_member_snapshot(
            chan, tag, role="serve", metrics_text=_text(rng),
            healthz={"status": "degraded" if i else "ok",
                     "checks": {"repl_lag_s": {"value": 12.0,
                                               "ok": not i}}},
            lineage=tfleet.compact_lineage(
                [dict(r, t_view=r["t_sink"] + 0.25)
                 for r in _lineage(1, "p0")]),
            audit=_audit_block(taudit, docs, tag, verify_ok=not i),
            delivery=_delivery_block(tdelivery, 20 + i),
            cq={"registered": 1})
    txproc.publish_child_freshness(chan, "p0", {"event_age_p50_s": 0.4,
                                                "event_age_p99_s": 2.0,
                                                "ring_residency_mean_s": 0.1})
    sup = txproc.SupervisorChannel(chan)
    sup.update(restarts_total=2, child_running=1)
    with open(txproc.member_path(chan, "torn"), "w") as fh:
        fh.write('{"tag": "torn", "metri')
    with open(txproc.member_path(chan, "p9") + ".tmp123", "w") as fh:
        fh.write("{}")
    for tag, upd in (("skewed", time.time() + 3600),
                     ("stale", time.time() - 3600)):
        path = txproc.member_path(chan, tag)
        txproc.atomic_write_json(path, {"tag": tag, "role": "serve",
                                        "updated_unix": upd})
    jxproc.publish_member_snapshot(chan, "gone", role="serve", left=True)


# ------------------------------------------------------------ readers
def test_member_snapshots_read_across_packages(tmp_path):
    chan = str(tmp_path / "chan.json")
    populate(chan)
    mine, ref = txproc.members_from(chan), jxproc.members_from(chan)
    assert mine == ref
    members, skipped = mine
    assert sorted(members) == ["p0", "serve101", "serve102"]
    assert skipped["torn"] == "corrupt" and skipped["gone"] == "left"
    assert skipped["skewed"].startswith("clock skew")
    assert skipped["stale"].startswith("stale")
    assert (txproc.child_freshness_from(chan)
            == jxproc.child_freshness_from(chan) != {})
    assert (txproc.SupervisorChannel.metrics_from(chan)
            == jxproc.SupervisorChannel.metrics_from(chan))
    assert (txproc.supervisor_metrics_lines(
        txproc.SupervisorChannel.metrics_from(chan))
        == jxproc.supervisor_metrics_lines(
            jxproc.SupervisorChannel.metrics_from(chan)))
    assert txproc.members_from(None) == ({}, {})


def test_fleet_aggregator_matches_jax_over_one_channel(tmp_path):
    chan = str(tmp_path / "chan.json")
    populate(chan)
    aggs = {"port": tfleet.FleetAggregator(chan, clock=lambda: T_FIXED),
            "jax": jfleet.FleetAggregator(chan, clock=lambda: T_FIXED)}
    got = {}
    for pkg, agg in aggs.items():
        got[pkg] = {"metrics_text": agg.metrics_text(),
                    "healthz": agg.healthz(),
                    "freshness": agg.freshness(4),
                    "delivery": agg.delivery(), "audit": agg.audit(),
                    "quality": agg.quality()}
    for surface in got["port"]:
        assert got["port"][surface] == got["jax"][surface], surface
    hz, down = got["port"]["healthz"]
    assert hz["status"] == "degraded" and not down
    assert hz["checks"]["member_serve102"]["failing"] == ["repl_lag_s"]
    audit = got["port"]["audit"]
    assert audit["digest_mismatches"] == 0
    assert audit["combine_mismatches"] >= 1 and not audit["ok"]
    delivery, degraded = got["port"]["delivery"]
    assert delivery["reporting"] == 2 and degraded   # stale members
    assert got["port"]["quality"]["scorecards"]["ok"]
    text = got["port"]["metrics_text"]
    assert "heatmap_fleet_members 3" in text
    assert 'heatmap_child_event_age_p50_s{child="p0"} 0.4' in text
    assert "heatmap_fleet_event_age_p50_s" in text
    # a member whose file vanishes after it was seen degrades both
    os.remove(txproc.member_path(chan, "serve101"))
    for pkg, agg in aggs.items():
        hz, _ = agg.healthz()
        assert hz["checks"]["member_serve101"] == {"value": "vanished",
                                                    "ok": False}, pkg
    assert aggs["port"].metrics_text() == aggs["jax"].metrics_text()


def test_stamps_read_the_channel_as_jax(tmp_path, monkeypatch):
    chan = str(tmp_path / "chan.json")
    populate(chan)
    monkeypatch.setenv("HEATMAP_SUPERVISOR_CHANNEL", chan)
    assert (tfleet.fleet_stamp(900.0, role="serve")
            == jfleet.fleet_stamp(900.0, role="serve")
            == {"fleet": {"members": 2, "member_tags": ["serve101",
                                                        "serve102"],
                          "per_member_rate": 450.0}})
    assert tfleet.repl_stamp() == jfleet.repl_stamp()
    assert tfleet.repl_stamp()["repl"]["replicas"] == 3


# ------------------------------------------------------------ episodes
EPISODE_MODS = {"jax": jxproc, "port": txproc}


def test_episodes_claimed_joined_and_cleared_as_in_jax(tmp_path):
    """The same script through each package's functions on its own
    channel, and across packages on a shared one."""
    out = {}
    for pkg, x in EPISODE_MODS.items():
        chan = str(tmp_path / pkg)
        claim = x.episode_path(chan) + ".claim"
        steps = [x.read_episode(chan)]
        first = x.ensure_episode(chan, "p0", "p0 degraded")
        second = x.ensure_episode(chan, "p1", "p1 degraded")
        steps.append((bool(first["episode_id"]), first["origin"],
                      second == x.read_episode(chan),
                      second["episode_id"] == first["episode_id"],
                      os.path.exists(claim)))
        # a foreign member may not clear it; its claimant may
        steps.append((x.clear_episode(chan, origin="p1"),
                      x.clear_episode(chan, origin="p0"),
                      x.read_episode(chan)))
        # a fresh foreign claim with no broadcast: back off empty
        open(claim, "w").close()
        steps.append((x.ensure_episode(chan, "p1", "x"),
                      x.read_episode(chan)))
        # an orphaned claim is swept, and the next call claims
        old = time.time() - 60
        os.utime(claim, (old, old))
        steps.append((x.ensure_episode(chan, "p1", "x"),
                      os.path.exists(claim)))
        ep = x.ensure_episode(chan, "p1", "x")
        steps.append((ep["origin"], x.read_episode(chan, max_age_s=-1.0)))
        out[pkg] = steps
    assert out["port"] == out["jax"]
    # across packages: a port member joins a JAX claim, and the reverse
    chan = str(tmp_path / "shared")
    ep = jxproc.ensure_episode(chan, "jax0", "jax degraded")
    assert txproc.ensure_episode(chan, "port0", "port degraded") == \
        txproc.read_episode(chan) == jxproc.read_episode(chan)
    assert txproc.clear_episode(chan, origin="jax0")
    ep = txproc.ensure_episode(chan, "port0", "port degraded")
    assert jxproc.ensure_episode(chan, "jax0", "x")["episode_id"] == \
        ep["episode_id"]


WATCHDOGS = {"jax": (JaxSloWatchdog, jxproc, JaxFlightRecorder),
             "port": (SloWatchdog, txproc, FlightRecorder)}


def test_watchdogs_claim_follow_and_clear_as_in_jax(tmp_path, monkeypatch):
    """Each package's fleet-mode watchdog with no runtime: a supervisor
    that gave up downs the verdict, so the watchdog claims an episode and
    dumps under it, never re-dumps its own, clears it on recovery, follows
    a foreign episode once, and skips one broadcast before it booted."""
    out = {}
    for pkg, (wd_cls, x, fr_cls) in WATCHDOGS.items():
        chan = str(tmp_path / pkg / "chan.json")
        os.makedirs(os.path.dirname(chan))
        monkeypatch.setenv("HEATMAP_SUPERVISOR_CHANNEL", chan)
        pre = x.broadcast_episode(chan, "p0", "before boot")
        time.sleep(0.01)
        wd = wd_cls(None, interval_s=0.0, cooldown_s=0.0,
                    channel_path=chan, tag="serve1",
                    flightrec=fr_cls(str(tmp_path / pkg / "fr")))
        steps = [wd.check_once(), pre in wd._episodes_done]
        x.clear_episode(chan)
        sup = x.SupervisorChannel(chan)
        sup.update(gave_up=1)
        path = wd.check_once()
        ep = x.read_episode(chan)
        with open(path, encoding="utf-8") as fh:
            steps.append((ep["origin"],
                          json.load(fh)["episode_id"] == ep["episode_id"]))
        steps.append(wd.check_once())
        sup.update(gave_up=0)
        steps.append((wd.check_once(), x.read_episode(chan)))
        time.sleep(0.01)
        eid = x.broadcast_episode(chan, "p0", "p0 degraded")
        path = wd.check_once()
        with open(path, encoding="utf-8") as fh:
            steps.append(json.load(fh)["episode_id"] == eid)
        steps.append(wd.check_once())
        out[pkg] = steps
    assert out["port"] == out["jax"]
    assert out["port"] == [None, True, ("serve1", True), None,
                           (None, {}), True, None]


# ------------------------------------------------------ serve members
def test_serve_fleet_member_publishes_and_follows_episodes(tmp_path,
                                                          monkeypatch):
    chan = str(tmp_path / "chan.json")
    monkeypatch.setenv("HEATMAP_SUPERVISOR_CHANNEL", chan)
    monkeypatch.setenv("HEATMAP_FLEET_PUBLISH_S", "0.05")
    monkeypatch.setenv("HEATMAP_FLIGHTREC_DIR", str(tmp_path / "fr"))
    monkeypatch.delenv("HEATMAP_FLEET_TAG", raising=False)
    app = tapi.make_wsgi_app(MemoryStore(),
                             load_config({"HEATMAP_AUDIT": "1"}))
    member = tapi.ServeFleetMember.from_env(app)
    try:
        assert member.tag == f"serve{os.getpid()}"
        snap = json.loads(open(txproc.member_path(chan, member.tag)).read())
        assert snap["role"] == "serve" and snap["audit"]["tag"] == \
            member.tag
        assert "heatmap_view_rebuilds_total" in snap["metrics_text"]
        agg = jfleet.FleetAggregator(chan)
        assert f'proc="{member.tag}",role="serve"' in agg.metrics_text()
        eid = jxproc.broadcast_episode(chan, "p0", "p0 degraded")
        path = member.watchdog.check_once()
        assert json.loads(open(path).read())["episode_id"] == eid
        # the app serves the fleet surfaces off the same channel
        from test_torch_serve import call

        s, _, b = call(app, "/fleet/healthz")
        assert s.startswith("200")
        assert json.loads(b)["members"] == [member.tag]
    finally:
        member.stop()
        app.close()
    assert txproc.members_from(chan) == ({}, {member.tag: "left"})
    monkeypatch.setenv("HEATMAP_FLEET_TAG", "city1")
    assert (tapi.ServeFleetMember(None, chan).tag
            == f"city1-serve{os.getpid()}")
    monkeypatch.delenv("HEATMAP_SUPERVISOR_CHANNEL")
    assert tapi.ServeFleetMember.from_env(app) is None


def _get_json(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_workers_publish_one_member_each_and_depart(tmp_path):
    chan = str(tmp_path / "chan.json")
    env = dict(os.environ, HEATMAP_STORE="memory",
               HEATMAP_SUPERVISOR_CHANNEL=chan,
               HEATMAP_FLEET_PUBLISH_S="0.2")
    env.pop("PYTHONSTARTUP", None)
    env.pop("HEATMAP_FLEET_TAG", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "heatmap_tpu_torch.serve", "--workers", "2",
         "--port", "0"], cwd=REPO, env=env, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            assert line, "the supervisor exited"
            m = re.search(r"serve fleet: 2 workers on "
                          r"http://127\.0\.0\.1:(\d+)/", line)
            if m:
                port = int(m.group(1))
        members = {}
        deadline = time.monotonic() + 60
        while len(members) < 2 and time.monotonic() < deadline:
            members, _ = txproc.members_from(chan)
            time.sleep(0.1)
        assert len(members) == 2
        for tag, snap in members.items():
            assert tag == f"serve{snap['pid']}" and snap["role"] == "serve"
        status, hz = _get_json(port, "/fleet/healthz")
        assert status == 200 and hz["members"] == sorted(members)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert txproc.members_from(chan) == (
            {}, {tag: "left" for tag in members})
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()


# ------------------------------------------------------------- obs_top
def _load_obs_top():
    spec = importlib.util.spec_from_file_location(
        "obs_top", os.path.join(REPO, "tools", "obs_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_obs_top_renders_a_fleet_frame_from_the_ports_channel(
        tmp_path, monkeypatch):
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    chan = str(tmp_path / "chan.json")
    monkeypatch.setenv("HEATMAP_SUPERVISOR_CHANNEL", chan)
    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    monkeypatch.delenv("HEATMAP_FLEET_TAG", raising=False)
    cfg = load_config({"HEATMAP_AUDIT": "1"}, checkpoint_dir=str(tmp_path),
                      city="bos", h3_res=8, resolutions=(8,),
                      batch_size=1024, state_capacity_log2=12)
    rt = MicroBatchRuntime(
        cfg, SyntheticSource(n_events=4096, t0=int(time.time()) - 900),
        MemoryStore(), device="cpu", checkpoint_every=0)
    app = tapi.make_wsgi_app(MemoryStore(), load_config({}))
    member = tapi.ServeFleetMember(app.serve_registry, chan,
                                   healthz_fn=app.healthz_fn,
                                   delivery_fn=app.delivery_fn)
    try:
        for _ in range(3):
            rt.step_once()
        rt.flush_pending("idle")
        rt.writer.drain()
        rt._publish_member_snapshot(force=True)
        member.publish()
        top = _load_obs_top()
        text = tfleet.FleetAggregator(chan).metrics_text()
        frame = top.render_fleet_frame(top.parse_prom(text), None, 0.0,
                                       tfleet.FleetAggregator(chan)
                                       .healthz()[0])
        assert "p0" in frame and member.tag in frame
        assert "runtime" in frame and "serve" in frame
        snap = json.loads(open(txproc.member_path(chan, "p0")).read())
        # at quiescence the books balance but for the batch prefetched
        in_flight = sum(e.n for e in rt._prefetched)
        assert snap["audit"]["residuals"] == {
            "feed_fold": in_flight, "emit_sink": 0, "sink_view": 0}
    finally:
        rt.close()
        app.close()
