"""The port's supervisor (heatmap_tpu_torch/stream/supervisor.py), its
shard fleet, the runtime's heartbeat and the entry point's ``--supervise``
and ``--shards``, on the CPU.

Counterparts of ``tests/test_supervisor.py``.  The restart, stall, budget,
backoff, episode and SIGTERM mechanics run tiny child scripts that import
neither ``torch`` nor ``jax``, so each failure mode is fast and
deterministic; the beacon and its watchdog are pinned on the port's
runtime in process.  The reference's platform failover is refused by the
port: ``Supervisor`` raises, naming the rule.  Only the end-to-end fleet
tests start real port children (``--device cpu``), each with a deadline
of its own: one shard of two is SIGKILLed after its first checkpoint, the
fleet supervisor revives it, ``/fleet/healthz`` names it while it is dark,
and the merged JSONL store converges to one unsharded port fold.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from heatmap_tpu_torch.obs import SupervisorChannel
from heatmap_tpu_torch.stream.supervisor import (FleetSupervisor,
                                                 RestartPolicy, Supervisor)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
FAST = dict(backoff_s=0.05, backoff_max_s=0.1, term_grace_s=1.0,
            window_s=60.0)
# the children import the port from the checkout, and no interpreter hook
CHILD_ENV = {**os.environ, "PYTHONPATH": REPO}


def _child(body: str) -> list[str]:
    return [sys.executable, "-c", body]


COUNTING = """
import os, sys, time
log = os.environ["LAUNCH_LOG"]
with open(log, "a") as fh:
    fh.write("launch\\n")
n = sum(1 for _ in open(log))
sys.exit(0 if n >= {succeed_on} else 1)
"""


def _sup(tmp_path, body, policy, **kw):
    return Supervisor(_child(body), policy,
                      env={**CHILD_ENV, "LAUNCH_LOG": str(tmp_path / "log")},
                      heartbeat_path=str(tmp_path / "hb"), poll_s=0.02, **kw)


def _launches(tmp_path):
    return open(tmp_path / "log").read().split()


def test_restarts_until_clean_exit(tmp_path):
    sup = _sup(tmp_path, COUNTING.format(succeed_on=3),
               RestartPolicy(max_restarts=5, **FAST))
    assert sup.run() == 0
    assert len(_launches(tmp_path)) == 3 and sup.restarts == 2
    assert SupervisorChannel.metrics_from(sup.channel.path)[
        "restarts_total"] == 2


def test_restart_budget_exhausts(tmp_path):
    sup = _sup(tmp_path, COUNTING.format(succeed_on=99),
               RestartPolicy(max_restarts=2, **FAST))
    assert sup.run() == 1
    assert len(_launches(tmp_path)) == 3
    assert SupervisorChannel.metrics_from(sup.channel.path)["gave_up"] == 1


def test_stall_detected_and_killed(tmp_path):
    """A child that writes its beacon once and then wedges is killed and
    restarted; the second launch exits 0."""
    body = """
import os, sys, time
log = os.environ["LAUNCH_LOG"]
with open(log, "a") as fh:
    fh.write("launch\\n")
if sum(1 for _ in open(log)) == 1:
    open(os.environ["HEATMAP_HEARTBEAT_FILE"], "w").write(str(time.time()))
    time.sleep(3600)
sys.exit(0)
"""
    sup = _sup(tmp_path, body,
               RestartPolicy(max_restarts=5, stall_timeout_s=4.0, **FAST))
    t0 = time.monotonic()
    assert sup.run() == 0
    assert time.monotonic() - t0 < 60
    assert len(_launches(tmp_path)) >= 2
    assert SupervisorChannel.metrics_from(sup.channel.path)[
        "stalls_total"] >= 1


def test_stall_covers_wedged_startup(tmp_path):
    body = """
import os, sys, time
log = os.environ["LAUNCH_LOG"]
with open(log, "a") as fh:
    fh.write("launch\\n")
if sum(1 for _ in open(log)) == 1:
    time.sleep(3600)
sys.exit(0)
"""
    sup = _sup(tmp_path, body,
               RestartPolicy(max_restarts=5, stall_timeout_s=4.0,
                             startup_grace_s=4.0, **FAST))
    assert sup.run() == 0
    assert len(_launches(tmp_path)) >= 2


def test_failover_is_refused(tmp_path, monkeypatch):
    """The reference's failover restarts a failing child on
    HEATMAP_PLATFORM=cpu; the port refuses the policy, naming the rule,
    whichever way it is given, and starts no child."""
    with pytest.raises(ValueError, match="failover_after is refused"):
        _sup(tmp_path, COUNTING.format(succeed_on=1),
             RestartPolicy(max_restarts=5, failover_after=2, **FAST))
    assert not (tmp_path / "log").exists()
    monkeypatch.setenv("HEATMAP_SUPERVISE_FAILOVER_AFTER", "2")
    from heatmap_tpu_torch.stream.supervisor import supervise_cli

    with pytest.raises(ValueError, match="HEATMAP_PLATFORM=cpu"):
        supervise_cli(_child("raise SystemExit(0)"))
    # the default is the reference's: no failover
    assert RestartPolicy().failover_after is None
    # a fleet ignores failover_after, as the reference's does
    sup = FleetSupervisor(_child("raise SystemExit(0)"), 2,
                          RestartPolicy(failover_after=2, **FAST),
                          env=CHILD_ENV, heartbeat_dir=str(tmp_path),
                          poll_s=0.02, channel_path=str(tmp_path / "c"))
    assert sup.run() == 0


def test_startup_grace_outlasts_stall_timeout(tmp_path):
    body = """
import os, sys, time
with open(os.environ["LAUNCH_LOG"], "a") as fh:
    fh.write("launch\\n")
time.sleep(2.0)
sys.exit(0)
"""
    sup = _sup(tmp_path, body,
               RestartPolicy(max_restarts=2, stall_timeout_s=0.2,
                             startup_grace_s=60.0, **FAST))
    assert sup.run() == 0
    assert len(_launches(tmp_path)) == 1


class _Waits(list):
    """Records the supervisor's backoff waits (every wait longer than a
    poll slice)."""

    def wrap(self, sup):
        orig = sup._wait

        def wait(seconds):
            if seconds > sup.poll_s:
                self.append(seconds)
            orig(seconds)

        sup._wait = wait
        return sup


def test_healthy_run_resets_the_backoff(tmp_path):
    """Failures separated by runs healthy for a whole budget window are
    isolated blips: each restarts after the base backoff (the reference's
    failover streak resets at the same point)."""
    body = """
import os, sys, time
with open(os.environ["LAUNCH_LOG"], "a") as fh:
    fh.write("launch\\n")
n = sum(1 for _ in open(os.environ["LAUNCH_LOG"]))
time.sleep(1.0)
sys.exit(0 if n >= 3 else 1)
"""
    waits = _Waits()
    sup = waits.wrap(_sup(tmp_path, body, RestartPolicy(
        max_restarts=10, window_s=0.3, backoff_s=0.05, backoff_max_s=1.0,
        term_grace_s=1.0)))
    assert sup.run() == 0
    assert len(_launches(tmp_path)) == 3
    assert waits == [0.05, 0.05]


def test_wedged_child_is_not_healthy(tmp_path):
    """A child that only ever wedges (no beacon, killed by the startup
    grace) does not count as healthy: the stall wait is not health, so its
    backoff keeps doubling."""
    body = """
import os, sys, time
with open(os.environ["LAUNCH_LOG"], "a") as fh:
    fh.write("launch\\n")
if sum(1 for _ in open(os.environ["LAUNCH_LOG"])) >= 3:
    sys.exit(0)
time.sleep(3600)
"""
    waits = _Waits()
    sup = waits.wrap(_sup(tmp_path, body, RestartPolicy(
        max_restarts=10, stall_timeout_s=3.0, startup_grace_s=3.0,
        window_s=2.0, backoff_s=0.05, backoff_max_s=1.0,
        term_grace_s=1.0)))
    assert sup.run() == 0
    assert waits == [0.05, 0.1]


def test_separate_incidents_mint_fresh_episode_ids(tmp_path):
    from heatmap_tpu.obs.xproc import read_episode as jax_read_episode
    from heatmap_tpu_torch.obs.xproc import read_episode

    chan = str(tmp_path / "chan")
    body = """
import os, sys, time
with open(os.environ["LAUNCH_LOG"], "a") as fh:
    fh.write("launch\\n")
if sum(1 for _ in open(os.environ["LAUNCH_LOG"])) >= 3:
    sys.exit(0)
time.sleep(0.5)
sys.exit(1)
"""
    sup = _sup(tmp_path, body, RestartPolicy(
        max_restarts=10, window_s=0.3, backoff_s=0.05, backoff_max_s=0.1,
        term_grace_s=1.0), channel_path=chan)
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(sup.run()), daemon=True)
    t.start()
    deadline, first = time.monotonic() + 30, None
    while time.monotonic() < deadline and first is None:
        first = read_episode(chan).get("episode_id")
        time.sleep(0.01)
    assert first
    t.join(timeout=30)
    assert rcs == [0]
    final = read_episode(chan)
    assert final.get("origin") == "supervisor"
    assert final["episode_id"] != first
    # the JAX package reads the port supervisor's broadcast
    assert jax_read_episode(chan)["episode_id"] == final["episode_id"]


def test_policy_from_env():
    from heatmap_tpu.stream.supervisor import RestartPolicy as JaxPolicy

    env = {"HEATMAP_SUPERVISE_MAX_RESTARTS": "9",
           "HEATMAP_SUPERVISE_STALL_TIMEOUT_S": "7.5",
           "HEATMAP_SUPERVISE_FAILOVER_AFTER": "2",
           "HEATMAP_SUPERVISE_STARTUP_GRACE_S": "11",
           "HEATMAP_SUPERVISE_BACKOFF_S": "0.5"}
    p = RestartPolicy.from_env(env)
    # the reference's fields less failover_platform: the port refuses
    # failover, so it has no platform to fail over to
    shared = lambda jp: {k: v for k, v in jp._asdict().items()
                         if k != "failover_platform"}
    assert p._asdict() == shared(JaxPolicy.from_env(env))
    assert (p.max_restarts, p.stall_timeout_s, p.startup_grace_s,
            p.failover_after) == (9, 7.5, 11, 2)
    assert not hasattr(p, "failover_platform")
    assert RestartPolicy.from_env({}) == RestartPolicy()
    assert RestartPolicy()._asdict() == shared(JaxPolicy())


def _runtime(tmp_path, events):
    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import MemorySource

    cfg = load_config({}, batch_size=64, state_capacity_log2=10,
                      speed_hist_bins=8, store="memory",
                      checkpoint_dir=str(tmp_path / "ckpt"))
    src = MemorySource(events)
    return MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu"), src


def _events(n):
    t0 = int(time.time()) - 600
    return [{"provider": "t", "vehicleId": f"v{i}", "lat": 42.0 + i * 1e-3,
             "lon": -71.0, "speedKmh": 10.0, "bearing": 0.0,
             "accuracyM": 1.0, "ts": t0 + i} for i in range(n)]


def test_runtime_heartbeat(tmp_path, monkeypatch):
    hb = tmp_path / "hb"
    monkeypatch.setenv("HEATMAP_HEARTBEAT_FILE", str(hb))
    rt, src = _runtime(tmp_path, _events(64))
    src.finish()
    # no beacon before the first completed step
    rt.step_once()
    assert not hb.exists()
    rt.run()
    content = open(hb).read()
    assert content[0].isdigit() and "epoch=" in content
    assert not rt._hb_watchdog.is_alive() or rt._hb_stop.is_set()
    # a run without the knob writes no beacon and starts no thread
    monkeypatch.delenv("HEATMAP_HEARTBEAT_FILE")
    rt2, src2 = _runtime(tmp_path / "b", _events(64))
    src2.finish()
    rt2.run()
    assert rt2._hb_watchdog is None


def test_sigterm_during_backoff_exits_promptly(tmp_path):
    prog = (
        "import sys; sys.path.insert(0, %r); "
        "from heatmap_tpu_torch.stream.supervisor import supervise_cli; "
        "sys.exit(supervise_cli([sys.executable, '-c', "
        "'raise SystemExit(3)']))" % REPO)
    env = {**os.environ, "PYTHONPATH": "",
           "HEATMAP_SUPERVISE_BACKOFF_S": "60",
           "HEATMAP_SUPERVISE_BACKOFF_MAX_S": "60",
           "HEATMAP_SUPERVISE_MAX_RESTARTS": "9",
           "HEATMAP_SUPERVISOR_CHANNEL": str(tmp_path / "chan")}
    p = subprocess.Popen([sys.executable, "-c", prog], env=env)
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if SupervisorChannel.metrics_from(str(tmp_path / "chan")).get(
                    "restarts_total"):
                break
            time.sleep(0.05)
        assert p.poll() is None
        t0 = time.monotonic()
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=10) == 0
        assert time.monotonic() - t0 < 5.0
    finally:
        if p.poll() is None:
            p.kill()


def test_watchdog_vouches_for_in_flight_step_up_to_grace(tmp_path,
                                                         monkeypatch):
    hb = tmp_path / "hb"
    monkeypatch.setenv("HEATMAP_HEARTBEAT_FILE", str(hb))
    monkeypatch.setenv("HEATMAP_DISPATCH_GRACE_S", "2.5")
    rt, _ = _runtime(tmp_path, _events(1))
    rt.step_once()
    rt._touch_heartbeat()
    assert rt._hb_watchdog is not None and rt._hb_watchdog.is_alive()
    rt._step_began = time.monotonic()
    before = os.stat(hb).st_mtime
    time.sleep(1.6)
    assert os.stat(hb).st_mtime > before, "watchdog never touched beacon"
    rt._step_began = time.monotonic() - 10.0
    # let a write the watchdog decided on before the change land first
    time.sleep(1.1)
    quiet_from = os.stat(hb).st_mtime
    time.sleep(1.6)
    assert os.stat(hb).st_mtime == quiet_from
    rt._step_began = None
    rt.close()
    rt._hb_watchdog.join(timeout=5)
    assert not rt._hb_watchdog.is_alive()


CHAOS_CHILD = """
import os, sys, time
from heatmap_tpu_torch.obs.xproc import publish_member_snapshot
chan = os.environ["HEATMAP_SUPERVISOR_CHANNEL"]
open(os.environ["CHILD_PID_FILE"], "w").write(str(os.getpid()))
hb = os.environ["HEATMAP_HEARTBEAT_FILE"]
assert "torch" not in sys.modules
while True:
    with open(hb, "w") as fh:
        fh.write(str(time.time()))
    publish_member_snapshot(chan, "c1", role="runtime",
                            freshness={"event_age_p50_s": 0.1},
                            healthz={"status": "ok", "checks": {}})
    time.sleep(0.05)
"""


def test_fleet_chaos_child_killed_mid_stream(tmp_path, monkeypatch):
    import glob

    from heatmap_tpu_torch.obs.fleet import FleetAggregator
    from heatmap_tpu_torch.obs.flightrec import FlightRecorder
    from heatmap_tpu_torch.obs.runtimeinfo import SloWatchdog
    from heatmap_tpu_torch.obs.xproc import (member_path,
                                             publish_member_snapshot,
                                             read_episode)

    chan = str(tmp_path / "chan")
    pid_file = tmp_path / "child.pid"
    fr_sup, fr_srv = tmp_path / "fr-supervisor", tmp_path / "fr-serve1"
    monkeypatch.setenv("HEATMAP_FLEET_PUBLISH_S", "0.05")
    sup = Supervisor(
        _child(CHAOS_CHILD),
        RestartPolicy(max_restarts=5, backoff_s=60.0, backoff_max_s=60.0,
                      term_grace_s=1.0, window_s=60.0,
                      stall_timeout_s=120.0),
        env={**CHILD_ENV, "CHILD_PID_FILE": str(pid_file),
             "HEATMAP_FLIGHTREC_DIR": str(fr_sup)},
        heartbeat_path=str(tmp_path / "hb"), poll_s=0.02,
        channel_path=chan)
    t = threading.Thread(target=sup.run, daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if (pid_file.exists()
                    and os.path.exists(member_path(chan, "c1"))
                    and os.path.exists(member_path(chan, "supervisor"))):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("fleet never assembled")
        snap = json.loads(open(member_path(chan, "supervisor")).read())
        assert snap["role"] == "supervisor"
        assert "heatmap_supervisor_restarts_total" in snap["metrics_text"]
        publish_member_snapshot(chan, "serve1", role="serve",
                                healthz={"status": "ok", "checks": {}})
        wd = SloWatchdog(None, interval_s=0.0, cooldown_s=0.0,
                         channel_path=chan, tag="serve1",
                         flightrec=FlightRecorder(str(fr_srv)))
        assert wd.check_once() is None
        os.kill(int(pid_file.read_text()), signal.SIGKILL)
        deadline = time.monotonic() + 30
        ep = {}
        while time.monotonic() < deadline and not ep:
            ep = read_episode(chan)
            time.sleep(0.05)
        assert ep["origin"] == "supervisor"
        assert "child failed" in ep["reason"]
        eid = ep["episode_id"]
        deadline, dumps = time.monotonic() + 15, []
        while time.monotonic() < deadline and not dumps:
            dumps = [json.loads(open(p).read()) for p in
                     glob.glob(str(fr_sup / "flightrec-*.json"))]
            time.sleep(0.05)
        assert dumps and dumps[0]["episode_id"] == eid
        path = wd.check_once()
        assert path is not None
        assert json.loads(open(path).read())["episode_id"] == eid
        publish_member_snapshot(chan, "serve1", role="serve",
                                healthz={"status": "ok", "checks": {}})
        agg = FleetAggregator(chan, max_age_s=0.75)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            payload, down = agg.healthz()
            if "c1" in payload.get("stale_members", []):
                break
            time.sleep(0.1)
        else:
            raise AssertionError(f"dead member never went stale: {payload}")
        assert payload["status"] == "degraded" and not down
        assert payload["checks"]["member_c1"]["ok"] is False
        assert {"supervisor", "serve1"} <= set(payload["members"])
        assert payload["episode"]["episode_id"] == eid
        assert ('heatmap_fleet_member_up{proc="c1",role="?"} 0'
                in agg.metrics_text())
    finally:
        sup.stop()
        t.join(timeout=30)


SHARD_COUNTING = """
import os, sys
log = os.environ["LAUNCH_LOG"] + os.environ["HEATMAP_SHARD_INDEX"]
with open(log, "a") as fh:
    fh.write(os.environ["HEATMAP_SHARDS"] + ":"
             + os.environ["HEATMAP_SHARD_INDEX"] + "\\n")
n = sum(1 for _ in open(log))
sys.exit(0 if n >= int(os.environ["SUCCEED_ON"]) else 1)
"""


def test_fleet_spawns_per_shard_env_and_restarts_each(tmp_path):
    sup = FleetSupervisor(
        _child(SHARD_COUNTING), 3, RestartPolicy(max_restarts=5, **FAST),
        env={**CHILD_ENV, "LAUNCH_LOG": str(tmp_path / "log"),
             "SUCCEED_ON": "2"},
        heartbeat_dir=str(tmp_path), poll_s=0.02,
        channel_path=str(tmp_path / "chan"))
    assert sup.run() == 0
    for i in range(3):
        lines = open(str(tmp_path / "log") + str(i)).read().split()
        assert lines == [f"3:{i}", f"3:{i}"]
        assert sup.children[i].restarts == 1 and sup.children[i].done
    assert sup.restarts == 3


def test_fleet_one_shard_exhausting_budget_degrades_not_kills(tmp_path):
    from heatmap_tpu_torch.obs.xproc import member_path

    body = """
import os, sys
i = os.environ["HEATMAP_SHARD_INDEX"]
with open(os.environ["LAUNCH_LOG"] + i, "a") as fh:
    fh.write("launch\\n")
sys.exit(3 if i == "1" else 0)
"""
    chan = str(tmp_path / "chan")
    sup = FleetSupervisor(
        _child(body), 3, RestartPolicy(max_restarts=1, **FAST),
        env={**CHILD_ENV, "LAUNCH_LOG": str(tmp_path / "log")},
        heartbeat_dir=str(tmp_path), poll_s=0.02, channel_path=chan)
    assert sup.run() == 3
    assert sup.children[1].gave_up and not sup.children[1].done
    assert sup.children[0].done and sup.children[2].done
    assert sum(1 for _ in open(str(tmp_path / "log") + "1")) == 2
    assert SupervisorChannel.metrics_from(chan)["gave_up"] == 0
    snap = json.loads(open(member_path(chan, "supervisor")).read())
    assert snap["healthz"]["status"] == "degraded"
    assert snap["healthz"]["checks"]["shard1"] == {"value": "gave_up",
                                                   "ok": False}


def test_fleet_needs_two_shards():
    with pytest.raises(ValueError):
        FleetSupervisor(["true"], 1)


SHARD_STREAM_CHILD = """
import json, os, sys, time
import numpy as np
from heatmap_tpu_torch.obs.xproc import publish_member_snapshot

n = int(os.environ["HEATMAP_SHARDS"])
i = int(os.environ["HEATMAP_SHARD_INDEX"])
chan = os.environ["HEATMAP_SUPERVISOR_CHANNEL"]
hb = os.environ["HEATMAP_HEARTBEAT_FILE"]
outdir = os.environ["FLEET_OUTDIR"]
batch = int(os.environ["FLEET_BATCH"])
tag = "shard%d" % i
with open(os.path.join(outdir, tag + ".launches"), "a") as fh:
    fh.write("launch\\n")
open(os.path.join(outdir, tag + ".pid"), "w").write(str(os.getpid()))
rows = [json.loads(l) for l in open(os.environ["FLEET_CORPUS"])]
# this shard's rows, as ShardMap(n, i, 8).owned_mask gives them (worked
# out by the test: the host snap's module imports torch)
own = np.load(os.path.join(outdir, tag + ".own.npy"))
off_path = os.path.join(outdir, tag + ".offset")
out_path = os.path.join(outdir, tag + ".rows")
off = int(open(off_path).read()) if os.path.exists(off_path) else 0
assert "torch" not in sys.modules
while off < len(rows):
    hi = min(off + batch, len(rows))
    with open(out_path, "a") as fh:
        for j in range(off, hi):
            if own[j]:
                fh.write("%d\\n" % j)
    with open(off_path + ".tmp", "w") as fh:
        fh.write(str(hi))
    os.replace(off_path + ".tmp", off_path)
    off = hi
    open(hb, "w").write(str(time.time()))
    publish_member_snapshot(chan, tag, role="runtime",
                            healthz={"status": "ok", "checks": {}})
    time.sleep(0.05)
publish_member_snapshot(chan, tag, role="runtime",
                        healthz={"status": "ok", "checks": {}}, left=True)
"""


def _kill_and_watch(chan, kill, member, backoff_window_s=30):
    """Kill a member, then probe the episode and /fleet/healthz together
    until both name it (the degraded window spans only the backoff)."""
    from heatmap_tpu_torch.obs.fleet import FleetAggregator
    from heatmap_tpu_torch.obs.xproc import read_episode

    kill()
    agg = FleetAggregator(chan, max_age_s=0.5)
    deadline = time.monotonic() + backoff_window_s
    ep, degraded = {}, None
    while time.monotonic() < deadline:
        if not ep:
            ep = read_episode(chan)
        if degraded is None:
            payload, down = agg.healthz()
            if not payload.get("checks", {}).get(
                    f"member_{member}", {}).get("ok", True):
                assert payload["status"] == "degraded" and not down
                degraded = payload
        if ep and degraded is not None:
            break
        time.sleep(0.02)
    return ep, degraded


def test_fleet_chaos_shard_killed_revived_converges(tmp_path, monkeypatch):
    import numpy as np

    from heatmap_tpu_torch.obs.xproc import member_path
    from heatmap_tpu_torch.stream.shardmap import ShardMap

    monkeypatch.setenv("HEATMAP_FLEET_PUBLISH_S", "0.05")
    outdir = tmp_path / "out"
    outdir.mkdir()
    corpus = tmp_path / "corpus.jsonl"
    rng = np.random.default_rng(29)
    rows = [{"lat": float(rng.uniform(42.3, 42.5)),
             "lon": float(rng.uniform(-71.2, -71.0))} for _ in range(160)]
    with open(corpus, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    lat = np.radians([r["lat"] for r in rows]).astype(np.float32)
    lng = np.radians([r["lon"] for r in rows]).astype(np.float32)
    masks = [ShardMap(2, i, 8).owned_mask(lat, lng) for i in range(2)]
    for i, mask in enumerate(masks):
        np.save(outdir / f"shard{i}.own.npy", mask)
    chan = str(tmp_path / "chan")
    sup = FleetSupervisor(
        _child(SHARD_STREAM_CHILD), 2,
        RestartPolicy(max_restarts=5, backoff_s=3.0, backoff_max_s=3.0,
                      term_grace_s=1.0, window_s=60.0,
                      stall_timeout_s=120.0),
        env={**CHILD_ENV, "FLEET_OUTDIR": str(outdir),
             "FLEET_CORPUS": str(corpus), "FLEET_BATCH": "4"},
        heartbeat_dir=str(tmp_path), poll_s=0.02, channel_path=chan)
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(sup.run()), daemon=True)
    t.start()
    try:
        off1, pid1 = outdir / "shard1.offset", outdir / "shard1.pid"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if off1.exists() and 0 < int(off1.read_text()) < len(rows) - 8:
                break
            time.sleep(0.01)
        else:
            raise AssertionError("shard1 never got mid-stream")
        ep, degraded = _kill_and_watch(
            chan, lambda: os.kill(int(pid1.read_text()), signal.SIGKILL),
            "shard1")
        assert ep and "shard1" in ep["reason"]
        assert degraded is not None
        t.join(timeout=120)
        assert rcs == [0]
        assert len(open(outdir / "shard1.launches").read().split()) >= 2
        assert open(outdir / "shard0.launches").read().split() == ["launch"]
        owned = [np.flatnonzero(m) for m in masks]
        got0 = [int(x) for x in open(outdir / "shard0.rows").read().split()]
        got1 = [int(x) for x in open(outdir / "shard1.rows").read().split()]
        assert got0 == list(owned[0])
        assert len(got1) - len(set(got1)) <= 4
        assert sorted(set(got0) | set(got1)) == list(range(len(rows)))
        assert not set(got0) & set(got1)
        snap = json.loads(open(member_path(chan, "supervisor")).read())
        assert snap["healthz"]["status"] == "ok"
        assert snap["healthz"]["checks"]["shard0"]["value"] == "done"
        assert snap["healthz"]["checks"]["shard1"]["value"] == "done"
    finally:
        sup.stop()
        t.join(timeout=30)


# --- the entry point --------------------------------------------------------

def test_entry_point_supervise_rules(monkeypatch):
    """--shards > 1 without --supervise exits; an explicit --shards 1
    overrides an inherited fleet env; the child argv carries --device and
    --max-batches; the supervising parent imports no torch."""
    from heatmap_tpu_torch.stream import __main__ as entry
    from heatmap_tpu_torch.stream import supervisor

    with pytest.raises(SystemExit, match="--shards needs --supervise"):
        entry.main(["mbta_default", "--shards", "2"])
    seen = []
    monkeypatch.setattr(supervisor, "supervise_cli",
                        lambda child, shards=1: seen.append(
                            (child, shards, os.environ["HEATMAP_SHARDS"]))
                        or 7)
    monkeypatch.setenv("HEATMAP_SHARDS", "4")
    monkeypatch.setenv("HEATMAP_SHARD_INDEX", "2")
    with pytest.raises(SystemExit) as e:
        entry.main(["synthetic_backfill", "--supervise", "--shards", "1",
                    "--device", "cpu", "--max-batches", "5"])
    assert e.value.code == 7
    child, shards, env_shards = seen[-1]
    assert shards == 1 and env_shards == "1"
    assert os.environ["HEATMAP_SHARD_INDEX"] == "0"
    assert child[1:] == ["-m", "heatmap_tpu_torch.stream",
                         "synthetic_backfill", "--device", "cpu",
                         "--max-batches", "5"]
    monkeypatch.setenv("HEATMAP_SHARDS", "3")
    with pytest.raises(SystemExit):
        entry.main(["--supervise"])
    assert seen[-1][1] == 3
    assert seen[-1][0][-2:] == ["--device", "cuda"]
    prog = ("import sys; sys.path.insert(0, %r)\n"
            "from heatmap_tpu_torch.stream import __main__ as m, "
            "supervisor as s\n"
            "s.supervise_cli = lambda child, shards=1: 0\n"
            "try:\n    m.main(['--supervise', '--shards', '2'])\n"
            "except SystemExit as e:\n    assert e.code == 0\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('torch', 'jax', 'heatmap_tpu')]\n"
            "print('LEAKED', bad)\n" % REPO)
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": ""})
    assert "LEAKED []" in out.stdout, out.stdout + out.stderr


# --- real port children -----------------------------------------------------

FLEET_ENV = {"KAFKA_BOOTSTRAP": "127.0.0.1:1", "BATCH_SIZE": "512",
             "STATE_CAPACITY_LOG2": "12", "HEATMAP_STORE": "jsonl",
             "HEATMAP_SHARD_OVERSAMPLE": "1", "HEATMAP_H3_IMPL": "native",
             "HEATMAP_FLEET_PUBLISH_S": "0.1"}


def test_cli_fleet_of_port_children(tmp_path):
    """``python -m heatmap_tpu_torch.stream --supervise --shards 2
    --device cpu``: two real port children, each folding its own cell
    space into its own JSONL log under the shared checkpoint dir, both
    departing cleanly."""
    from heatmap_tpu_torch.obs.xproc import members_from

    chan = str(tmp_path / "chan")
    env = {**CHILD_ENV, **FLEET_ENV, "CHECKPOINT": str(tmp_path / "ckpt"),
           "HEATMAP_SUPERVISOR_CHANNEL": chan,
           "HEATMAP_SUPERVISE_STARTUP_GRACE_S": "240"}
    p = subprocess.run(
        [sys.executable, "-m", "heatmap_tpu_torch.stream", "mbta_default",
         "--supervise", "--shards", "2", "--device", "cpu",
         "--max-batches", "2"], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    outs = [json.loads(line) for line in p.stdout.splitlines()
            if line.startswith("{")]
    assert len(outs) == 2
    for out in outs:
        assert out["batches"] >= 2 and out["device"] == "cpu"
        assert out["events_out_of_shard"] > 0
    for i in range(2):
        assert (tmp_path / "ckpt" / f"shard{i}" / "store.jsonl").exists()
        assert (tmp_path / "ckpt" / f"shard{i}" / "LATEST").exists()
    # every member departed cleanly: the shards' and the supervisor's
    # snapshots are tombstones
    _, skipped = members_from(chan, max_age_s=3600)
    assert skipped == {"shard0": "left", "shard1": "left",
                       "supervisor": "left"}


FLEET_CHILD = """
import os, sys
from heatmap_tpu_torch.stream.__main__ import build_runtime
from heatmap_tpu_torch.stream.source import SyntheticSource
open(os.environ["CHILD_PID_DIR"] + "/shard" + os.environ["HEATMAP_SHARD_INDEX"]
     + ".pid", "w").write(str(os.getpid()))
rt, store = build_runtime(
    "mbta_default", device="cpu", checkpoint_every=3,
    source=SyntheticSource(n_events=int(os.environ["N_EVENTS"]),
                           n_vehicles=300, events_per_second=8))
try:
    rt.run()
finally:
    store.close()
"""
N_EVENTS = 24 * 512


def test_port_shard_killed_revived_store_converges(tmp_path):
    """Two real port shard children under the fleet supervisor; shard 1
    is SIGKILLed after its first checkpoint.  It is revived and resumes
    from its own namespace, /fleet/healthz names it while it is dark, and
    the merged JSONL store equals one unsharded port fold of the stream."""
    import dataclasses

    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.sink import make_store
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    chan = str(tmp_path / "chan")
    ckpt = tmp_path / "ckpt"
    env = {**CHILD_ENV, **FLEET_ENV, "CHECKPOINT": str(ckpt),
           "CHILD_PID_DIR": str(tmp_path), "N_EVENTS": str(N_EVENTS),
           "TRIGGER_MS": "250", "CITY": "bos"}
    sup = FleetSupervisor(
        _child(FLEET_CHILD), 2,
        RestartPolicy(max_restarts=3, backoff_s=3.0, backoff_max_s=3.0,
                      term_grace_s=5.0, window_s=120.0,
                      stall_timeout_s=120.0, startup_grace_s=240.0),
        env=env, heartbeat_dir=str(tmp_path), poll_s=0.05,
        channel_path=chan)
    rcs = []
    t = threading.Thread(target=lambda: rcs.append(sup.run()), daemon=True)
    t.start()
    try:
        latest = ckpt / "shard1" / "LATEST"
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and not latest.exists():
            time.sleep(0.02)
        assert latest.exists(), "shard1 never committed"
        pid = int((tmp_path / "shard1.pid").read_text())
        ep, degraded = _kill_and_watch(
            chan, lambda: os.kill(pid, signal.SIGKILL), "shard1")
        assert ep and "shard1" in ep["reason"]
        assert degraded is not None, "dead shard never named"
        t.join(timeout=300)
        assert rcs == [0]
        assert sup.children[1].restarts >= 1
        assert sup.children[0].restarts == 0
    finally:
        sup.stop()
        t.join(timeout=30)
    cfg = load_config({**FLEET_ENV, "HEATMAP_SHARDS": "2", "CITY": "bos"},
                      checkpoint_dir=str(ckpt))
    reader = make_store(cfg, writer=False)
    one = MemoryStore()
    MicroBatchRuntime(
        dataclasses.replace(cfg, shards=1, store="memory",
                            checkpoint_dir=str(tmp_path / "one")),
        SyntheticSource(n_events=N_EVENTS, n_vehicles=300,
                        events_per_second=8),
        one, device="cpu", checkpoint_every=0).run()
    assert len(one._tiles) > 100
    assert reader._tiles == one._tiles
    assert reader._positions == one._positions
    reader.close()
