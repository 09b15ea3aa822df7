"""Failure detection and restart for the streaming job: a copy of
``heatmap_tpu/stream/supervisor.py``.

The supervisor runs the streaming job as a child process and restarts it
from its own checkpoint when it crashes, or when it *stalls*: a device op
that never returns shows no exit code.  The runtime's step loop writes a
heartbeat file (``MicroBatchRuntime._touch_heartbeat``, at most 1/s); the
supervisor declares a stall when the beacon goes quiet past
``stall_timeout_s``, kills the child, and restarts it.  The sink's
idempotent upserts and the offsets-after-commit checkpoint discipline make
the replay safe (stream/checkpoint.py).

``FleetSupervisor`` runs N H3-partitioned shard children
(``--supervise --shards N``), each with ``HEATMAP_SHARDS``,
``HEATMAP_SHARD_INDEX``, a heartbeat of its own and the shared channel;
a child that exhausts its budget leaves its shard down and the rest of
the fleet serving.

The reference's platform failover (``failover_after``: restart a failing
child with ``HEATMAP_PLATFORM=cpu``) is refused: the port does not carry
on on the CPU when the card fails, so ``Supervisor`` raises ``ValueError``
when ``failover_after`` is set.  Its default, ``None``, is the
reference's default too.

Usage: ``python -m heatmap_tpu_torch.stream --supervise [pipeline]`` (the
CLI builds the child argv from its own), or programmatically::

    Supervisor([sys.executable, "-m", "heatmap_tpu_torch.stream", "mbta"],
               RestartPolicy(stall_timeout_s=120)).run()
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

from heatmap_tpu_torch.obs import ENV_CHANNEL, SupervisorChannel

log = logging.getLogger("supervisor")


class RestartPolicy(NamedTuple):
    """Restart budget and failure thresholds.

    ``max_restarts`` within ``window_s`` bounds a crash loop (an old
    failure ages out of the budget after the window); exponential
    backoff between restarts keeps a hard-down dependency from being
    hammered."""

    max_restarts: int = 5
    window_s: float = 300.0
    backoff_s: float = 1.0
    backoff_max_s: float = 30.0
    # After the first beacon, a beacon gap past this declares a stall.
    # Legitimate LONG steps mid-run (a kernel library built on first use,
    # a large slab grow) are covered by the runtime's in-flight beacon
    # watchdog (runtime._hb_watchdog_loop), which keeps the beacon alive
    # while a step is in flight for up to HEATMAP_DISPATCH_GRACE_S
    # (default 300 s) — so only an op that outlives BOTH that grace and
    # this timeout is killed.  Raise HEATMAP_DISPATCH_GRACE_S (child
    # env) rather than this if such steps are routinely slower.
    stall_timeout_s: float = 120.0
    # grace before the FIRST beacon: the child's first step builds the
    # kernels (nvcc) and the native codecs, which can take minutes on a
    # cold build directory — killing it mid-build would make supervised
    # mode unable to ever start.  After the first beacon the tighter
    # stall_timeout_s applies.
    startup_grace_s: float = 600.0
    term_grace_s: float = 10.0     # SIGTERM → SIGKILL escalation
    # the reference's platform failover; the port refuses it (Supervisor)
    failover_after: int | None = None

    @classmethod
    def from_env(cls, env=os.environ) -> "RestartPolicy":
        """Env-var form for the CLI (HEATMAP_SUPERVISE_* namespace)."""
        def _f(name, cast, default):
            v = env.get(f"HEATMAP_SUPERVISE_{name}")
            return cast(v) if v not in (None, "") else default

        failover = _f("FAILOVER_AFTER", int, None)
        return cls(
            max_restarts=_f("MAX_RESTARTS", int, cls._field_defaults["max_restarts"]),
            window_s=_f("WINDOW_S", float, cls._field_defaults["window_s"]),
            backoff_s=_f("BACKOFF_S", float, cls._field_defaults["backoff_s"]),
            backoff_max_s=_f("BACKOFF_MAX_S", float,
                             cls._field_defaults["backoff_max_s"]),
            stall_timeout_s=_f("STALL_TIMEOUT_S", float,
                               cls._field_defaults["stall_timeout_s"]),
            startup_grace_s=_f("STARTUP_GRACE_S", float,
                               cls._field_defaults["startup_grace_s"]),
            term_grace_s=_f("TERM_GRACE_S", float,
                            cls._field_defaults["term_grace_s"]),
            failover_after=failover,
        )


class Supervisor:
    def __init__(self, argv: list[str], policy: RestartPolicy | None = None,
                 env: dict | None = None, heartbeat_path: str | None = None,
                 poll_s: float = 0.2, channel_path: str | None = None):
        self.argv = list(argv)
        self.policy = policy or RestartPolicy()
        if self.policy.failover_after is not None:
            raise ValueError(
                "RestartPolicy.failover_after is refused: the port does "
                "not fail over to HEATMAP_PLATFORM=cpu when the card "
                "fails (unset HEATMAP_SUPERVISE_FAILOVER_AFTER)")
        self.env = dict(env if env is not None else os.environ)
        self.heartbeat_path = heartbeat_path or os.path.join(
            tempfile.gettempdir(), f"heatmap-hb-{os.getpid()}")
        self.poll_s = poll_s
        self.restarts = 0            # total child launches after the first
        # cross-process metrics channel (obs.xproc): the child's /metrics
        # merges this file's restart/backoff/failover counters.  The path
        # defaults next to the heartbeat; a caller-supplied STABLE path
        # (or a pre-set env var) also survives supervisor restarts —
        # resume() folds persisted totals back in either way.
        self.channel = SupervisorChannel(
            channel_path or self.env.get(ENV_CHANNEL)
            or self.heartbeat_path + ".chan").resume()
        # resumed launch total: published counters continue from the
        # predecessor supervisor's count instead of resetting to this
        # process's self.restarts
        self._restarts_base = int(self.channel.state["restarts_total"])
        # fleet observatory (obs.fleet): the supervisor is a member too
        # — its snapshot carries the channel counters + its own verdict
        # so /fleet/healthz can see the control plane, not just the
        # children.  Fixed tag: one supervisor per channel (the env
        # HEATMAP_FLEET_TAG names the CHILD runtime, which inherits it).
        self._fleet_tag = "supervisor"
        self._member_pub_last = 0.0
        # A plain bool, NOT a threading.Event: stop() runs inside signal
        # handlers (supervise_cli), and Event.set() acquires the Event's
        # non-reentrant Condition lock — which the interrupted main
        # thread holds in the prologue/epilogue of every wait(), so a
        # badly-timed signal would self-deadlock the supervisor.  A bool
        # store is async-signal-safe; responsiveness comes from _wait()
        # sleeping in poll_s slices (a signal interrupts time.sleep, the
        # handler sets the flag, PEP 475 resumes the <=poll_s remainder,
        # and the slice loop exits — worst-case stop latency poll_s).
        self._stop_flag = False

    # -------------------------------------------------------------- child

    def _spawn(self) -> subprocess.Popen:
        env = dict(self.env)
        env["HEATMAP_HEARTBEAT_FILE"] = self.heartbeat_path
        env[ENV_CHANNEL] = self.channel.path
        try:
            os.remove(self.heartbeat_path)  # age from THIS child's start
        except OSError:
            pass
        log.info("starting child: %s", " ".join(self.argv))
        self.channel.update(
            child_running=1,
            restarts_total=self._restarts_base + self.restarts,
            failed_over=0)
        return subprocess.Popen(self.argv, env=env)

    def _heartbeat_age(self, child_started: float) -> tuple[float, bool]:
        """(seconds since the child last proved liveness, beacon seen):
        age of its latest beacon write, or of its start time if it never
        wrote one (covers a child wedged inside backend init / the first
        compile — judged against startup_grace_s, not stall_timeout_s)."""
        try:
            return (time.monotonic() - max(
                child_started,
                self._mono_of(os.stat(self.heartbeat_path).st_mtime)), True)
        except OSError:
            return time.monotonic() - child_started, False

    @staticmethod
    def _mono_of(wall_ts: float) -> float:
        """Translate a wall-clock mtime onto the monotonic axis."""
        return time.monotonic() - max(0.0, time.time() - wall_ts)

    def _wait(self, seconds: float) -> None:
        """Sleep up to ``seconds``, returning within ``poll_s`` of
        stop() — including stop() from a signal handler.  Every slice
        also rides the fleet member publish (rate-limited inside), so
        the supervisor stays fresh on /fleet/healthz through poll loops
        AND long restart backoffs alike."""
        deadline = time.monotonic() + seconds
        while not self._stop_flag:
            self._publish_member_snapshot()
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(self.poll_s, left))

    def _publish_member_snapshot(self, force: bool = False,
                                 left: bool = False) -> None:
        """Fleet member snapshot for the supervisor itself (obs.xproc):
        channel counters as exposition text + a control-plane verdict.
        Rate-limited to HEATMAP_FLEET_PUBLISH_S (0 disables); guarded —
        telemetry never takes the supervisor down."""
        from heatmap_tpu_torch.obs.xproc import (fleet_publish_s,
                                           publish_member_snapshot,
                                           supervisor_metrics_lines)

        interval = fleet_publish_s()
        if interval <= 0:
            return
        now = time.monotonic()
        if not force and now - self._member_pub_last < interval:
            return
        self._member_pub_last = now
        try:
            chan = SupervisorChannel.metrics_from(self.channel.path)
            lines = supervisor_metrics_lines(chan)
            checks = {
                "child_running": {
                    "value": int(chan.get("child_running", 0)), "ok": True},
            }
            down = bool(chan.get("gave_up"))
            if down:
                checks["supervisor"] = {"value": "gave_up", "ok": False}
            healthz = {
                "ok": not down,
                "status": "down" if down else "ok",
                "checks": checks,
            }
            publish_member_snapshot(
                self.channel.path, self._fleet_tag, role="supervisor",
                metrics_text="\n".join(lines) + ("\n" if lines else ""),
                healthz=healthz, left=left)
        except Exception:  # noqa: BLE001 - never kill the supervise loop
            log.warning("supervisor fleet snapshot publish failed",
                        exc_info=True)

    def _kill(self, proc: subprocess.Popen) -> None:
        """SIGTERM, grace period, SIGKILL."""
        if proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(self.policy.term_grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    # --------------------------------------------------------------- loop

    def run(self) -> int:
        """Supervise until the child exits 0 (done), the restart budget
        is exhausted, or stop() is called.  Returns the final child exit
        code (0 on clean completion)."""
        p = self.policy
        recent: list[float] = []     # monotonic times of recent failures
        backoff = p.backoff_s
        rc = 1
        while not self._stop_flag:
            proc = self._spawn()
            started = time.monotonic()
            reason = None
            healthy_span = 0.0
            while reason is None and not self._stop_flag:
                code = proc.poll()
                if code is not None:
                    if code == 0:
                        log.info("child exited cleanly; done")
                        self.channel.update(child_running=0)
                        # departure tombstone: a finished job leaves
                        # the fleet instead of going "stale" on it
                        self._publish_member_snapshot(force=True,
                                                      left=True)
                        return 0
                    reason = f"exit code {code}"
                    # exit-code failure: the child ran under its own
                    # power until it ended — its lifetime was healthy
                    healthy_span = time.monotonic() - started
                    rc = code
                    break
                age, beacon_seen = self._heartbeat_age(started)
                limit = (p.stall_timeout_s if beacon_seen
                         else max(p.stall_timeout_s, p.startup_grace_s))
                if age > limit:
                    reason = f"stall: no heartbeat for >{limit:.1f}s"
                    # healthy span ends at the LAST beacon, not at kill
                    # time: the stall-detection wait is not health, or a
                    # child that only ever wedged (startup grace > window)
                    # would reset the streak on every iteration and the
                    # budget could never trip
                    healthy_span = max(0.0,
                                       time.monotonic() - started - age)
                    self._kill(proc)
                    rc = 1
                    break
                self._wait(self.poll_s)
            if self._stop_flag:
                self._kill(proc)
                log.info("stopped; child terminated")
                self.channel.update(child_running=0)
                self._publish_member_snapshot(force=True, left=True)
                return 0
            # failure bookkeeping for the child's /metrics and the
            # /healthz restart-rate SLO: timestamps retained for at
            # least an hour (the SLO's rate window)
            self.channel.note_failure(
                reason, stalled=reason.startswith("stall"),
                window_s=max(3600.0, p.window_s))
            # fleet episode correlation (obs.xproc): a dead child is ONE
            # incident across the whole fleet — claim (or join) the
            # episode broadcast so every surviving member's watchdog
            # writes its flight-recorder dump under the same id.  The
            # broadcast itself is a file write; it happens whether or
            # not THIS process records flights.
            from heatmap_tpu_torch.obs.xproc import clear_episode, ensure_episode

            if healthy_span > p.window_s:
                # a failure after a FULL healthy window is a separate
                # incident: close our own previous episode (if it is
                # still broadcast) so this one mints a fresh id — joined
                # stale, the surviving watchdogs would skip it as
                # already-dumped and the new incident would leave no
                # correlated dump set
                clear_episode(self.channel.path, origin=self._fleet_tag)
            episode = ensure_episode(self.channel.path, self._fleet_tag,
                                     f"child failed ({reason})")
            # supervisor-side flight record (obs.flightrec): the child's
            # own recorder misses hard deaths (SIGKILL, a wedged device
            # op the stall detector shot) — dump the PARENT's view so
            # every failure leaves a post-mortem artifact.  Best-effort:
            # dump_snapshot never raises.
            frdir = self.env.get("HEATMAP_FLIGHTREC_DIR")
            if frdir:
                from heatmap_tpu_torch.obs.flightrec import dump_snapshot

                dump_snapshot(frdir, f"supervisor: child failed ({reason})",
                              {"channel": dict(self.channel.state),
                               "argv": self.argv,
                               "restarts": self.restarts,
                               **({"episode": episode} if episode else {})},
                              episode_id=episode.get("episode_id"))
            # forced: the failure bookkeeping (and the open episode)
            # must reach /fleet/healthz now, not a publish-cadence later
            self._publish_member_snapshot(force=True)
            if healthy_span > p.window_s:
                # the child ran healthy for a full budget window before
                # this failure — an isolated blip, not a streak: the
                # backoff starts over
                backoff = p.backoff_s
            now = time.monotonic()
            recent = [t for t in recent if now - t <= p.window_s]
            recent.append(now)
            if len(recent) > p.max_restarts:
                log.error("giving up: %d failures within %.0fs (last: %s)",
                          len(recent), p.window_s, reason)
                self.channel.update(gave_up=1, child_running=0)
                self._publish_member_snapshot(force=True)
                return rc
            log.warning("child failed (%s); restarting in %.1fs "
                        "(%d/%d in window)", reason, backoff,
                        len(recent), p.max_restarts)
            self.restarts += 1
            self.channel.update(
                child_running=0, backoff_s=backoff,
                restarts_total=self._restarts_base + self.restarts)
            self._wait(backoff)
            backoff = min(backoff * 2, p.backoff_max_s)
        if self._stop_flag:  # stop() during backoff = clean stop
            self._publish_member_snapshot(force=True, left=True)
            return 0
        return rc

    def stop(self) -> None:
        """Ask run() to terminate the child and return (signal-safe)."""
        self._stop_flag = True


class _ShardChild:
    """Per-shard lifecycle record of a FleetSupervisor (one child =
    one H3-partitioned runtime shard, stream/shardmap.py)."""

    def __init__(self, index: int, heartbeat_path: str):
        self.index = index
        self.tag = f"shard{index}"
        self.heartbeat_path = heartbeat_path
        self.proc: subprocess.Popen | None = None
        self.started = 0.0
        self.recent: list[float] = []   # monotonic times of failures
        self.backoff = 0.0
        self.next_spawn_at = 0.0        # monotonic; 0 = spawn now
        self.restarts = 0
        self.done = False               # clean exit 0
        self.gave_up = False
        self.rc = 0

    @property
    def terminal(self) -> bool:
        return self.done or self.gave_up


class FleetSupervisor:
    """Spawn/restart/SIGTERM-fanout for the N shard children of a
    partitioned runtime (the single-child Supervisor above runs
    unsharded jobs).

    Every child runs the same argv with a per-shard env:
    ``HEATMAP_SHARDS=N``, ``HEATMAP_SHARD_INDEX=i``, its own heartbeat
    file, and the SHARED supervisor channel — so each shard publishes
    member snapshots tagged ``shard<i>`` and its own per-shard
    checkpoint namespace resumes only its own offsets.  Failure
    handling is per child (stall detection, exponential backoff,
    restart budget); a failure claims/joins ONE fleet episode so every
    member's flight-recorder dump for the incident correlates.  One
    child exhausting its budget marks that shard down (the fleet keeps
    serving its remaining cell space, degraded) rather than killing
    the whole fleet.  Platform failover is not fanned out: a per-shard
    CPU fallback would desync the fleet's partition economics — the
    policy's ``failover_after`` is ignored with a warning."""

    def __init__(self, argv: list[str], n_shards: int,
                 policy: RestartPolicy | None = None,
                 env: dict | None = None, heartbeat_dir: str | None = None,
                 poll_s: float = 0.2, channel_path: str | None = None):
        if n_shards < 2:
            raise ValueError(f"FleetSupervisor needs >= 2 shards, "
                             f"got {n_shards}")
        self.argv = list(argv)
        self.n_shards = int(n_shards)
        self.policy = policy or RestartPolicy()
        if self.policy.failover_after is not None:
            log.warning("fleet mode ignores failover_after: a per-shard "
                        "platform failover would desync the fleet")
        self.env = dict(env if env is not None else os.environ)
        hb_dir = heartbeat_dir or tempfile.gettempdir()
        self.poll_s = poll_s
        self.channel = SupervisorChannel(
            channel_path or self.env.get(ENV_CHANNEL)
            or os.path.join(hb_dir, f"heatmap-fleet-{os.getpid()}.chan")
        ).resume()
        self._restarts_base = int(self.channel.state["restarts_total"])
        self.children = [
            _ShardChild(i, os.path.join(
                hb_dir, f"heatmap-hb-{os.getpid()}-shard{i}"))
            for i in range(n_shards)]
        self.restarts = 0
        self._fleet_tag = "supervisor"
        self._member_pub_last = 0.0
        self._stop_flag = False  # plain bool: signal-safe (see Supervisor)

    # -------------------------------------------------------------- child

    def _spawn(self, ch: _ShardChild) -> None:
        env = dict(self.env)
        env["HEATMAP_SHARDS"] = str(self.n_shards)
        env["HEATMAP_SHARD_INDEX"] = str(ch.index)
        env["HEATMAP_HEARTBEAT_FILE"] = ch.heartbeat_path
        env[ENV_CHANNEL] = self.channel.path
        try:
            os.remove(ch.heartbeat_path)  # age from THIS launch
        except OSError:
            pass
        log.info("starting shard %d: %s", ch.index, " ".join(self.argv))
        ch.proc = subprocess.Popen(self.argv, env=env)
        ch.started = time.monotonic()
        self._publish_state()

    def _kill(self, proc: subprocess.Popen) -> None:
        if proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(self.policy.term_grace_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()

    def _heartbeat_age(self, ch: _ShardChild) -> tuple[float, bool]:
        try:
            return (time.monotonic() - max(
                ch.started,
                Supervisor._mono_of(
                    os.stat(ch.heartbeat_path).st_mtime)), True)
        except OSError:
            return time.monotonic() - ch.started, False

    def _publish_state(self) -> None:
        self.channel.update(
            child_running=sum(1 for c in self.children
                              if c.proc is not None
                              and c.proc.poll() is None),
            restarts_total=self._restarts_base + self.restarts,
            gave_up=int(all(c.gave_up for c in self.children)))

    def _publish_member_snapshot(self, force: bool = False,
                                 left: bool = False) -> None:
        """The fleet supervisor's own member snapshot: channel counters
        plus one check per shard child, so /fleet/healthz names the
        down shard from the control plane's view too."""
        from heatmap_tpu_torch.obs.xproc import (fleet_publish_s,
                                           publish_member_snapshot,
                                           supervisor_metrics_lines)

        interval = fleet_publish_s()
        if interval <= 0:
            return
        now = time.monotonic()
        if not force and now - self._member_pub_last < interval:
            return
        self._member_pub_last = now
        try:
            chan = SupervisorChannel.metrics_from(self.channel.path)
            lines = supervisor_metrics_lines(chan)
            checks = {}
            degraded = False
            for c in self.children:
                running = c.proc is not None and c.proc.poll() is None
                state = ("gave_up" if c.gave_up
                         else "done" if c.done
                         else "running" if running else "backoff")
                ok = not c.gave_up
                degraded |= not ok
                checks[c.tag] = {"value": state, "ok": ok}
            down = all(c.gave_up for c in self.children)
            healthz = {
                "ok": not down,
                "status": ("down" if down
                           else "degraded" if degraded else "ok"),
                "checks": checks,
            }
            publish_member_snapshot(
                self.channel.path, self._fleet_tag, role="supervisor",
                metrics_text="\n".join(lines) + ("\n" if lines else ""),
                healthz=healthz, left=left)
        except Exception:  # noqa: BLE001 - never kill the supervise loop
            log.warning("fleet supervisor snapshot publish failed",
                        exc_info=True)

    def _note_failure(self, ch: _ShardChild, reason: str,
                      healthy_span: float) -> None:
        p = self.policy
        self.channel.note_failure(
            f"{ch.tag}: {reason}", stalled=reason.startswith("stall"),
            window_s=max(3600.0, p.window_s))
        from heatmap_tpu_torch.obs.xproc import clear_episode, ensure_episode

        if healthy_span > p.window_s:
            # separate incident after a full healthy window — same rule
            # as the single-child supervisor: close our own broadcast
            # so this incident mints a fresh id
            clear_episode(self.channel.path, origin=self._fleet_tag)
            ch.recent = []
            ch.backoff = p.backoff_s
        episode = ensure_episode(self.channel.path, self._fleet_tag,
                                 f"{ch.tag} failed ({reason})")
        frdir = self.env.get("HEATMAP_FLIGHTREC_DIR")
        if frdir:
            from heatmap_tpu_torch.obs.flightrec import dump_snapshot

            dump_snapshot(
                frdir, f"fleet supervisor: {ch.tag} failed ({reason})",
                {"channel": dict(self.channel.state), "argv": self.argv,
                 "shard": ch.index, "restarts": ch.restarts,
                 **({"episode": episode} if episode else {})},
                episode_id=episode.get("episode_id"))
        now = time.monotonic()
        ch.recent = [t for t in ch.recent if now - t <= p.window_s]
        ch.recent.append(now)
        if len(ch.recent) > p.max_restarts:
            log.error("%s: giving up — %d failures within %.0fs (last: "
                      "%s); the fleet keeps serving without its cell "
                      "space", ch.tag, len(ch.recent), p.window_s, reason)
            ch.gave_up = True
        else:
            backoff = ch.backoff or p.backoff_s
            log.warning("%s failed (%s); restarting in %.1fs (%d/%d in "
                        "window)", ch.tag, reason, backoff,
                        len(ch.recent), p.max_restarts)
            ch.next_spawn_at = now + backoff
            ch.backoff = min(backoff * 2, p.backoff_max_s)
            ch.restarts += 1
            self.restarts += 1
        self._publish_state()
        self._publish_member_snapshot(force=True)

    # --------------------------------------------------------------- loop

    def run(self) -> int:
        """Supervise until every shard is terminal (exited 0 or
        exhausted its budget) or stop() is called.  Returns 0 when
        every shard ended cleanly (or on stop), else the first failing
        shard's exit code."""
        p = self.policy
        while not self._stop_flag:
            now = time.monotonic()
            for ch in self.children:
                if ch.terminal:
                    continue
                if ch.proc is None:
                    if now >= ch.next_spawn_at:
                        self._spawn(ch)
                    continue
                code = ch.proc.poll()
                if code is not None:
                    ch.proc = None
                    span = time.monotonic() - ch.started
                    if code == 0:
                        log.info("%s exited cleanly", ch.tag)
                        ch.done = True
                        self._publish_state()
                    else:
                        ch.rc = code
                        self._note_failure(ch, f"exit code {code}", span)
                    continue
                age, beacon_seen = self._heartbeat_age(ch)
                limit = (p.stall_timeout_s if beacon_seen
                         else max(p.stall_timeout_s, p.startup_grace_s))
                if age > limit:
                    span = max(0.0, time.monotonic() - ch.started - age)
                    self._kill(ch.proc)
                    ch.proc = None
                    ch.rc = 1
                    self._note_failure(
                        ch, f"stall: no heartbeat for >{limit:.1f}s", span)
            if all(c.terminal for c in self.children):
                break
            self._publish_member_snapshot()
            time.sleep(self.poll_s)
        if self._stop_flag:
            # SIGTERM fanout: every live shard gets the same stop
            for ch in self.children:
                if ch.proc is not None:
                    self._kill(ch.proc)
                    ch.proc = None
            log.info("stopped; %d shard children terminated",
                     self.n_shards)
            self._publish_state()
            self._publish_member_snapshot(force=True, left=True)
            return 0
        self._publish_state()
        clean = all(c.done for c in self.children)
        self._publish_member_snapshot(force=True, left=clean)
        if clean:
            return 0
        return next((c.rc for c in self.children if c.gave_up and c.rc),
                    1)

    def stop(self) -> None:
        """Ask run() to SIGTERM-fanout and return (signal-safe)."""
        self._stop_flag = True


def supervise_cli(child_argv: list[str], shards: int = 1) -> int:
    """CLI glue: run ``child_argv`` under a Supervisor (or, with
    ``shards`` > 1, a FleetSupervisor fanning out N shard children)
    configured from HEATMAP_SUPERVISE_* env vars; SIGTERM/SIGINT stop
    children + parent."""
    if shards > 1:
        sup: "Supervisor | FleetSupervisor" = FleetSupervisor(
            child_argv, shards, RestartPolicy.from_env())
    else:
        sup = Supervisor(child_argv, RestartPolicy.from_env())

    def _on_signal(signum, frame):  # noqa: ARG001
        sup.stop()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    return sup.run()


if __name__ == "__main__":  # pragma: no cover - tiny manual harness
    logging.basicConfig(level=logging.INFO)
    sys.exit(supervise_cli(sys.argv[1:]))
