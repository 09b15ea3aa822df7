"""Cross-process fleet channel (file-backed): supervisor counters,
per-member metrics snapshots, and episode-correlation broadcasts.

A copy of ``heatmap_tpu/obs/xproc.py``, the shard-watermark files
(``<channel>.wm-<tag>``) included.  Every file here is byte-compatible
with the reference's, so members of either package can share one
channel directory.

The supervisor runs the streaming job as a child process; the child
owns the HTTP /metrics endpoint.  Without a channel, the supervisor's
restart/backoff/failover counters — exactly the telemetry that explains
"why did the stream blip" — are invisible to scrapes, and everything
resets when the child dies.

This channel is a single small JSON file written atomically
(tmp + rename) by the supervisor and read by anyone holding the path:

- the supervisor passes the path to the child via
  ``HEATMAP_SUPERVISOR_CHANNEL`` in its env, so the child's /metrics can
  merge ``supervisor_*`` series into its exposition;
- counters survive child restarts trivially (the parent owns them), and
  survive *supervisor* restarts too: ``SupervisorChannel.load()`` at
  startup resumes the persisted totals.

A file (not a pipe/socket) because the reader must never block the
writer, a half-written read must be impossible (rename is atomic on
POSIX), and stale data must be detectable (``updated_unix`` rides in the
payload).

The fleet observatory (obs/fleet.py) extends the same file-per-writer
discipline to three more artifact kinds next to the channel:

- ``<channel>.fresh-<tag>``  — the per-child freshness summary
  (old children keep surfacing as ``heatmap_child_*`` gauges next to
  the richer format below);
- ``<channel>.member-<tag>`` — one member's FULL observability
  snapshot: its metrics-registry exposition text, freshness summary,
  /healthz verdict, and a compact lineage tail
  (:func:`publish_member_snapshot` / :func:`members_from`);
- ``<channel>.episode``      — the fleet-wide episode-correlation
  broadcast: when any member's SLO verdict transitions into degraded,
  it claims one episode ID here so EVERY member's flight-recorder dump
  for the incident carries the same ID (one episode, one dump set;
  :func:`broadcast_episode` / :func:`read_episode`).

Reads are hardened: a torn/corrupt member file, a missing
``updated_unix``, a stale snapshot, or a future-dated clock (skewed
writer) is SKIPPED and reported to the caller — never raised — so one
sick member cannot take down the fleet's aggregated surfaces
(``heatmap_fleet_stale_members`` counts them at /fleet/metrics).
"""

from __future__ import annotations

import json
import logging
import os
import time

log = logging.getLogger(__name__)

ENV_CHANNEL = "HEATMAP_SUPERVISOR_CHANNEL"
# Fleet-observatory knobs (obs/fleet.py shares them):
#   HEATMAP_FLEET_MAX_AGE_S   snapshot staleness window (default 30 s —
#                             members publish every HEATMAP_FLEET_
#                             PUBLISH_S, so a member quiet for this long
#                             is dead or wedged)
#   HEATMAP_FLEET_PUBLISH_S   member snapshot publish cadence (default
#                             2 s; 0 disables publishing)
#   HEATMAP_FLEET_TAG         names the RUNTIME member (default
#                             p<process_index>); serve-only workers
#                             suffix it -serve<pid> (default
#                             serve<pid>) so they never collide with
#                             the runtime on one member file
ENV_FLEET_MAX_AGE = "HEATMAP_FLEET_MAX_AGE_S"
ENV_FLEET_PUBLISH = "HEATMAP_FLEET_PUBLISH_S"
ENV_FLEET_TAG = "HEATMAP_FLEET_TAG"


def fleet_max_age_s(default: float = 30.0) -> float:
    raw = os.environ.get(ENV_FLEET_MAX_AGE, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        log.warning("%s=%r is not a number; using %s",
                    ENV_FLEET_MAX_AGE, raw, default)
        return default


def fleet_publish_s(default: float = 2.0) -> float:
    raw = os.environ.get(ENV_FLEET_PUBLISH, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        log.warning("%s=%r is not a number; using %s",
                    ENV_FLEET_PUBLISH, raw, default)
        return default

# numeric fields exported to /metrics as supervisor_* series; everything
# else in the payload (reason strings, timestamps) serves /trace-style
# debugging via /metrics.json
COUNTER_FIELDS = ("restarts_total", "failures_total", "stalls_total",
                  "failovers_total")
GAUGE_FIELDS = ("failed_over", "backoff_s", "gave_up",
                "recent_failures", "child_running")

# Per-child freshness summary keys (obs.lineage): each CHILD runtime
# publishes these into a sibling file next to the channel
# (``<channel>.fresh-<tag>``, tag = "p<process_index>"), so the process
# that owns /metrics — the child itself, a serve-only process, or a
# multi-host parent holding the same channel path — exposes per-child
# freshness as ``heatmap_child_<key>{child="<tag>"}`` gauges.  Lineage
# itself stays host-local; only this summary crosses processes.
FRESHNESS_FIELDS = ("event_age_p50_s", "event_age_p99_s",
                    "ring_residency_mean_s")


def supervisor_metrics_lines(chan: dict) -> list:
    """Supervisor channel fields -> exposition lines
    (``heatmap_supervisor_*``; xproc names carry their own _total
    suffixes).  Shared by serve/api's /metrics merge and the
    supervisor's OWN fleet member snapshot (stream/supervisor.py) — the
    supervisor process must not import the serve layer to describe
    itself."""
    from heatmap_tpu_torch.obs.registry import _fmt

    lines = []
    for k in COUNTER_FIELDS:
        if isinstance(chan.get(k), (int, float)):
            lines.append(f"# TYPE heatmap_supervisor_{k} counter")
            lines.append(f"heatmap_supervisor_{k} {_fmt(chan[k])}")
    for k in GAUGE_FIELDS:
        if isinstance(chan.get(k), (int, float)):
            lines.append(f"# TYPE heatmap_supervisor_{k} gauge")
            lines.append(f"heatmap_supervisor_{k} {_fmt(chan[k])}")
    return lines


def atomic_write_json(path: str, payload: dict) -> None:
    """THE tmp+rename JSON write (channel, member snapshots, flight
    records, feed meta, history state all use it): a reader can never see a half-written file;
    the tmp is cleaned up on failure and the error re-raised for the
    caller to contextualize."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, separators=(",", ":"))
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def child_freshness_path(channel_path: str, tag: str) -> str:
    return f"{channel_path}.fresh-{tag}"


def publish_child_freshness(channel_path: str, tag: str,
                            summary: dict) -> None:
    """Atomic write of one child's freshness summary next to the
    channel; unwritable degrades to a warning (telemetry must never
    take the pipeline down)."""
    payload = {k: summary[k] for k in FRESHNESS_FIELDS
               if isinstance(summary.get(k), (int, float))}
    payload["updated_unix"] = round(time.time(), 3)
    try:
        atomic_write_json(child_freshness_path(channel_path, tag), payload)
    except OSError as e:
        log.warning("child freshness publish failed: %s", e)


def child_freshness_from(channel_path: str | None,
                         max_age_s: float = 900.0) -> dict:
    """{tag: summary dict} for every published child next to the
    channel; {} when no channel / none published.  Summaries whose
    ``updated_unix`` is older than ``max_age_s`` are dropped — a dead
    child's last file must not keep exporting a frozen-green freshness
    gauge forever (staleness is detectable, per the channel contract)."""
    if not channel_path:
        return {}
    import glob

    now = time.time()
    out = {}
    for p in sorted(glob.glob(glob.escape(channel_path) + ".fresh-*")):
        tag = p.rsplit(".fresh-", 1)[1]
        if ".tmp" in tag:  # in-flight atomic write of any publisher
            continue
        d = SupervisorChannel.load(p)
        upd = d.get("updated_unix")
        if not isinstance(upd, (int, float)) or now - upd > max_age_s:
            continue
        out[tag] = d
    return out


# ---------------------------------------------------------------- fleet
# Full member snapshots: one file per process, next to the channel.
# The freshness-only format above stays untouched (back-compat: old
# children keep publishing .fresh-<tag> files and they keep surfacing
# as heatmap_child_* gauges); the member snapshot is the superset the
# fleet aggregator (obs/fleet.py) federates.

def member_path(channel_path: str, tag: str) -> str:
    return f"{channel_path}.member-{tag}"


def publish_member_snapshot(channel_path: str, tag: str, *, role: str,
                            metrics_text: str = "",
                            freshness: dict | None = None,
                            healthz: dict | None = None,
                            lineage: list | None = None,
                            audit: dict | None = None,
                            cq: dict | None = None,
                            hist: dict | None = None,
                            delivery: dict | None = None,
                            infer: dict | None = None,
                            quality: dict | None = None,
                            left: bool = False) -> None:
    """Atomic write of one member's full observability snapshot:
    Prometheus exposition text of its registry, its freshness summary,
    its /healthz verdict, and a compact lineage tail (lid-keyed stage
    contributions the fleet freshness stitch merges).  Unwritable
    degrades to a warning — telemetry never takes a member down.

    ``audit`` carries the member's integrity-observatory block
    (obs.audit.AuditState.member_block: ledger counts, residuals,
    per-shard digests) — /fleet/audit stitches these cross-process
    exactly as /fleet/freshness stitches lineage; absent when
    HEATMAP_AUDIT is off, keeping snapshots byte-compatible.

    ``cq`` carries the member's continuous-query block
    (query.continuous.ContinuousQueryEngine.member_block: registered
    standing queries, evaluations, matches, eval lag, index size) —
    what ``obs_top --fleet`` renders per serve member; absent on
    members without the engine.

    ``left=True`` marks the snapshot a DEPARTURE tombstone: the member
    closed cleanly and is leaving the fleet on purpose.  Readers
    (``members_from``) report it as neither fresh nor stale — without
    the tombstone a finished bounded job would degrade /fleet/healthz
    as "stale" forever (and deleting its file would flip the reason to
    "vanished" on every live aggregator).  A rejoining member simply
    overwrites its own tombstone."""
    payload = {
        "tag": str(tag),
        "role": str(role),
        "pid": os.getpid(),
        "metrics_text": str(metrics_text),
        "freshness": freshness or {},
        "healthz": healthz or {},
        "lineage": lineage or [],
        "updated_unix": round(time.time(), 3),
    }
    if audit:
        payload["audit"] = audit
    if cq:
        payload["cq"] = cq
    if hist:
        # the member's space-time history block (query/history.py
        # HistoryCompactor.member_block / serve-side
        # compaction_status): chunks, covered span, compaction lag,
        # backfills — absent on members without the tier, keeping
        # snapshots byte-compatible
        payload["hist"] = hist
    if delivery:
        # the member's delivery-lineage block (obs.delivery
        # DeliveryTracker.member_block: delivered-age p50/p99, per-stage
        # p50s, worst stage, residual bound) — /fleet/delivery rolls
        # these up and names the worst replica; absent on members
        # without subscribers or with HEATMAP_DELIVERY off, keeping
        # snapshots byte-compatible
        payload["delivery"] = delivery
    if infer:
        # the member's streaming-inference block (infer.engine
        # InferenceEngine.member_block: entity-table occupancy/capacity,
        # seed/evict/reseed counts, per-reason anomaly totals) — what
        # ``obs_top --fleet`` renders per runtime shard; absent on
        # members without the kalman reducer, keeping snapshots
        # byte-compatible
        payload["infer"] = infer
    if quality:
        # the member's inference-quality block (obs.quality
        # QualityObservatory.member_block: scorecard conservation
        # identity, rolling live skill per (grid, horizon), NIS
        # coverage vs the calibration band, anomaly rates, entity-table
        # pressure) — /fleet/quality plain-sums these and names the
        # worst shard; absent with HEATMAP_QUALITY off, keeping
        # snapshots byte-compatible
        payload["quality"] = quality
    if left:
        payload["left"] = True
    try:
        atomic_write_json(member_path(channel_path, tag), payload)
    except (OSError, TypeError, ValueError) as e:
        log.warning("fleet member snapshot publish failed: %s", e)


def members_from(channel_path: str | None,
                 max_age_s: float | None = None,
                 skew_s: float | None = None) -> tuple[dict, dict]:
    """``({tag: snapshot}, {tag: skip reason})`` for every member file
    next to the channel.  The second dict is the hardening surface: a
    torn/corrupt file, a snapshot whose ``updated_unix`` is older than
    ``max_age_s``, or one dated further than ``skew_s`` into the future
    (a writer with a skewed clock must not masquerade as eternally
    fresh) is skipped WITH its reason instead of raised — the fleet
    aggregator exports the count as ``heatmap_fleet_stale_members``."""
    if not channel_path:
        return {}, {}
    if max_age_s is None:
        max_age_s = fleet_max_age_s()
    if skew_s is None:
        skew_s = max(5.0, max_age_s)
    import glob

    now = time.time()
    members: dict = {}
    skipped: dict = {}
    for p in sorted(glob.glob(glob.escape(channel_path) + ".member-*")):
        tag = p.rsplit(".member-", 1)[1]
        if ".tmp" in tag:  # in-flight atomic write of any publisher
            continue
        try:
            with open(p, "r", encoding="utf-8") as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            # torn write can't happen via atomic_write_json, but a
            # foreign/partial writer (chaos, disk-full cp) can leave one
            skipped[tag] = "corrupt"
            continue
        if isinstance(d, dict) and d.get("left"):
            # departure tombstone: a clean close, not an incident —
            # checked BEFORE staleness so an hours-old tombstone still
            # reads as "left", never degrading the fleet
            skipped[tag] = "left"
            continue
        upd = d.get("updated_unix") if isinstance(d, dict) else None
        if not isinstance(upd, (int, float)):
            skipped[tag] = "corrupt"
            continue
        if now - upd > max_age_s:
            skipped[tag] = f"stale {now - upd:.1f}s"
            continue
        if upd - now > skew_s:
            skipped[tag] = f"clock skew +{upd - now:.1f}s"
            continue
        members[tag] = d
    return members, skipped


# ---------------------------------------------------------- shard wm
# Cross-shard watermark alignment (stream/shardmap.py): each runtime
# shard publishes its event-time high watermark next to the channel;
# every shard's effective cutoff is bounded by the fleet LOW watermark
# (min over fresh peers), so no shard closes (evicts and finalizes) a
# window that a straggling shard is still folding events into.  The
# same file-per-writer, atomic-rename, staleness-detectable discipline
# as every other channel artifact — a dead shard's stale file drops out
# of the bound after ``max_age_s`` instead of freezing eviction
# fleet-wide forever.

def shard_watermark_path(channel_path: str, tag: str) -> str:
    return f"{channel_path}.wm-{tag}"


def publish_shard_watermark(channel_path: str, tag: str,
                            max_event_ts: int) -> None:
    """Atomic write of one shard's event-time high watermark; unwritable
    degrades to a warning (telemetry never takes a shard down)."""
    payload = {"max_event_ts": int(max_event_ts),
               "updated_unix": round(time.time(), 3)}
    try:
        atomic_write_json(shard_watermark_path(channel_path, tag), payload)
    except OSError as e:
        log.warning("shard watermark publish failed: %s", e)


def shard_watermarks_from(channel_path: str | None,
                          max_age_s: float | None = None) -> dict:
    """{tag: max_event_ts} for every FRESH shard watermark next to the
    channel; {} when no channel / none published.  Stale, torn, or
    corrupt files are skipped (never raised): a wedged shard must
    eventually release the fleet low bound, and a sick file must not
    take the step loop down."""
    if not channel_path:
        return {}
    if max_age_s is None:
        max_age_s = fleet_max_age_s()
    import glob

    now = time.time()
    out: dict = {}
    for p in sorted(glob.glob(glob.escape(channel_path) + ".wm-*")):
        tag = p.rsplit(".wm-", 1)[1]
        if ".tmp" in tag:  # in-flight atomic write of any publisher
            continue
        d = SupervisorChannel.load(p)
        ts = d.get("max_event_ts")
        upd = d.get("updated_unix")
        if not isinstance(ts, (int, float)) \
                or not isinstance(upd, (int, float)) \
                or now - upd > max_age_s:
            continue
        out[tag] = int(ts)
    return out


# -------------------------------------------------------------- episode
# Fleet-wide incident correlation: the first member whose SLO verdict
# transitions into degraded claims ONE episode id in this file; every
# other member's watchdog sees it and writes its own flight-recorder
# dump under the same id, so an incident leaves one correlated dump SET
# instead of N unrelated files.

def episode_path(channel_path: str) -> str:
    return channel_path + ".episode"


def broadcast_episode(channel_path: str, origin: str, reason: str) -> str:
    """Claim a fleet episode: write the correlation broadcast and
    return its id ('' when the write failed — degradation handling must
    never depend on a writable channel)."""
    import uuid

    eid = uuid.uuid4().hex[:12]
    payload = {
        "episode_id": eid,
        "origin": str(origin),
        "reason": str(reason)[:300],
        "updated_unix": round(time.time(), 3),
    }
    try:
        atomic_write_json(episode_path(channel_path), payload)
    except (OSError, TypeError, ValueError) as e:
        log.warning("fleet episode broadcast failed: %s", e)
        return ""
    return eid


def read_episode(channel_path: str | None,
                 max_age_s: float = 600.0) -> dict:
    """The current fleet episode broadcast, or {} when none / expired /
    unreadable (same never-raise contract as every channel read)."""
    if not channel_path:
        return {}
    try:
        with open(episode_path(channel_path), "r", encoding="utf-8") as fh:
            d = json.load(fh)
    except (OSError, ValueError):
        return {}
    if not isinstance(d, dict) or not d.get("episode_id"):
        return {}
    upd = d.get("updated_unix")
    if not isinstance(upd, (int, float)) or time.time() - upd > max_age_s:
        return {}
    return d


def clear_episode(channel_path: str | None, origin: str | None = None) -> bool:
    """Close the fleet episode: remove the broadcast file so the NEXT
    incident mints a fresh id instead of being conflated under (and
    dump-suppressed by) this one.  With ``origin`` set, only an episode
    that origin claimed is removed — a member must not close an
    incident some other member is still correlating.  Called on
    recovery (the claiming watchdog's degraded→ok transition) and by
    the supervisor when a failure follows a full healthy window (a
    separate incident, not a continuation).  Never raises; returns
    whether a broadcast was removed."""
    if not channel_path:
        return False
    path = episode_path(channel_path)
    if origin is not None:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                d = json.load(fh)
        except (OSError, ValueError):
            return False
        if not isinstance(d, dict) or d.get("origin") != str(origin):
            return False
    try:
        os.unlink(path)
        return True
    except OSError:
        return False


def ensure_episode(channel_path: str, origin: str, reason: str,
                   max_age_s: float = 600.0) -> dict:
    """Join the fresh fleet episode if one is open, else claim a new
    one — a member degrading WHILE an incident is already broadcast
    must correlate with it, not mint a second id for the same event.

    The claim itself is an O_EXCL create of ``<episode>.claim``:
    without it, two members degrading in the same watchdog tick window
    (a shared-cause incident is exactly when that happens) would both
    read-empty-then-broadcast, the second atomic rename would erase
    the first id, and one incident would leave two uncorrelated dump
    sets.  The winner broadcasts and removes the claim; a loser adopts
    the winner's broadcast (brief re-read), or returns {} and
    correlates on its next tick.  A claim orphaned by a crashed winner
    is swept by mtime so it cannot wedge the NEXT incident."""
    ep = read_episode(channel_path, max_age_s=max_age_s)
    if ep:
        return ep
    claim = episode_path(channel_path) + ".claim"
    try:
        os.close(os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        # another member is claiming right now — adopt its broadcast
        for _ in range(50):
            ep = read_episode(channel_path, max_age_s=max_age_s)
            if ep:
                return ep
            time.sleep(0.01)
        try:  # orphaned claim (winner crashed mid-broadcast): sweep it
            if time.time() - os.path.getmtime(claim) > 10.0:
                os.unlink(claim)
        except OSError:
            pass
        return {}
    except OSError:
        pass  # unwritable channel dir: degrade to best-effort broadcast
    # claim won — but a PREVIOUS winner may have broadcast and removed
    # its claim between our read-empty entry and our O_EXCL create:
    # re-read under the claim and adopt, or our rename would replace
    # its id and split the incident into two uncorrelated dump sets
    ep = read_episode(channel_path, max_age_s=max_age_s)
    if ep:
        try:
            os.unlink(claim)
        except OSError:
            pass
        return ep
    eid = broadcast_episode(channel_path, origin, reason)
    try:
        os.unlink(claim)
    except OSError:
        pass
    return {"episode_id": eid, "origin": str(origin),
            "reason": str(reason)[:300]} if eid else {}


class SupervisorChannel:
    def __init__(self, path: str):
        self.path = path
        self.state: dict = {
            "restarts_total": 0,
            "failures_total": 0,
            "stalls_total": 0,
            "failovers_total": 0,
            "failed_over": 0,
            "gave_up": 0,
            "child_running": 0,
            "backoff_s": 0.0,
            "failure_times": [],     # wall clock of recent failures
            "last_reason": "",
            "started_unix": round(time.time(), 3),
            "updated_unix": 0.0,
        }

    def resume(self) -> "SupervisorChannel":
        """Fold persisted TOTALS back in (a restarted supervisor keeps
        counting where its predecessor stopped).  Point-in-time flags
        (gave_up, failed_over, child_running, backoff_s) deliberately do
        NOT resume: they describe the predecessor process — a fresh
        supervisor is actively supervising again, and carrying a stale
        gave_up=1 would pin /healthz at down (503) forever."""
        prior = self.load(self.path)
        for k in COUNTER_FIELDS:
            if isinstance(prior.get(k), (int, float)):
                self.state[k] = prior[k]
        if isinstance(prior.get("failure_times"), list):
            self.state["failure_times"] = [
                float(t) for t in prior["failure_times"][-64:]
                if isinstance(t, (int, float))]
        return self

    def update(self, **fields) -> None:
        self.state.update(fields)
        self.publish()

    def note_failure(self, reason: str, stalled: bool = False,
                     window_s: float = 3600.0) -> None:
        now = time.time()
        ft = [t for t in self.state["failure_times"] if now - t <= window_s]
        ft.append(now)
        self.state["failure_times"] = ft[-64:]
        self.state["failures_total"] += 1
        if stalled:
            self.state["stalls_total"] += 1
        self.state["last_reason"] = str(reason)[:200]
        self.publish()

    def publish(self) -> None:
        """Atomic write; an unwritable channel degrades to a warning —
        telemetry must never take the supervisor down."""
        self.state["updated_unix"] = round(time.time(), 3)
        try:
            atomic_write_json(self.path, self.state)
        except OSError as e:
            log.warning("supervisor channel write failed: %s", e)

    @staticmethod
    def load(path: str | None) -> dict:
        """Read a channel file; {} when absent/unreadable/corrupt (a
        scrape must never 500 because the supervisor died mid-write —
        which the atomic rename already precludes — or never existed)."""
        if not path:
            return {}
        try:
            with open(path, "r", encoding="utf-8") as fh:
                d = json.load(fh)
            return d if isinstance(d, dict) else {}
        except (OSError, ValueError):
            return {}

    @staticmethod
    def metrics_from(path: str | None,
                     rate_window_s: float = 3600.0) -> dict:
        """Flatten a channel file into /metrics-ready numeric fields,
        with the derived recent-failure count the /healthz restart-rate
        SLO evaluates.  {} when no channel."""
        d = SupervisorChannel.load(path)
        if not d:
            return {}
        now = time.time()
        ft = [t for t in d.get("failure_times", ())
              if isinstance(t, (int, float)) and now - t <= rate_window_s]
        out = {"recent_failures": len(ft)}
        for k in (*COUNTER_FIELDS, "failed_over", "gave_up",
                  "child_running", "backoff_s"):
            v = d.get(k)
            if isinstance(v, (int, float)):
                out[k] = v
        return out
