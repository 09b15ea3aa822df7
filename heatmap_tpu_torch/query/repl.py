"""Delta-log view replication: writer-published feed, zero-store-read replicas.

A copy of ``heatmap_tpu/query/repl.py`` without its delivery-lineage
(``HEATMAP_DELIVERY`` publish stamps, ``pt``) and integrity-audit
(per-record ``"dg"`` verification) branches: both belong to
integrity and delivery (ROADMAP A6c), ``load_config`` refuses ``HEATMAP_DELIVERY``,
and the port's feed bytes equal an unaudited reference writer's with the
knob off.

The materialized view decouples reads from the Store for ONE process; a
serve-only replica still rebuilt its view by store-scan polling
(``StoreViewRefresher``), re-coupling the read fleet to the Store
exactly when fan-out matters.  This module ships the view's own
mutation stream — the same bounded per-grid delta protocol
``/api/tiles/delta`` already replays byte-exactly from ``since=0`` —
over a replication channel, so any number of serve workers hold a hot,
seq-consistent ``TileMatView`` with zero steady-state store reads
(precomputed, replicated, delta-refreshed views in front of the
compute tier).

Feed anatomy (one directory per writer, ``HEATMAP_REPL_DIR``):

- ``meta.json`` — the feed header, atomically rewritten
  (obs.xproc.atomic_write_json): ``epoch`` (a per-boot nonce), the
  newest published ``last_seq``, the oldest record seq still retained
  (``min_seq``), the latest snapshot's seq, and ``updated_unix`` (the
  staleness signal every channel artifact carries).
- ``snapshot-<epoch>.json`` — the full view state at one seq
  (``TileMatView.export_state``), atomically rewritten on every
  segment rotation.  Catch-up is snapshot-then-tail: a follower that
  predates the oldest retained segment re-bootstraps from here.
- ``seg-<epoch>-<startseq>.jsonl`` — the mutation records themselves,
  one JSON line per seq-advancing view mutation ({"kind":
  "apply"|"evict"|"resync", "seq", ...}), appended by the publisher
  thread and rotated at ``HEATMAP_REPL_SEG_BYTES``; the newest
  ``HEATMAP_REPL_SEGMENTS`` segments are retained (older ones are
  covered by the rotation-time snapshot).

Epoch/seq invariants:

- seqs are the writer view's own ``view_seq`` — strictly increasing
  within an epoch, never reused, so a replica's ``/api/tiles/delta``
  seq stream is interchangeable with the writer's;
- the epoch nonce changes on every writer boot and prefixes every
  artifact, so a restarted writer (whose seq counter restarts) can
  never splice stale records into a new feed: a follower that sees the
  epoch change discards EVERYTHING and re-bootstraps from the new
  epoch's snapshot — the stale tail is unreachable by construction;
- records ≤ the replica's applied seq are skipped (snapshot + tail
  overlap is idempotent).

Transports: :class:`FileFeedSource` tails the directory directly
(same-host fleets — the file-per-writer, atomic-rename,
staleness-detectable discipline of obs/xproc.py); for remote replicas
the writer's serve app exposes the same three artifacts over HTTP
(``/api/repl/meta``, ``/api/repl/snapshot``, ``/api/repl/feed`` —
serve/api.py) and :class:`HttpFeedSource` consumes them over plain
TCP long-polls.  Records ride JSON with tagged datetimes
(``{"$dt": iso}``) that round-trip exactly, so a replica's rendered
bytes equal the writer's.

``ReplicaViewFollower`` drives a replica-mode ``TileMatView`` from any
source: snapshot bootstrap, tail apply through the same
``TileMatView`` mutation path the writer uses (ETag/delta/SSE/topk/
pyramid all work unchanged), seq-lag + staleness gauges, and a
degraded-until-first-snapshot /healthz contract with exponential
retry backoff.
"""

from __future__ import annotations

import collections
import datetime as dt
import glob
import json
import logging
import os
import threading
import time
import uuid

from heatmap_tpu_torch.obs.xproc import atomic_write_json, fleet_max_age_s

log = logging.getLogger(__name__)

META = "meta.json"


# ---------------------------------------------------------------- codec
def _enc_default(o):
    if isinstance(o, dt.datetime):
        return {"$dt": o.isoformat()}
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


def _dec_hook(d: dict):
    if len(d) == 1 and "$dt" in d:
        return dt.datetime.fromisoformat(d["$dt"])
    return d


def dumps(obj) -> str:
    """Feed-record JSON: compact, with datetimes tagged ``{"$dt": iso}``
    so they round-trip to equal datetime objects — the replica's
    rendered response bytes must equal the writer's."""
    return json.dumps(obj, separators=(",", ":"), default=_enc_default)


def loads(s: str):
    return json.loads(s, object_hook=_dec_hook)


# ------------------------------------------------------------- publisher
class DeltaLogPublisher:
    """Publishes a ``TileMatView``'s mutation stream as the replication
    feed.  The view's hook (called under the view lock) only enqueues;
    a daemon thread drains to the segment log every ``flush_s`` and
    heartbeats ``meta.json`` so followers can tell a quiet writer from
    a dead one.  One publisher per feed directory — the boot sweep
    removes every prior epoch's artifacts."""

    def __init__(self, view, feed_dir: str, seg_bytes: int = 1 << 22,
                 segments: int = 4, flush_s: float = 0.05,
                 registry=None, start: bool = True, hist=None):
        self.view = view
        self.dir = feed_dir
        # space-time history hand-off (query/history.py HistoryLog,
        # HEATMAP_HIST_DIR): with it, rotated segments are RETIRED into
        # the durable log instead of deleted, and every snapshot is
        # adopted as a view-at-seq replay base — the feed becomes the
        # system's log of record instead of a replication detail
        self.hist = hist
        self.seg_bytes = max(4096, int(seg_bytes))
        self.segments = max(1, int(segments))
        self.flush_s = flush_s
        self.epoch = uuid.uuid4().hex[:12]
        self._q: collections.deque = collections.deque()
        self._io_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._fh = None
        self._fh_bytes = 0
        self._last_seq = 0
        self._min_seq = 1          # oldest record seq still on disk
        self._snapshot_seq = 0
        self._meta_beat = 0.0
        self._c_published = self._g_feed_seq = None
        if registry is not None:
            self._c_published = registry.counter(
                "heatmap_repl_published_total",
                "view mutation records appended to the replication "
                "feed (one per seq-advancing view apply/evict/resync)")
            self._g_feed_seq = registry.gauge(
                "heatmap_repl_feed_seq",
                "newest view seq published to the replication feed",
                fn=lambda: self._last_seq)
        os.makedirs(feed_dir, exist_ok=True)
        # boot sweep: a restarted writer's stale epoch must be
        # unreachable — followers pin the epoch, and these files would
        # otherwise accumulate forever.  With history attached, the
        # dead epoch's segments (including its never-rotated live
        # tail, which a crash left behind) RETIRE into the durable log
        # instead of vanishing — a writer crash loses no history.
        for p in glob.glob(os.path.join(glob.escape(feed_dir),
                                        "seg-*.jsonl")):
            if self.hist is not None:
                self.hist.retire(p)
            else:
                try:
                    os.remove(p)
                except OSError:
                    pass
        for p in glob.glob(os.path.join(glob.escape(feed_dir),
                                        "snapshot-*.json")):
            try:
                os.remove(p)
            except OSError:
                pass
        # hook BEFORE the boot snapshot: a mutation landing between the
        # two would otherwise be in neither (not exported, not hooked) —
        # a permanent seq gap no follower could cross.  With this order
        # a mutation is in the snapshot, the queue, or both (overlap is
        # idempotent: followers skip records ≤ their seq).
        view.set_hook(self._q.append)
        with self._io_lock:
            self._write_snapshot()
            self._open_segment(self._last_seq + 1)
            self._write_meta()
        if start:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="repl-publisher")
            self._thread.start()

    # the hook target is the deque's own append (atomic, lock-free, and
    # safe under the view lock); everything below runs on the publisher
    # thread or the closing caller

    def _seg_path(self, start_seq: int) -> str:
        return os.path.join(self.dir,
                            f"seg-{self.epoch}-{start_seq:012d}.jsonl")

    def _open_segment(self, start_seq: int) -> None:
        self._fh_path = self._seg_path(start_seq)
        self._fh = open(self._fh_path, "a", encoding="utf-8")
        self._fh_bytes = 0

    def _write_snapshot(self) -> None:
        state = self.view.export_state()
        self._snapshot_seq = state["seq"]
        self._last_seq = max(self._last_seq, state["seq"])
        payload = json.loads(dumps({"epoch": self.epoch,
                                    "seq": state["seq"],
                                    "state": state}))
        atomic_write_json(
            os.path.join(self.dir, f"snapshot-{self.epoch}.json"),
            payload)
        if self.hist is not None:
            # every snapshot (boot + each rotation) is a replay base:
            # retention can then prune old segments without orphaning
            # view-at-seq reconstruction of the retained tail
            self.hist.adopt_snapshot(self.epoch, state["seq"], payload)

    def _write_meta(self, closed: bool = False) -> None:
        payload = {
            "epoch": self.epoch,
            "last_seq": self._last_seq,
            "min_seq": self._min_seq,
            "snapshot_seq": self._snapshot_seq,
            "updated_unix": round(time.time(), 3),
        }
        if closed:
            payload["closed"] = True
        atomic_write_json(os.path.join(self.dir, META), payload)
        self._meta_beat = time.monotonic()

    def _rotate(self) -> None:
        self._fh.close()
        # snapshot FIRST: every record in the segments about to be
        # pruned is ≤ the snapshot's seq, so a follower that lost the
        # tail race re-bootstraps without a gap
        self._write_snapshot()
        segs = sorted(glob.glob(os.path.join(glob.escape(self.dir),
                                             f"seg-{self.epoch}-*.jsonl")))
        # the bound counts the live segment about to open: keep the
        # newest (segments - 1) rotated ones
        keep = self.segments - 1
        drop = segs if keep == 0 else segs[:-keep]
        for p in drop:
            # hand rotated segments to the history tier instead of
            # deleting them (query/history.py): the chunk compactor
            # owns their lifetime from here, and prune ordering (chunk
            # written + digest-verified first) guarantees zero loss
            if self.hist is not None:
                self.hist.retire(p)
            else:
                try:
                    os.remove(p)
                except OSError:
                    pass
        segs = segs[len(drop):]
        self._min_seq = (_seg_start(segs[0]) if segs
                         else self._last_seq + 1)
        self._open_segment(self._last_seq + 1)

    def flush(self) -> int:
        """Drain the queue to the segment log; returns records written.
        Called by the publisher thread, close(), and tests (which drive
        the feed synchronously)."""
        wrote = 0
        with self._io_lock:
            if self._fh is None:
                return 0
            while self._q:
                # peek-then-pop: an encode/write/rotate failure leaves
                # the record QUEUED for the next flush — popping first
                # would drop it and punch a permanent seq gap into the
                # feed (every follower would loop bootstrap→gap until
                # the next rotation snapshot finally covered the hole)
                rec = dict(self._q[0])
                rec["t"] = round(time.time(), 3)
                line = dumps(rec) + "\n"
                if (self._fh_bytes and
                        self._fh_bytes + len(line) > self.seg_bytes):
                    self._rotate()
                self._fh.write(line)
                self._fh_bytes += len(line)
                self._q.popleft()
                self._last_seq = max(self._last_seq, int(rec["seq"]))
                wrote += 1
                if self._c_published is not None:
                    self._c_published.inc()
            if wrote:
                self._fh.flush()
            if wrote or time.monotonic() - self._meta_beat >= 1.0:
                # heartbeat even when idle: followers must be able to
                # tell "quiet writer" from "dead writer"
                try:
                    self._write_meta()
                except OSError as e:
                    log.warning("repl meta write failed: %s", e)
        return wrote

    def _run(self) -> None:
        while not self._stop.wait(self.flush_s):
            try:
                self.flush()
            except Exception:
                log.exception("replication feed flush failed")

    def close(self) -> None:
        """Final drain + a ``closed`` meta marker (planned shutdown:
        replicas keep serving the last state without alarming on feed
        staleness the way they would for a vanished writer)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self.flush()
        except Exception:
            log.exception("replication feed final flush failed")
        with self._io_lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError as e:
                    # never raise out of close(): the runtime's
                    # teardown finally still has work to do after us
                    log.warning("repl segment close failed: %s", e)
                self._fh = None
                if self.hist is not None:
                    # clean shutdown completes the history: snapshot
                    # FIRST (so a late follower still catches up
                    # without the retired tail), then retire the live
                    # segment into the durable log
                    try:
                        self._write_snapshot()
                        self.hist.retire(self._fh_path)
                        self._min_seq = self._last_seq + 1
                    except OSError as e:
                        log.warning("history tail retire failed: %s",
                                    e)
            try:
                self._write_meta(closed=True)
            except OSError as e:
                log.warning("repl close meta write failed: %s", e)


def _seg_start(path: str) -> int:
    try:
        return int(os.path.basename(path).rsplit("-", 1)[1]
                   .split(".", 1)[0])
    except (IndexError, ValueError):
        return 1 << 62


# --------------------------------------------------------------- readers
def read_meta(feed_dir: str) -> dict:
    """The feed header; {} when absent/corrupt (never raises — the
    same contract as every channel read)."""
    try:
        with open(os.path.join(feed_dir, META), encoding="utf-8") as fh:
            d = json.load(fh)
        return d if isinstance(d, dict) and d.get("epoch") else {}
    except (OSError, ValueError):
        return {}


def read_snapshot(feed_dir: str, epoch: str) -> dict | None:
    """The epoch's snapshot ({"epoch", "seq", "state"}) or None."""
    try:
        with open(os.path.join(feed_dir, f"snapshot-{epoch}.json"),
                  encoding="utf-8") as fh:
            d = loads(fh.read())
    except (OSError, ValueError):
        return None
    if not isinstance(d, dict) or d.get("epoch") != epoch:
        return None
    return d


def read_records(feed_dir: str, epoch: str, since: int,
                 max_n: int = 512) -> list:
    """Decoded feed records with seq > ``since``, in seq order, capped
    at ``max_n``.  A torn tail line (mid-append read) stops the scan —
    the next poll completes it.  Stale-epoch segments never match the
    glob, so a restarted writer's old tail is unreachable."""
    segs = sorted(glob.glob(os.path.join(
        glob.escape(feed_dir), f"seg-{glob.escape(epoch)}-*.jsonl")))
    # start at the newest segment that can contain since+1
    starts = [_seg_start(p) for p in segs]
    first = 0
    for i, s in enumerate(starts):
        if s <= since + 1:
            first = i
    out: list = []
    for p in segs[first:]:
        try:
            with open(p, encoding="utf-8") as fh:
                raw = fh.read()
        except OSError:
            continue
        for line in raw.splitlines():
            if not line:
                continue
            # cheap prefilter: a caught-up follower re-reads the live
            # segment every poll tick, and fully JSON-decoding
            # thousands of already-applied lines just to discard them
            # on seq is the dominant steady-state cost — records are
            # written {"kind": ..., "seq": N, ...}, so the seq parses
            # out of the prefix without touching the doc payload
            pos = line.find('"seq":')
            if pos > 0:
                end = line.find(",", pos + 6)
                try:
                    if int(line[pos + 6:end if end > 0 else None]) \
                            <= since:
                        continue
                except ValueError:
                    pass  # odd framing: fall through to the full parse
            try:
                rec = loads(line)
            except ValueError:
                # torn tail of the live segment; retry next poll
                return out
            if not isinstance(rec, dict):
                continue
            if int(rec.get("seq", 0)) <= since:
                continue
            out.append(rec)
            if len(out) >= max_n:
                return out
    return out


class FileFeedSource:
    """Same-host transport: tail the feed directory directly."""

    def __init__(self, feed_dir: str):
        self.dir = feed_dir

    def meta(self) -> dict:
        return read_meta(self.dir)

    def snapshot(self, epoch: str) -> dict | None:
        return read_snapshot(self.dir, epoch)

    def records(self, epoch: str, since: int, max_n: int = 512) -> list:
        return read_records(self.dir, epoch, since, max_n)


class HttpFeedSource:
    """Remote transport: the writer's serve app re-exposes the feed at
    /api/repl/* (serve/api.py); this polls it over plain TCP.  Errors
    raise to the follower, which counts them and backs off.  Each poll
    is one urllib request — a fresh connection per call — so the feed
    endpoints work identically behind either serve core (the epoll
    core, like wsgiref, answers HTTP/1.0 close-per-request; nothing
    here assumes keep-alive)."""

    def __init__(self, base_url: str, timeout_s: float = 10.0):
        self.base = base_url.rstrip("/")
        self.timeout_s = timeout_s

    def _get(self, path: str):
        import urllib.request

        req = urllib.request.Request(self.base + path)
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return loads(r.read().decode("utf-8"))

    def meta(self) -> dict:
        d = self._get("/api/repl/meta")
        return d if isinstance(d, dict) and d.get("epoch") else {}

    def snapshot(self, epoch: str) -> dict | None:
        from urllib.parse import quote

        try:
            d = self._get(f"/api/repl/snapshot?epoch={quote(epoch)}")
        except OSError:
            return None
        if not isinstance(d, dict) or d.get("epoch") != epoch:
            return None
        return d

    def records(self, epoch: str, since: int, max_n: int = 512) -> list:
        from urllib.parse import quote

        d = self._get(f"/api/repl/feed?epoch={quote(epoch)}"
                      f"&since={int(since)}&max={int(max_n)}")
        recs = d.get("records") if isinstance(d, dict) else None
        return recs if isinstance(recs, list) else []


def feed_source(feed: str):
    """``HEATMAP_REPL_FEED`` value -> transport: an http(s):// URL gets
    the TCP transport, anything else is a same-host directory."""
    if feed.startswith("http://") or feed.startswith("https://"):
        return HttpFeedSource(feed)
    return FileFeedSource(feed)


# --------------------------------------------------------------- follower
class ReplicaViewFollower:
    """Drives a replica-mode ``TileMatView`` from a feed source.

    Snapshot-then-tail: bootstrap from the epoch's snapshot, then apply
    records through ``TileMatView.replica_apply`` — the same mutation
    path the writer's own applies take, so every serving surface works
    unchanged on the replica.  Re-bootstraps on: epoch change (writer
    restart — the stale tail is rejected wholesale), falling behind the
    oldest retained segment, or a view seq that moved underneath us
    (the store-scan fallback touched the view while we were unhealthy).

    Catch-up failures retry with exponential backoff, and /healthz
    stays DEGRADED until the first snapshot applies — a replica must
    never report ok-but-empty."""

    def __init__(self, view, source, poll_s: float = 0.2,
                 registry=None, clock=time.time, hist_source=None):
        self.view = view
        self.source = source
        self.poll_s = max(0.01, float(poll_s))
        self.clock = clock
        # space-time history cold-start backfill (query/history.py):
        # after every snapshot bootstrap, pre-snapshot windows still
        # inside their TTL are restored into the view from the chunk
        # store — a writer restart that shrank the snapshot no longer
        # silently narrows this replica's history.  The pending flag
        # keeps retrying while the bootstrapped view is still empty (a
        # fresh writer's boot snapshot has no grids to anchor on yet).
        self.hist_source = hist_source
        self._backfill_pending = False
        self._backfill_tries = 0
        self.epoch: str | None = None
        self.applied = 0
        self.synced = False
        self.closed_feed = False
        self._need_resync = False
        self._last_seq_seen = 0
        self._last_rec_t: float | None = None
        self._meta_updated: float | None = None
        # staleness is anchored to the LOCAL monotonic receipt time of
        # a meta heartbeat CHANGE, never to the writer's wall clock —
        # on the cross-host HTTP transport a skewed writer clock must
        # not mark a perfectly synced replica permanently unhealthy
        self._meta_seen_mono: float | None = None
        self._backoff = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.c_applied = self.c_snapshots = self.c_errors = None
        self.c_fallback = self.c_backfill = None
        self._g_lag = self._g_lag_s = self._g_synced = None
        if registry is not None:
            self.c_applied = registry.counter(
                "heatmap_repl_applied_total",
                "replication feed records applied to this replica's "
                "materialized view")
            self.c_snapshots = registry.counter(
                "heatmap_repl_snapshot_loads_total",
                "full snapshot bootstraps (first catch-up, writer "
                "epoch change, log-horizon overrun, post-fallback "
                "resync)")
            self.c_errors = registry.counter(
                "heatmap_repl_errors_total",
                "replication catch-up attempts that failed (feed "
                "unreadable, transport error, missing snapshot) and "
                "were retried with backoff")
            self.c_fallback = registry.counter(
                "heatmap_repl_fallback_total",
                "requests served through the demoted store-scan "
                "fallback because the replication follower was not "
                "synced or its feed went stale — 0 in a healthy "
                "replicated fleet")
            self._g_lag = registry.gauge(
                "heatmap_repl_seq_lag",
                "view seqs the replica is behind the writer's "
                "published feed head")
            self._g_lag_s = registry.gauge(
                "heatmap_repl_lag_seconds",
                "replication lag in seconds: 0 when caught up to a "
                "fresh feed, else the age of the newest applied record")
            self._g_synced = registry.gauge(
                "heatmap_repl_synced",
                "1 once the first snapshot applied (until then the "
                "replica reports degraded, never ok-but-empty)")
            self.c_backfill = registry.counter(
                "heatmap_hist_backfill_total",
                "pre-snapshot windows cold-start backfilled into this "
                "replica's view from the space-time history chunks "
                "(query/history.py) after a snapshot bootstrap")

    # ------------------------------------------------------------- state
    def seq_lag(self) -> int:
        return max(0, self._last_seq_seen - self.applied)

    def lag_s(self) -> float:
        """0 when fully caught up; while behind, how far the replica's
        content trails the writer — a WRITER-clock difference (feed
        head publish time minus the newest applied record's publish
        time), so cross-host clock skew cancels out."""
        if self.applied >= self._last_seq_seen:
            return 0.0
        if self._meta_updated is None:
            return float("inf")
        anchor = self._last_rec_t
        if anchor is None:
            return float("inf")
        return max(0.0, self._meta_updated - anchor)

    def feed_age_s(self) -> float | None:
        """Seconds since a meta heartbeat CHANGE was last observed, on
        the follower's own monotonic clock (skew-immune)."""
        if self._meta_seen_mono is None:
            return None
        return max(0.0, time.monotonic() - self._meta_seen_mono)

    def healthy(self) -> bool:
        """Synced and the feed is fresh (or cleanly closed) — the gate
        for serving from the replica WITHOUT the store-scan fallback.
        A lagging-but-alive feed stays healthy here (the replica's
        bounded-stale view beats a store scan that would fork its seq
        stream); the lag SLO degrades /healthz instead."""
        if not self.synced:
            return False
        if self.closed_feed:
            return True
        age = self.feed_age_s()
        return age is not None and age <= fleet_max_age_s()

    def healthz_checks(self, lag_budget_s: float) -> tuple[dict, bool]:
        """({check: ...}, degraded) for /healthz: not-synced degrades
        (never ok-but-empty), replication lag past the SLO degrades,
        and a stale (not closed) feed degrades."""
        checks: dict = {}
        degraded = False
        checks["repl_synced"] = {"value": bool(self.synced),
                                 "ok": bool(self.synced)}
        degraded |= not self.synced
        lag = self.lag_s()
        ok = lag <= lag_budget_s
        checks["repl_lag_s"] = {
            "value": round(lag, 3) if lag != float("inf") else "inf",
            "budget": lag_budget_s, "ok": ok,
            "seq_lag": self.seq_lag()}
        degraded |= not ok
        age = self.feed_age_s()
        if age is not None and not self.closed_feed:
            budget = fleet_max_age_s()
            ok = age <= budget
            checks["repl_feed_age_s"] = {"value": round(age, 3),
                                         "budget": budget, "ok": ok}
            degraded |= not ok
        return checks, degraded

    # ------------------------------------------------------------- drive
    def step(self, max_n: int = 512) -> int:
        """One catch-up round; returns records applied.  Raises on feed
        trouble (the thread loop counts + backs off; tests drive this
        synchronously)."""
        meta = self.source.meta()
        if not meta:
            raise OSError("replication feed has no readable meta")
        upd = meta.get("updated_unix")
        if upd != self._meta_updated or self._meta_seen_mono is None:
            self._meta_seen_mono = time.monotonic()
        self._meta_updated = upd
        self.closed_feed = bool(meta.get("closed"))
        self._last_seq_seen = max(self._last_seq_seen
                                  if meta.get("epoch") == self.epoch
                                  else 0,
                                  int(meta.get("last_seq", 0)))
        if (meta.get("epoch") != self.epoch or self._need_resync
                or self.view.seq != self.applied):
            snap = self.source.snapshot(meta["epoch"])
            if snap is None:
                raise OSError(f"no snapshot for epoch {meta['epoch']!r}")
            self.view.replica_reset(snap["state"])
            self.epoch = snap["epoch"]
            self.applied = int(snap["state"].get("seq", 0))
            # the snapshot is as fresh as the meta we just read: seed
            # the lag anchor so a just-bootstrapped-but-behind replica
            # reports a finite lag instead of flapping on "unknown"
            self._last_rec_t = self._meta_updated
            self._need_resync = False
            self.synced = True
            if self.c_snapshots is not None:
                self.c_snapshots.inc()
            log.info("replica bootstrapped from snapshot: epoch=%s "
                     "seq=%d", self.epoch, self.applied)
            self._backfill_pending = self.hist_source is not None
            self._backfill_tries = 0
        min_seq = int(meta.get("min_seq", 1))
        if self.applied + 1 < min_seq and self._last_seq_seen > self.applied:
            # fell behind the retained log: records we need were
            # pruned — the rotation-time snapshot covers them
            self._need_resync = True
            raise OSError(f"behind the feed horizon (applied "
                          f"{self.applied} < min {min_seq}); "
                          f"re-bootstrapping")
        n = 0
        recs = self.source.records(self.epoch, self.applied, max_n)
        for rec in recs:
            # feed seqs are DENSE within an epoch (every view seq
            # advance publishes exactly one record), so a gap here
            # means records were lost (pruned mid-read, corrupt line):
            # applying past it would silently diverge — re-bootstrap
            if int(rec.get("seq", 0)) != self.applied + 1:
                self._need_resync = True
                raise OSError(
                    f"feed gap: expected seq {self.applied + 1}, got "
                    f"{rec.get('seq')}; re-bootstrapping from snapshot")
            if self.view.seq != self.applied:
                # someone else (a late store-scan fallback racing the
                # first bootstrap) claimed a seq under us: replica_apply
                # would silently skip the writer's record for that seq
                # and the divergence would become undetectable — resync
                self._need_resync = True
                raise OSError("view seq forked under the follower; "
                              "re-bootstrapping from snapshot")
            self.view.replica_apply(rec)
            self.applied = max(self.applied, int(rec.get("seq", 0)))
            t = rec.get("t")
            if isinstance(t, (int, float)):
                self._last_rec_t = t
            n += 1
            if self.c_applied is not None:
                self.c_applied.inc()
        self._last_seq_seen = max(self._last_seq_seen, self.applied)
        if self._backfill_pending:
            # AFTER the tail applies: additive only (never touches
            # latest/seq), and a failure must not fail the catch-up
            # round that just succeeded.  Stays pending until the view
            # has at least one anchorable grid — a fresh writer's boot
            # snapshot is empty, and its first windows arrive by tail.
            try:
                n_bf, anchored = self._backfill()
                self._backfill_tries += 1
                # bounded retries: a chunk store holding only grids
                # this feed never serves (relabeled resolutions) must
                # not rescan the full index on every poll forever
                if anchored or self._backfill_tries >= 20:
                    self._backfill_pending = False
                if n_bf:
                    log.info("replica backfilled %d pre-snapshot "
                             "window(s) from history chunks", n_bf)
            except Exception:  # noqa: BLE001 - history is best-effort here
                # a TRANSIENT index/chunk read failure keeps the
                # backfill pending (retried next poll, same bounded
                # tries) — one connection reset at bootstrap must not
                # silently narrow the replica's history for good
                self._backfill_tries += 1
                if self._backfill_tries >= 20:
                    self._backfill_pending = False
                log.warning("history backfill attempt failed (retrying"
                            " up to %d times)",
                            20 - self._backfill_tries, exc_info=True)
        self._gauges()
        return n

    def _backfill(self) -> tuple[int, bool]:
        """Install pre-snapshot, still-inside-TTL windows from the
        history chunk store into the replica view (additive: no seq
        advance, no hooks, latest window untouched).  Returns (windows
        installed — counted in ``heatmap_hist_backfill_total`` —,
        anchored: whether the view had any grid to backfill against)."""
        if self.hist_source is None:
            return 0, True
        from heatmap_tpu_torch.query.history import decode_chunk

        now = self.clock()
        anchored = False
        by_gw: dict = {}
        for meta in self.hist_source.index():
            grid = meta.get("grid")
            if not grid:
                continue
            for ws_s, wm in (meta.get("windows") or {}).items():
                try:
                    ws = int(ws_s)
                except (TypeError, ValueError):
                    continue
                stale = wm.get("stale")
                if stale is not None and stale <= now:
                    continue  # would evict on first read anyway
                by_gw.setdefault((grid, ws), []).append(meta)
        installed = 0
        for (grid, ws), metas in sorted(by_gw.items()):
            latest = self.view.latest_ws_of(grid)
            if latest is None:
                continue
            anchored = True
            if ws >= latest or self.view.has_window(grid, ws):
                continue
            cells: dict = {}
            stale = None
            for meta in metas:
                buf = self.hist_source.chunk_bytes(meta.get("name"))
                if buf is None:
                    continue
                try:
                    _m, windows = decode_chunk(buf)
                except ValueError:
                    continue
                part = windows.get(ws)
                if part is not None:
                    for d in part["docs"]:
                        cells[d.get("cellId")] = d
                wm = (meta.get("windows") or {}).get(str(ws)) or {}
                if wm.get("stale") is not None:
                    stale = wm["stale"]
            if cells and self.view.backfill_window(
                    grid, ws, list(cells.values()), stale_ts=stale):
                installed += 1
                if self.c_backfill is not None:
                    self.c_backfill.inc()
        return installed, anchored or not by_gw

    def _gauges(self) -> None:
        if self._g_lag is not None:
            self._g_lag.set(self.seq_lag())
        if self._g_lag_s is not None:
            lag = self.lag_s()
            self._g_lag_s.set(lag if lag != float("inf") else -1.0)
        if self._g_synced is not None:
            self._g_synced.set(1 if self.synced else 0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                n = self.step()
                self._backoff = 0.0
                # a full page means we're mid-catch-up: keep draining
                wait = 0.0 if n >= 512 else self.poll_s
            except Exception as e:
                if self.c_errors is not None:
                    self.c_errors.inc()
                self._backoff = min(5.0, (self._backoff or 0.1) * 2)
                wait = self._backoff
                log.warning("replication catch-up failed (retry in "
                            "%.1fs): %s", wait, e)
                self._gauges()
            if wait:
                self._stop.wait(wait)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repl-follower")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
