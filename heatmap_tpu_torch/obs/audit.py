"""Integrity observatory: event-conservation ledger + content digests.

A copy of ``heatmap_tpu/obs/audit.py``, for the port's one device: its
runtime stamps the ledger on the single fold (shard table ``"self"``, as
the reference's single-device runtime does), and the multi-host and
partitioned-mesh paths that feed other shard tables are not ported.

Every structural guarantee the system rests on — writer-vs-replica
byte-interchangeability of the replicated serve fleet above all — is
pinned by offline differential tests; in production nothing else
detects a silently diverged replica, a corrupted repl segment, or a
double-applied window.  This module extends the conservation-exact
discipline the freshness lineage applies to *time* (obs.lineage: stages
telescope, residual == 0) to *content*, as two observe-only halves
gated by ``HEATMAP_AUDIT=1`` (zero data-path mutation either way):

**Event conservation ledger** (:class:`AuditState` + the counters the
runtime stamps at every pipeline boundary):

    polled == folded + dropped{reason: invalid, late, out_of_shard,
                               oversample, exchange}
    docs_emitted == docs_committed == docs_view_applied
    view seq == repl feed seq == replica applied seq   (per replica)

Residuals are computed per boundary.  A pipeline in flight legitimately
holds a transient residual (prefetched batches, the device emit ring,
the writer queue), but a healthy residual shrinks at every flush; a
LEAK never shrinks.  :meth:`AuditState.healthz_checks` therefore
degrades /healthz NAMING the boundary only when a non-zero residual has
not decreased (or returned to zero) for ``HEATMAP_AUDIT_SETTLE_S``
(default 10 s) — an idle-but-unbalanced book, or a monotonically
growing one, is the incident; a deep-but-draining pipeline is not.

**Per-window content digests** (:class:`DigestTable`): each tile doc
hashes to a stable 64-bit value (:func:`doc_hash` — salt-free blake2b
over the canonicalized doc, so every process agrees), and a (grid,
windowStart) window's digest is the XOR of its live cells' hashes.
XOR makes the digest order-independent (upsert order, shard-merge
order, replica apply order all commute) and incrementally maintainable
(upsert = ``old_hash ^ new_hash``), with the empty window as the
identity (0) and eviction retiring the window's digest entirely.
Because shard cell spaces are disjoint, per-shard digests COMBINE by
the same XOR to the merged-view digest (:func:`combine_digests`) —
the fan-in invariant /fleet/audit checks continuously.  The history
chunks (query/history.py) carry one ``doc_hash`` per doc, so a
compactor restart keeps each window's XOR digest exact.

The writer-side ``TileMatView`` maintains a digest table under its own
lock and publishes the post-apply digest of every touched (grid,
windowStart) inside the repl delta-log record (``"dg"``); every replica
recomputes from its OWN applied state and verifies per seq advance
(:meth:`AuditState.verify_record`).  A mismatch bumps
``heatmap_audit_digest_mismatch_total``, degrades /healthz naming the
(grid, window, seq), and dumps the flight recorder under ONE correlated
fleet episode (obs.xproc.ensure_episode).
Verification covers the grid's LATEST window only: non-latest windows
may legitimately diverge across replicas (local TTL clocks evict them
independently), and latest is the only serving-visible window anyway.
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

ENV_AUDIT = "HEATMAP_AUDIT"
ENV_AUDIT_SETTLE = "HEATMAP_AUDIT_SETTLE_S"

# Ledger stages, in pipeline order (events, then docs, then records).
# ``dropped_<reason>`` children appear next to them per drop reason
# (stream.metrics.DROP_REASONS — the closed set).
LEDGER_STAGES = (
    "polled",          # rows polled from the source (incl. parse drops)
    "dispatched",      # rows entering the device fold
    "folded",          # rows aggregated (primary pair n_valid)
    "docs_emitted",    # tile docs pulled off the device, handed to sink
    "docs_committed",  # tile docs durably applied by the store
    "docs_view_applied",  # tile docs applied to the materialized view
    "repl_applied",    # replication records applied (replica side)
)

# Count-based boundaries: (name, upstream stage, downstream stages).
# feed_fold additionally subtracts every dropped_<reason> stage — the
# ledger's headline identity.  sink_view is only evaluated when a
# materialized view is attached (shard runtimes may have none).
BOUNDARIES = ("feed_fold", "emit_sink", "sink_view", "view_repl",
              "repl_replica")


def audit_enabled(env=None) -> bool:
    e = os.environ if env is None else env
    return e.get(ENV_AUDIT, "0") not in ("0", "false", "")


def audit_settle_s(default: float = 10.0) -> float:
    raw = os.environ.get(ENV_AUDIT_SETTLE, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        log.warning("%s=%r is not a number; using %s", ENV_AUDIT_SETTLE,
                    raw, default)
        return default


# ----------------------------------------------------------------- hash
def _canon(v) -> str:
    if isinstance(v, _dt.datetime):
        return v.isoformat()
    if isinstance(v, dict):
        return "{" + ",".join(
            f"{k}:{_canon(v[k])}" for k in sorted(v)) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_canon(x) for x in v) + "]"
    return repr(v)


def doc_hash(doc: dict) -> int:
    """Stable 64-bit content hash of one tile doc: salt-free blake2b
    over the canonicalized (sorted-key, ISO-datetime, repr-float) doc,
    so every process, shard, and replica derives the same value from
    the same content — Python's salted ``hash`` is exactly what this
    must NOT be."""
    parts = [f"{k}={_canon(doc[k])}" for k in sorted(doc)]
    h = hashlib.blake2b("|".join(parts).encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "big")


def combine_digests(digests) -> int:
    """XOR-combine per-shard window digests (disjoint cell spaces) into
    the merged-view digest; the empty iterable is the identity 0."""
    out = 0
    for d in digests:
        out ^= int(d)
    return out


# ---------------------------------------------------------------- table
class DigestTable:
    """Per-(grid, windowStart) order-independent content digests.

    digest(grid, ws) == XOR of doc_hash(doc) over the window's live
    cells; maintained incrementally (upsert = old ^ new) under one
    lock.  ``staleAt`` rides along per window so :meth:`snapshot` can
    prune windows the view-side TTL would have retired — keeping a
    shard's published digests combinable against a lazily-evicting
    merged view."""

    def __init__(self):
        self._lock = threading.Lock()
        # grid -> ws -> {"cells": {cid: hash}, "digest": int,
        #               "stale": float | None}
        self._g: dict[str, dict[int, dict]] = {}

    def update(self, grid: str, ws: int, cid: str,
               old_doc: dict | None, new_doc: dict | None) -> None:
        """One cell's doc changed: fold the hash delta into the window
        digest.  ``new_doc=None`` removes the cell."""
        if not grid:
            return
        with self._lock:
            wins = self._g.setdefault(grid, {})
            w = wins.get(ws)
            if w is None:
                w = wins[ws] = {"cells": {}, "digest": 0, "stale": None}
            d = w["digest"]
            prev = w["cells"].pop(cid, None)
            if prev is not None:
                d ^= prev
            elif old_doc is not None:
                d ^= doc_hash(old_doc)
            if new_doc is not None:
                h = doc_hash(new_doc)
                w["cells"][cid] = h
                d ^= h
                stale = new_doc.get("staleAt")
                if isinstance(stale, _dt.datetime):
                    w["stale"] = stale.timestamp()
            w["digest"] = d
            if not w["cells"]:
                del wins[ws]

    def apply_doc(self, doc: dict) -> None:
        grid = doc.get("grid")
        ws_dt = doc.get("windowStart")
        if not grid or not isinstance(ws_dt, _dt.datetime):
            return
        self.update(grid, int(ws_dt.timestamp()), doc.get("cellId"),
                    None, doc)

    def apply_docs(self, docs) -> None:
        for d in docs:
            self.apply_doc(d)

    def drop_window(self, grid: str, ws: int) -> None:
        with self._lock:
            wins = self._g.get(grid)
            if wins is not None:
                wins.pop(ws, None)
                if not wins:
                    self._g.pop(grid, None)

    def prune(self, now: float) -> int:
        """Drop every window whose ``staleAt`` has passed — the
        emit-shard tables' eviction (the VIEW's table is pruned by the
        view's own evictions; nothing else evicts these tables, and an
        unpruned table would grow one cell-hash map per window
        forever).  Returns windows dropped."""
        n = 0
        with self._lock:
            for grid in list(self._g):
                wins = self._g[grid]
                for ws in [w for w, rec in wins.items()
                           if rec["stale"] is not None
                           and rec["stale"] <= now]:
                    del wins[ws]
                    n += 1
                if not wins:
                    del self._g[grid]
        return n

    def clear(self) -> None:
        with self._lock:
            self._g.clear()

    def digest(self, grid: str, ws: int) -> int | None:
        with self._lock:
            w = (self._g.get(grid) or {}).get(ws)
            return None if w is None else w["digest"]

    def windows(self, grid: str) -> list:
        with self._lock:
            return sorted(self._g.get(grid) or ())

    def snapshot(self, now: float | None = None,
                 max_windows: int = 32) -> dict:
        """{grid: {str(ws): {"digest": hex16, "cells": n}}} — newest
        ``max_windows`` windows per grid, windows stale at ``now``
        pruned (so a shard's published digests stay combinable against
        the merged view's lazy TTL eviction)."""
        out: dict = {}
        with self._lock:
            for grid, wins in self._g.items():
                live = {ws: w for ws, w in wins.items()
                        if now is None or w["stale"] is None
                        or w["stale"] > now}
                for ws in sorted(live)[-max_windows:]:
                    w = live[ws]
                    out.setdefault(grid, {})[str(ws)] = {
                        "digest": format(w["digest"], "016x"),
                        "cells": len(w["cells"]),
                    }
        return out


# ---------------------------------------------------------------- ledger
def residuals_from_counts(counts: dict, has_view: bool = True) -> dict:
    """Count-based boundary residuals from a ledger/stage dict — shared
    by the local snapshot and the fleet stitch (obs.fleet sums member
    ledgers, then applies the same identities)."""
    c = counts.get
    dropped = sum(v for k, v in counts.items()
                  if k.startswith("dropped_"))
    out = {"feed_fold": c("polled", 0) - c("folded", 0) - dropped,
           "emit_sink": c("docs_emitted", 0) - c("docs_committed", 0)}
    if has_view:
        out["sink_view"] = (c("docs_committed", 0)
                            - c("docs_view_applied", 0))
    return out


class AuditState:
    """One process's integrity-observatory state: the conservation
    ledger, per-shard digest tables, replica digest verification, the
    ``heatmap_audit_*`` metric families, and the /healthz checks.
    Observe-only by construction — nothing here is on the data path's
    failure surface (every hook call is counted arithmetic)."""

    def __init__(self, registry=None, tag: str = "local",
                 settle_s: float | None = None, clock=time.monotonic,
                 channel_path=None, flightrec=None):
        self.tag = str(tag)
        self.clock = clock
        self.settle_s = (audit_settle_s() if settle_s is None
                         else float(settle_s))
        # channel/flightrec feed the correlated-episode dump on a digest
        # mismatch; both default from env lazily (a serve worker builds
        # this before its recorder exists)
        self._channel_path = channel_path
        self.flightrec = flightrec
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._tables: dict[object, DigestTable] = {}
        self.has_view = False
        self.view = None
        self.repl_pub = None
        self.follower = None
        self.verified = 0
        self.mismatches = 0
        self.last_verified_seq = 0
        self.last_mismatch: dict | None = None
        # per-boundary leak tracker: last |residual| and the last time
        # it was zero or decreased (the "draining" evidence)
        self._track: dict[str, list] = {}
        self._dumped_episodes: set = set()
        self._prune_last = time.monotonic()  # shard-table sweep limiter
        self._scrape_memo: tuple | None = None  # (mono_ts, residuals)
        self._c_stage = self._g_residual = None
        self._c_verified = self._c_mismatch = self._g_last_seq = None
        if registry is not None:
            self._c_stage = registry.counter(
                "heatmap_audit_stage_total",
                "events/docs/records counted at each pipeline boundary "
                "by the conservation ledger (HEATMAP_AUDIT=1; stages "
                "telescope — see /debug/audit for the residuals)",
                labels=("stage",))
            for s in LEDGER_STAGES:
                self._c_stage.labels(stage=s)
            self._g_residual = registry.gauge(
                "heatmap_audit_residual",
                "conservation-ledger residual per pipeline boundary "
                "(upstream minus downstream counts; transiently nonzero "
                "while batches are in flight, 0 at quiescence — a "
                "residual that stops draining degrades /healthz naming "
                "the boundary)", labels=("boundary",))
            for b in ("feed_fold", "emit_sink"):
                self._g_residual.labels(boundary=b).fn = (
                    lambda bb=b: self._scrape_residuals().get(bb, 0))
            self._c_verified = registry.counter(
                "heatmap_audit_digests_verified_total",
                "per-window content digests recomputed from this "
                "replica's own applied state that matched the writer's "
                "published digest")
            self._c_mismatch = registry.counter(
                "heatmap_audit_digest_mismatch_total",
                "published-vs-recomputed window digest mismatches — a "
                "diverged replica, corrupted repl record, or "
                "double-applied window; any nonzero degrades /healthz "
                "naming the (grid, window, seq)")
            self._g_last_seq = registry.gauge(
                "heatmap_audit_last_verified_seq",
                "newest view seq whose published window digest this "
                "replica verified against its own state")

    # ------------------------------------------------------------ wiring
    def attach(self, view=None, repl_pub=None, follower=None) -> None:
        """Late-bound live refs: the materialized view (seq + digest
        table), the repl publisher (feed head seq), the replica
        follower (applied seq) — the record/seq boundaries are computed
        from these at read time instead of double-counted."""
        if view is not None:
            self.view = view
            self.has_view = True
        if repl_pub is not None:
            self.repl_pub = repl_pub
        if follower is not None:
            self.follower = follower
        if self._g_residual is not None:
            for b, want in (("sink_view", self.has_view),
                            ("view_repl", self.repl_pub is not None),
                            ("repl_replica", self.follower is not None)):
                if want:
                    self._g_residual.labels(boundary=b).fn = (
                        lambda bb=b:
                        self._scrape_residuals().get(bb, 0))

    @property
    def channel_path(self):
        if self._channel_path is not None:
            return self._channel_path
        from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL

        return os.environ.get(ENV_CHANNEL)

    # ------------------------------------------------------------ ledger
    def add(self, stage: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            self._counts[stage] = self._counts.get(stage, 0) + int(n)
        if self._c_stage is not None:
            self._c_stage.labels(stage=stage).inc(n)
        self._maybe_prune()

    def _maybe_prune(self) -> None:
        """Rate-limited (60 s) stale-window sweep over the emit-shard
        digest tables — without it a 24/7 audited run retains every
        expired window's cell-hash map forever (the view's table is
        pruned by the view's own evictions; nothing else prunes
        these)."""
        now = time.monotonic()
        with self._lock:
            if now - self._prune_last < 60.0:
                return
            self._prune_last = now
            tables = list(self._tables.values())
        wall = time.time()
        for t in tables:
            t.prune(wall)

    def counts(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def shard_table(self, shard=None) -> DigestTable:
        """The digest table of one emit shard: ``None`` = the process's
        single fold, an int = one partitioned-mesh device.  Published
        per shard so /fleet/audit can XOR-combine them against the
        merged-view digest (disjoint cell spaces)."""
        key = "self" if shard is None else str(shard)
        with self._lock:
            t = self._tables.get(key)
            if t is None:
                t = self._tables[key] = DigestTable()
            return t

    def _scrape_residuals(self) -> dict:
        """residuals() behind a short memo for the per-boundary gauge
        callbacks: one /metrics scrape evaluates up to 5 children, and
        without the memo each would re-take the ledger/view locks for
        values from the same instant — the memo also makes the
        published boundary values mutually consistent."""
        now = time.monotonic()
        memo = self._scrape_memo
        if memo is not None and now - memo[0] < 0.25:
            return memo[1]
        res = self.residuals()
        self._scrape_memo = (now, res)
        return res

    def residuals(self) -> dict:
        out = residuals_from_counts(self.counts(),
                                    has_view=self.has_view)
        view, pub, fol = self.view, self.repl_pub, self.follower
        if view is not None and pub is not None:
            out["view_repl"] = max(
                0, int(view.seq) - int(getattr(pub, "_last_seq", 0)))
        if fol is not None:
            out["repl_replica"] = int(fol.seq_lag())
        return out

    # ---------------------------------------------------------- settling
    def evaluate(self, now: float | None = None) -> dict:
        """Residuals + leak tracking in one pass: a boundary whose
        |residual| hit zero or decreased is 'draining' (its timer
        resets); one that stayed nonzero without ever decreasing for
        ``settle_s`` is LEAKING.  Returns {boundary: residual}."""
        now = self.clock() if now is None else now
        res = self.residuals()
        with self._lock:
            for b, r in res.items():
                t = self._track.get(b)
                if t is None:
                    self._track[b] = [abs(r), now]
                    continue
                if abs(r) == 0 or abs(r) < t[0]:
                    t[1] = now
                t[0] = abs(r)
        return res

    def leaking(self, now: float | None = None) -> dict:
        """{boundary: residual} for boundaries in the leak state."""
        now = self.clock() if now is None else now
        res = self.evaluate(now)
        out = {}
        with self._lock:
            for b, r in res.items():
                t = self._track.get(b)
                if (r != 0 and t is not None
                        and now - t[1] >= self.settle_s):
                    out[b] = r
        return out

    def worst_boundary(self) -> tuple[str, int] | None:
        res = self.residuals()
        if not res:
            return None
        b = max(res, key=lambda k: abs(res[k]))
        return (b, res[b]) if res[b] else None

    # ------------------------------------------------------------ digests
    def verify_record(self, view, rec: dict) -> None:
        """Replica-side digest verification, per applied feed record:
        the writer published its post-apply digest for every touched
        (grid, windowStart) (``rec["dg"]``); recompute from THIS
        replica's applied state and compare.  Latest-window only —
        non-latest windows evict on local TTL clocks and may
        legitimately differ."""
        dg = rec.get("dg")
        if not isinstance(dg, dict):
            return
        seq = int(rec.get("seq", 0))
        for grid, per_ws in dg.items():
            if not isinstance(per_ws, dict):
                continue
            latest = view.latest_ws_of(grid)
            for ws_s, expect in per_ws.items():
                try:
                    ws, want = int(ws_s), int(expect, 16)
                except (TypeError, ValueError):
                    continue
                if latest is None or ws != latest:
                    continue
                have = view.audit_digest(grid, ws) or 0
                if have == want:
                    self.note_verified(seq)
                else:
                    self.note_digest_mismatch(grid, ws, seq, have=have,
                                              want=want)

    def note_verified(self, seq: int) -> None:
        with self._lock:
            self.verified += 1
            self.last_verified_seq = max(self.last_verified_seq,
                                         int(seq))
        if self._c_verified is not None:
            self._c_verified.inc()
        if self._g_last_seq is not None:
            self._g_last_seq.set(self.last_verified_seq)

    def note_digest_mismatch(self, grid: str, ws: int, seq: int,
                             have: int = 0, want: int = 0) -> None:
        """Content divergence detected: count it, remember the (grid,
        window, seq) for /healthz, and dump the flight recorder under
        ONE correlated fleet episode (the first mismatch of an incident
        claims/joins the episode; later mismatches under the same
        episode don't re-dump)."""
        with self._lock:
            self.mismatches += 1
            self.last_mismatch = {"grid": grid, "ws": int(ws),
                                  "seq": int(seq),
                                  "have": format(have, "016x"),
                                  "want": format(want, "016x")}
        if self._c_mismatch is not None:
            self._c_mismatch.inc()
        log.error("AUDIT digest mismatch: grid=%s window=%d seq=%d "
                  "(have %016x, want %016x)", grid, ws, seq, have, want)
        self._dump_mismatch(grid, ws, seq)

    def _dump_mismatch(self, grid: str, ws: int, seq: int) -> None:
        rec = self.flightrec
        if rec is None:
            from heatmap_tpu_torch.obs.flightrec import from_env

            rec = from_env()
        reason = (f"audit digest mismatch: grid={grid} window={ws} "
                  f"seq={seq}")
        episode: dict = {}
        chan = self.channel_path
        if chan:
            from heatmap_tpu_torch.obs.xproc import ensure_episode

            episode = ensure_episode(chan, self.tag, reason)
        # dump once per incident: the fleet episode id when a channel
        # is attached; channel-less, per diverged (grid, window) — a
        # NEW window diverging days later is a new incident and must
        # still leave a flight record
        eid = episode.get("episode_id") or ""
        key = eid or f"local:{grid}:{int(ws)}"
        with self._lock:
            if key in self._dumped_episodes:
                return
            while len(self._dumped_episodes) >= 64:
                self._dumped_episodes.pop()
            self._dumped_episodes.add(key)
        if rec is None:
            return
        try:
            snap = rec.spawn()
            snap.add_source("audit", lambda: self.snapshot())
            if episode:
                snap.add_source("episode", lambda e=dict(episode): e)
            snap.dump(reason + (f" (episode {eid})" if eid else ""),
                      episode_id=eid or None)
        except Exception:  # noqa: BLE001 - telemetry never takes us down
            log.warning("audit mismatch flight-record dump failed",
                        exc_info=True)

    # ----------------------------------------------------------- surfaces
    def healthz_checks(self, now: float | None = None
                       ) -> tuple[dict, bool]:
        """({check: ...}, degraded) for /healthz: a leaking boundary
        degrades NAMING it; any digest mismatch degrades naming the
        (grid, window, seq)."""
        checks: dict = {}
        degraded = False
        leaks = self.leaking(now)
        if leaks:
            worst = max(leaks, key=lambda k: abs(leaks[k]))
            checks["audit_residual"] = {
                "value": "; ".join(f"{b}={r:+d}"
                                   for b, r in sorted(leaks.items())),
                "boundary": worst, "ok": False}
            degraded = True
        else:
            checks["audit_residual"] = {"value": "conserved", "ok": True}
        with self._lock:
            mm, last = self.mismatches, dict(self.last_mismatch or {})
        if mm:
            checks["audit_digest"] = {
                "value": (f"{mm} mismatch(es); last grid={last.get('grid')}"
                          f" window={last.get('ws')} seq={last.get('seq')}"),
                "ok": False, **last}
            degraded = True
        else:
            checks["audit_digest"] = {"value": "verified", "ok": True}
        return checks, degraded

    def member_block(self, now_wall: float | None = None) -> dict:
        """The compact audit block a fleet member snapshot publishes
        (obs.xproc) — what /fleet/audit stitches: ledger counts,
        residuals, per-shard + view digests, verification state, and
        the repl seq anchors."""
        now_wall = time.time() if now_wall is None else now_wall
        with self._lock:
            tables = dict(self._tables)
            verify = {"verified": self.verified,
                      "mismatches": self.mismatches,
                      "last_verified_seq": self.last_verified_seq}
            if self.last_mismatch:
                verify["last_mismatch"] = dict(self.last_mismatch)
        view, pub, fol = self.view, self.repl_pub, self.follower
        out = {
            "tag": self.tag,
            "ledger": self.counts(),
            "residuals": self.residuals(),
            "digests": {
                "shard": {label: t.snapshot(now=now_wall)
                          for label, t in sorted(tables.items())},
            },
            "verify": verify,
        }
        if view is not None and (tables or pub is not None):
            # only an EMITTING member (or the feed publisher) owns the
            # merged-view digests the fleet combine targets; a replica's
            # view digests are its verification input, not a combine
            # anchor — publishing them would make a lagging replica
            # read as a shard-merge mismatch
            vt = getattr(view, "audit_table", None)
            if vt is not None:
                out["digests"]["view"] = vt.snapshot(now=now_wall)
        repl: dict = {}
        if view is not None:
            repl["view_seq"] = int(view.seq)
        if pub is not None:
            repl["feed_seq"] = int(getattr(pub, "_last_seq", 0))
        if fol is not None:
            repl["applied_seq"] = int(fol.applied)
            repl["feed_head_seq"] = int(fol._last_seq_seen)
        if repl:
            out["repl"] = repl
        return out

    def snapshot(self) -> dict:
        """The /debug/audit payload: the member block plus the settled
        verdicts an operator asks for first."""
        out = self.member_block()
        out["leaking"] = self.leaking()
        worst = self.worst_boundary()
        out["worst_boundary"] = (
            {"boundary": worst[0], "residual": worst[1]}
            if worst else None)
        out["settle_s"] = self.settle_s
        return out

    def bench_stamp(self) -> dict:
        """The ``audit`` block a benchmark stamps into its artifacts:
        a run whose stamp carries a non-zero residual or any digest
        mismatch is not a result."""
        res = self.residuals()
        return {
            "enabled": True,
            "max_residual": (max((abs(r) for r in res.values()),
                                 default=0)),
            "digests_verified": self.verified,
            "mismatches": self.mismatches,
        }
