"""Continuous spatial query engine over the materialized-view stream.

A copy of ``heatmap_tpu/query/continuous.py`` without the fleet member
block (the supervisor channel it is published on is ROADMAP A7).
*Standing* queries — register once, get pushed matches forever —
evaluated off the view's mutation stream, in dense seq order, on the
writer or on a replica following its feed (query.repl), so query load
scales with serve workers: the writer carries no watcher, no index, no
per-mutation work until a query is registered on it.

Query menu (one registered spec each, compiled once by query.geom):

- ``range``     — bbox/polygon subscription: every count change to a
                  matching cell in the latest window pushes a match.
- ``topk``      — regional (or whole-grid) hottest-k cells; a push
                  whenever the ranked list changes.
- ``geofence``  — ENTER/EXIT edge alerts: a cell inside the fence
                  becoming live in the serving-visible window pushes
                  ``enter``; leaving it (window advance, eviction,
                  resync) pushes ``exit``.  Granularity is the cell at
                  snap res — the mutation stream is tile-granular, so
                  "entity" here means "occupied cell".
- ``threshold`` — per-cell count threshold: ``above``/``below`` edge
                  alerts for cells crossing it.
- ``anomaly``   — per-entity anomaly subscription over the streaming
                  inference engine's event feed (infer.engine): a
                  reason-tagged event (stopped / teleport / deviation)
                  whose cell falls inside the registered region pushes
                  a match naming the entity and reason.  Events ride
                  the same mutation stream as tile applies
                  (``kind="anomaly"`` records, matview.publish_
                  anomalies).  An anomaly query keeps NO edge state — it
                  is a pure filtered event stream.

Evaluation is O(changed), never O(registered): each query's compiled
``CellSet`` is filed in two per-grid inverted indexes — sliver cells
at snap res, promoted interior parents at the coarse res (the same
bit surgery as the pyramid rollup) — both EXACT, so a view mutation
for cell ``c`` touches only queries whose region actually contains
``c``.  The engine keeps its own per-grid shadow of window cell counts,
maintained purely from the mutation records — which is what makes the
load-bearing invariant provable: **a query registered then replayed from
seq 0 yields, at every seq, exactly the one-shot evaluation of the same
query against the view at that seq**.  A replica snapshot resync
arrives as the view's synthetic ``reset`` record: derived state rebuilds
from the replaced view silently — an epoch restart or catch-up never
mints phantom enter/exit transitions.

Hook discipline: the engine attaches a view WATCHER (called under the
view lock, enqueue-only) and drains on its own thread.  Attachment is
LAZY: until the first register() the view carries no watcher at all.
"""

from __future__ import annotations

import collections
import datetime as dt
import heapq
import logging
import threading
import time
import uuid

from heatmap_tpu_torch.query import geom
from heatmap_tpu_torch.query.matview import _grid_base_res
from heatmap_tpu_torch.query.pyramid import cell_to_parent

log = logging.getLogger(__name__)

QUERY_TYPES = ("range", "topk", "geofence", "threshold", "anomaly")


def _chain_ids(fine, coarse, all_q):
    """Iterate the candidate query ids of one cell: its snap-index
    entry, its parent-index entry, and the whole-grid set.  The two
    indexes are disjoint per query (a sliver cell's parent was, by
    construction, NOT promoted), so no dedup is needed."""
    if fine:
        yield from fine
    if coarse:
        yield from coarse
    if all_q:
        yield from all_q

# shadow windows retained per grid: non-latest windows evict silently
# on the view (no mutation record), so the shadow bounds itself instead
_MAX_SHADOW_WINDOWS = 32


class Query:
    """One registered standing query (all mutation under the engine
    lock).  ``state`` is the incrementally-maintained edge set the
    replay invariant is about: occupied cells (geofence), above-cells
    (threshold), the ranked list (topk); range keeps none (its
    evaluation is a pure shadow scan)."""

    __slots__ = ("id", "spec", "type", "grid", "cellset", "k",
                 "threshold", "reasons", "expires_mono", "created_unix",
                 "state", "counts", "events", "ev_next", "matches",
                 "index_keys")

    def __init__(self, qid: str, spec: dict, grid: str, cellset,
                 k: int, threshold: int, expires_mono: float | None,
                 events_cap: int):
        self.id = qid
        self.spec = spec
        self.type = spec["type"]
        self.grid = grid
        self.cellset = cellset          # geom.CellSet | None (whole grid)
        self.k = k
        self.threshold = threshold
        # anomaly: accepted reason tags (None = every reason)
        self.reasons = (frozenset(spec["reasons"])
                        if spec.get("reasons") else None)
        self.expires_mono = expires_mono
        self.created_unix = time.time()
        self.state: set = set()         # geofence occupied / threshold above
        self.counts: dict = {}          # topk: cid -> count (region only)
        self.events: collections.deque = collections.deque(maxlen=events_cap)
        self.ev_next = 1
        self.matches = 0
        self.index_keys: tuple | None = None  # (sliver cells, parents)

    def contains(self, cell_int: int) -> bool:
        return self.cellset is None or self.cellset.contains(cell_int)

    def describe(self) -> dict:
        d = {"id": self.id, "type": self.type, "grid": self.grid,
             "created_unix": round(self.created_unix, 3),
             "matches": self.matches,
             "cells": (self.cellset.size() if self.cellset is not None
                       else None)}
        if self.type == "topk":
            d["k"] = self.k
        if self.type == "threshold":
            d["threshold"] = self.threshold
        if self.type == "anomaly" and self.reasons is not None:
            d["reasons"] = sorted(self.reasons)
        if self.expires_mono is not None:
            d["expires_in_s"] = round(
                max(0.0, self.expires_mono - time.monotonic()), 1)
        for key in ("bbox", "polygon"):
            if key in self.spec:
                d[key] = self.spec[key]
        return d


class _GridState:
    """Per-grid engine state: the inverted indexes and the shadow.

    Two EXACT indexes (a candidate from either is a member by
    construction — no per-candidate geometry on the hot path):
    ``index`` keys each query's sliver cells at SNAP res, ``pindex``
    keys its promoted interior parents at the coarse res.  A tiny
    fence (no parents) therefore has snap-exact selectivity — filing
    slivers under their coarse parent instead was measured ~9x worse
    at 100k-fence density (every mutation dragged in every fence
    within the parent's 49-cell footprint)."""

    __slots__ = ("index_res", "index", "pindex", "all", "wins",
                 "active")

    def __init__(self, index_res: int):
        self.index_res = index_res
        self.index: dict[int, set] = {}     # snap cell -> query ids
        self.pindex: dict[int, set] = {}    # coarse parent -> query ids
        self.all: set = set()               # whole-grid queries
        self.wins: dict[int, dict] = {}     # ws -> cid -> count
        self.active: set = set()            # qids with non-empty state

    def latest(self) -> int | None:
        return max(self.wins) if self.wins else None


class ContinuousQueryEngine:
    def __init__(self, view, registry=None, max_queries: int = 1 << 20,
                 events_per_query: int = 256, max_cells: int = 4096,
                 index_levels: int = 2, default_ttl_s: float = 3600.0,
                 clock=time.monotonic):
        self.view = view
        self.max_queries = int(max_queries)
        self.events_per_query = max(1, int(events_per_query))
        self.max_cells = int(max_cells)
        self.index_levels = max(0, int(index_levels))
        self.default_ttl_s = float(default_ttl_s)
        self.clock = clock
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        # drain is single-flight: two concurrent drainers would pop
        # queue records and could acquire the engine lock out of seq
        # order — the later seq would then win and the earlier record's
        # docs would be silently skipped by the idempotency guard
        self._drain_lock = threading.Lock()
        self._queries: dict[str, Query] = {}
        self._grids: dict[str, _GridState] = {}
        self._pending: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._attached = False
        self._seq = 0
        self._sweep_last = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._c_evals = self._c_matches = self._h_eval = None
        self._g_lag = None
        if registry is not None:
            registry.gauge(
                "heatmap_cq_registered",
                "standing continuous spatial queries currently "
                "registered on this worker (range / topk / geofence / "
                "threshold subscriptions)",
                fn=lambda: len(self._queries))
            self._c_evals = registry.counter(
                "heatmap_cq_evaluations_total",
                "per-query incremental evaluations performed by the "
                "continuous-query engine (one per query actually "
                "touched by a view mutation — O(changed), never "
                "O(registered))")
            self._c_matches = registry.counter(
                "heatmap_cq_matches_total",
                "match/alert records pushed by standing queries "
                "(range matches, topk changes, geofence enter/exit, "
                "threshold above/below)")
            self._h_eval = registry.histogram(
                "heatmap_cq_eval_seconds",
                "wall time evaluating one view mutation record against "
                "the touched standing queries",
                buckets=(1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0))
            registry.gauge(
                "heatmap_cq_index_cells",
                "live coarse-cell keys in the continuous-query "
                "inverted index (cell -> subscribed query ids) across "
                "grids",
                fn=lambda: sum(len(g.index) + len(g.pindex)
                               for g in self._grids.values()))
            self._g_lag = registry.gauge(
                "heatmap_cq_eval_lag_seconds",
                "age of the oldest view mutation record still queued "
                "for continuous-query evaluation (0 when drained; the "
                "HEATMAP_SLO_CQ_LAG_S /healthz budget)",
                fn=self.eval_lag_s)

    # ------------------------------------------------------------ wiring
    def _ingest(self, rec: dict) -> None:
        """The view watcher: called under the VIEW lock — append-only
        (deque.append is atomic), never the engine lock."""
        self._pending.append((time.monotonic(), rec))
        self._wake.set()

    def _attach(self) -> None:
        """First register(): hook the view and seed the shadow.  Order
        matters — watcher first, snapshot second, so a mutation in the gap is in the queue, the
        snapshot, or both (re-applies are idempotent: the shadow stores
        counts, not deltas)."""
        if self._attached:
            return
        self.view.add_watcher(self._ingest)
        self._attached = True
        self._seed_from_view()

    def _seed_from_view(self) -> None:
        state = self.view.export_state()
        self._seq = int(state.get("seq", 0))
        for grid, gs in (state.get("grids") or {}).items():
            g = self._grid(grid)
            g.wins.clear()
            for ws_key, cells in (gs.get("windows") or {}).items():
                g.wins[int(ws_key)] = {cid: int(doc.get("count", 0))
                                       for cid, doc in cells.items()}

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._attached:
            self.view.remove_watcher(self._ingest)
            self._attached = False

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="cq-engine")
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            try:
                self.drain()
            except Exception:
                log.exception("continuous-query drain failed")
            self._maybe_sweep()

    # ---------------------------------------------------------- register
    def _grid(self, grid: str) -> _GridState:
        g = self._grids.get(grid)
        if g is None:
            base = _grid_base_res(grid)
            index_res = max(0, (base if base is not None else 8)
                            - self.index_levels)
            g = self._grids[grid] = _GridState(index_res)
        return g

    def validate(self, spec: dict, default_grid: str | None) -> dict:
        """Normalize + validate a registration spec; raises ValueError
        with an operator-shaped message (the API answers 400 with it)."""
        if not isinstance(spec, dict):
            raise ValueError("query spec must be a JSON object")
        qtype = spec.get("type")
        if qtype not in QUERY_TYPES:
            raise ValueError(
                f"type must be one of {'/'.join(QUERY_TYPES)}, "
                f"got {qtype!r}")
        grid = spec.get("grid") or default_grid
        if not grid or _grid_base_res(str(grid)) is None:
            raise ValueError(f"grid {grid!r} is not a sink grid label "
                             f"(h3r<res>[m<min>])")
        out = {"type": qtype, "grid": str(grid)}
        if "bbox" in spec and "polygon" in spec:
            raise ValueError("give bbox OR polygon, not both")
        if "bbox" in spec:
            b = spec["bbox"]
            if not (isinstance(b, (list, tuple)) and len(b) == 4):
                raise ValueError(
                    "bbox must be [min_lon, min_lat, max_lon, max_lat]")
            out["bbox"] = [float(v) for v in b]
        elif "polygon" in spec:
            p = spec["polygon"]
            if not (isinstance(p, (list, tuple)) and len(p) >= 3):
                raise ValueError(
                    "polygon must be [[lon, lat], ...] with >= 3 points")
            out["polygon"] = [[float(x), float(y)] for x, y in p]
        elif qtype in ("geofence", "anomaly"):
            raise ValueError(f"{qtype} queries need a bbox or polygon")
        if qtype == "anomaly":
            reasons = spec.get("reasons")
            if reasons is not None:
                from heatmap_tpu_torch.infer import ANOMALY_REASONS

                if (not isinstance(reasons, (list, tuple)) or not reasons
                        or any(r not in ANOMALY_REASONS for r in reasons)):
                    raise ValueError(
                        f"reasons must be a non-empty list drawn from "
                        f"{'/'.join(ANOMALY_REASONS)}, got {reasons!r}")
                out["reasons"] = sorted(set(reasons))
        if qtype == "topk":
            k = spec.get("k", 10)
            if not isinstance(k, int) or not 1 <= k <= 1000:
                raise ValueError(f"k must be an int in 1..1000, got {k!r}")
            out["k"] = k
        if qtype == "threshold":
            t = spec.get("threshold")
            if not isinstance(t, int) or t < 1:
                raise ValueError(
                    f"threshold must be an int >= 1, got {t!r}")
            out["threshold"] = t
        ttl = spec.get("ttl_s", self.default_ttl_s)
        if not isinstance(ttl, (int, float)) or ttl < 0:
            raise ValueError(f"ttl_s must be a number >= 0 (0 = no "
                             f"expiry), got {ttl!r}")
        out["ttl_s"] = float(ttl)
        return out

    def register(self, spec: dict,
                 default_grid: str | None = None) -> dict:
        """Compile + index one standing query; returns its description
        (id included).  Raises ValueError on a bad spec or a full
        engine."""
        norm = self.validate(spec, default_grid)
        grid = norm["grid"]
        base_res = _grid_base_res(grid)
        with self._lock:
            if len(self._queries) >= self.max_queries:
                raise ValueError(
                    f"query limit reached ({self.max_queries}; "
                    f"HEATMAP_CQ_MAX_QUERIES)")
            g = self._grid(grid)
            cellset = None
            if "bbox" in norm:
                cellset = geom.compile_bbox(
                    norm["bbox"], base_res, coarse_res=g.index_res,
                    max_cells=self.max_cells)
            elif "polygon" in norm:
                cellset = geom.compile_polygon(
                    norm["polygon"], base_res, coarse_res=g.index_res,
                    max_cells=self.max_cells)
            qid = uuid.uuid4().hex[:16]
            q = Query(qid, norm, grid, cellset,
                      k=norm.get("k", 10),
                      threshold=norm.get("threshold", 1),
                      expires_mono=(self.clock() + norm["ttl_s"]
                                    if norm["ttl_s"] > 0 else None),
                      events_cap=self.events_per_query)
            self._attach()
            if cellset is None:
                g.all.add(qid)
            else:
                q.index_keys = (cellset.cells, cellset.parents)
                for key in cellset.cells:
                    g.index.setdefault(key, set()).add(qid)
                for key in cellset.parents:
                    g.pindex.setdefault(key, set()).add(qid)
            self._queries[qid] = q
            # seed the edge state from the CURRENT one-shot evaluation,
            # silently: registration is not a transition, so a fence
            # over an already-occupied cell must not alert "enter"
            self._seed_query(q, g)
        self._ensure_thread()
        return q.describe()

    def _members_of(self, q: Query, g: _GridState, win: dict) -> dict:
        """{cid: count} of the window cells inside the query's region.
        A sliver-only compiled set (tiny fence, the common case at
        registration-storm scale) probes its OWN few cells against the
        window instead of scanning the window — O(|fence|), not
        O(|city|)."""
        cs = q.cellset
        if cs is None:
            return dict(win)
        if not cs.parents and len(cs.cells) * 4 < len(win):
            out = {}
            for ci in cs.cells:
                cid = format(ci, "x")
                c = win.get(cid)
                if c is not None:
                    out[cid] = c
            return out
        cells, parents, ires = cs.cells, cs.parents, g.index_res
        out = {}
        for cid, c in win.items():
            ci = int(cid, 16)
            if ci in cells or cell_to_parent(ci, ires) in parents:
                out[cid] = c
        return out

    def _bulk_members(self, g: _GridState, win: dict) -> dict:
        """{qid: {cid: count}} for EVERY query the window's cells
        touch, built in one pass over the window through the inverted
        index — the resync/advance path must never be O(registered ×
        window)."""
        out: dict = {}
        for cid, c in win.items():
            ci = int(cid, 16)
            fine = g.index.get(ci)
            coarse = g.pindex.get(cell_to_parent(ci, g.index_res))
            for qid in _chain_ids(fine, coarse, g.all):
                out.setdefault(qid, {})[cid] = c
        return out

    def _seed_from_members(self, q: Query, g: _GridState,
                           members: dict) -> None:
        """Silently install a query's edge state from its current
        region members (registration and resync are not transitions)."""
        if q.type == "geofence":
            q.state = set(members)
        elif q.type == "threshold":
            q.state = {cid for cid, c in members.items()
                       if c >= q.threshold}
        elif q.type == "topk":
            q.counts = dict(members)
            # seed the last-pushed ranking signature too: the
            # incremental state must equal the one-shot list right
            # after a registration or resync, and the next real change
            # must push exactly one update
            q.state = {tuple((e["cell"], e["count"]) for e in
                             self._topk_of(q.counts, q.k))}
        if q.state or q.counts:
            g.active.add(q.id)
        else:
            g.active.discard(q.id)

    def _seed_query(self, q: Query, g: _GridState) -> None:
        latest = g.latest()
        if latest is None:
            return
        self._seed_from_members(q, g,
                                self._members_of(q, g, g.wins[latest]))

    def remove(self, qid: str) -> bool:
        with self._lock:
            q = self._queries.pop(qid, None)
            if q is None:
                return False
            g = self._grids.get(q.grid)
            if g is not None:
                g.all.discard(qid)
                g.active.discard(qid)
                fine, coarse = q.index_keys or ((), ())
                for keys, idx in ((fine, g.index), (coarse, g.pindex)):
                    for key in keys:
                        ids = idx.get(key)
                        if ids is not None:
                            ids.discard(qid)
                            if not ids:
                                del idx[key]
            self._cond.notify_all()
            return True

    def _maybe_sweep(self) -> None:
        now = self.clock()
        with self._lock:
            if now - self._sweep_last < 1.0:
                return
            self._sweep_last = now
            dead = [qid for qid, q in self._queries.items()
                    if q.expires_mono is not None
                    and q.expires_mono <= now]
        for qid in dead:
            self.remove(qid)

    # ------------------------------------------------------------- drain
    def eval_lag_s(self) -> float:
        try:
            head = self._pending[0]
        except IndexError:
            return 0.0  # drained between the scrape's check and read
        return max(0.0, time.monotonic() - head[0])

    def drain(self, max_n: int = 100000) -> int:
        """Apply queued mutation records in order; returns records
        processed.  Tests drive this synchronously for per-seq
        determinism; production drains on the engine thread."""
        n = 0
        with self._drain_lock:
            while self._pending and n < max_n:
                t_enq, rec = self._pending.popleft()
                t0 = time.perf_counter()
                try:
                    with self._lock:
                        self._process(rec)
                except Exception:
                    log.exception("continuous-query record eval failed "
                                  "(kind=%s seq=%s)", rec.get("kind"),
                                  rec.get("seq"))
                if self._h_eval is not None:
                    self._h_eval.observe(time.perf_counter() - t0)
                n += 1
        if n:
            with self._cond:
                self._cond.notify_all()
        return n

    def _process(self, rec: dict) -> None:
        kind = rec.get("kind")
        seq = int(rec.get("seq", 0))
        if kind == "reset":
            # replica snapshot resync / epoch switch: rebuild the
            # shadow AND every query's edge state from the replaced
            # view, emitting nothing — the records between the old and
            # new state were never observed, so diffing across the gap
            # would mint phantom transitions.  One bulk pass per grid
            # through the index (never O(registered x window)).
            self._seed_from_view()
            for q in self._queries.values():
                q.state = set()
                q.counts = {}
            for grid, g in self._grids.items():
                g.active.clear()
                latest = g.latest()
                if latest is None:
                    continue
                by_q = self._bulk_members(g, g.wins[latest])
                for qid, members in by_q.items():
                    q = self._queries.get(qid)
                    if q is not None and q.grid == grid:
                        self._seed_from_members(q, g, members)
            return
        if seq <= self._seq:
            return  # snapshot/tail overlap replay — idempotent skip
        self._seq = seq
        if kind == "apply":
            self._apply_record(rec.get("docs") or [], seq)
        elif kind == "evict":
            grid = rec.get("grid") or ""
            g = self._grids.get(grid)
            if g is None:
                return
            for ws in rec.get("ws") or []:
                g.wins.pop(int(ws), None)
            self._retarget(grid, g, seq)
        elif kind == "resync":
            grid = rec.get("grid") or ""
            g = self._grid(grid)
            g.wins.clear()
            ws = rec.get("ws")
            docs = rec.get("docs") or []
            if ws is not None and docs:
                g.wins[int(ws)] = {d["cellId"]: int(d.get("count", 0))
                                   for d in docs}
            self._retarget(grid, g, seq)
        elif kind == "anomaly":
            self._anomaly_record(rec, seq)

    def _anomaly_record(self, rec: dict, seq: int) -> None:
        """Match one inference anomaly batch against anomaly
        subscribers through the same inverted indexes the tile types
        use — O(events x candidates-of-their-cells), never
        O(registered).  Event cells are snapped at the grid's base res
        by the inference engine (infer.engine._raise_events), so index
        membership is exact here too."""
        grid = rec.get("grid") or ""
        g = self._grids.get(grid)
        if g is None:
            return
        ws = g.latest() or 0
        for ev in rec.get("events") or []:
            cid = ev.get("cell")
            reason = ev.get("reason")
            if not cid or not reason:
                continue
            try:
                ci = int(cid, 16)
            except ValueError:
                continue
            fine = g.index.get(ci)
            coarse = g.pindex.get(cell_to_parent(ci, g.index_res))
            for qid in list(_chain_ids(fine, coarse, g.all)):
                q = self._queries.get(qid)
                if q is None or q.type != "anomaly":
                    continue
                if q.reasons is not None and reason not in q.reasons:
                    continue
                if self._c_evals is not None:
                    self._c_evals.inc()
                self._emit(q, "anomaly", seq, grid, ws, cid=cid,
                           extra={"entity": ev.get("entity"),
                                  "reason": reason,
                                  "score": ev.get("score"),
                                  "lat": ev.get("lat"),
                                  "lon": ev.get("lon"),
                                  "speedKmh": ev.get("speedKmh"),
                                  "eventT": ev.get("t")})

    def _apply_record(self, docs, seq: int) -> None:
        """One apply record, evaluated at RECORD granularity.  A window
        advance is detected against the record's per-grid max ws and
        handled after the WHOLE record's docs are in the shadow —
        diffing edge state against a partially-installed new window
        would flap exit/enter pairs for cells occupied in both windows
        (and push truncated topk lists) whenever the advancing record
        carries more than one doc."""
        staged: dict[str, list] = {}
        for doc in docs:
            grid = doc.get("grid")
            ws_dt_v = doc.get("windowStart")
            cid = doc.get("cellId")
            if not grid or cid is None \
                    or not isinstance(ws_dt_v, dt.datetime):
                continue
            staged.setdefault(grid, []).append(
                (int(ws_dt_v.timestamp()), cid,
                 int(doc.get("count", 0)), doc))
        for grid, items in staged.items():
            g = self._grids.get(grid)
            if g is None:
                # no queries ever touched this grid: keep a shadow
                # anyway (cheap — counts only), so a query registered
                # later has state to seed from without a view export
                g = self._grid(grid)
            latest_before = g.latest()
            rec_max_ws = max(ws for ws, _, _, _ in items)
            if latest_before is not None and rec_max_ws > latest_before:
                # window advance: install everything first, then diff
                # edge state ONCE against the complete new window
                for ws, cid, count, _doc in items:
                    self._shadow_put(g, ws, cid, count)
                self._retarget(grid, g, seq)
                # _retarget deliberately pushes no per-cell range
                # deltas; the new window's docs ARE count changes the
                # range contract promises to push
                latest = g.latest()
                self._range_matches(
                    grid, g, seq, latest,
                    [(cid, count) for ws, cid, count, _ in items
                     if ws == latest])
                continue
            for ws, cid, count, doc in items:
                old = self._shadow_put(g, ws, cid, count)
                if ws == g.latest():
                    self._touch(grid, g, seq, ws, cid, old, count, doc)
                # else: late event into a non-latest window, invisible

    def _shadow_put(self, g: _GridState, ws: int, cid: str,
                    count: int):
        """Install one count into the shadow; returns the previous
        count (None when new)."""
        win = g.wins.get(ws)
        if win is None:
            win = g.wins[ws] = {}
            while len(g.wins) > _MAX_SHADOW_WINDOWS:
                del g.wins[min(g.wins)]
        old = win.get(cid)
        win[cid] = count
        return old

    def _range_matches(self, grid: str, g: _GridState, seq: int,
                       ws: int | None, pairs) -> None:
        """Push ``match`` events to range subscribers for freshly
        installed latest-window docs (the window-advance path)."""
        if ws is None:
            return
        for cid, count in pairs:
            ci = int(cid, 16)
            fine = g.index.get(ci)
            coarse = g.pindex.get(cell_to_parent(ci, g.index_res))
            for qid in list(_chain_ids(fine, coarse, g.all)):
                q = self._queries.get(qid)
                if q is None or q.type != "range":
                    continue
                if self._c_evals is not None:
                    self._c_evals.inc()
                self._emit(q, "match", seq, grid, ws, cid=cid,
                           count=count)

    def _touch(self, grid: str, g: _GridState, seq: int, ws: int,
               cid: str, old: int | None, count: int, doc: dict) -> None:
        # the engine's only hot path: one changed cell against its
        # candidate queries.  Both indexes are EXACT (a query appears
        # under a snap cell or its promoted parent only if the cell is
        # a member), so there is no per-candidate geometry here at all
        cell_int = int(cid, 16)
        fine = g.index.get(cell_int)
        coarse = g.pindex.get(cell_to_parent(cell_int, g.index_res))
        if not fine and not coarse and not g.all:
            return
        for qid in list(_chain_ids(fine, coarse, g.all)):
            q = self._queries.get(qid)
            if q is None:
                continue
            if self._c_evals is not None:
                self._c_evals.inc()
            if q.type == "range":
                if old != count:
                    self._emit(q, "match", seq, grid, ws, cid=cid,
                               count=count)
            elif q.type == "geofence":
                if cid not in q.state:
                    q.state.add(cid)
                    g.active.add(qid)
                    self._emit(q, "enter", seq, grid, ws, cid=cid,
                               count=count)
            elif q.type == "threshold":
                above = count >= q.threshold
                was = cid in q.state
                if above and not was:
                    q.state.add(cid)
                    g.active.add(qid)
                    self._emit(q, "above", seq, grid, ws, cid=cid,
                               count=count)
                elif was and not above:
                    q.state.discard(cid)
                    self._emit(q, "below", seq, grid, ws, cid=cid,
                               count=count)
            elif q.type == "topk":
                if q.counts.get(cid) != count:
                    q.counts[cid] = count
                    g.active.add(qid)
                    self._retopk(q, seq, grid, ws)

    @staticmethod
    def _topk_of(counts: dict, k: int) -> list:
        return [{"cell": cid, "count": counts[cid]}
                for cid in heapq.nsmallest(
                    k, counts, key=lambda c: (-counts[c], c))]

    def _retopk(self, q: Query, seq: int, grid: str, ws: int) -> None:
        # q.state holds the last pushed ranking signature (the set slot
        # reused as a one-element container) — a count change inside
        # the region that does not reorder the published list pushes
        # nothing
        top = self._topk_of(q.counts, q.k)
        sig = tuple((e["cell"], e["count"]) for e in top)
        if q.state and next(iter(q.state)) == sig:
            return
        q.state = {sig}
        self._emit(q, "topk", seq, grid, ws, topk=top)

    def _retarget(self, grid: str, g: _GridState, seq: int) -> None:
        """The serving-visible window changed wholesale (advance /
        eviction / store rebuild resync): rebuild every touched query's edge
        state against the new latest window and emit the DIFF — cells
        present in both windows transition nothing."""
        latest = g.latest()
        win = g.wins.get(latest, {}) if latest is not None else {}
        ws = latest if latest is not None else 0
        # one bulk pass over the new window through the index, then
        # diff every touched query — plus everything with PRIOR state
        # (its cells may have vanished entirely)
        by_q = self._bulk_members(g, win)
        cands = set(g.active) | set(by_q)
        for qid in cands:
            q = self._queries.get(qid)
            if q is None:
                continue
            if self._c_evals is not None:
                self._c_evals.inc()
            members = by_q.get(qid, {})
            if q.type == "geofence":
                new = set(members)
                for cid in sorted(q.state - new):
                    self._emit(q, "exit", seq, grid, ws, cid=cid)
                for cid in sorted(new - q.state):
                    self._emit(q, "enter", seq, grid, ws, cid=cid,
                               count=members.get(cid))
                q.state = new
            elif q.type == "threshold":
                new = {cid for cid, c in members.items()
                       if c >= q.threshold}
                for cid in sorted(q.state - new):
                    self._emit(q, "below", seq, grid, ws, cid=cid,
                               count=members.get(cid))
                for cid in sorted(new - q.state):
                    self._emit(q, "above", seq, grid, ws, cid=cid,
                               count=members.get(cid))
                q.state = new
            elif q.type == "topk":
                q.counts = dict(members)
                self._retopk(q, seq, grid, ws)
            # range: per-cell applies to the new window emit their own
            # matches; a wholesale switch has no per-cell delta to push
            if q.state or q.counts:
                g.active.add(qid)
            else:
                g.active.discard(qid)

    def _emit(self, q: Query, kind: str, seq: int, grid: str, ws: int,
              cid: str | None = None, count: int | None = None,
              topk: list | None = None,
              extra: dict | None = None) -> None:
        ev = {"id": q.ev_next, "query": q.id, "kind": kind, "seq": seq,
              "grid": grid, "windowStart": ws,
              "t": round(time.time(), 3)}
        if cid is not None:
            ev["cell"] = cid
        if count is not None:
            ev["count"] = int(count)
        if topk is not None:
            ev["topk"] = topk
        if extra:
            ev.update({k: v for k, v in extra.items() if v is not None})
        q.ev_next += 1
        q.matches += 1
        q.events.append(ev)
        if self._c_matches is not None:
            self._c_matches.inc()

    # -------------------------------------------------------------- read
    def evaluate(self, qid: str) -> dict | None:
        """One-shot evaluation of a registered query against the
        engine's shadow (== the view at the last drained seq): the
        differential replay invariant's left-hand side, and the
        /api/queries?id= detail payload."""
        with self._lock:
            q = self._queries.get(qid)
            if q is None:
                return None
            g = self._grids.get(q.grid)
            latest = g.latest() if g is not None else None
            win = g.wins.get(latest, {}) if latest is not None else {}
            out = {"id": q.id, "type": q.type, "grid": q.grid,
                   "seq": self._seq, "windowStart": latest}
            members = self._members_of(q, g, win)
            if q.type == "topk":
                out["topk"] = self._topk_of(members, q.k)
            elif q.type == "threshold":
                out["cells"] = sorted(cid for cid, c in members.items()
                                      if c >= q.threshold)
            else:  # range / geofence: the matched/occupied cell set
                out["cells"] = sorted(members)
            return out

    @staticmethod
    def oneshot(spec: dict, docs) -> dict:
        """The invariant's right-hand side: evaluate a (validated) spec
        against one latest-window doc list directly — no engine, no
        shadow, no incremental state.  The tests compare this
        against ``evaluate`` at every seq."""
        base_res = _grid_base_res(spec["grid"])
        coarse = max(0, base_res - 2)
        cellset = None
        if "bbox" in spec:
            cellset = geom.compile_bbox(spec["bbox"], base_res,
                                        coarse_res=coarse)
        elif "polygon" in spec:
            cellset = geom.compile_polygon(spec["polygon"], base_res,
                                           coarse_res=coarse)

        def member(cid: str) -> bool:
            return cellset is None or cellset.contains(int(cid, 16))

        counts = {d["cellId"]: int(d.get("count", 0)) for d in docs
                  if member(d["cellId"])}
        if spec["type"] == "topk":
            k = spec.get("k", 10)
            return {"topk": [
                {"cell": cid, "count": counts[cid]}
                for cid in heapq.nsmallest(
                    k, counts, key=lambda c: (-counts[c], c))]}
        if spec["type"] == "threshold":
            t = spec.get("threshold", 1)
            return {"cells": sorted(c for c, n in counts.items()
                                    if n >= t)}
        return {"cells": sorted(counts)}

    def get(self, qid: str) -> Query | None:
        with self._lock:
            return self._queries.get(qid)

    def state_of(self, qid: str):
        """The INCREMENTALLY-maintained edge state (vs ``evaluate``'s
        shadow scan): sorted occupied/above cells, or the last pushed
        topk list — what the differential replay test pins against the
        one-shot evaluation at every seq."""
        with self._lock:
            q = self._queries.get(qid)
            if q is None:
                return None
            if q.type == "topk":
                sig = next(iter(q.state), ())
                return [{"cell": c, "count": n} for c, n in sig]
            return sorted(q.state)

    def describe(self, qid: str) -> dict | None:
        with self._lock:
            q = self._queries.get(qid)
            return q.describe() if q is not None else None

    def list(self, limit: int = 100) -> dict:
        with self._lock:
            qs = sorted(self._queries.values(),
                        key=lambda q: q.created_unix)
            return {"registered": len(qs),
                    "queries": [q.describe() for q in qs[:limit]]}

    def events_since(self, qid: str, last_id: int,
                     max_n: int = 256) -> list:
        with self._lock:
            q = self._queries.get(qid)
            if q is None:
                return []
            return [ev for ev in q.events if ev["id"] > last_id][:max_n]

    def wait_events(self, qid: str, last_id: int,
                    timeout: float) -> bool:
        """Block until the query has events past ``last_id``, was
        removed, or the timeout lapses (the SSE push wait)."""
        with self._cond:
            def ready():
                q = self._queries.get(qid)
                return q is None or (len(q.events) > 0
                                     and q.events[-1]["id"] > last_id)

            return self._cond.wait_for(ready, timeout=timeout)

    @property
    def registered(self) -> int:
        with self._lock:
            return len(self._queries)

    # --------------------------------------------------------- surfaces
    def healthz_checks(self, lag_budget_s: float) -> tuple[dict, bool]:
        """({check: ...}, degraded): evaluation lag past the
        HEATMAP_SLO_CQ_LAG_S budget degrades — standing subscribers are
        being pushed stale matches."""
        lag = self.eval_lag_s()
        ok = lag <= lag_budget_s
        return ({"cq_lag_s": {"value": round(lag, 3),
                              "budget": lag_budget_s, "ok": ok,
                              "registered": self.registered}},
                not ok)
