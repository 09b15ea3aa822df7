"""TileMatView — the materialized tile view the API reads instead of the Store.

A copy of ``heatmap_tpu/query/matview.py`` without its audit branches
(the per-window ``DigestTable`` of ``HEATMAP_AUDIT=1``, ROADMAP A6c): the
view keeps no digest table and its feed records carry no ``"dg"``, as an
unaudited reference writer's do.

One in-memory view of (grid, windowStart, cell) → tile doc, maintained
two ways:

- **Writer-fed** (the streaming process): ``AsyncWriter`` calls
  ``apply_packed``/``apply_docs`` on its own thread immediately AFTER a
  sink write has durably applied, so the view never exposes rows that
  aren't in the store.  Each applied batch bumps one monotonic
  ``view_seq``.
- **Store-fed** (serve-only processes): ``StoreViewRefresher`` rebuilds
  a grid from a Store scan, triggered by write-version polling plus a
  TTL for deployments where other processes write the backing store.
  An unchanged rebuild bumps nothing, so ETags stay stable across
  polls of an idle store.

The view powers:

- ``/api/tiles/latest`` renders (O(window), no Store traffic),
- strong ETags — ``etag()`` is a pure view lookup, so an If-None-Match
  hit answers 304 without invoking the renderer at all,
- ``/api/tiles/delta?since=seq`` — changed cells only, from a bounded
  per-grid changelog (mode="full" resync when the client's ``since``
  predates the log horizon, a window switch, or an eviction),
- ``/api/tiles/stream`` SSE pushes (``wait_changed`` blocks on the
  view's condition variable),
- ``/api/tiles/topk`` + bbox filtering, and ``?res=`` zoom-out via the
  incremental pyramid rollup (query.pyramid).

Window eviction mirrors the store's ``staleAt`` TTL semantics lazily at
read time; evicting the grid's LATEST window forces delta clients
through a full resync (their baseline vanished).

Thread model: one lock + condition per view.  Writers (writer thread or
refresher) and readers (HTTP threads) all serialize on it; every
critical section is dict surgery, no I/O, no rendering.
"""

from __future__ import annotations

import collections
import datetime as dt
import logging
import os
import threading
import time

from heatmap_tpu_torch.query.pyramid import Pyramid

log = logging.getLogger(__name__)

UTC = dt.timezone.utc


def _grid_base_res(grid: str) -> int | None:
    """Base H3 resolution of a sink grid label ("h3r8" / "h3r8m1"), or
    None for labels the runtime never writes (junk ?grid= values)."""
    if not grid or not grid.startswith("h3r"):
        return None
    digits = grid[3:].split("m", 1)[0]
    try:
        res = int(digits)
    except ValueError:
        return None
    return res if 0 <= res <= 15 else None


class _Grid:
    """Per-grid view state (all access under the owning view's lock)."""

    __slots__ = ("windows", "meta", "log", "dropped_seq", "window_seq",
                 "mod_seq", "pyramid")

    def __init__(self, grid: str, delta_log: int, pyramid_levels: int):
        self.windows: dict[int, dict[str, dict]] = {}   # ws -> cell -> doc
        self.meta: dict[int, tuple] = {}  # ws -> (ws_dt, we_dt, stale_epoch)
        self.log: collections.deque = collections.deque(maxlen=delta_log)
        self.dropped_seq = 0     # newest changelog seq lost to the bound
        self.window_seq = 0      # seq when the latest window last changed
        self.mod_seq = 0         # seq of the last visible change
        base = _grid_base_res(grid)
        self.pyramid = (Pyramid(base, pyramid_levels)
                        if base is not None and pyramid_levels > 0 else None)

    def latest_ws(self) -> int | None:
        return max(self.windows) if self.windows else None


class TileMatView:
    def __init__(self, delta_log: int = 4096, pyramid_levels: int = 2,
                 registry=None, now_fn=None, replica: bool = False):
        self._delta_log = max(1, int(delta_log))
        self._pyramid_levels = max(0, int(pyramid_levels))
        self._now = now_fn or time.time
        self._grids: dict[str, _Grid] = {}
        self._seq = 0
        # Replica mode (query.repl): the view is a seq-exact FOLLOWER of
        # a writer's replication feed.  Local clock-driven eviction of
        # the LATEST window is disabled — the seq advance it implies
        # must come from the writer's feed marker, or the replica's seq
        # stream would diverge from the writer's and /api/tiles/delta
        # responses would stop being byte-interchangeable across the
        # fleet.  Non-latest stale windows still evict locally (they
        # never advance seq on the writer either).
        self._replica = bool(replica)
        # mutation hook (query.repl.DeltaLogPublisher): called under
        # the view lock with one record per seq-advancing mutation, in
        # seq order — the replication feed is exactly this stream
        self._hook = None
        # mutation WATCHERS (query.continuous): secondary observers of
        # the same stream, enqueue-only like the hook, but (1) there can
        # be several, (2) they additionally see a synthetic
        # {"kind": "reset"} record when replica_reset replaces the whole
        # view (the publisher hook must NOT see one — a reset is not a
        # feed record), so an observer can rebuild derived state without
        # minting phantom transitions for the bootstrap diff
        self._watchers: list = []
        # per-boot nonce folded into every ETag: seq counters restart at
        # 0 each process, so without it a post-restart ETag string could
        # equal a pre-restart one while naming DIFFERENT content — and a
        # strong ETag must never repeat across representations
        self._nonce = os.urandom(4).hex()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.poisoned = False  # an apply blew up; serving falls back
        self._h_apply = None
        if registry is not None:
            self._h_apply = registry.histogram(
                "heatmap_view_apply_seconds",
                "wall time applying one durable write batch (or one "
                "serve-only rebuild diff) to the materialized tile view")
            registry.gauge(
                "heatmap_view_seq",
                "monotonic materialized-view sequence (bumps once per "
                "applied batch / rebuild that changed the view)",
                fn=lambda: self._seq)
            registry.gauge(
                "heatmap_view_cells",
                "live (window, cell) entries held by the materialized "
                "tile view across all grids",
                fn=self.cells_live)

    def set_hook(self, fn) -> None:
        """Attach the replication mutation hook (one per view).  ``fn``
        receives {"kind": "apply"|"evict"|"resync", "seq": int, ...}
        under the view lock — it must only enqueue (the publisher
        drains on its own thread)."""
        with self._lock:
            self._hook = fn

    def add_watcher(self, fn) -> None:
        """Attach a secondary mutation observer (continuous-query
        engine).  Same discipline as the hook — called under the view
        lock, must only enqueue — plus the synthetic reset record."""
        with self._lock:
            if fn not in self._watchers:
                self._watchers.append(fn)

    def remove_watcher(self, fn) -> None:
        with self._lock:
            if fn in self._watchers:
                self._watchers.remove(fn)

    def _emit(self, rec: dict) -> None:
        """Fire the mutation hook + watchers (callers hold the lock).
        A hook failure detaches it and is logged — replication trouble
        must never poison the apply path the sink depends on; the
        detached publisher's feed goes stale, which is exactly what the
        replicas' staleness handling exists to absorb."""
        if self._hook is not None:
            try:
                self._hook(rec)
            except Exception:
                log.exception("view mutation hook failed; detaching "
                              "replication publisher")
                self._hook = None
        self._notify_watchers(rec)

    def _notify_watchers(self, rec: dict) -> None:
        for fn in list(self._watchers):
            try:
                fn(rec)
            except Exception:
                log.exception("view mutation watcher failed; detaching")
                try:
                    self._watchers.remove(fn)
                except ValueError:
                    pass

    def apply_packed(self, body, meta) -> int:
        """Apply packed emit BODY rows (engine layout) — the writer-thread
        hook for the packed sink path.  Decodes with the same oracle the
        portable store write path uses, so view content is exactly what
        a Store read-back would return."""
        from heatmap_tpu_torch.sink.base import packed_tile_docs

        return self.apply_docs(packed_tile_docs(body, meta))

    def apply_docs(self, docs) -> int:
        """Upsert tile docs into the view; one view_seq bump per call.
        Returns the number of cells whose visible doc changed."""
        if not docs:
            return 0
        t0 = time.perf_counter()
        with self._cond:
            seq = self._seq + 1
            changed_docs: list = []
            touched: set = set()
            for doc in docs:
                if self._apply_one(doc, seq):
                    changed_docs.append(doc)
                if doc.get("grid"):
                    touched.add(doc["grid"])
            changed = len(changed_docs)
            if changed:
                self._seq = seq
                self._cond.notify_all()
                self._emit({"kind": "apply", "seq": seq,
                            "docs": changed_docs})
            # evict on the WRITE path too: a grid nobody polls over
            # HTTP (replica behind an LB, secondary grid of a pyramid)
            # would otherwise retain every expired window's cell docs
            # and rollups forever — read-side lazy eviction alone is an
            # unbounded leak for unread grids
            for grid in touched:
                g = self._grids.get(grid)
                if g is not None:
                    self._evict(grid, g)
        if self._h_apply is not None:
            self._h_apply.observe(time.perf_counter() - t0)
        return changed

    def _grid(self, grid: str) -> _Grid:
        g = self._grids.get(grid)
        if g is None:
            g = self._grids[grid] = _Grid(grid, self._delta_log,
                                          self._pyramid_levels)
        return g

    def _apply_one(self, doc: dict, seq: int, g: _Grid | None = None) -> int:
        if g is None:
            grid = doc.get("grid")
            if not grid:
                return 0
            g = self._grid(grid)
        ws_dt = doc["windowStart"]
        ws = int(ws_dt.timestamp())
        w = g.windows.get(ws)
        if w is None:
            w = g.windows[ws] = {}
            stale = doc.get("staleAt")
            g.meta[ws] = (ws_dt, doc.get("windowEnd"),
                          stale.timestamp() if stale is not None else None)
            if ws == g.latest_ws():
                # a NEW latest window: delta clients baselined on the
                # previous window must resync
                g.window_seq = seq
        cid = doc["cellId"]
        old = w.get(cid)
        if old == doc:
            return 0
        w[cid] = doc
        if len(g.log) == g.log.maxlen and g.log:
            g.dropped_seq = g.log[0][0]
        g.log.append((seq, ws, cid))
        if ws == g.latest_ws():
            # mod_seq drives ETags and SSE wakeups: late events landing
            # in a NON-latest window change nothing a client can see, so
            # they must not flap every poller's If-None-Match (their log
            # entries are filtered out of deltas the same way)
            g.mod_seq = seq
        if g.pyramid is not None:
            try:
                g.pyramid.apply(ws, int(cid, 16), old, doc)
            except ValueError:
                g.pyramid = None  # un-H3 cell ids: rollup off for grid
        return 1

    def replace_grid(self, grid: str, docs) -> int:
        """Serve-only rebuild: make the view's ``grid`` equal a Store
        scan of its latest window.  Diffs against the current state so
        an unchanged store bumps nothing (stable ETags) and a same-window
        change flows out as a DELTA, not a full resync.  Returns changed
        cells."""
        t0 = time.perf_counter()
        docs = list(docs)
        with self._cond:
            g = self._grids.get(grid)
            if g is None:
                if not docs:
                    return 0  # junk ?grid= probes must not grow state
                g = self._grid(grid)
            new_ws = int(docs[0]["windowStart"].timestamp()) if docs else None
            self._evict(grid, g)
            cur_ws = g.latest_ws()
            changed = 0
            if new_ws is None:
                if g.windows:
                    changed = self._full_resync(grid, g, None, [])
            elif new_ws != cur_ws:
                changed = self._full_resync(grid, g, new_ws, docs)
            else:
                w = g.windows[cur_ws]
                new_cells = {d["cellId"]: d for d in docs}
                if set(w) - set(new_cells):
                    # cells vanished inside one window (an external
                    # writer replaced the store) — full resync
                    changed = self._full_resync(grid, g, new_ws, docs)
                else:
                    delta = [d for cid, d in new_cells.items()
                             if w.get(cid) != d]
                    if delta:
                        seq = self._seq + 1
                        applied = [d for d in delta
                                   if self._apply_one(d, seq, g)]
                        changed = len(applied)
                        if changed:
                            self._seq = seq
                            self._cond.notify_all()
                            self._emit({"kind": "apply", "seq": seq,
                                        "docs": applied})
        if self._h_apply is not None:
            self._h_apply.observe(time.perf_counter() - t0)
        return changed

    def _advance(self) -> int:
        self._seq += 1
        return self._seq

    def _full_resync(self, grid: str, g: _Grid, ws: int | None,
                     docs) -> int:
        """Replace a grid's whole state (empty when ws is None) and force
        delta clients through mode=full — the one resync sequence every
        replace_grid branch shares (callers hold the lock)."""
        seq = self._advance()
        self._drop_all_windows(grid, g)
        if ws is not None:
            self._install_window(grid, g, ws, docs)
        g.window_seq = g.mod_seq = seq
        g.log.clear()
        g.dropped_seq = seq
        self._cond.notify_all()
        self._emit({"kind": "resync", "seq": seq, "grid": grid,
                    "ws": ws, "docs": list(docs)})
        return max(1, len(docs))

    def _drop_all_windows(self, grid: str, g: _Grid) -> None:
        for ws in list(g.windows):
            del g.windows[ws]
            del g.meta[ws]
            if g.pyramid is not None:
                g.pyramid.drop_window(ws)

    def _install_window(self, grid: str, g: _Grid, ws: int,
                        docs) -> None:
        d0 = docs[0]
        stale = d0.get("staleAt")
        g.meta[ws] = (d0["windowStart"], d0.get("windowEnd"),
                      stale.timestamp() if stale is not None else None)
        w = g.windows[ws] = {}
        for d in docs:
            w[d["cellId"]] = d
            if g.pyramid is not None:
                try:
                    g.pyramid.apply(ws, int(d["cellId"], 16), None, d)
                except ValueError:
                    g.pyramid = None

    def seed_grid(self, grid: str, docs) -> int:
        """One-shot warm-up of a grid the view has never seen (a
        writer-fed process restarting against a durable store): UPSERT
        the scanned docs, but only while the grid is still unknown —
        if the writer thread materialized it first, the scan is stale
        and loses.  Never removes cells, so racing a concurrent writer
        apply cannot un-expose a durable row (unlike replace_grid's
        diff, which serve-only rebuilds use as the sole feeder)."""
        with self._cond:
            if grid in self._grids:
                return 0
            docs = list(docs)
            if not docs:
                return 0
            g = self._grid(grid)
            seq = self._seq + 1
            applied = [doc for doc in docs if self._apply_one(doc, seq, g)]
            if applied:
                self._seq = seq
                self._cond.notify_all()
                self._emit({"kind": "apply", "seq": seq, "docs": applied})
            return len(applied)

    def publish_anomalies(self, grid: str, events: list) -> None:
        """Fan an inference anomaly batch (infer.engine event dicts)
        into the mutation feed: one seq bump, one ``kind="anomaly"``
        record through the hook + watchers.  Runs on the writer thread
        via submit_mark, AFTER the batch's tile writes — an anomaly is
        never announced before the window state that produced it is
        durable.  Deliberately does NOT touch mod_seq / window_seq or
        the digest table: events are not tile content, so tile ETags,
        delta logs, and window digests stay byte-identical to a run
        with the reducer off.  Replicas relay the record verbatim
        (replica_apply advances seq on unknown kinds), so a replica's
        continuous-query engine sees the same stream as the writer's."""
        if not events:
            return
        with self._cond:
            self._seq += 1
            rec = {"kind": "anomaly", "seq": self._seq, "grid": grid,
                   "events": list(events)}
            self._cond.notify_all()
            self._emit(rec)

    def poison(self) -> None:
        """An apply failed: the view may have diverged from the store.
        Serving falls back to direct Store renders; SSE waiters wake."""
        with self._cond:
            self.poisoned = True
            self._cond.notify_all()

    # ---- replication (query.repl) --------------------------------------
    # The follower half of the mutation-hook contract: apply records at
    # the WRITER'S seq values, so a replica's delta/ETag seq stream is
    # interchangeable with the writer's.  Records at or below the
    # replica's seq are skipped (idempotent replay: snapshot + tail may
    # overlap).

    def replica_apply(self, rec: dict) -> int:
        """Apply one replication feed record; returns changed cells."""
        kind = rec.get("kind")
        seq = int(rec.get("seq", 0))
        with self._cond:
            if seq <= self._seq:
                return 0
            changed = 0
            if kind == "apply":
                for doc in rec.get("docs") or []:
                    changed += self._apply_one(doc, seq)
            elif kind == "evict":
                grid = rec.get("grid") or ""
                g = self._grids.get(grid)
                if g is not None:
                    for ws in rec.get("ws") or []:
                        if ws in g.windows:
                            del g.windows[ws]
                            del g.meta[ws]
                            if g.pyramid is not None:
                                g.pyramid.drop_window(ws)
                    g.window_seq = g.mod_seq = seq
                    changed = 1
            elif kind == "resync":
                grid = rec.get("grid") or ""
                g = self._grid(grid)
                self._drop_all_windows(grid, g)
                ws = rec.get("ws")
                docs = rec.get("docs") or []
                if ws is not None and docs:
                    self._install_window(grid, g, int(ws), docs)
                g.window_seq = g.mod_seq = seq
                g.log.clear()
                g.dropped_seq = seq
                changed = max(1, len(docs))
            # the seq tracks the writer even when nothing changed
            # locally (replayed no-ops): lag accounting and delta
            # "since > seq -> full" behavior depend on it
            self._seq = seq
            if changed:
                self._cond.notify_all()
            self._emit(rec)  # relay topologies republish verbatim
        return changed

    def replica_reset(self, state: dict) -> None:
        """Replace the whole view with a publisher snapshot
        (``export_state`` shape): the follower's bootstrap, epoch
        switch, and post-fallback resync path.  Mints a fresh ETag
        nonce — after a reset the seq counter may move BACKWARD (a
        restarted writer), and a strong ETag must never name two
        representations."""
        with self._cond:
            self._grids.clear()
            seq = int(state.get("seq", 0))
            for grid, gs in (state.get("grids") or {}).items():
                g = self._grid(grid)
                for ws_key, cells in (gs.get("windows") or {}).items():
                    ws = int(ws_key)
                    w = g.windows[ws] = {}
                    meta = (gs.get("meta") or {}).get(ws_key)
                    if meta:
                        g.meta[ws] = (meta[0], meta[1], meta[2])
                    else:
                        any_doc = next(iter(cells.values()), None)
                        stale = (any_doc or {}).get("staleAt")
                        g.meta[ws] = (
                            (any_doc or {}).get("windowStart"),
                            (any_doc or {}).get("windowEnd"),
                            stale.timestamp() if stale is not None
                            else None)
                    for cid, doc in cells.items():
                        w[cid] = doc
                        if g.pyramid is not None:
                            try:
                                g.pyramid.apply(ws, int(cid, 16),
                                                None, doc)
                            except ValueError:
                                g.pyramid = None
                g.window_seq = int(gs.get("window_seq", seq))
                g.mod_seq = int(gs.get("mod_seq", seq))
                # the snapshot carries no changelog: anything before
                # its seq is beyond this replica's delta horizon
                g.dropped_seq = seq
            self._seq = seq
            self._nonce = os.urandom(4).hex()
            self._cond.notify_all()
            # watchers (not the feed hook): derived state must rebuild
            # from the replaced view instead of diffing across the
            # bootstrap — a resync never mints phantom transitions
            self._notify_watchers({"kind": "reset", "seq": seq})

    def backfill_window(self, grid: str, ws: int, docs,
                        stale_ts: float | None = None) -> bool:
        """History cold-start backfill (query/history.py): install one
        PRE-LATEST window's docs without advancing seq, firing the
        replication hook/watchers — the window is historical context, not a new mutation, so the
        replica's seq/ETag/delta stream stays byte-interchangeable
        with the writer's.  Refused (False) when the grid is unknown
        or empty, the window already exists, or ``ws`` would become
        the latest window (backfill must never change what /latest
        serves)."""
        docs = list(docs)
        if not docs:
            return False
        ws = int(ws)
        with self._cond:
            g = self._grids.get(grid)
            if g is None:
                return False
            latest = g.latest_ws()
            if latest is None or ws >= latest or ws in g.windows:
                return False
            d0 = docs[0]
            w = g.windows[ws] = {}
            g.meta[ws] = (d0.get("windowStart"), d0.get("windowEnd"),
                          stale_ts)
            for d in docs:
                w[d["cellId"]] = d
                if g.pyramid is not None:
                    try:
                        g.pyramid.apply(ws, int(d["cellId"], 16),
                                        None, d)
                    except ValueError:
                        g.pyramid = None
            return True

    def has_window(self, grid: str, ws: int) -> bool:
        with self._lock:
            g = self._grids.get(grid)
            return g is not None and int(ws) in g.windows

    def window_docs(self, grid: str) -> dict:
        """{ws: (ws_dt, we_dt, docs)} of the grid's live windows under
        ONE lock acquisition — the live overlay /api/tiles/range
        merges over the compacted chunk store (the view is always
        fresher than any chunk covering the same window)."""
        with self._lock:
            g = self._grids.get(grid)
            if g is None:
                return {}
            self._evict(grid, g)
            return {ws: (g.meta[ws][0], g.meta[ws][1], list(w.values()))
                    for ws, w in g.windows.items()}

    def export_state(self) -> dict:
        """The publisher's snapshot of the whole view under ONE lock
        acquisition (``replica_reset``'s input).  Window dicts are
        shallow-copied — docs are replaced, never mutated in place, so
        sharing the doc dicts with concurrent appliers is safe."""
        with self._lock:
            grids = {}
            for grid, g in self._grids.items():
                grids[grid] = {
                    "windows": {str(ws): dict(w)
                                for ws, w in g.windows.items()},
                    "meta": {str(ws): list(m)
                             for ws, m in g.meta.items()},
                    "window_seq": g.window_seq,
                    "mod_seq": g.mod_seq,
                }
            return {"seq": self._seq, "grids": grids}

    # ---- eviction (lazy, under the lock) -------------------------------
    def _evict(self, grid: str, g: _Grid) -> None:
        """Drop windows past their staleAt, mirroring the store's TTL
        index.  Evicting the LATEST window is a visible change: the seq
        advances and delta clients resync (their baseline is gone).  A
        replica never evicts its latest window locally — that seq
        advance arrives as the writer's feed marker (or not at all,
        which is what its staleness SLO is for)."""
        now = self._now()
        latest_before = g.latest_ws()
        dead = [ws for ws, (_, _, stale) in g.meta.items()
                if stale is not None and stale <= now]
        if self._replica:
            dead = [ws for ws in dead if ws != latest_before]
        for ws in dead:
            del g.windows[ws]
            del g.meta[ws]
            if g.pyramid is not None:
                g.pyramid.drop_window(ws)
        if dead and g.latest_ws() != latest_before:
            seq = self._advance()
            g.window_seq = g.mod_seq = seq
            self._cond.notify_all()
            self._emit({"kind": "evict", "seq": seq, "grid": grid,
                        "ws": dead})

    # ---- read side -----------------------------------------------------
    def known_grid(self, grid: str) -> bool:
        with self._lock:
            return grid in self._grids

    def latest_ws_of(self, grid: str) -> int | None:
        """Epoch-seconds windowStart of the grid's latest window (the
        serving-visible one digest verification covers); None when the
        grid is unknown or empty."""
        with self._lock:
            g = self._grids.get(grid)
            return g.latest_ws() if g is not None else None

    def etag(self, grid: str, res: int | None = None) -> str:
        """Strong ETag for the grid's current latest-window view (and
        rollup resolution) — a pure lookup; computing it never renders."""
        with self._lock:
            g = self._grids.get(grid)
            if g is None:
                return f'"{self._nonce}.{grid}.{res}.none.0"'
            self._evict(grid, g)
            return (f'"{self._nonce}.{grid}.{res}.'
                    f'{g.latest_ws()}.{g.mod_seq}"')

    def latest_docs(self, grid: str,
                    res: int | None = None) -> tuple[object, list]:
        """(window_start datetime | None, docs) of the grid's latest
        window; ``res`` selects a pyramid rollup level.  Raises KeyError
        on a resolution the pyramid does not maintain."""
        _, ws_dt, docs = self.snapshot(grid, res)
        return ws_dt, docs

    def snapshot(self, grid: str,
                 res: int | None = None) -> tuple[str, object, list]:
        """(etag, window_start, docs) captured under ONE lock
        acquisition — the pair the serving layer labels responses with.
        Reading them separately would let a concurrent writer apply
        land between the two, pairing a stale strong ETag with newer
        content (one ETag must never name two representations)."""
        etag, ws_dt, docs, _seq = self.snapshot_seq(grid, res)
        return etag, ws_dt, docs

    def snapshot_seq(self, grid: str,
                     res: int | None = None) -> tuple:
        """(etag, window_start, docs, view_seq) under ONE lock
        acquisition — the binary wire frame stamps the view seq into
        every /latest response (the same seq a delta client would feed
        back as ``since=``), so it must be captured atomically with
        the ETag and docs it describes."""
        with self._lock:
            g = self._grids.get(grid)
            if g is None:
                self._check_res(None, grid, res)
                return (f'"{self._nonce}.{grid}.{res}.none.0"', None,
                        [], self._seq)
            self._evict(grid, g)
            ws = g.latest_ws()
            self._check_res(g, grid, res)
            etag = (f'"{self._nonce}.{grid}.{res}.'
                    f'{ws}.{g.mod_seq}"')
            if ws is None:
                return etag, None, [], self._seq
            ws_dt, we_dt, _ = g.meta[ws]
            if res is None or res == _grid_base_res(grid):
                return (etag, ws_dt, list(g.windows[ws].values()),
                        self._seq)
            return (etag, ws_dt, g.pyramid.docs(res, ws, we_dt, ws_dt),
                    self._seq)

    def _check_res(self, g: _Grid | None, grid: str,
                   res: int | None) -> None:
        if res is None or res == _grid_base_res(grid):
            return
        pyr = g.pyramid if g is not None else None
        if pyr is None or res not in pyr.resolutions:
            raise KeyError(res)

    def delta(self, grid: str, since: int) -> dict:
        """Changed cells of the grid's latest window after view seq
        ``since``.  Returns {"mode": "delta"|"full", "seq": next-since,
        "window_start": datetime|None, "docs": [...]}.

        mode="full" (docs = the entire latest window; the client
        REPLACES its set) whenever ``since`` predates the changelog
        horizon, the latest-window switch, an eviction/rebuild, or the
        view itself (a restarted server).  mode="delta" guarantees: the
        client's set at ``since`` plus these upserts == the latest
        window now."""
        with self._lock:
            g = self._grids.get(grid)
            if g is None:
                return {"mode": "full", "seq": self._seq,
                        "window_start": None, "docs": []}
            self._evict(grid, g)
            ws = g.latest_ws()
            if ws is None:
                return {"mode": "full", "seq": self._seq,
                        "window_start": None, "docs": []}
            ws_dt = g.meta[ws][0]
            w = g.windows[ws]
            if (since <= 0 or since > self._seq
                    or since < g.window_seq or since < g.dropped_seq):
                return {"mode": "full", "seq": self._seq,
                        "window_start": ws_dt, "docs": list(w.values())}
            cids: dict[str, None] = {}
            for seq, e_ws, cid in reversed(g.log):
                if seq <= since:
                    break
                if e_ws == ws:
                    cids.setdefault(cid)
            docs = [w[cid] for cid in cids if cid in w]
            return {"mode": "delta", "seq": self._seq,
                    "window_start": ws_dt, "docs": docs}

    def changed_since(self, grid: str, since: int) -> bool:
        with self._lock:
            g = self._grids.get(grid)
            if g is None:
                return False
            self._evict(grid, g)
            return g.mod_seq > since

    def wait_changed(self, grid: str, since: int, timeout: float) -> bool:
        """Block until the grid's view advances past ``since`` (SSE
        push), the view poisons, or the timeout lapses."""
        with self._cond:
            def ready():
                if self.poisoned:
                    return True
                g = self._grids.get(grid)
                return g is not None and g.mod_seq > since

            return self._cond.wait_for(ready, timeout=timeout)

    def topk(self, grid: str, k: int, res: int | None = None,
             bbox: tuple[float, float, float, float] | None = None) -> list:
        """Top-k docs of the latest window by count (count desc, cellId
        asc tiebreak), optionally bbox-filtered (min_lon, min_lat,
        max_lon, max_lat) on the tile centroid."""
        import heapq

        _, docs = self.latest_docs(grid, res)
        if bbox is not None:
            lo_lon, lo_lat, hi_lon, hi_lat = bbox
            kept = []
            for d in docs:
                try:
                    lon, lat = d["centroid"]["coordinates"]
                except (KeyError, TypeError, ValueError):
                    continue
                if lo_lon <= lon <= hi_lon and lo_lat <= lat <= hi_lat:
                    kept.append(d)
            docs = kept
        return heapq.nsmallest(k, docs,
                               key=lambda d: (-int(d.get("count", 0)),
                                              d.get("cellId", "")))

    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def cells_live(self) -> int:
        with self._lock:
            return sum(len(w) for g in self._grids.values()
                       for w in g.windows.values())


class StoreViewRefresher:
    """Keeps a TileMatView equal to a Store for serve-only processes.

    ``refresh(grid)`` is called at the top of every view-backed request:
    it rebuilds the grid from a Store scan when the store's write
    version moved, or when ``poll_s`` elapsed — the TTL that covers
    deployments where OTHER processes write the backing store and a
    local version counter cannot see them (same bound the render cache
    uses).  Rebuild scans only the grid's latest window: exactly what
    the serving surface exposes."""

    def __init__(self, store, view: TileMatView, poll_s: float = 1.0,
                 registry=None, max_grids: int = 256):
        self.store = store
        self.view = view
        self.poll_s = poll_s
        self._max_grids = max_grids
        self._lock = threading.Lock()
        self._st: dict[str, tuple] = {}  # grid -> (ver, next_eligible_t)
        self._fails: dict[str, int] = {}  # grid -> consecutive failures
        # catch-up health for /healthz: a replica whose FIRST scan
        # failed must report degraded, not ok-but-empty — ever_ok flips
        # on the first successful rebuild (even of an empty store, which
        # is a legitimate fresh deployment, not a failure)
        self.ever_ok = False
        self.ever_failed = False
        self._c_rebuilds = None
        if registry is not None:
            self._c_rebuilds = registry.counter(
                "heatmap_view_rebuilds_total",
                "serve-only materialized-view rebuild scans (store "
                "version moved or the poll TTL lapsed)")

    def health(self) -> dict:
        """One /healthz check fragment: not-ok while the view has never
        successfully caught up from the store AND a scan has failed —
        the serves-empty-until-recovery window an LB must see as
        degraded.  Steady-state transient failures keep serving the
        bounded-stale view (ok), as before."""
        catching_up = self.ever_failed and not self.ever_ok
        fails = max(self._fails.values(), default=0)
        return {"value": ("catching up" if catching_up
                          else f"{fails} consecutive scan failures"
                          if fails else "ok"),
                "ok": not catching_up}

    def refresh(self, grid: str) -> None:
        try:
            ver = self.store.version()
        except Exception:
            ver = None
        with self._lock:
            now = time.monotonic()
            st = self._st.get(grid)
            # one guard covers both regimes: st[1] is the next-eligible
            # deadline — poll TTL after a success, the exponential
            # backoff deadline after a failure (retry SOONER than the
            # TTL at first, 0.2 s doubling toward a 30 s cap: a replica
            # must not serve empty for a full TTL because one boot-time
            # scan flaked, nor hammer a down store at request rate).  A
            # MOVED version bypasses either wait: the store is
            # answering again (or changed) and a rescan is due.
            if (st is not None and now < st[1]
                    and (ver is None or ver == st[0])):
                return
            # claim the poll slot BEFORE scanning and scan outside the
            # lock: single-flight per grid without serializing every
            # reader/SSE loop behind one slow store scan
            if len(self._st) >= self._max_grids and grid not in self._st:
                # bounded against client-controlled ?grid= values; evict
                # ONE arbitrary entry, like the serve render cache
                self._st.pop(next(iter(self._st)))
            self._st[grid] = (ver, now + self.poll_s)
        try:
            ws = self.store.latest_window_start(grid)
            docs = (list(self.store.tiles_in_window(ws, grid))
                    if ws is not None else [])
            self.view.replace_grid(grid, docs)
        except Exception:
            # a rebuild scan is idempotent: a transient store error
            # must NOT poison the view — serve the (bounded-stale)
            # current state and retry with backoff
            with self._lock:
                n = self._fails.get(grid, 0) + 1
                self._fails[grid] = n
                self.ever_failed = True
                retry = min(30.0, 0.1 * (2 ** min(n, 9)))
                if grid in self._st:
                    self._st[grid] = (self._st[grid][0],
                                      time.monotonic() + retry)
            log.warning("view rebuild failed for grid %r (attempt %d); "
                        "serving the last materialized state, retrying "
                        "in %.1fs", grid, n, retry, exc_info=True)
            return
        with self._lock:
            self._fails.pop(grid, None)
            self.ever_ok = True
        if self._c_rebuilds is not None:
            self._c_rebuilds.inc()
