"""In-memory Store: the hermetic test/dev sink.

A copy of ``heatmap_tpu/sink/memory.py``.  TTL semantics of ``staleAt``
apply lazily at read time; packed tile writes bank the raw rows and reads
fold the backlog into docs with vectorized last-write-wins per
(grid, cell, windowStart).
"""

from __future__ import annotations

import datetime as dt
import threading
from typing import Iterable, Sequence

import numpy as np

from heatmap_tpu_torch.sink.base import (
    Store,
    TilePackMeta,
    UTC,
    packed_tile_docs,
)


class MemoryStore(Store):
    def __init__(self, now_fn=None):
        self._tile_docs: dict[str, dict] = {}
        self._pos_docs: dict[str, dict] = {}
        # write-side tile backlog [(body_rows, meta)], folded into the
        # doc dicts by _compact_tiles() on the read side.  Positions are
        # NOT banked lazily: their Store contract returns the number
        # APPLIED (the monotonic guard may reject stale rows), which a
        # deferred fold cannot know — and per-batch position volume is
        # bounded by the vehicle count, so the eager doc path is cheap.
        self._tile_backlog: list[tuple[np.ndarray, TilePackMeta]] = []
        self._lock = threading.Lock()
        self._now = now_fn or (lambda: dt.datetime.now(UTC))
        self._version = 0  # bumped on every write (serve cache key)

    def version(self) -> int:
        with self._lock:
            return self._version

    # --- writes ---------------------------------------------------------
    def upsert_tiles(self, docs: Sequence[dict]) -> int:
        with self._lock:
            self._compact_tiles()  # doc writes order AFTER banked packed rows
            for d in docs:
                self._tile_docs[d["_id"]] = dict(d)
            if docs:
                self._version += 1
        return len(docs)

    def upsert_tiles_packed(self, body, meta: TilePackMeta) -> int:
        body = np.asarray(body)
        keep = (body[:, 8] != 0) & (body[:, 3].view(np.int32) > 0)
        n = int(keep.sum())
        if not n:
            return 0
        with self._lock:
            self._tile_backlog.append((body[keep], meta))
            self._version += 1
        return n

    def upsert_positions(self, docs: Sequence[dict]) -> int:
        applied = 0
        with self._lock:
            for d in docs:
                cur = self._pos_docs.get(d["_id"])
                if cur is None or cur.get("ts") is None or cur["ts"] < d["ts"]:
                    self._pos_docs[d["_id"]] = dict(d)
                    applied += 1
            if applied:
                self._version += 1
        return applied

    # --- lazy fold of the packed backlog (callers hold the lock) --------
    def _compact_tiles(self) -> None:
        if not self._tile_backlog:
            return
        backlog, self._tile_backlog = self._tile_backlog, []
        # group per meta (grid identity), newest batch last
        by_meta: dict[TilePackMeta, list[np.ndarray]] = {}
        for body, meta in backlog:
            by_meta.setdefault(meta, []).append(body)
        for meta, bodies in by_meta.items():
            rows = bodies[0] if len(bodies) == 1 else np.concatenate(bodies)
            # vectorized last-write-wins on (cell_hi, cell_lo, windowStart):
            # reverse so the NEWEST duplicate is the one unique() keeps
            rev = rows[::-1]
            comp = rev[:, :3].copy().view(
                [("a", np.uint32), ("b", np.uint32), ("c", np.uint32)])
            _, first = np.unique(comp, return_index=True)
            for d in packed_tile_docs(rev[np.sort(first)], meta):
                self._tile_docs[d["_id"]] = d

    # --- TTL ------------------------------------------------------------
    def _gc(self) -> None:
        now = self._now()
        dead = [k for k, v in self._tile_docs.items()
                if v.get("staleAt") is not None and v["staleAt"] <= now]
        for k in dead:
            del self._tile_docs[k]

    # --- reads ----------------------------------------------------------
    def latest_window_start(self, grid=None):
        with self._lock:
            self._compact_tiles()
            self._gc()
            ws = [v["windowStart"] for v in self._tile_docs.values()
                  if grid is None or v.get("grid") == grid]
        return max(ws) if ws else None

    def tiles_in_window(self, window_start, grid=None) -> Iterable[dict]:
        with self._lock:
            self._compact_tiles()
            self._gc()
            return [dict(v) for v in self._tile_docs.values()
                    if v["windowStart"] == window_start
                    and (grid is None or v.get("grid") == grid)]

    def all_positions(self) -> Iterable[dict]:
        with self._lock:
            return [dict(v) for v in self._pos_docs.values()]

    def grids(self) -> list:
        with self._lock:
            self._compact_tiles()
            self._gc()
            return sorted({v.get("grid") for v in self._tile_docs.values()
                           if v.get("grid")})

    # --- test helpers ---------------------------------------------------
    @property
    def n_tiles(self) -> int:
        with self._lock:
            self._compact_tiles()
            return len(self._tile_docs)

    @property
    def n_positions(self) -> int:
        with self._lock:
            return len(self._pos_docs)

    # Tests and debugging peek at ._tiles/._positions directly (the
    # round-1 attribute names); keep them as compacting views so the
    # lazy packed backlog is invisible to those readers.
    @property
    def _tiles(self) -> dict:
        with self._lock:
            self._compact_tiles()
            return self._tile_docs

    @property
    def _positions(self) -> dict:
        with self._lock:
            return self._pos_docs
