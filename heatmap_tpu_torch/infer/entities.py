"""Bounded vehicleId -> slot table holding per-entity filter state.

A copy of ``heatmap_tpu/infer/entities.py`` (host numpy in both packages,
so a snapshot of either restores into the other).  One slot per
concurrently-tracked entity: Kalman state + covariance, the local-frame
reference the state is metered about, and the anomaly-edge bookkeeping
(stopped-since, deviation EWMA).  Bounded by ``HEATMAP_ENTITY_CAPACITY``;
slots free by TTL (an entity silent past ``HEATMAP_ENTITY_TTL_S`` is gone)
and, when a batch needs more slots than are free, by exact LRU on
last-observation time -- eviction is accounted per reason so occupancy is
conservation-exact:

    seeded == tracked + evicted{ttl, lru}

Cross-shard handoff: slots are keyed by the COMPOSITE (vehicle, owner
shard) -- the shard that owns each observation's cell under
stream/shardmap.py's fmix64 parent-cell partition.  When an entity's
observations move to a cell owned by a different shard, its filter state
does not follow: the destination keeps its own slot for that vehicle
(seeded on first sight, resumed -- stale -- on re-entry).  Because the key
is a pure function of (vehicle, event cell, partition config), a 1-shard
run with N logical shards maintains exactly the union of the per-shard
tables a real N-shard fleet would.

The slot table is checkpointed alongside the window state (the runtime
commits :meth:`snapshot` as the ``infer`` extra); entities are persisted
under their NAME strings, not intern ids -- intern maps restart empty on
resume, names are the stable key.
"""

from __future__ import annotations

import numpy as np

TS_FREE = -(2 ** 62)  # last_ts of a free slot: below any real epoch


class EntityTable:
    """Slot-table storage + allocation; the Kalman math lives in
    infer.kalman, the policy (gates, anomalies, fields) in
    infer.engine."""

    def __init__(self, capacity: int):
        if capacity < 8:
            raise ValueError(f"entity capacity must be >= 8, got {capacity}")
        self.capacity = int(capacity)
        n = self.capacity
        # slot key (-1 free): intern vehicle id, or the composite
        # vid * n_part + owner when a logical partition is active
        self.vid = np.full(n, -1, np.int64)
        self.last_ts = np.full(n, TS_FREE, np.int64)
        self.seed_ts = np.zeros(n, np.int64)
        self.owner = np.full(n, -1, np.int16)      # partition owner shard
        self.ref = np.zeros((n, 3), np.float64)    # lat0, lon0, cos(lat0)
        self.x = np.zeros((n, 4), np.float32)      # px, py, vx, vy (m, m/s)
        self.P = np.zeros((n, 4, 4), np.float32)
        self.nis_ewma = np.zeros(n, np.float32)
        self.n_upd = np.zeros(n, np.int32)         # filter updates since seed
        self.moving = np.zeros(n, bool)            # ever exceeded v_move
        self.stop_ts = np.full(n, -1, np.int64)    # below v_stop since
        self.stop_alerted = np.zeros(n, bool)
        self.dev_alerted = np.zeros(n, bool)
        self.names: list = [None] * n              # vehicle string per slot
        self._slot_of_vid = np.full(1024, -1, np.int32)
        self.occupancy = 0
        # conservation counters (engine mirrors them into metrics)
        self.n_seeded = 0
        self.n_evicted_ttl = 0
        self.n_evicted_lru = 0
        self.n_reseed_handoff = 0
        self.n_reseed_teleport = 0

    # ------------------------------------------------------------- lookup
    def _grow_vid_map(self, need: int) -> None:
        if need <= len(self._slot_of_vid):
            return
        grown = np.full(max(need, 2 * len(self._slot_of_vid)), -1, np.int32)
        grown[: len(self._slot_of_vid)] = self._slot_of_vid
        self._slot_of_vid = grown

    def slots_of(self, vids: np.ndarray) -> np.ndarray:
        """Current slot per key (-1 = untracked); keys are intern
        vehicle ids, or composite (vehicle, owner) ids under a
        logical partition."""
        self._grow_vid_map(int(vids.max()) + 1 if len(vids) else 0)
        return self._slot_of_vid[vids]

    # ---------------------------------------------------------- allocate
    def _free_slots(self, need: int, now_ts: int, ttl_s: float) -> np.ndarray:
        """``need`` free slot indices, TTL-sweeping first and LRU-evicting
        live entities only when the free pool still falls short."""
        self.evict_ttl(now_ts, ttl_s)
        free = np.nonzero(self.vid < 0)[0]
        if len(free) >= need:
            return free[:need]
        shortfall = need - len(free)
        occupied = np.nonzero(self.vid >= 0)[0]
        # exact LRU: the globally oldest last-observation slots go first
        order = occupied[np.argsort(self.last_ts[occupied],
                                    kind="stable")][:shortfall]
        self._release(order)
        self.n_evicted_lru += len(order)
        return np.concatenate([free, order])[:need]

    def _release(self, slots: np.ndarray) -> None:
        if not len(slots):
            return
        vids = self.vid[slots]
        live = vids >= 0
        self._slot_of_vid[vids[live]] = -1
        self.vid[slots] = -1
        self.last_ts[slots] = TS_FREE
        self.owner[slots] = -1
        for s in slots:
            self.names[int(s)] = None
        self.occupancy -= int(np.count_nonzero(live))

    def evict_ttl(self, now_ts: int, ttl_s: float) -> int:
        """Free every slot silent past the TTL; returns the count."""
        stale = np.nonzero((self.vid >= 0)
                           & (self.last_ts < now_ts - int(ttl_s)))[0]
        if len(stale):
            self._release(stale)
            self.n_evicted_ttl += len(stale)
        return len(stale)

    def seed(self, vids: np.ndarray, names: list, lat: np.ndarray,
             lng: np.ndarray, ts: np.ndarray, owner: np.ndarray,
             now_ts: int, ttl_s: float, p0_pos: float,
             p0_vel: float) -> np.ndarray:
        """Seed fresh slots for ``vids`` (unique, currently untracked) at
        their first observations; returns the assigned slots."""
        m = len(vids)
        if m == 0:
            return np.empty(0, np.int64)
        slots = self._free_slots(m, now_ts, ttl_s)
        self._grow_vid_map(int(vids.max()) + 1)
        self.vid[slots] = vids
        self._slot_of_vid[vids] = slots
        self.last_ts[slots] = ts
        self.seed_ts[slots] = ts
        self.owner[slots] = owner
        lat64 = lat.astype(np.float64)
        self.ref[slots, 0] = lat64
        self.ref[slots, 1] = lng.astype(np.float64)
        self.ref[slots, 2] = np.cos(np.deg2rad(lat64))
        self.x[slots] = 0.0
        P = np.zeros((m, 4, 4), np.float32)
        P[:, 0, 0] = P[:, 1, 1] = p0_pos
        P[:, 2, 2] = P[:, 3, 3] = p0_vel
        self.P[slots] = P
        self.nis_ewma[slots] = 0.0
        self.n_upd[slots] = 0
        self.moving[slots] = False
        self.stop_ts[slots] = -1
        self.stop_alerted[slots] = False
        self.dev_alerted[slots] = False
        for s, name in zip(slots, names):
            self.names[int(s)] = name
        self.occupancy += m
        self.n_seeded += m
        return slots

    # -------------------------------------------------------- checkpoint
    _CKPT_COLS = ("last_ts", "seed_ts", "owner", "ref", "x", "P",
                  "nis_ewma", "n_upd", "moving", "stop_ts",
                  "stop_alerted", "dev_alerted")

    def snapshot(self) -> dict:
        """Compacted occupied rows, keyed by entity NAME (stable across
        restarts; intern ids are not)."""
        occ = np.nonzero(self.vid >= 0)[0]
        out = {"names": np.asarray(
            [self.names[int(s)] or "" for s in occ], dtype=str)}
        for col in self._CKPT_COLS:
            out[col] = getattr(self, col)[occ].copy()
        return out

    def restore(self, data: dict, intern_v: dict, n_part: int = 1) -> int:
        """Re-seat a snapshot's entities; ``intern_v`` is the runtime's
        persistent vehicle intern map (names re-intern into it so the
        restored slots match the ids later batches will carry), and
        ``n_part`` the logical partition width so composite
        (vehicle, owner) keys rebuild identically.
        Returns the number of entities restored."""
        names = [str(n) for n in data["names"]]
        m = min(len(names), self.capacity)
        if m < len(names):
            # capacity shrank across the restart: keep the most recent
            keep = np.argsort(np.asarray(data["last_ts"]),
                              kind="stable")[-m:]
        else:
            keep = np.arange(len(names))
        slots = np.arange(m)
        vids = np.asarray([intern_v.setdefault(names[int(i)], len(intern_v))
                           for i in keep], np.int64)
        owner = np.asarray(data["owner"], np.int64)[keep]
        kids = vids * int(n_part) + np.maximum(owner, 0)
        self._grow_vid_map(int(kids.max()) + 1 if m else 0)
        self.vid[:] = -1
        self._slot_of_vid[:] = -1
        self.last_ts[:] = TS_FREE
        self.names = [None] * self.capacity
        self.vid[slots] = kids
        self._slot_of_vid[kids] = slots
        for s, i in zip(slots, keep):
            self.names[int(s)] = names[int(i)]
        for col in self._CKPT_COLS:
            arr = getattr(self, col)
            src = np.asarray(data[col])[keep]
            arr[slots] = src.astype(arr.dtype, copy=False)
        self.occupancy = m
        return m
