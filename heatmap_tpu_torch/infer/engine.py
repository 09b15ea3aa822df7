"""InferenceEngine: the Kalman reducer's policy layer.

The counterpart of ``heatmap_tpu/infer/engine.py``.  Consumes the
dispatched host batches (stream.events.EventColumns) in dispatch order,
maintains the bounded per-entity slot table (infer.entities), runs the
rounds scan (infer.kalman: the ``kalman_rounds`` CUDA kernel on a CUDA
device, on a stream of the engine's own; the plain version on the CPU), and
owns everything above the filter math:

- **observation order** -- rows sort by (vehicle, owner, ts, stream
  order), a total order invariant under ANY batch re-partitioning; late
  and duplicate rows are folded as-is (dt clamps to [0, TTL]) so the
  filter never consults the count fold's watermark.
- **logical partition** -- slots are keyed by the COMPOSITE (vehicle,
  owner shard), the owner being the shard of each observation's cell
  (stream/shardmap.py's fmix64 parent-cell rule) over
  ``HEATMAP_ENTITY_SHARDS`` logical shards.  Filter state never follows a
  cross-shard crossing: the destination sub-table seeds its own track on
  first sight and resumes it -- stale -- on re-entry, exactly as the real
  destination shard would.  Crossings are counted in the table
  (``n_reseed_handoff``).
- **anomalies** -- reason-tagged events: ``teleport`` (Mahalanobis NIS
  gate), ``stopped`` (filtered speed below v_stop for
  ``HEATMAP_ENTITY_STOP_S`` after having moved; edge-triggered, re-arms
  on movement), ``deviation`` (NIS EWMA above the chi-square 95% line
  after filter warmup; edge-triggered with hysteresis at half the
  threshold).  All detectors run per OBSERVATION round, so the emitted
  event set is exactly reproducible across re-batching.
- **derived fields** -- per-cell velocity field and advected occupancy
  forecasts, both pure functions of the current table; their cells come
  from the f64 C++ host snap (hexgrid.native_snap), as the reference's.

With ``metrics=`` (the runtime's ``stream.metrics.Metrics``) the engine
registers the reference's families in its registry
(``heatmap_infer_entities``, ``heatmap_infer_entity_events_total{op}``,
``heatmap_infer_anomalies_total{reason}``, ``heatmap_infer_fold_seconds``)
and counts ``infer_events_folded`` and ``infer_entities_untracked``
through ``metrics.count``, and the cross-shard re-seeds through
``metrics.drop("handoff", audit=False)``; without one it keeps a
``Metrics`` of its own (``counters`` reads either).

With ``quality`` set (the runtime attaches ``obs.quality``'s observatory
under ``HEATMAP_QUALITY=1``) each fold ends by feeding it: the update
rounds, those inside the chi-square 95% gate and the innovation sums, read
off the rounds' host planes (``nis``, ``inn``, ``tele`` and the round
mask; the one device-to-host copy of the scan), the anomaly counts and the
table's pressure; then the scorecards mature against the event-time
watermark.

Axis convention: state is ``[pn, pe, vn, ve]`` (north, east) in meters
about each entity's f64 reference; serving maps east->``vxKmh``,
north->``vyKmh``.
"""

from __future__ import annotations

import threading
import time

import numpy as np

import torch

from heatmap_tpu_torch.infer.entities import TS_FREE, EntityTable
from heatmap_tpu_torch.infer.kalman import (
    M_PER_DEG,
    RoundsStaging,
    filter_rounds,
    latlng_of,
    local_xy,
)
from heatmap_tpu_torch.stream.shardmap import ShardMap

ANOMALY_REASONS = ("stopped", "teleport", "deviation")

# chi-square(2 dof) tails: 0.999 gates teleports, 0.95 flags deviation
_GATE_NIS = 13.816
_DEV_NIS = 5.991
_EWMA_ALPHA = 0.2
_WARMUP_UPDATES = 10       # filter updates before deviation can fire
_Q_ACCEL = 0.5             # white-accel PSD, m^2/s^3 (urban vehicles)
_R_M = 25.0                # GPS position std, meters
_P0_POS = _R_M * _R_M
_P0_VEL = 100.0            # (10 m/s)^2 prior velocity variance
_V_STOP = 1.0              # m/s: below this counts as stopped
_V_MOVE = 3.0              # m/s: must exceed once before stop can alarm
_MAX_ANOMALY_BUFFER = 65536


class InferenceEngine:
    """Per-entity streaming filter + anomaly/forecast policy."""

    def __init__(self, cfg, device="cuda", metrics=None, clock=None,
                 partition_snap=None):
        from heatmap_tpu_torch.obs.registry import DEFAULT_TIME_BUCKETS
        from heatmap_tpu_torch.stream.metrics import Metrics

        self.cfg = cfg
        self.device = torch.device(device)
        # the rounds scan's own CUDA stream and staging buffers
        self._staging = (RoundsStaging(self.device)
                         if self.device.type == "cuda" else None)
        self.metrics = metrics if metrics is not None else Metrics()
        self.clock = clock or time.time
        # the quality observatory (obs.quality), attached by the runtime
        # under HEATMAP_QUALITY=1; None leaves the fold as it was
        self.quality = None
        self.capacity = int(cfg.entity_capacity)
        self.ttl_s = float(cfg.entity_ttl_s)
        self.stop_s = float(cfg.entity_stop_s)
        res_list = cfg.resolutions or (cfg.h3_res,)
        self.base_res = (cfg.h3_res if cfg.h3_res in res_list
                         else res_list[0])
        # logical entity partition: HEATMAP_ENTITY_SHARDS logical
        # shards (0 = the runtime's HEATMAP_SHARDS); a single-process run
        # with N logical shards applies the SAME handoff re-seeds as a
        # real N-shard fleet.  ``partition_snap`` is the snap the
        # runtime's ownership filter reads (None: the host snap), so an
        # entity's owner is the shard that folds its rows
        n_part = int(cfg.entity_shards) or int(cfg.shards)
        self.n_part = n_part if n_part > 1 else 1
        self.partition = None
        if n_part > 1:
            idx = cfg.shard_index if cfg.shards > 1 else 0
            self.partition = ShardMap(n_part, idx, min(res_list),
                                      cfg.shard_res,
                                      snap_fn=partition_snap)
        self.table = EntityTable(self.capacity)
        self._lock = threading.Lock()
        self._snap_maps: dict = {}
        self._anomalies: list = []
        self._anom_counts = {r: 0 for r in ANOMALY_REASONS}
        self._anom_dropped = 0
        self._max_ts = 0
        self._folds = 0
        self._events = 0
        self._last_fold_ms = 0.0
        self._last_wall = 0.0
        self._vel_cache: dict = {}
        self._tbl_last = {k: 0 for k in (
            "n_seeded", "n_evicted_ttl", "n_evicted_lru",
            "n_reseed_handoff", "n_reseed_teleport")}
        reg = self.metrics.registry
        reg.gauge(
            "heatmap_infer_entities",
            "entities currently tracked in the per-shard slot table "
            "(bounded by HEATMAP_ENTITY_CAPACITY)",
            fn=lambda: float(self.table.occupancy))
        self._ent_fam = reg.counter(
            "heatmap_infer_entity_events_total",
            "entity slot-table lifecycle events per op (seeded, "
            "evicted_ttl, evicted_lru, reseed_handoff, reseed_teleport) "
            "- seeded == tracked + evicted so occupancy is "
            "conservation-exact",
            labels=("op",))
        for op in ("seeded", "evicted_ttl", "evicted_lru",
                   "reseed_handoff", "reseed_teleport"):
            self._ent_fam.labels(op=op)
        self._anom_fam = reg.counter(
            "heatmap_infer_anomalies_total",
            "reason-tagged per-entity anomaly events (stopped, teleport, "
            "deviation) raised by the Kalman reducer",
            labels=("reason",))
        for r in ANOMALY_REASONS:
            self._anom_fam.labels(reason=r)
        self._fold_hist = reg.histogram(
            "heatmap_infer_fold_seconds",
            "wall time of one reducer fold over a dispatched batch (sort, "
            "rounds build, Kalman scan, anomaly pass)",
            buckets=DEFAULT_TIME_BUCKETS)

    @property
    def counters(self):
        """The event counters (the metrics' counter dict)."""
        return self.metrics.counters

    # ----------------------------------------------------------- helpers
    def _snap(self, lat_rad: np.ndarray, lng_rad: np.ndarray,
              res: int) -> np.ndarray:
        """uint64 cells at ``res`` via the shared shard-map snap path."""
        sm = self._snap_maps.get(res)
        if sm is None:
            sm = self._snap_maps[res] = ShardMap(1, 0, res)
        return sm.cells_of(np.asarray(lat_rad, np.float32),
                           np.asarray(lng_rad, np.float32))

    # -------------------------------------------------------------- fold
    def fold_batch(self, cols, ts_wall: float | None = None) -> None:
        """Fold one dispatched batch (host EventColumns), in dispatch
        order.  Late/duplicate rows fold as-is — see module docstring."""
        n = len(cols)
        if n == 0:
            return
        t0 = time.perf_counter()
        with self._lock:
            self._fold_locked(cols)
            self._folds += 1
            self._events += n
            self._vel_cache.clear()
        self._last_wall = ts_wall if ts_wall is not None else self.clock()
        dt = time.perf_counter() - t0
        self._last_fold_ms = dt * 1e3
        self._fold_hist.observe(dt)
        self.metrics.count("infer_events_folded", n)
        self._sync_table_metrics()

    def _fold_locked(self, cols) -> None:
        n = len(cols)
        vid = cols.vehicle_id.astype(np.int64, copy=False)
        ts = cols.ts_s.astype(np.int64)
        now_ts = max(self._max_ts, int(ts.max()))
        self._max_ts = now_ts
        # partition owner per observation (raw row order)
        n_part = self.n_part
        if self.partition is not None:
            pcells = self.partition.cells_of(cols.lat_rad, cols.lng_rad)
            own_all = self.partition.shard_of_cells(pcells) \
                .astype(np.int64)
        else:
            own_all = np.zeros(n, np.int64)
        # slot key: COMPOSITE (vehicle, owner shard).  Filter state
        # lives under the shard that owns each observation's cell, so
        # a 1-shard run with N logical shards maintains exactly the
        # union of the per-shard tables a real N-shard fleet would —
        # including the stale track a shard resumes when an entity
        # re-enters it — which is what makes fan-in equality exact.
        kid_all = vid * n_part + own_all
        # total per-slot observation order: (vehicle, owner, ts,
        # stream order) — each slot's subsequence is exactly the rows
        # the owning fleet shard would fold, in the same order
        idx = np.argsort(ts, kind="stable")
        idx = idx[np.argsort(kid_all[idx], kind="stable")]
        skid = kid_all[idx]
        sv = vid[idx]
        st = ts[idx]
        slat = cols.lat_deg[idx]
        slng = cols.lng_deg[idx]
        own = own_all[idx].astype(np.int16)
        newgrp = np.empty(n, bool)
        newgrp[0] = True
        newgrp[1:] = skid[1:] != skid[:-1]
        grp_start = np.flatnonzero(newgrp)
        gid = np.cumsum(newgrp) - 1
        rk = np.arange(n) - grp_start[gid]
        m = len(grp_start)
        k = int(rk.max()) + 1
        ukid = skid[grp_start]
        uveh = sv[grp_start]
        # cross-shard handoffs: accounting only — state never follows
        # a crossing (the destination sub-table seeds, or resumes its
        # own stale track).  Counted as owner changes between
        # consecutive same-vehicle observations in (vehicle, ts)
        # order; batch heads consult the vehicle's most-recent slot
        # across owners, so the statistic is batch-boundary invariant.
        # A physical fleet shard never witnesses a crossing (its rows
        # are pre-filtered to one owner): only logical runs count.
        n_handoff = 0
        if n_part > 1:
            jv = np.argsort(ts, kind="stable")
            jv = jv[np.argsort(vid[jv], kind="stable")]
            vj = vid[jv]
            oj = own_all[jv]
            same = vj[1:] == vj[:-1]
            n_handoff = int((same & (oj[1:] != oj[:-1])).sum())
            heads = np.concatenate(([0], np.flatnonzero(~same) + 1))
            cand = vj[heads][:, None] * n_part + np.arange(n_part)
            cslot = self.table.slots_of(cand.ravel()) \
                .reshape(cand.shape)
            clast = np.where(cslot >= 0, self.table.last_ts[cslot],
                             TS_FREE)
            prev = clast.argmax(axis=1)  # column index IS the owner
            seen = clast.max(axis=1) > TS_FREE
            n_handoff += int((seen & (prev != oj[heads])).sum())
        # TTL sweep at event time (deterministic: a function of
        # last_ts and the monotone stream max, never the wall clock)
        self.table.evict_ttl(now_ts, self.ttl_s)
        slots = self.table.slots_of(ukid)
        newm = slots < 0
        untracked = None
        if newm.any():
            n_new = int(newm.sum())
            if n_new > self.capacity:
                # more NEW entities than the whole table: track the
                # first capacity of them this batch, leave the rest
                # untracked (their rows fold as invalid) — accounted,
                # never silently wedged
                keep = np.flatnonzero(newm)[: self.capacity]
                dropped_ent = np.flatnonzero(newm)[self.capacity:]
                untracked = np.isin(gid, dropped_ent)
                newm = np.zeros(m, bool)
                newm[keep] = True
                self.metrics.count("infer_entities_untracked",
                                   int(dropped_ent.size))
            fr = grp_start[newm]
            names = [cols.vehicles[v] if v < len(cols.vehicles) else str(v)
                     for v in uveh[newm]]
            self.table.seed(ukid[newm], names, slat[fr], slng[fr],
                            st[fr], own[fr], now_ts=now_ts,
                            ttl_s=self.ttl_s, p0_pos=_P0_POS,
                            p0_vel=_P0_VEL)
            slots = self.table.slots_of(ukid)
        tracked_g = slots >= 0
        # a fresh seed's first observation IS the seed; it is not a
        # measurement round
        valid = np.ones(n, bool)
        valid[grp_start[newm]] = False
        if untracked is not None:
            valid &= ~untracked
            slots = np.where(tracked_g, slots, 0)  # pad rows, masked out
        # dt per observation: within-group diff; group heads diff
        # against the slot's last observation (clamped to [0, TTL])
        last0 = self.table.last_ts[slots]
        dt = np.zeros(n, np.int64)
        if n > 1:
            dt[1:] = st[1:] - st[:-1]
        dt[grp_start] = st[grp_start] - last0
        dt = np.clip(dt, 0, int(self.ttl_s))
        # measurements in each entity's local frame
        z = local_xy(slat, slng, self.table.ref[slots][gid])
        # rounds tensors (K, M); the scan's reseed lane is unused —
        # a crossing lands in a DIFFERENT slot, never resets this one
        zr = np.zeros((k, m, 2), np.float32)
        zr[rk, gid] = z
        dtr = np.zeros((k, m), np.float32)
        dtr[rk, gid] = dt
        vr = np.zeros((k, m), bool)
        vr[rk, gid] = valid
        rsr = np.zeros((k, m), bool)
        tr_ = np.zeros((k, m), np.int64)
        tr_[rk, gid] = st
        row_of = np.full((k, m), -1, np.int64)
        row_of[rk, gid] = np.arange(n)
        x1, p1, nis, tele, spd, inn = filter_rounds(
            self.table.x[slots], self.table.P[slots], zr, dtr, vr, rsr,
            q=_Q_ACCEL, r_m=_R_M, gate=_GATE_NIS, p0_pos=_P0_POS,
            p0_vel=_P0_VEL, device=self.device, staging=self._staging)
        # write-backs index tracked groups only: untracked-overflow
        # groups were padded to slot 0 and must never touch it
        tg = tracked_g
        stg = slots[tg]
        self.table.x[stg] = x1[tg]
        self.table.P[stg] = p1[tg]
        cnt = np.diff(np.append(grp_start, n))
        last_rows = grp_start + cnt - 1
        self.table.last_ts[stg] = st[last_rows][tg]
        # ---- per-round anomaly pass (order-deterministic): EWMA
        # deviation, stopped-vehicle, plus bookkeeping resets at
        # scan re-seeds
        ew = self.table.nis_ewma[slots].astype(np.float64)
        nupd = self.table.n_upd[slots].copy()
        moving = self.table.moving[slots].copy()
        stop_ts = self.table.stop_ts[slots].copy()
        s_alert = self.table.stop_alerted[slots].copy()
        d_alert = self.table.dev_alerted[slots].copy()
        events: list = []  # (reason, row, score, speed_ms)
        for r in range(k):
            act = vr[r]
            if not act.any():
                continue
            reseed_r = tele[r]
            upd = act & ~reseed_r
            ew = np.where(upd, (1.0 - _EWMA_ALPHA) * ew
                          + _EWMA_ALPHA * nis[r], ew)
            nupd = np.where(upd, nupd + 1, nupd)
            # teleports: the gated observation itself is the event
            for mm in np.flatnonzero(tele[r]):
                events.append(("teleport", int(row_of[r, mm]),
                               float(nis[r, mm]), float(spd[r, mm])))
            # deviation: EWMA crossing after warmup, edge-triggered
            # with hysteresis release at half the threshold
            trig_d = (upd & (ew > _DEV_NIS) & ~d_alert
                      & (nupd >= _WARMUP_UPDATES))
            for mm in np.flatnonzero(trig_d):
                events.append(("deviation", int(row_of[r, mm]),
                               float(ew[mm]), float(spd[r, mm])))
            d_alert |= trig_d
            d_alert &= ~(upd & (ew < _DEV_NIS * 0.5))
            # stopped: filtered speed below v_stop for stop_s after
            # having moved; re-arms when the entity moves again
            spd_r = spd[r]
            moving |= act & (spd_r > _V_MOVE)
            below = act & (spd_r < _V_STOP)
            t_r = tr_[r]
            stop_ts = np.where(below & (stop_ts < 0), t_r, stop_ts)
            stop_ts = np.where(act & ~below, -1, stop_ts)
            s_alert &= ~(act & ~below)
            trig_s = (moving & below & (stop_ts >= 0) & ~s_alert
                      & (t_r - stop_ts >= int(self.stop_s)))
            for mm in np.flatnonzero(trig_s):
                events.append(("stopped", int(row_of[r, mm]),
                               float(t_r[mm] - stop_ts[mm]),
                               float(spd_r[mm])))
            s_alert |= trig_s
            # a teleport re-seed resets all detector state
            ew = np.where(reseed_r, 0.0, ew)
            nupd = np.where(reseed_r, 0, nupd)
            moving &= ~reseed_r
            stop_ts = np.where(reseed_r, -1, stop_ts)
            s_alert &= ~reseed_r
            d_alert &= ~reseed_r
        self.table.nis_ewma[stg] = ew[tg].astype(np.float32)
        self.table.n_upd[stg] = nupd[tg]
        self.table.moving[stg] = moving[tg]
        self.table.stop_ts[stg] = stop_ts[tg]
        self.table.stop_alerted[stg] = s_alert[tg]
        self.table.dev_alerted[stg] = d_alert[tg]
        # NOTE: an entity's reference frame is FIXED at seed time — a
        # scan re-seed resets state about the same reference.  Deferred
        # re-anchoring would make f32 rounding depend on where batch
        # boundaries fall, breaking the replay/resize byte-identity
        # these differentials pin; city-scale f32 offsets resolve ~4 mm,
        # so a stable frame costs nothing.
        n_tele = int(tele.sum())
        self.table.n_reseed_handoff += n_handoff
        self.table.n_reseed_teleport += n_tele
        # the count fold did fold these events: the tag records the
        # filter discarding cross-shard history, outside the event
        # conservation identity (audit=False)
        self.metrics.drop("handoff", n_handoff, audit=False)
        if events:
            self._raise_events(events, slat, slng, st, sv, cols)
        if self.quality is not None:
            # calibration feed (observe-only; after all fold state is
            # final, so a raise cannot corrupt the table), read off the
            # rounds' host planes: update rounds are valid non-teleport
            # rounds, the rounds whose NIS the chi-square reference
            # describes
            upd_mask = vr & ~tele
            self.quality.note_fold(
                t=now_ts,
                updates=int(upd_mask.sum()),
                inside=int((upd_mask & (nis <= _DEV_NIS)).sum()),
                inn_n=float(inn[..., 0][upd_mask].sum()),
                inn_e=float(inn[..., 1][upd_mask].sum()),
                anomalies=dict(self._anom_counts),
                table={
                    "entities": int(self.table.occupancy),
                    "capacity": int(self.table.capacity),
                    "evicted_ttl": int(self.table.n_evicted_ttl),
                    "evicted_lru": int(self.table.n_evicted_lru),
                    "reseed_handoff": int(self.table.n_reseed_handoff),
                    "reseed_teleport": int(self.table.n_reseed_teleport),
                })
            # the scorecard lifecycle advances on the event-time high
            # watermark (deterministic: never the wall clock)
            self.quality.mature(now_ts)

    def _raise_events(self, events, slat, slng, st, sv, cols) -> None:
        rows = np.asarray([e[1] for e in events], np.int64)
        cells = self._snap(np.deg2rad(slat[rows].astype(np.float64)),
                           np.deg2rad(slng[rows].astype(np.float64)),
                           self.base_res)
        for (reason, row, score, spd_ms), cell in zip(events, cells):
            v = int(sv[row])
            name = (cols.vehicles[v] if v < len(cols.vehicles)
                    else str(v))
            self._anom_counts[reason] += 1
            self._anom_fam.labels(reason=reason).inc()
            if len(self._anomalies) >= _MAX_ANOMALY_BUFFER:
                self._anom_dropped += 1
                continue
            self._anomalies.append({
                "entity": name,
                "reason": reason,
                "cell": f"{int(cell):x}",
                "lat": round(float(slat[row]), 6),
                "lon": round(float(slng[row]), 6),
                "t": int(st[row]),
                "score": round(score, 3),
                "speedKmh": round(spd_ms * 3.6, 2),
            })

    def _sync_table_metrics(self) -> None:
        ops = {"n_seeded": "seeded", "n_evicted_ttl": "evicted_ttl",
               "n_evicted_lru": "evicted_lru",
               "n_reseed_handoff": "reseed_handoff",
               "n_reseed_teleport": "reseed_teleport"}
        for attr, op in ops.items():
            cur = getattr(self.table, attr)
            delta = cur - self._tbl_last[attr]
            if delta:
                self._ent_fam.labels(op=op).inc(delta)
                self._tbl_last[attr] = cur

    # ------------------------------------------------------------ drains
    def drain_anomalies(self) -> list:
        """Anomaly events raised since the last drain (publication
        order = fold order; per-batch order = round order)."""
        with self._lock:
            out = self._anomalies
            self._anomalies = []
        return out

    # ---------------------------------------------------- derived fields
    def velocity_field(self, res: int) -> dict:
        """{cell(uint64): (vx_east_kmh, vy_north_kmh, n_entities)} —
        mean filtered velocity of warm tracked entities per cell at
        ``res``.  A pure function of the table (cached per fold)."""
        with self._lock:
            key = (res, self._folds)
            hit = self._vel_cache.get(key)
            if hit is not None:
                return hit
            occ = np.nonzero((self.table.vid >= 0)
                             & (self.table.n_upd >= 2))[0]
            out: dict = {}
            if len(occ):
                lat, lng = latlng_of(self.table.x[occ],
                                     self.table.ref[occ])
                cells = self._snap(np.deg2rad(lat), np.deg2rad(lng), res)
                order = np.argsort(cells, kind="stable")
                cells = cells[order]
                vn = self.table.x[occ][order, 2].astype(np.float64)
                ve = self.table.x[occ][order, 3].astype(np.float64)
                bnd = np.flatnonzero(np.concatenate(
                    ([True], cells[1:] != cells[:-1])))
                counts = np.diff(np.append(bnd, len(cells)))
                sve = np.add.reduceat(ve, bnd)
                svn = np.add.reduceat(vn, bnd)
                for c, se, sn, ct in zip(cells[bnd], sve, svn, counts):
                    out[int(c)] = (float(se / ct * 3.6),
                                   float(sn / ct * 3.6), int(ct))
            self._vel_cache[key] = out
            return out

    def forecast_cells(self, h_s: float, res: int) -> dict:
        """{cell(uint64): predicted_entity_count} after advecting every
        tracked entity along its filtered velocity for ``h_s`` s."""
        with self._lock:
            occ = np.nonzero(self.table.vid >= 0)[0]
            if not len(occ):
                return {}
            x = self.table.x[occ]
            ref = self.table.ref[occ]
            lat = (ref[:, 0] + (x[:, 0] + x[:, 2] * h_s).astype(np.float64)
                   / M_PER_DEG)
            cos = np.maximum(ref[:, 2], 1e-6)
            lng = (ref[:, 1] + (x[:, 1] + x[:, 3] * h_s).astype(np.float64)
                   / (M_PER_DEG * cos))
            lat = np.clip(lat, -89.999, 89.999)
            lng = (lng + 180.0) % 360.0 - 180.0
            cells = self._snap(np.deg2rad(lat), np.deg2rad(lng), res)
            uniq, counts = np.unique(cells, return_counts=True)
            return {int(c): int(n) for c, n in zip(uniq, counts)}

    # -------------------------------------------------------- checkpoint
    def snapshot(self) -> dict:
        """Checkpoint payload (rides CheckpointManager extras)."""
        with self._lock:
            out = self.table.snapshot()
            out["engine_scalars"] = np.asarray(
                [self._max_ts, self._events, self._folds], np.int64)
            return out

    def restore(self, data: dict, intern_v: dict | None = None) -> int:
        """Restore a snapshot; ``intern_v`` is the runtime's persistent
        vehicle intern map (entity names re-intern into it so restored
        slots match the ids replayed batches will carry).  Sources that
        feed pre-interned columns with their own id space (columnar
        synthetic benches) should not resume across restarts."""
        with self._lock:
            scal = data.get("engine_scalars")
            if scal is not None:
                scal = np.asarray(scal, np.int64)
                self._max_ts = int(scal[0])
                self._events = int(scal[1])
                self._folds = int(scal[2])
            m = self.table.restore(
                data, intern_v if intern_v is not None else {},
                n_part=self.n_part)
            self._vel_cache.clear()
            return m

    # ----------------------------------------------------------- observe
    def member_block(self) -> dict:
        """Inference stats for member snapshots / obs_top."""
        t = self.table
        return {
            "entities": int(t.occupancy),
            "capacity": int(t.capacity),
            "seeded": int(t.n_seeded),
            "evicted_ttl": int(t.n_evicted_ttl),
            "evicted_lru": int(t.n_evicted_lru),
            "reseed_handoff": int(t.n_reseed_handoff),
            "reseed_teleport": int(t.n_reseed_teleport),
            "anomalies": dict(self._anom_counts),
            "anomaly_buffer_dropped": int(self._anom_dropped),
            "folds": int(self._folds),
            "events_folded": int(self._events),
            "last_fold_ms": round(self._last_fold_ms, 3),
            "max_event_ts": int(self._max_ts),
        }
