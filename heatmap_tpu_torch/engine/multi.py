"""MultiAggregator: every (resolution, window) pair folded per batch.

The counterpart of ``heatmap_tpu/engine/multi.py`` for one device: the H3
snap runs once per unique resolution, each pair's ``merge_batch`` folds its
own slab, and the per-pair packed emits stack into one (P, E+1, 13) int32
matrix, so the whole batch's output is one tensor for the stream
runtime's emit ring to park and pull.  ``grow`` resizes every pair's slab
on the device, and ``PairView`` is one pair's checkpoint adapter
(snapshot, restore).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from heatmap_tpu_torch.engine.state import (
    EMPTY_KEY_HI,
    EMPTY_KEY_LO,
    TileState,
    device_copy,
    from_host,
    grow_state,
    init_state,
    to_host,
)
from heatmap_tpu_torch.engine.step import (
    RAD_TO_DEG,
    AggParams,
    merge_batch,
    pack_emit,
    read_stats_rider,
    ride_stats,
    snap_and_window,
    window_start,
)


def fused_fold(params_list, states, lat_rad, lng_rad, speed, ts, valid,
               cutoff, prekeys=None):
    """THE per-batch multi-pair fold: one H3 snap per unique resolution
    shared across its windows, then each pair's merge_batch on its own
    state slab.  Returns (new_states, [(emit, stats)] in pair order).

    ``prekeys``: optional dict res -> (hi, lo) of pre-computed cell keys
    (int32 bit patterns); the fold then runs no snap for those resolutions,
    only the valid-mask, which keeps the invalid-row contract identical to
    snap_and_window's."""
    lat_deg = lat_rad * RAD_TO_DEG
    lon_deg = lng_rad * RAD_TO_DEG
    by_res: dict[int, tuple] = {}
    for p in params_list:
        if p.res not in by_res:
            if prekeys is not None and p.res in prekeys:
                hi, lo = prekeys[p.res]
                hi = torch.where(valid, hi, EMPTY_KEY_HI)
                lo = torch.where(valid, lo, EMPTY_KEY_LO)
            else:
                hi, lo, _ = snap_and_window(lat_rad, lng_rad, ts, valid, p)
            by_res[p.res] = (hi, lo)
    new_states, folded = [], []
    for p, st in zip(params_list, states):
        hi, lo = by_res[p.res]
        ws = window_start(ts, valid, p.window_s)
        st2, emit, stats = merge_batch(
            st, hi, lo, ws, speed, lat_deg, lon_deg, ts, valid, cutoff, p)
        new_states.append(st2)
        folded.append((emit, stats))
    return tuple(new_states), folded


class MultiAggregator:
    """Fused aggregation over P (resolution, window_s) pairs on one device.

    All pairs share capacity / hist_bins / emit capacity so states and
    emits stack along a leading pair axis."""

    n_shards = 1

    def __init__(
        self,
        pairs: Sequence[tuple[int, int]],   # (res, window_s), unique
        capacity: int,
        batch_size: int,
        emit_capacity: int,
        hist_bins: int = 0,
        speed_hist_max: float = 256.0,
        device: torch.device | str = "cuda",
    ):
        if len(set(pairs)) != len(pairs):
            raise ValueError(f"duplicate (res, window) pairs: {pairs}")
        self.pairs = list(pairs)
        self.device = torch.device(device)
        self.capacity_per_shard = capacity
        self.batch_size = batch_size
        self.params = [
            AggParams(res=r, window_s=w, emit_capacity=emit_capacity,
                      speed_hist_max=speed_hist_max)
            for r, w in self.pairs
        ]
        self.states: list[TileState] = [
            init_state(capacity, hist_bins, self.device) for _ in self.pairs]
        self._uniq_res = list(dict.fromkeys(p.res for p in self.params))
        # the step's entry points, the reference's two jitted programs:
        # the in-program snap, and the fold of host-snapped prekeys
        self._step = self._fold
        self._step_pre = self._fold
        # host wall spent in step dispatch, per local shard (one here):
        # the runtime's heatmap_device_dispatch_seconds reads it
        self.device_seconds = [0.0]
        self.n_steps = 0

    def instrument(self, wrap) -> None:
        """Wrap the step's entry points with a compile tracker
        (obs.runtimeinfo.CompileTracker.wrap) under the reference's fn
        labels, ``multi_step`` and ``multi_step_pre``.  Call once, before
        the first step."""
        self._step = wrap("multi_step", self._step)
        self._step_pre = wrap("multi_step_pre", self._step_pre)

    def step_packed_all(self, lat_rad, lng_rad, speed, ts, valid,
                        watermark_cutoff: int, prekeys=None):
        """Fold one batch into every pair's state.

        Returns the packed emits on device: (P, E+1, 13) int32, one
        ``unpack_emit`` block per pair in ``self.pairs`` order, with that
        pair's step stats ridden in head-row slots 2..7
        (``stats_from_packed``).  ``prekeys``, when given, must hold keys
        for every unique resolution."""
        t0 = time.monotonic()
        if prekeys is None:
            packed = self._step(lat_rad, lng_rad, speed, ts, valid,
                                watermark_cutoff)
        else:
            missing = [r for r in self._uniq_res if r not in prekeys]
            if missing:
                raise ValueError(f"prekeys missing resolutions {missing}")
            packed = self._step_pre(lat_rad, lng_rad, speed, ts, valid,
                                    watermark_cutoff, prekeys)
        self.device_seconds[0] += time.monotonic() - t0
        self.n_steps += 1
        return packed

    def _fold(self, lat_rad, lng_rad, speed, ts, valid, watermark_cutoff,
              prekeys=None):
        new_states, folded = fused_fold(
            self.params, self.states, lat_rad, lng_rad, speed, ts, valid,
            watermark_cutoff, prekeys=prekeys)
        packs = [ride_stats(pack_emit(emit, p.speed_hist_max), stats)
                 for p, (emit, stats) in zip(self.params, folded)]
        self.states = list(new_states)
        return torch.stack(packs)

    def view(self, res: int, window_s: int) -> "PairView":
        return PairView(self, self.pairs.index((res, window_s)))

    def grow(self, new_capacity: int) -> None:
        """Grow EVERY pair's slab to ``new_capacity`` rows on the device
        (pairs share one capacity so their emits stack).  The slab stays
        sorted (EMPTY pads the tail).  The emit capacity grows with it, to
        ``max(old, min(batch_size, new_capacity))``, as the reference's
        does, so the packed emits change shape: the caller must have
        flushed every parked emit first (the emit ring refuses mixed
        shapes)."""
        self.states = [grow_state(st, new_capacity) for st in self.states]
        self.capacity_per_shard = new_capacity
        new_emit = min(self.batch_size, new_capacity)
        self.params = [
            p._replace(emit_capacity=max(p.emit_capacity, new_emit))
            for p in self.params]


class PairView:
    """Checkpoint adapter for one pair of a MultiAggregator: host snapshots
    in the reference's layout, and restore from one."""

    def __init__(self, multi: MultiAggregator, idx: int):
        self._multi = multi
        self._idx = idx

    @property
    def capacity_per_shard(self) -> int:  # tracks growth
        return self._multi.capacity_per_shard

    @property
    def state(self) -> TileState:
        return self._multi.states[self._idx]

    def snapshot(self) -> TileState:
        """Host copy (numpy, key words uint32)."""
        return to_host(self.state)

    def device_snapshot(self) -> TileState:
        """Fresh-buffer copy on the device: later folds do not touch it."""
        return device_copy(self.state)

    @staticmethod
    def to_host(snap: TileState) -> TileState:
        return to_host(snap)

    def restore(self, st: TileState, pad: bool = False) -> None:
        """Load a host snapshot in the reference's layout; a slab of
        another shape refuses (config drift).  With ``pad``, a snapshot
        of fewer rows is taken too and grown on the device to this
        capacity (EMPTY tail)."""
        cur = self.state
        cap, rows = cur.key_hi.shape[0], st.key_hi.shape[0]
        fit = rows if pad and rows < cap else cap
        want = ((fit,), (fit,) + tuple(cur.hist.shape[1:]))
        got = (tuple(st.key_hi.shape), tuple(st.hist.shape))
        if want != got:
            raise ValueError(f"state shape {got} != configured {want}")
        dev = from_host(st, self._multi.device)
        if rows < cap:
            dev = grow_state(dev, cap)
        self._multi.states[self._idx] = dev


class MultiStats(NamedTuple):
    """Host-side StepStats (field order MUST match engine.step.StepStats —
    the rider is decoded positionally, see step.ride_stats)."""

    n_valid: int
    n_late: int
    n_evicted: int
    n_active: int
    state_overflow: int
    batch_max_ts: int


def stats_from_packed(packed_pair: np.ndarray) -> MultiStats:
    """Decode the StepStats ridden in a pair's packed head row."""
    return read_stats_rider(packed_pair, MultiStats)
