"""The per-micro-batch aggregation fold (device hot path), in PyTorch.

The counterpart of ``heatmap_tpu/engine/step.py``:

  1. ``snap_and_window``: the H3 snap (the fused CUDA snap kernel on the
     card, its plain version on the CPU) and the tumbling window start.  Invalid
     rows get the EMPTY key.
  2. ``merge_batch``: one of three routing impls, bit-identical to one
     another (``sort``: one stable sort of the (state ∥ batch) compressed
     keys; ``rank``: a batch-only sort merged into the sorted slab by
     insertion rank; ``probe``: a hash-probe dedup of the batch, then the
     rank rails), each ending in the scatters that rebuild the sorted slab
     (``_apply_routing``), and by default the steady-state fast path
     around them (``_merge_fastpath``: all-hit in-place tier, few-misses
     insert tier, else the impl).  Watermark eviction of closed windows and
     the late drop ride the same pass.
  3. ``pack_emit``: the touched groups as one (E+1, 13) matrix; the stream
     runtime parks these in an ``EmitRing`` on the device and pulls K
     batches at once, a live prefix of each (``pull_packed_stack``).

Everything is static-shape; the number of distinct keys and of touched
groups ride as masks and counters.  The one exception is the choice of
fast-path tier (and of the probe's fallback), which the reference makes on
the device with ``lax.cond`` and eager PyTorch cannot: the fold packs the
predicates into one small tensor and reads it on the host once
(``_read_flags``), the fold's only synchronisation between emit flushes.

Key words are int32 tensors holding the reference's uint32 bit patterns
(engine.state).  Where the reference compares or sorts them unsigned, the
fold builds one int64 per row from the pair (see ``_sort_key``), and the
probe hash does its uint32 arithmetic in int64 under a 32-bit mask.

The reference's ``.at[...](mode="drop")`` scatters drop out-of-range
indices; torch raises on them.  Here segment ids at or beyond C mean
"dropped", and each scatter target has spare rows past C that are sliced
off afterwards: every dropped row writes a spare row of its own
(``_spread``).  One shared drop row would collect the writes of a whole
slab's empty rows, and the writes to one row serialise (atomics on one
address, or the deterministic kernel's walk over duplicates).

Determinism: the only scatter whose result depends on the order of its
writes is the batch-side float sum of residuals (``delta``, in
``_apply_routing`` and in the fast path's tier 1): it runs with
``torch.use_deterministic_algorithms(True)``, so on CUDA each segment's
rows add in row order (the order the reference's scatter adds in) instead
of with float atomics.  Every other scatter is an integer add, a min, a
write of equal values, or one write per target row, whose result is the
same in any order.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from heatmap_tpu_torch.engine.state import (
    EMPTY_KEY_HI,
    EMPTY_KEY_LO,
    EMPTY_WS,
    TileState,
)
from heatmap_tpu_torch.hexgrid import device as hexdev
from heatmap_tpu_torch.hexgrid import snap_kernel

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1

# Events this many windows ahead of an active watermark are dropped as
# clock-skew poison (and keep the live span well inside the 4096-window
# sort-key compression, see _compress_key).
FUTURE_WINDOWS = 2048

# _compress_key's upper sort word for empty rows
_EMPTY_K1 = 0xFFFFFFFF
# _sort_key of an empty row, (k1, lo) = (0xFFFFFFFF, 0xFFFFFFFF): the
# largest int64, so empties sort last
_EMPTY_SORT_KEY = 2**63 - 1

# Merge-fold routing (sort|rank|probe|auto) and the steady-state fast
# path, as in the reference: ``MERGE_IMPL`` / ``FASTPATH`` are override
# slots (tests and sweeps assign them); when they are None,
# HEATMAP_MERGE_IMPL (default auto) and HEATMAP_FASTPATH (default on) are
# read at call time.  All routes are bit-identical, so results never
# depend on the choice.
MERGE_IMPL: "str | None" = None
FASTPATH: "bool | None" = None

# _merge_probe tunables, read once at import as in the reference: probe
# rounds before the sort fallback, and the unique-key budget divisor
# (budget = batch / PROBE_UNIQ_DIV, floor 256).
PROBE_ROUNDS = int(os.environ.get("HEATMAP_PROBE_ROUNDS", "16"))
PROBE_UNIQ_DIV = int(os.environ.get("HEATMAP_PROBE_UNIQ_DIV", "8"))


def _resolve_merge_impl() -> str:
    return (MERGE_IMPL if MERGE_IMPL is not None
            else os.environ.get("HEATMAP_MERGE_IMPL", "auto"))


def _resolve_fastpath() -> bool:
    if FASTPATH is not None:
        return FASTPATH
    return os.environ.get("HEATMAP_FASTPATH", "1") != "0"


class AggParams(NamedTuple):
    """Static parameters of one (resolution, window) aggregation."""

    res: int                 # H3 resolution
    window_s: int            # tumbling window seconds
    emit_capacity: int       # max groups emitted per batch (update mode)
    speed_hist_max: float = 256.0   # km/h mapped onto the last hist bin


class BatchEmit(NamedTuple):
    """Update-mode output: current aggregates of every group touched by this
    batch.  Fixed capacity; ``valid`` marks live rows."""

    key_hi: torch.Tensor
    key_lo: torch.Tensor
    key_ws: torch.Tensor
    count: torch.Tensor
    sum_speed: torch.Tensor   # residual sums about the anchor_* lanes
    sum_speed2: torch.Tensor  # (engine.state.TileState docstring)
    sum_lat: torch.Tensor
    sum_lon: torch.Tensor
    anchor_speed: torch.Tensor  # per-group anchors: consumers recombine
    anchor_lat: torch.Tensor    # anchor + resid/count in f64 host-side
    anchor_lon: torch.Tensor
    hist: torch.Tensor
    valid: torch.Tensor       # bool
    n_emitted: torch.Tensor   # int32 scalar — true touched-group count
    overflowed: torch.Tensor  # bool scalar — touched groups > emit capacity


class StepStats(NamedTuple):
    n_valid: torch.Tensor       # events aggregated
    n_late: torch.Tensor        # events dropped by the watermark
    n_evicted: torch.Tensor     # state rows recycled (closed windows)
    n_active: torch.Tensor      # live groups after the merge
    state_overflow: torch.Tensor  # distinct keys beyond capacity (dropped)
    batch_max_ts: torch.Tensor  # int32 — max valid event ts (watermark input)


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms for the span of one op, then the caller's
    setting back."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


def _read_flags(flags: torch.Tensor) -> list[bool]:
    """Read a small int32 tensor of predicates on the host: the fold's one
    synchronisation between emit flushes, where the reference branches on
    the device (``lax.cond``).  Counts each read (``.reads``) and the host
    time spent waiting on it (``.wait_s``)."""
    t0 = time.monotonic()
    out = [bool(v) for v in flags.tolist()]
    _read_flags.wait_s += time.monotonic() - t0
    _read_flags.reads += 1
    return out


_read_flags.reads = 0
_read_flags.wait_s = 0.0


def _snap_impl(res: int):
    """The in-program H3 snap, ``snap_kernel.latlng_to_cell_kernel``: one
    launch of the fused CUDA kernel on CUDA tensors, its plain version on
    CPU tensors."""
    hexdev.check_res(res)
    return snap_kernel.latlng_to_cell_kernel


def window_start(ts_s, valid, window_s: int):
    """Tumbling window start per event; invalid → EMPTY_WS."""
    ws = torch.div(ts_s, window_s, rounding_mode="floor") * window_s
    return torch.where(valid, ws, EMPTY_WS)


def snap_and_window(lat_rad, lng_rad, ts_s, valid, params: AggParams):
    """Compute (key_hi, key_lo, window_start) per event; invalid → EMPTY."""
    hi, lo = _snap_impl(params.res)(lat_rad, lng_rad, params.res)
    hi = torch.where(valid, hi, EMPTY_KEY_HI)
    lo = torch.where(valid, lo, EMPTY_KEY_LO)
    return hi, lo, window_start(ts_s, valid, params.window_s)


def _drop_and_evict(state, ev_hi, ev_lo, ev_ws, ev_valid, watermark_cutoff,
                    params: AggParams):
    """Shared prologue: late/future-event drop + window eviction masks.

    late: the window already closed (ws + window <= cutoff).  future: more
    than FUTURE_WINDOWS ahead of the watermark (a clock-skewed producer's
    poison pill).  int32 arithmetic wraps as the reference's does."""
    late = ev_valid & (ev_ws + params.window_s <= watermark_cutoff)
    if FUTURE_WINDOWS and watermark_cutoff > I32_MIN:
        future = ev_valid & (
            (ev_ws - watermark_cutoff) >= FUTURE_WINDOWS * params.window_s)
        late = late | future
    ev_valid = ev_valid & ~late
    ev_hi = torch.where(ev_valid, ev_hi, EMPTY_KEY_HI)
    ev_lo = torch.where(ev_valid, ev_lo, EMPTY_KEY_LO)
    ev_ws = torch.where(ev_valid, ev_ws, EMPTY_WS)

    live = state.key_hi != EMPTY_KEY_HI
    evict = live & (state.key_ws + params.window_s <= watermark_cutoff)
    keep = live & ~evict
    st_hi = torch.where(keep, state.key_hi, EMPTY_KEY_HI)
    st_lo = torch.where(keep, state.key_lo, EMPTY_KEY_LO)
    st_ws = torch.where(keep, state.key_ws, EMPTY_WS)
    return (late, ev_valid, ev_hi, ev_lo, ev_ws,
            evict, keep, st_hi, st_lo, st_ws)


def _compress_key(hi, ws, empty, params: AggParams):
    """96-bit composite key → the upper sort word k1 (the low word is `lo`),
    as an int64 in [0, 2**32).

    With `res` fixed, hi's upper bits (mode/res) are constant and its
    variable part (base cell + coarse digits) fits 20 bits; the window start
    folds to a 12-bit window index (mod 4096).  k1 = 0xFFFFFFFF is
    unreachable for live rows (base cell <= 121) and marks empties."""
    wix = torch.div(ws, params.window_s, rounding_mode="floor").long() & 0xFFF
    return torch.where(empty, _EMPTY_K1,
                       (wix << 20) | (hi.long() & 0xFFFFF))


def _sort_key(k1, lo):
    """One int64 per row whose signed order is the unsigned (k1, lo) order:
    (k1 - 2**31) * 2**32 + lo, i.e. the u64 key with bit 63 flipped."""
    return ((k1 - 2**31) << 32) | (lo.long() & 0xFFFFFFFF)


def _is_live(key):
    """Which int64 sort keys belong to live rows (upper word not EMPTY)."""
    return (key >> 32) != (_EMPTY_K1 - 2**31)


def merge_batch(
    state: TileState,
    ev_hi,
    ev_lo,
    ev_ws,
    ev_speed,
    ev_lat_deg,
    ev_lon_deg,
    ev_ts,
    ev_valid,
    watermark_cutoff: int,    # evict windows ending at or before this
    params: AggParams,
    impl: str | None = None,
):
    """Fold one batch into the state. Returns (state, BatchEmit, StepStats).

    ``impl`` (default: ``MERGE_IMPL``, else HEATMAP_MERGE_IMPL, else auto)
    picks the routing: ``sort``, ``rank``, ``probe``, or ``auto``, which
    takes rank when the slab holds at least 4x the batch and sort
    otherwise (the reference's static rule; the port has no hardware
    bank).  With the fast path on (``FASTPATH``, else HEATMAP_FASTPATH !=
    0) the batch goes through ``_merge_fastpath``, which falls back to the
    impl only when its cheaper tiers do not apply.  All combinations give
    identical results."""
    if not I32_MIN <= int(watermark_cutoff) <= I32_MAX:
        raise ValueError(f"watermark cutoff {watermark_cutoff} is not int32")
    if impl is None:
        impl = _resolve_merge_impl()
    if impl == "auto":
        impl = "rank" if state.capacity >= 4 * ev_hi.shape[0] else "sort"
    if impl not in ("sort", "rank", "probe"):
        raise ValueError(f"merge impl must be sort|rank|probe|auto, "
                         f"got {impl!r}")
    args = (state, ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg, ev_lon_deg,
            ev_ts, ev_valid, int(watermark_cutoff), params)
    if _resolve_fastpath():
        return _merge_fastpath(*args, impl)
    return _slow_impl(impl)(*args)


def _slow_impl(impl: str):
    """The routing function of ``impl``, looked up at call time (so tests
    can wrap it)."""
    return {"sort": _merge_sort, "rank": _merge_rank,
            "probe": _merge_probe}[impl]


def _merge_sort(
    state: TileState,
    ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg, ev_lon_deg, ev_ts, ev_valid,
    watermark_cutoff: int,
    params: AggParams,
):
    """Routing via one merge-sort of (state ∥ batch) compressed keys."""
    C = state.capacity
    N = ev_hi.shape[0]
    device = ev_hi.device

    (late, ev_valid, ev_hi, ev_lo, ev_ws, evict, keep, st_hi, st_lo,
     st_ws) = _drop_and_evict(state, ev_hi, ev_lo, ev_ws, ev_valid,
                              watermark_cutoff, params)

    # --- merge-sort state ∥ batch; carry origin row -----------------------
    all_hi = torch.cat([st_hi, ev_hi])
    all_lo = torch.cat([st_lo, ev_lo])
    all_ws = torch.cat([st_ws, ev_ws])
    k1 = _compress_key(all_hi, all_ws, all_hi == EMPTY_KEY_HI, params)
    s_key, s_orig = torch.sort(_sort_key(k1, all_lo), stable=True)

    nonempty = _is_live(s_key)
    is_start = torch.ones_like(s_key, dtype=torch.bool)
    is_start[1:] = s_key[1:] != s_key[:-1]
    seg = torch.cumsum(is_start, 0, dtype=torch.int32) - 1  # sorted-order id
    seg_c = torch.clamp(seg, max=C)  # segments past capacity → C (dropped)

    # --- per-origin-row new segment (the scatter routing tables) ---------
    # s_orig is a permutation of the origin rows, so one scatter with
    # distinct targets gives every origin row its segment; state row r
    # (kept) lands in segment state_seg[r], batch row i in batch_seg[i]
    seg_of = torch.empty(C + N, dtype=torch.int32, device=device)
    seg_of.scatter_(0, s_orig, seg_c)
    # route empties/evictions/lates to C (dropped)
    state_seg = torch.where(keep, seg_of[:C], C)
    batch_seg = torch.where(ev_valid, seg_of[C:], C)

    n_seg_total = seg[-1] + 1  # includes the single EMPTY segment if present
    has_empty = ~nonempty[-1]  # empties (if any) sort last
    n_distinct = n_seg_total - has_empty.to(torch.int32)
    return _apply_routing(state, ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg,
                          ev_lon_deg, ev_ts, ev_valid, late, evict, keep,
                          state_seg, batch_seg, n_distinct, params)


def _searchsorted_pair(a1, a2, q1, q2):
    """Leftmost insertion index of each (q1, q2) query into rows sorted by
    the unsigned pair (a1, a2): upper words as int64 in [0, 2**32), lower
    words as int32 bit patterns.  One search over the int64 sort keys;
    int64 results in [0, len(a1)]."""
    return torch.searchsorted(_sort_key(a1, a2), _sort_key(q1, q2),
                              side="left")


def _merge_rank(
    state: TileState,
    ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg, ev_lon_deg, ev_ts, ev_valid,
    watermark_cutoff: int,
    params: AggParams,
):
    """Routing via a batch-only sort merged into the sorted slab by rank.

    The slab is sorted, so its kept rows compact out with a cumsum, the
    batch's unique keys search their insertion points, and every row's
    final position is (its rank) + (the new keys smaller than it): ~sort(N)
    instead of ~sort(C+N)."""
    C = state.capacity
    (late, ev_valid, ev_hi, ev_lo, ev_ws, evict, keep, st_hi, st_lo,
     st_ws) = _drop_and_evict(state, ev_hi, ev_lo, ev_ws, ev_valid,
                              watermark_cutoff, params)
    st_k1 = _compress_key(st_hi, st_ws, ~keep, params)
    ev_k1 = _compress_key(ev_hi, ev_ws, ~ev_valid, params)
    c, pos_k, n_keep = _compact_state(keep, st_k1, st_lo, C)
    u, uid_of_event = _sorted_batch_uniques(_sort_key(ev_k1, ev_lo))
    state_seg, batch_seg, n_distinct = _route_via_uniques(
        c, pos_k, keep, n_keep, u, uid_of_event, ev_valid, C)
    return _apply_routing(state, ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg,
                          ev_lon_deg, ev_ts, ev_valid, late, evict, keep,
                          state_seg, batch_seg, n_distinct, params)


def _compact_state(keep, st_k1, st_lo, C: int):
    """The kept state rows compacted to the slab prefix (a subsequence of
    a sorted sequence stays sorted): their sort keys ``c``, EMPTY-padded
    to C, each row's rank among the kept ones, and how many were kept.
    THE compacted slab that the rank and probe routes search."""
    keep_i = keep.to(torch.int32)
    pos_k = torch.cumsum(keep_i, 0, dtype=torch.int32) - 1
    n_keep = keep_i.sum(dtype=torch.int32)
    c = torch.full((2 * C,), _EMPTY_SORT_KEY, dtype=torch.int64,
                   device=keep.device)
    c.scatter_(0, _spread(torch.where(keep, pos_k, C), C),
               _sort_key(st_k1, st_lo))
    return c[:C], pos_k, n_keep


def _sorted_batch_uniques(key):
    """Batch sort + dedup of int64 sort keys: the ascending unique keys,
    EMPTY-padded to the batch length, and each event's index into them.
    THE sort route of the rank rails: _merge_rank always takes it,
    _merge_probe falls back to it and the fast path's tier 2 sorts its
    misses with it."""
    s_key, s_orig = torch.sort(key, stable=True)
    is_start = torch.ones_like(s_key, dtype=torch.bool)
    is_start[1:] = s_key[1:] != s_key[:-1]
    seg = torch.cumsum(is_start, 0) - 1
    u = torch.full_like(key, _EMPTY_SORT_KEY)
    u.scatter_(0, seg, s_key)           # rows of a segment write one value
    uid_of_event = torch.empty_like(seg)
    uid_of_event.scatter_(0, s_orig, seg)   # s_orig is a permutation
    return u, uid_of_event


def _route_via_uniques(c, pos_k, keep, n_keep, u, uid_of_event, ev_valid,
                       C: int):
    """Shared rank-merge tail: from the compacted sorted slab ``c``, the
    ascending unique batch keys ``u`` (any length, EMPTY-padded) and each
    event's index into them, the routing tables (state_seg, batch_seg,
    n_distinct)."""
    u_valid = _is_live(u)
    p_state = torch.searchsorted(c, u, side="left")
    i = torch.clamp(p_state, max=C - 1)
    matched = u_valid & (p_state < C) & (c[i] == u)
    new_i = (u_valid & ~matched).to(torch.int64)
    before = torch.cumsum(new_i, 0) - new_i     # new keys strictly smaller
    out_u = torch.where(u_valid, p_state + before, C)
    # slab row j moves right by #{new keys < c[j]} = #{new: p_state <= j}
    # (a new key inserting at j is smaller than c[j], never equal, else it
    # would have matched): an inclusive cumsum of insertion-point counts
    cnt_new = torch.zeros(C + u.shape[0], dtype=torch.int64, device=c.device)
    cnt_new.index_add_(0, _spread(torch.where(new_i > 0, p_state, C), C),
                       new_i)
    out_state_pos = (torch.arange(C, dtype=torch.int64, device=c.device)
                     + torch.cumsum(cnt_new[:C], 0))
    state_seg = torch.where(keep, out_state_pos[pos_k.clamp(0, C - 1)], C)
    batch_seg = torch.where(ev_valid, out_u[uid_of_event], C)
    n_distinct = (n_keep + new_i.sum()).to(torch.int32)
    return state_seg, batch_seg, n_distinct


_U32 = 0xFFFFFFFF


def _mul_u32(a, b: int):
    """(a * b) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant
    ``b`` < 2**32, in int64 without overflow: a's 16-bit halves apart,
    each product below 2**48."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF    # only 16 bits survive the << 16
    return (lo + (hi << 16)) & _U32


def _merge_probe(
    state: TileState,
    ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg, ev_lon_deg, ev_ts, ev_valid,
    watermark_cutoff: int,
    params: AggParams,
):
    """Routing via hash-probe dedup instead of a batch sort.

    The batch dedups into a 2N-slot linear-probing table in PROBE_ROUNDS
    rounds of gather/scatter, then only a fixed N/PROBE_UNIQ_DIV unique
    budget is sorted and rides the rank rails.  If an event is still
    unplaced after the rounds, or the distinct keys exceed the budget,
    THIS batch takes the batch-sort route instead (the same routing-table
    contract and epilogue, so the result is identical).  The reference
    picks between the two on the device (``lax.cond``); here the fallback
    flag is read on the host (``_read_flags``)."""
    C = state.capacity
    N = ev_hi.shape[0]
    M = 1 << (2 * N - 1).bit_length()       # pow2 table, load <= 0.5
    U = min(N, max(256, N // PROBE_UNIQ_DIV))
    device = ev_hi.device
    i64 = torch.int64

    (late, ev_valid, ev_hi, ev_lo, ev_ws, evict, keep, st_hi, st_lo,
     st_ws) = _drop_and_evict(state, ev_hi, ev_lo, ev_ws, ev_valid,
                              watermark_cutoff, params)
    st_k1 = _compress_key(st_hi, st_ws, ~keep, params)
    ev_k1 = _compress_key(ev_hi, ev_ws, ~ev_valid, params)
    c, pos_k, n_keep = _compact_state(keep, st_k1, st_lo, C)
    ev_key = _sort_key(ev_k1, ev_lo)

    # --- probe-dedup the batch (uint32 hash arithmetic in int64) ---------
    h = (_mul_u32(ev_k1, 0x9E3779B9)
         ^ _mul_u32(ev_lo.long() & _U32, 0x85EBCA6B))
    eidx = torch.arange(N, dtype=torch.int32, device=device)
    # slot tables of M rows plus N spare rows for the non-writers (_spread)
    table = torch.full((M + N,), _EMPTY_SORT_KEY, dtype=i64, device=device)
    placed = ~ev_valid                          # invalid rows never probe
    slot = torch.zeros(N, dtype=i64, device=device)
    off = torch.zeros(N, dtype=i64, device=device)
    for _ in range(PROBE_ROUNDS):
        idx = (h + off) & (M - 1)
        want = ~placed
        cur = table[idx]
        empty = cur == _EMPTY_SORT_KEY
        mine = want & ~empty & (cur == ev_key)
        claim = want & empty
        # the lowest event index wins a contested empty slot (an
        # order-free min).  Every loser re-checks the same slot next
        # round: a same-key loser then matches, another key advances
        claim_arr = torch.full((M + N,), N, dtype=torch.int32, device=device)
        claim_arr.scatter_reduce_(
            0, _spread(torch.where(claim, idx, M), M), eidx, "amin")
        winner = claim & (claim_arr[idx] == eidx)
        table.scatter_(0, _spread(torch.where(winner, idx, M), M), ev_key)
        got = mine | winner
        placed = placed | got
        slot = torch.where(got, idx, slot)
        off = off + (want & ~empty & ~mine).to(i64)

    # --- compact + sort only the unique budget ---------------------------
    occupied = table[:M] != _EMPTY_SORT_KEY
    comp_pos = torch.cumsum(occupied, 0, dtype=i64) - 1       # over M slots
    n_uniq = comp_pos[-1] + 1
    cu = torch.full((U + M,), _EMPTY_SORT_KEY, dtype=i64, device=device)
    cu.scatter_(0, _spread(torch.where(occupied & (comp_pos < U), comp_pos,
                                       U), U), table[:M])
    s_u, s_cid = torch.sort(cu[:U], stable=True)
    rank_of_compact = torch.empty_like(s_cid)
    rank_of_compact.scatter_(0, s_cid,
                             torch.arange(U, dtype=i64, device=device))
    uid_of_event = rank_of_compact[
        comp_pos.clamp(0, U - 1)[slot.clamp(0, M - 1)]]

    fallback = (ev_valid & ~placed).any() | (n_uniq > U)
    (sort_route,) = _read_flags(fallback.reshape(1).to(torch.int32))
    if sort_route:
        u, uid_of_event = _sorted_batch_uniques(ev_key)
        routed = ev_valid
    else:
        u, routed = s_u, ev_valid & placed
    state_seg, batch_seg, n_distinct = _route_via_uniques(
        c, pos_k, keep, n_keep, u, uid_of_event, routed, C)
    return _apply_routing(state, ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg,
                          ev_lon_deg, ev_ts, ev_valid, late, evict, keep,
                          state_seg, batch_seg, n_distinct, params)


def _fastpath_probe_full(state, ev_hi, ev_lo, ev_ws, ev_valid,
                         watermark_cutoff: int, params: AggParams):
    """The fast-path predicate: each event's insertion point in the sorted
    slab.  Returns the masked prologue outputs, compressed keys, per-event
    row position, hit mask, and the tier-1 ``fast_ok`` (0-dim bool).

    The prologue runs on masked COPIES of the event arrays; the slow impl
    gets the originals (its own prologue must see late rows to count
    them)."""
    C = state.capacity
    (late, ev_valid_m, ev_hi_m, ev_lo_m, ev_ws_m, evict, keep, st_hi,
     st_lo, st_ws) = _drop_and_evict(state, ev_hi, ev_lo, ev_ws, ev_valid,
                                     watermark_cutoff, params)
    st_k1 = _compress_key(st_hi, st_ws, ~keep, params)
    ev_k1 = _compress_key(ev_hi_m, ev_ws_m, ~ev_valid_m, params)
    pos = _searchsorted_pair(st_k1, st_lo, ev_k1, ev_lo_m)
    i = torch.clamp(pos, max=C - 1)
    hit = (ev_valid_m & (pos < C) & (st_k1[i] == ev_k1)
           & (st_lo[i] == ev_lo_m))
    # with evictions the slab has EMPTY holes and the search ran against
    # an unsorted sequence: `hit` is then meaningless, but the evict term
    # forces the slow tier
    fast_ok = (hit == ev_valid_m).all() & ~evict.any()
    return (late, ev_valid_m, ev_hi_m, ev_lo_m, ev_ws_m, evict, keep,
            ev_k1, st_k1, st_lo, pos, hit, fast_ok)


def _fastpath_probe(state, ev_hi, ev_lo, ev_ws, ev_valid,
                    watermark_cutoff: int, params: AggParams):
    """Compact view of `_fastpath_probe_full` for the predicate tests:
    (late, masked ev_valid, positions, hit mask, tier-1 fast_ok)."""
    (late, ev_valid_m, _hi, _lo, _ws, _evict, _keep, _k1, _sk1, _slo,
     pos, hit, fast_ok) = _fastpath_probe_full(
        state, ev_hi, ev_lo, ev_ws, ev_valid, watermark_cutoff, params)
    return late, ev_valid_m, pos, hit, fast_ok


def _merge_fastpath(
    state: TileState,
    ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg, ev_lon_deg, ev_ts, ev_valid,
    watermark_cutoff: int,
    params: AggParams,
    slow_impl: str,
):
    """Steady-state fast path wrapped around any routing impl.

    Each event searches the sorted slab directly, then one of three tiers
    folds the batch, cheapest condition first:

    1. **all-hit**: every valid event matched an existing row and no
       window evicts: scatter-adds onto the touched rows only
       (``_tier_all_hit``), no slab rebuild.
    2. **few misses** (at most max(1024, N/16) events, none evicts): the
       hits keep their searched rows, only the misses sort and ride the
       rank rails (``_tier_insert``), then the usual epilogue.
    3. otherwise (evictions, a miss burst, an empty slab): the configured
       slow impl on the original arrays.

    Tiers 1 and 2 are bit-identical to the slow impls by construction, as
    in the reference: tier 1 replicates ``_apply_routing``'s arithmetic
    under its no-new-key, no-evict conditions, Kahan rewrite of every row
    included; tier 2 feeds ``_apply_routing`` the routing tables rank
    would.  The reference picks the tier on the device (``lax.cond``);
    here ``fast_ok`` and ``insert_ok`` are read on the host in one
    ``_read_flags`` call.  ``.tiers`` counts the batches each tier
    folded."""
    N = ev_hi.shape[0]
    M = max(1024, N // 16)  # miss-event budget of the insert tier
    (late, ev_valid_m, ev_hi_m, ev_lo_m, ev_ws_m, evict, keep,
     ev_k1, st_k1, st_lo_m, pos, hit, fast_ok) = _fastpath_probe_full(
        state, ev_hi, ev_lo, ev_ws, ev_valid, watermark_cutoff, params)
    miss = ev_valid_m & ~hit
    n_miss = miss.sum(dtype=torch.int64)
    insert_ok = ~evict.any() & (n_miss <= M) & (n_miss > 0)
    fast, insert = _read_flags(torch.stack([fast_ok, insert_ok]).to(
        torch.int32))
    if fast:
        tier = 1
        out = _tier_all_hit(state, ev_speed, ev_lat_deg, ev_lon_deg, ev_ts,
                            ev_valid_m, late, evict, pos, hit, params)
    elif insert:
        tier = 2
        out = _tier_insert(state, ev_hi_m, ev_lo_m, ev_ws_m, ev_speed,
                           ev_lat_deg, ev_lon_deg, ev_ts, ev_valid_m, late,
                           evict, keep, ev_k1, st_k1, st_lo_m, pos, hit,
                           miss, M, params)
    else:
        tier = 3
        out = _slow_impl(slow_impl)(
            state, ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg, ev_lon_deg,
            ev_ts, ev_valid, watermark_cutoff, params)
    _merge_fastpath.tiers[tier] += 1
    return out


_merge_fastpath.tiers = {1: 0, 2: 0, 3: 0}


def _tier_all_hit(state: TileState, ev_speed, ev_lat_deg, ev_lon_deg, ev_ts,
                  ev_valid_m, late, evict, pos, hit, params: AggParams):
    """Tier 1: every valid event hit row ``pos``; add the batch onto copies
    of the touched lanes and Kahan-rewrite the sums as the slow path does.
    The keys, window starts and anchors stay the slab's own."""
    C = state.capacity
    B = state.hist_bins
    N = pos.shape[0]
    device = pos.device
    f32, i32 = torch.float32, torch.int32
    one = hit.to(i32)
    # integer lanes: a hit adds 1 at its row, every other event adds 0 at
    # a row of its own (i mod C), so no row collects a batch's misses
    row = torch.where(hit, pos, torch.arange(N, device=device) % C)
    count = state.count.clone()
    count.index_add_(0, row, one)

    gic = torch.clamp(pos, max=C - 1)
    resid = lambda ev, anc: torch.where(hit, ev - anc[gic], 0.0)
    r_speed = resid(ev_speed, state.anchor_speed)
    r_lat = resid(ev_lat_deg, state.anchor_lat)
    r_lon = resid(ev_lon_deg, state.anchor_lon)
    ev_vals = torch.stack([r_speed, r_speed * r_speed, r_lat, r_lon], dim=1)
    # the slow path's epilogue Kahan-rewrites EVERY row (an untouched row
    # becomes sum - comp, comp absorbing the shift); replicate it exactly
    # so that fast and slow batches interleave bit-identically
    base = torch.stack([state.sum_speed, state.sum_speed2, state.sum_lat,
                        state.sum_lon], dim=1)
    delta = torch.zeros((C + N, 4), dtype=f32, device=device)
    with _deterministic():       # rows of a group add in row order
        delta.index_add_(0, _spread(torch.where(hit, pos, C), C), ev_vals)
    y = delta[:C] - state.comp
    t = base + y
    comp = (t - base) - y
    sum_speed, sum_speed2, sum_lat, sum_lon = t.unbind(1)

    if B > 0:
        bin_w = hexdev.scalar_tensor(params.speed_hist_max / B, f32, device)
        ev_bin = torch.clamp((ev_speed / bin_w).to(i32), 0, B - 1)
        hist = state.hist.clone()
        hist.view(-1).index_add_(0, row * B + ev_bin, one)
    else:
        hist = state.hist

    new_state = state._replace(
        count=count, sum_speed=sum_speed.contiguous(),
        sum_speed2=sum_speed2.contiguous(), sum_lat=sum_lat.contiguous(),
        sum_lon=sum_lon.contiguous(), hist=hist, comp=comp.contiguous())
    # a row is touched iff a hit added to its count
    emit = _emit_touched(count != state.count, new_state,
                         params.emit_capacity)
    isum = lambda m: m.sum(dtype=i32)
    stats = StepStats(
        n_valid=isum(one),
        n_late=isum(late),
        n_evicted=isum(evict),
        n_active=isum(state.key_hi != EMPTY_KEY_HI),
        state_overflow=torch.zeros((), dtype=i32, device=device),
        batch_max_ts=torch.where(ev_valid_m, ev_ts, I32_MIN).max(),
    )
    return new_state, emit, stats


def _tier_insert(state: TileState, ev_hi_m, ev_lo_m, ev_ws_m, ev_speed,
                 ev_lat_deg, ev_lon_deg, ev_ts, ev_valid_m, late, evict,
                 keep, ev_k1, st_k1, st_lo_m, pos, hit, miss, M: int,
                 params: AggParams):
    """Tier 2: the hits keep their searched rows; only the (at most M)
    miss events sort and ride the rank insertion rails."""
    C = state.capacity
    N = pos.shape[0]
    device = pos.device
    i64 = torch.int64
    # the reference's nonzero(miss, size=M, fill_value=N), sync-free: the
    # m-th miss is where the running miss count first reaches m
    want = torch.arange(1, M + 1, dtype=i64, device=device)
    midx = torch.searchsorted(torch.cumsum(miss, 0, dtype=i64), want)
    mvalid = midx < N
    mkey = torch.where(mvalid, _sort_key(ev_k1, ev_lo_m)[midx.clamp(
        max=N - 1)], _EMPTY_SORT_KEY)
    mu, uid_m = _sorted_batch_uniques(mkey)
    # event -> its slot among the misses (meaningful for misses only)
    slot_of_event = torch.zeros(N + M, dtype=i64, device=device)
    slot_of_event.scatter_(0, _spread(torch.where(mvalid, midx, N), N),
                           torch.arange(M, dtype=i64, device=device))
    c, pos_k, n_keep = _compact_state(keep, st_k1, st_lo_m, C)
    state_seg, batch_seg_m, n_distinct = _route_via_uniques(
        c, pos_k, keep, n_keep, mu,
        uid_m[slot_of_event[:N].clamp(max=M - 1)], miss, C)
    # a hit's row moved where its slab row went: state_seg of that row
    # (== rank's position for a matched unique)
    batch_seg = torch.where(hit, state_seg[pos.clamp(max=C - 1)],
                            torch.where(miss, batch_seg_m, C))
    return _apply_routing(state, ev_hi_m, ev_lo_m, ev_ws_m, ev_speed,
                          ev_lat_deg, ev_lon_deg, ev_ts, ev_valid_m, late,
                          evict, keep, state_seg, batch_seg, n_distinct,
                          params)


def _spread(seg, C: int):
    """Scatter targets from segment ids in [0, C]: each dropped row (C)
    gets a spare row C + i of its own, so a target buffer needs C + len
    rows and no row collects the drops of a whole batch (see the module
    docstring)."""
    spare = torch.arange(C, C + seg.shape[0], dtype=torch.int64,
                         device=seg.device)
    return torch.where(seg < C, seg.long(), spare)


def _apply_routing(
    state: TileState,
    ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg, ev_lon_deg, ev_ts, ev_valid,
    late, evict, keep,
    state_seg, batch_seg, n_distinct,
    params: AggParams,
):
    """Shared epilogue: rebuild the slab from the routing tables, build the
    update-mode emit, and assemble StepStats.  ``state_seg`` / ``batch_seg``
    hold segment ids in [0, C], C meaning dropped."""
    C = state.capacity
    B = state.hist_bins
    N = ev_hi.shape[0]
    device = ev_hi.device
    f32, i32 = torch.float32, torch.int32
    st_t = _spread(state_seg, C)        # targets in [0, 2C)
    ev_t = _spread(batch_seg, C)        # targets in [0, C + N)
    rows = C + max(C, N)                # a buffer either side can target
    ev_i = torch.clamp(batch_seg.long(), max=C - 1)

    # --- rebuild the slab ------------------------------------------------
    # rows of one segment all write the same key value; the EMPTY segment
    # keeps its init sentinel
    def keys(fill, st_vals, ev_vals):
        out = torch.full((rows,), fill, dtype=i32, device=device)
        out.scatter_(0, st_t, st_vals)
        out.scatter_(0, ev_t, ev_vals)
        return out[:C]

    key_hi = keys(EMPTY_KEY_HI, state.key_hi, ev_hi)
    key_lo = keys(EMPTY_KEY_LO, state.key_lo, ev_lo)
    key_ws = keys(EMPTY_WS, state.key_ws, ev_ws)

    one = ev_valid.to(i32)
    count = torch.zeros(rows, dtype=i32, device=device)
    count.index_add_(0, st_t, torch.where(keep, state.count, 0))
    count.index_add_(0, ev_t, one)
    count = count[:C]

    # --- residual-anchor accumulation ------------------------------------
    # Each group carries FIXED anchors (min over the events of the batch
    # that created it — a segment-min) and accumulates residuals about
    # them, so f32 sums hold the centroid to ~1e-8 deg (see the reference's
    # _apply_routing for the full story).
    inf = float("inf")

    def group_anchor(ev, stored):
        a = torch.full((rows,), inf, dtype=f32, device=device)
        a.scatter_reduce_(0, ev_t, torch.where(ev_valid, ev, inf), "amin")
        # existing groups keep their stored anchor: accumulated residuals
        # are relative to it, so it must never move while the group lives
        a.scatter_(0, st_t, torch.where(keep, stored, inf))
        return a[:C]

    anc_speed = group_anchor(ev_speed, state.anchor_speed)
    anc_lat = group_anchor(ev_lat_deg, state.anchor_lat)
    anc_lon = group_anchor(ev_lon_deg, state.anchor_lon)

    resid = lambda ev, anc: torch.where(ev_valid, ev - anc[ev_i], 0.0)
    r_speed = resid(ev_speed, anc_speed)
    r_lat = resid(ev_lat_deg, anc_lat)
    r_lon = resid(ev_lon_deg, anc_lon)
    # overflow-dropped events may read an empty row's inf anchor; their
    # scatter writes land in spare rows, so the values never land

    # the four float accumulators ride one (C, 4) scatter instead of four
    kf = keep.to(f32)
    st_vals = torch.stack([
        state.sum_speed * kf, state.sum_speed2 * kf,
        state.sum_lat * kf, state.sum_lon * kf,
    ], dim=1)
    ev_vals = torch.stack([r_speed, r_speed * r_speed, r_lat, r_lon], dim=1)
    base = torch.zeros((rows, 4), dtype=f32, device=device)
    base.index_add_(0, st_t, st_vals)
    # the one order-sensitive scatter (module docstring): rows of a segment
    # add in row order
    delta = torch.zeros((rows, 4), dtype=f32, device=device)
    with _deterministic():
        delta.index_add_(0, ev_t, ev_vals)
    comp_r = torch.zeros((rows, 4), dtype=f32, device=device)
    comp_r.index_add_(0, st_t, state.comp * kf[:, None])
    base, delta, comp_r = base[:C], delta[:C], comp_r[:C]
    # Kahan fold of the batch delta into the carried sums: the error of
    # each fold is captured in `comp` and fed back
    y = delta - comp_r
    t = base + y
    comp = (t - base) - y
    sums = t
    sum_speed, sum_speed2, sum_lat, sum_lon = sums.unbind(1)
    # empty/recycled rows: finite zeros (inf anchors would poison a later
    # emit pack)
    finite0 = lambda a: torch.where(torch.isfinite(a), a, 0.0)
    anc_speed, anc_lat, anc_lon = (finite0(anc_speed), finite0(anc_lat),
                                   finite0(anc_lon))

    if B > 0:
        bin_w = hexdev.scalar_tensor(params.speed_hist_max / B, f32, device)
        ev_bin = torch.clamp((ev_speed / bin_w).to(i32), 0, B - 1)
        hist = torch.zeros((rows, B), dtype=i32, device=device)
        hist.index_add_(0, st_t, state.hist * keep[:, None].to(i32))
        hist.view(-1).index_add_(0, ev_t * B + ev_bin, one)
        # a copy, so the new slab does not hold the spare rows alive
        hist = hist[:C].clone()
    else:
        hist = state.hist

    new_state = TileState(
        key_hi=key_hi, key_lo=key_lo, key_ws=key_ws, count=count,
        sum_speed=sum_speed.contiguous(), sum_speed2=sum_speed2.contiguous(),
        sum_lat=sum_lat.contiguous(), sum_lon=sum_lon.contiguous(),
        hist=hist,
        anchor_speed=anc_speed, anchor_lat=anc_lat, anchor_lon=anc_lon,
        comp=comp.contiguous(),
    )

    # --- update-mode emit: groups touched by this batch -------------------
    # index_fill_ takes the value as a scalar: ``touched[ev_t] = True``
    # would copy it to the device from pageable memory, a sync
    touched = torch.zeros(rows, dtype=torch.bool, device=device)
    touched.index_fill_(0, ev_t, True)
    emit = _emit_touched(touched[:C], new_state, params.emit_capacity)

    # --- stats ------------------------------------------------------------
    isum = lambda m: m.sum(dtype=i32)
    stats = StepStats(
        n_valid=isum(one),
        n_late=isum(late),
        n_evicted=isum(evict),
        n_active=isum(key_hi != EMPTY_KEY_HI),
        state_overflow=torch.clamp(n_distinct - C, min=0),
        batch_max_ts=torch.where(ev_valid, ev_ts, I32_MIN).max(),
    )
    return new_state, emit, stats


def _emit_touched(touched, st: TileState, E: int) -> BatchEmit:
    """The update-mode emit: the rows of ``st`` that ``touched`` marks, in
    row order, in E rows.  The reference's nonzero(touched, size=E,
    fill_value=C) without a sync: the m-th touched row is where the
    running count of touched rows first reaches m; a search past the last
    touched row returns C, the fill."""
    C = touched.shape[0]
    device = touched.device
    i32 = torch.int32
    running = torch.cumsum(touched, 0, dtype=i32)
    n_emitted = running[-1]
    want = torch.arange(1, E + 1, dtype=i32, device=device)
    emit_idx = torch.searchsorted(running, want)
    emit_ok = emit_idx < C
    gi = torch.where(emit_ok, emit_idx, 0)
    ok = lambda a, fill: torch.where(emit_ok, a[gi], fill)
    return BatchEmit(
        key_hi=ok(st.key_hi, EMPTY_KEY_HI),
        key_lo=ok(st.key_lo, EMPTY_KEY_LO),
        key_ws=ok(st.key_ws, EMPTY_WS),
        count=ok(st.count, 0),
        sum_speed=ok(st.sum_speed, 0.0),
        sum_speed2=ok(st.sum_speed2, 0.0),
        sum_lat=ok(st.sum_lat, 0.0),
        sum_lon=ok(st.sum_lon, 0.0),
        anchor_speed=ok(st.anchor_speed, 0.0),
        anchor_lat=ok(st.anchor_lat, 0.0),
        anchor_lon=ok(st.anchor_lon, 0.0),
        hist=(st.hist[gi] * emit_ok[:, None].to(i32) if st.hist_bins > 0
              else torch.zeros((E, 0), dtype=i32, device=device)),
        valid=emit_ok,
        n_emitted=n_emitted,
        overflowed=n_emitted > E,
    )


def p95_from_hist_device(hist, count, hist_max: float):
    """Vectorized 95th percentile from per-row speed histograms (device).

    Same interpolation as the reference; the cumsum runs on int32 and is
    cast afterwards (a float cumsum on CUDA has no deterministic form)."""
    E, B = hist.shape
    bin_w = hist_max / B
    target = float(np.float32(0.95)) * count.to(torch.float32)
    cum = torch.cumsum(hist, dim=1, dtype=torch.int32).to(torch.float32)
    i = (cum < target[:, None]).sum(dim=1, dtype=torch.int32)
    ic = torch.clamp(i, 0, B - 1)
    prev = torch.where(
        ic > 0,
        torch.gather(cum, 1, torch.clamp(ic - 1, min=0)[:, None].long())[:, 0],
        0.0,
    )
    in_bin = torch.gather(hist, 1, ic[:, None].long())[:, 0].to(torch.float32)
    frac = torch.where(in_bin > 0, (target - prev) / in_bin, 0.0)
    p95 = torch.where(i >= B, hist_max,
                      (ic.to(torch.float32) + frac) * bin_w)
    return torch.where(count > 0, p95, 0.0)


def _bits(a):
    """float32 / int32 / bool lane -> int32 bit pattern."""
    if a.dtype == torch.float32:
        return a.view(torch.int32)
    return a.to(torch.int32)


def pack_emit(emit: BatchEmit, speed_hist_max: float = 256.0) -> torch.Tensor:
    """Pack a BatchEmit into one (E+1, 13) int32 matrix, the bit patterns
    of the reference's uint32 matrix (``.numpy().view(np.uint32)`` on the
    host gives it exactly).

    Row 0 carries [n_emitted, overflowed] in slots 0..1; slots 2.. are
    reserved for a stats rider (``ride_stats``).  Rows 1.. are [key_hi,
    key_lo, ws, count, sum_speed, sum_speed2, sum_lat, sum_lon, valid, p95,
    anchor_speed, anchor_lat, anchor_lon] with float lanes bitcast.  The
    histogram stays on device; its p95 summary is computed here.
    ``unpack_emit`` reverses it host-side."""
    E = emit.key_hi.shape[0]
    if emit.hist.shape[1] > 0:
        p95 = p95_from_hist_device(emit.hist, emit.count, speed_hist_max)
    else:
        p95 = torch.zeros(E, dtype=torch.float32, device=emit.key_hi.device)
    body = torch.stack([_bits(a) for a in (
        emit.key_hi, emit.key_lo, emit.key_ws, emit.count,
        emit.sum_speed, emit.sum_speed2, emit.sum_lat, emit.sum_lon,
        emit.valid, p95, emit.anchor_speed, emit.anchor_lat,
        emit.anchor_lon)], dim=1)
    head = torch.zeros((1, body.shape[1]), dtype=torch.int32,
                       device=body.device)
    head[0, 0] = emit.n_emitted.to(torch.int32)
    head[0, 1] = emit.overflowed.to(torch.int32)
    return torch.cat([head, body], dim=0)


_STATS_RIDER_SLOT0 = 2  # first head-row slot available to ride_stats


def ride_stats(packed: torch.Tensor, stats) -> torch.Tensor:
    """Embed a NamedTuple of int32 scalars into the packed head row (in
    place): fields land in head slots 2..2+len(stats), in field order.
    Decode with ``read_stats_rider``."""
    n = len(stats)
    if _STATS_RIDER_SLOT0 + n > packed.shape[1]:
        raise ValueError(f"stats rider of {n} fields does not fit the "
                         f"{packed.shape[1]}-slot head row")
    packed[0, _STATS_RIDER_SLOT0:_STATS_RIDER_SLOT0 + n] = torch.stack(
        [s.to(torch.int32) for s in stats])
    return packed


def read_stats_rider(packed_np, cls):
    """Host-side inverse of ``ride_stats``: decode ``cls`` (a NamedTuple
    type of ints, fields ordered as the device-side stats tuple) from a
    packed matrix's head row."""
    n = len(cls._fields)
    raw = np.asarray(packed_np)[0, _STATS_RIDER_SLOT0:_STATS_RIDER_SLOT0 + n]
    return cls(*[int(v) for v in raw.view(np.int32)])


def unpack_emit(packed) -> dict:
    """Host-side inverse of pack_emit (uint32 matrix): dict of numpy arrays
    + scalars."""
    p = np.asarray(packed)
    body = p[1:]
    f32 = lambda col: body[:, col].view(np.float32)
    return {
        "key_hi": body[:, 0],
        "key_lo": body[:, 1],
        "key_ws": body[:, 2].view(np.int32),
        "count": body[:, 3].view(np.int32),
        "sum_speed": f32(4),
        "sum_speed2": f32(5),
        "sum_lat": f32(6),
        "sum_lon": f32(7),
        "valid": body[:, 8] != 0,
        "p95": f32(9),
        "anchor_speed": f32(10),
        "anchor_lat": f32(11),
        "anchor_lon": f32(12),
        "n_emitted": int(p[0, 0]),
        "overflowed": bool(p[0, 1]),
    }


RAD_TO_DEG = float(np.float32(180.0 / np.pi))  # radians -> degrees, as f32


def aggregate_batch(
    state: TileState,
    lat_rad,
    lng_rad,
    speed_kmh,
    ts_s,
    valid,
    watermark_cutoff: int,
    params: AggParams,
):
    """Convenience: snap + window + merge in one call."""
    hi, lo, ws = snap_and_window(lat_rad, lng_rad, ts_s, valid, params)
    return merge_batch(
        state, hi, lo, ws, speed_kmh, lat_rad * RAD_TO_DEG,
        lng_rad * RAD_TO_DEG, ts_s, valid, watermark_cutoff, params,
    )


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device->host copy of ``t`` as a uint32 numpy array: into pinned
    memory on CUDA (then waits for it), a view on the CPU."""
    if t.device.type == "cpu":
        return t.numpy().view(np.uint32)
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return out.numpy().view(np.uint32)


def pull_packed_stack(packed: torch.Tensor, prefix: bool) -> list:
    """Device->host pull of a stacked packed-emit tensor ((P, E+1, L)
    int32, one ``pack_emit`` block per pair or batch) as a list of P host
    matrices (uint32).  The single implementation of the transfer
    discipline.

    ``prefix=False``: one full transfer.  ``prefix=True``: the P head rows
    first (they carry n_emitted and the stats rider), then one shared
    live-prefix bucket, the largest n_emitted of the blocks rounded up to
    a power of two.  Live emit rows are a prefix by construction and rows
    of the bucket past a block's own n_emitted carry valid=0, so every
    consumer (unpack_emit, the store) reads them unchanged."""
    if not prefix:
        b = _to_host(packed)
        return [b[i] for i in range(b.shape[0])]
    heads = _to_host(packed[:, 0, :])               # (P, L), tiny
    E = packed.shape[1] - 1
    n_max = int(heads[:, 0].astype(np.int64).max())
    bucket = 1
    while bucket < n_max and bucket < E:
        bucket <<= 1
    bucket = min(bucket, E)                          # overflow: n > E
    body = _to_host(packed[:, 1:1 + bucket, :])
    return [np.concatenate([heads[i:i + 1], body[i]])
            for i in range(body.shape[0])]


def pull_emit_prefix(packed: torch.Tensor) -> np.ndarray:
    """Live-prefix pull of ONE packed emit matrix ((E+1, L)): the
    single-block view of ``pull_packed_stack``."""
    return pull_packed_stack(packed[None], prefix=True)[0]


class EmitRing:
    """Fixed-capacity accumulator of DEVICE-RESIDENT packed emits.

    Each ``append`` parks one batch's stacked packed-emit tensor ((P, E+1,
    L) int32, stats ridden in the head rows) on the device; a
    ``flush_stacked`` concatenates every parked batch in one device op and
    pulls it with a single ``pull_packed_stack`` call, so K batches pay one
    pull instead of K, and nothing waits on batch k's fold until the flush
    that covers it.

    Entries must share one shape (``append`` refuses another).  ``take``
    hands the raw entries back unpulled.  Entries appended ``live=False``
    (empty dispatches) park but do not advance the flush trigger; past
    ``8 * capacity`` parked entries the ring reads full regardless.
    """

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._entries: list = []      # (packed_device, tag) append order
        self._enter: list = []        # (monotonic enter, append seq, live)
        self._appends = 0             # lifetime appends (residency base)
        self.live_pending = 0         # parked entries appended live=True
        self.n_flushes = 0            # drains that held entries
        # residency of the entries the LAST take()/flush_stacked()
        # drained, in its return order: (seconds parked, batches resident:
        # appends from the entry's own, inclusive, to the flush), and each
        # entry's live flag
        self.last_flush_residency: list = []
        self.last_flush_live: list = []

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def full(self) -> bool:
        return (self.live_pending >= self.capacity
                or len(self._entries) >= 8 * self.capacity)

    @property
    def nbytes(self) -> int:
        """Bytes of packed emits parked on the device."""
        entries = self._entries
        if not entries:
            return 0
        return len(entries) * int(entries[0][0].nbytes)

    def append(self, packed, tag=None, live: bool = True) -> bool:
        """Park one batch's packed emits; True when the ring is full
        (flush before the next append)."""
        if self._entries and tuple(packed.shape) != tuple(
                self._entries[0][0].shape):
            raise ValueError(
                f"emit ring entries must share one shape "
                f"(got {tuple(packed.shape)} vs "
                f"{tuple(self._entries[0][0].shape)}); flush before a "
                f"slab/emit-capacity resize")
        self._appends += 1
        self._entries.append((packed, tag))
        self._enter.append((time.monotonic(), self._appends, live))
        if live:
            self.live_pending += 1
        return self.full

    def take(self) -> list:
        """Drain the raw (packed, tag) entries without pulling."""
        entries, self._entries = self._entries, []
        enters, self._enter = self._enter, []
        self.live_pending = 0
        if entries:
            self.n_flushes += 1
            now = time.monotonic()
            self.last_flush_residency = [
                (now - t, self._appends - seq + 1) for t, seq, _ in enters]
            self.last_flush_live = [live for _t, _s, live in enters]
        else:
            self.last_flush_residency = []
            self.last_flush_live = []
        return entries

    def flush_stacked(self, prefix: bool) -> list:
        """Pull every parked batch in one transfer.  Returns [(bufs, tag)]
        in append order, ``bufs`` being the per-pair host matrices that
        ``pull_packed_stack`` gives for that batch alone."""
        entries = self.take()
        if not entries:
            return []
        n_pairs = entries[0][0].shape[0]
        blocks = (entries[0][0] if len(entries) == 1
                  else torch.cat([p for p, _ in entries], dim=0))
        bufs = pull_packed_stack(blocks, prefix)
        return [(bufs[i * n_pairs:(i + 1) * n_pairs], tag)
                for i, (_, tag) in enumerate(entries)]
