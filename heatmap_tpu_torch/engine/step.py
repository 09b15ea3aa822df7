"""The per-micro-batch aggregation fold (device hot path), in PyTorch.

The counterpart of ``heatmap_tpu/engine/step.py``, sort route only:

  1. ``snap_and_window``: the H3 snap (the fused CUDA snap kernel on the
     card, its plain version on the CPU) and the tumbling window start.  Invalid
     rows get the EMPTY key.
  2. ``merge_batch``: one stable sort of the (state ∥ batch) compressed
     keys, segment ids by cumsum, then scatters that rebuild the sorted slab
     (``_apply_routing``).  Watermark eviction of closed windows and the
     late drop ride the same sort.
  3. ``pack_emit``: the touched groups as one (E+1, 13) matrix for a single
     device->host pull.

Everything is static-shape; the number of distinct keys and of touched
groups ride as masks and counters, so no step synchronises with the host.

Key words are int32 tensors holding the reference's uint32 bit patterns
(engine.state).  Where the reference compares or sorts them unsigned, the
fold builds one int64 per row from the pair (see ``_sort_key``).

The reference's ``.at[...](mode="drop")`` scatters drop out-of-range
indices; torch raises on them.  Here segment ids at or beyond C mean
"dropped", and each scatter target has spare rows past C that are sliced
off afterwards: every dropped row writes a spare row of its own
(``_spread``).  One shared drop row would collect the writes of a whole
slab's empty rows, and the writes to one row serialise (atomics on one
address, or the deterministic kernel's walk over duplicates).

Determinism: the only scatter whose result depends on the order of its
writes is the batch-side float sum of residuals (``delta``): it runs with
``torch.use_deterministic_algorithms(True)``, so on CUDA each segment's
rows add in row order (the order the reference's scatter adds in) instead
of with float atomics.  Every other scatter is an integer add, a min, a
write of equal values, or one write per target row, whose result is the
same in any order.
"""

from __future__ import annotations

import contextlib
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
):
    """Fold one batch into the state. Returns (state, BatchEmit, StepStats).

    The sort route of the reference's merge_batch; its rank/probe routes
    and fast-path tiers are bit-identical to it and are not ported yet."""
    if not I32_MIN <= int(watermark_cutoff) <= I32_MAX:
        raise ValueError(f"watermark cutoff {watermark_cutoff} is not int32")
    return _merge_sort(state, ev_hi, ev_lo, ev_ws, ev_speed, ev_lat_deg,
                       ev_lon_deg, ev_ts, ev_valid, int(watermark_cutoff),
                       params)


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

    nonempty = (s_key >> 32) != (_EMPTY_K1 - 2**31)
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
    # the reference's nonzero(touched, size=E, fill_value=C): the m-th
    # touched row is where the running count of touched rows first reaches
    # m; a search past the last touched row returns C, the fill
    E = params.emit_capacity
    touched = torch.zeros(rows, dtype=torch.bool, device=device)
    touched[ev_t] = True
    touched = touched[:C]
    running = torch.cumsum(touched, 0, dtype=i32)
    n_emitted = running[-1]
    want = torch.arange(1, E + 1, dtype=i32, device=device)
    emit_idx = torch.searchsorted(running, want)
    emit_ok = emit_idx < C
    gi = torch.where(emit_ok, emit_idx, 0)
    ok = lambda a, fill: torch.where(emit_ok, a[gi], fill)
    emit = BatchEmit(
        key_hi=ok(key_hi, EMPTY_KEY_HI),
        key_lo=ok(key_lo, EMPTY_KEY_LO),
        key_ws=ok(key_ws, EMPTY_WS),
        count=ok(count, 0),
        sum_speed=ok(sum_speed, 0.0),
        sum_speed2=ok(sum_speed2, 0.0),
        sum_lat=ok(sum_lat, 0.0),
        sum_lon=ok(sum_lon, 0.0),
        anchor_speed=ok(anc_speed, 0.0),
        anchor_lat=ok(anc_lat, 0.0),
        anchor_lon=ok(anc_lon, 0.0),
        hist=(hist[gi] * emit_ok[:, None].to(i32) if B > 0
              else torch.zeros((E, 0), dtype=i32, device=device)),
        valid=emit_ok,
        n_emitted=n_emitted,
        overflowed=n_emitted > E,
    )

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
