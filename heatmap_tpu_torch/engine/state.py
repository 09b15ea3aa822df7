"""Device-resident aggregation state for one (resolution, window-size) pair.

The counterpart of ``heatmap_tpu/engine/state.py``: a fixed-capacity
compact slab of (cell, windowStart) groups, kept **sorted by key** with
empty slots (key_hi == EMPTY) at the tail, so that each micro-batch folds
in with one merge-sort (engine.step).

The 64-bit cell index rides as two 32-bit words.  The reference holds them
as uint32; torch covers few uint32 ops, so here they are int32 tensors
holding the same bit patterns.  ``to_host`` views them back as uint32 and
``from_host`` takes the reference's arrays, so a slab moves between the two
packages unchanged in either direction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Sentinels for empty slots.  Valid cell-index high words always have bit 31
# (the reserved H3 bit 63) clear, so 0xFFFFFFFF can never collide.  As an
# int32 bit pattern 0xFFFFFFFF is -1.
EMPTY_KEY_HI = -1
EMPTY_KEY_LO = -1
EMPTY_WS = 2**31 - 1

_KEY_FIELDS = ("key_hi", "key_lo")


class TileState(NamedTuple):
    """All tensors share leading dim = capacity C; hist is (C, B) (B may be
    0).  The float accumulators hold RESIDUAL sums about fixed per-group
    anchors (``anchor_*``), with Kahan compensation in ``comp``; consumers
    recombine ``anchor + resid/count`` in f64 on the host (see the
    reference's TileState docstring for why)."""

    key_hi: torch.Tensor    # int32 bit pattern of uint32 cell bits 32..63
    key_lo: torch.Tensor    # int32 bit pattern of uint32 cell bits 0..31
    key_ws: torch.Tensor    # int32  — window start, epoch seconds
    count: torch.Tensor     # int32
    sum_speed: torch.Tensor   # float32 — Σ (speedKmh - anchor_speed)
    sum_speed2: torch.Tensor  # float32 — Σ (speedKmh - anchor_speed)²
    sum_lat: torch.Tensor     # float32 — Σ (lat - anchor_lat) (degrees)
    sum_lon: torch.Tensor     # float32 — Σ (lon - anchor_lon) (degrees)
    hist: torch.Tensor        # int32 (C, B) — speed histogram for p95
    anchor_speed: torch.Tensor  # float32 — fixed per-group speed anchor
    anchor_lat: torch.Tensor    # float32 — fixed per-group lat anchor
    anchor_lon: torch.Tensor    # float32 — fixed per-group lon anchor
    comp: torch.Tensor          # float32 (C, 4) — Kahan compensation for
                                # (sum_speed, sum_speed2, sum_lat, sum_lon)

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]

    @property
    def hist_bins(self) -> int:
        return self.hist.shape[1]


def init_state(capacity: int, hist_bins: int = 0,
               device: torch.device | str = "cuda") -> TileState:
    c = capacity
    i32, f32 = torch.int32, torch.float32
    full = lambda v: torch.full((c,), v, dtype=i32, device=device)
    zeros = lambda *shape, dtype=f32: torch.zeros(shape, dtype=dtype,
                                                  device=device)
    return TileState(
        key_hi=full(EMPTY_KEY_HI),
        key_lo=full(EMPTY_KEY_LO),
        key_ws=full(EMPTY_WS),
        count=zeros(c, dtype=i32),
        sum_speed=zeros(c),
        sum_speed2=zeros(c),
        sum_lat=zeros(c),
        sum_lon=zeros(c),
        hist=zeros(c, hist_bins, dtype=i32),
        anchor_speed=zeros(c),
        anchor_lat=zeros(c),
        anchor_lon=zeros(c),
        comp=zeros(c, 4),
    )


def device_copy(state: TileState) -> TileState:
    """Fresh on-device copy of a state slab (new buffers, same device)."""
    return TileState(*[t.clone() for t in state])


def to_host(state: TileState) -> TileState:
    """Host numpy copy laid out as the reference's ``to_host`` gives it:
    the key words as uint32, every other field in its own dtype."""
    out = []
    for name, t in zip(TileState._fields, state):
        a = t.detach().cpu().numpy()
        out.append(a.view(np.uint32) if name in _KEY_FIELDS else a)
    return TileState(*out)


def from_host(snap: TileState, device: torch.device | str) -> TileState:
    """The port's slab on ``device`` from a host state in the reference's
    layout (numpy arrays, key words uint32), e.g. the JAX package's
    ``to_host`` output."""
    out = []
    for name, a in zip(TileState._fields, snap):
        a = np.ascontiguousarray(a)
        if name in _KEY_FIELDS:
            if a.dtype != np.uint32:
                raise TypeError(f"{name}: expected uint32, got {a.dtype}")
            a = a.view(np.int32)
        out.append(torch.from_numpy(a.copy()).to(device))
    return TileState(*out)


# EMPTY fills of a host slab in the reference's layout (key words uint32)
_HOST_FILLS = {
    "key_hi": np.uint32(EMPTY_KEY_HI & 0xFFFFFFFF),
    "key_lo": np.uint32(EMPTY_KEY_LO & 0xFFFFFFFF),
    "key_ws": np.int32(EMPTY_WS),
}
_DEVICE_FILLS = {"key_hi": EMPTY_KEY_HI, "key_lo": EMPTY_KEY_LO,
                 "key_ws": EMPTY_WS}


def resize_state(st: TileState, new_capacity: int) -> TileState:
    """Host-side resize of a one-shard snapshot in the reference's layout
    (numpy, key words uint32) to a new capacity, as the reference's
    ``resize_state`` does it.

    Growth pads the tail with EMPTY rows, which sort last, so the slab
    stays sorted.  Shrinking is allowed only when the live rows (a sorted
    prefix) fit; otherwise it raises, because dropping aggregates silently
    is never acceptable."""
    old_cap = st.key_hi.shape[0]
    if new_capacity == old_cap:
        return st
    if new_capacity < old_cap:
        live = int((np.asarray(st.key_hi) != _HOST_FILLS["key_hi"]).sum())
        if live > new_capacity:
            raise ValueError(f"cannot shrink to {new_capacity}: the slab "
                             f"holds {live} live groups")
    keep = min(old_cap, new_capacity)
    out = []
    for name, leaf in zip(TileState._fields, st):
        a = np.asarray(leaf)
        new = np.full((new_capacity,) + a.shape[1:],
                      _HOST_FILLS.get(name, a.dtype.type(0)), a.dtype)
        new[:keep] = a[:keep]
        out.append(new)
    return TileState(*out)


def grow_state(state: TileState, new_capacity: int) -> TileState:
    """The slab grown to ``new_capacity`` rows on its own device: fresh
    tensors EMPTY-filled, the old rows copied into the head.  The same
    slab as ``resize_state`` gives on the host, without the round trip
    through host memory; it only grows."""
    if new_capacity < state.capacity:
        raise ValueError(f"grow_state cannot shrink {state.capacity} -> "
                         f"{new_capacity} rows")
    out = []
    for name, t in zip(TileState._fields, state):
        new = t.new_full((new_capacity,) + tuple(t.shape[1:]),
                         _DEVICE_FILLS.get(name, 0))
        new[:t.shape[0]].copy_(t)
        out.append(new)
    return TileState(*out)
