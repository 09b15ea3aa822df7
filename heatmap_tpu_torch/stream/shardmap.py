"""H3-parent stream partitioning: which shard owns an event.

A copy of the part of ``heatmap_tpu/stream/shardmap.py`` that the
inference engine uses for its logical entity partition
(``HEATMAP_ENTITY_SHARDS``): the shard of an event is a pure, stable
function of its cell alone -- the H3 parent at ``parent_res`` by index bit
surgery, through murmur3's 64-bit finalizer, mod N -- so every process
that partitions the same stream agrees, across runs and hosts.  Cells come
from the C++ host snap (``hexgrid.native_snap``, f64), the same one the
reference's engine uses, so the partition matches the reference's row for
row.  The process fleet that partitions the fold itself
(``HEATMAP_SHARDS`` > 1, ``from_config``, ``owned_mask``,
``filter_columns``) and the mesh partition are not ported yet.
"""

from __future__ import annotations

import numpy as np

RES_SHIFT = 52
RES_MASK = np.uint64(0xF) << np.uint64(RES_SHIFT)


def parent_cells(cells: np.ndarray, res: int, parent_res: int) -> np.ndarray:
    """Vectorized H3 parent at ``parent_res`` for uint64 cell indices of
    uniform resolution ``res``: the resolution field lowered, freed digits
    set to the invalid marker 7; exact for pentagons too."""
    if parent_res > res:
        raise ValueError(
            f"parent res {parent_res} finer than cell res {res}")
    cells = np.asarray(cells, np.uint64)
    out = (cells & ~RES_MASK) | (np.uint64(parent_res) << np.uint64(RES_SHIFT))
    for r in range(parent_res + 1, res + 1):
        out = out | (np.uint64(0x7) << np.uint64(3 * (15 - r)))
    return out


def _fmix64(x: np.ndarray) -> np.ndarray:
    """murmur3's 64-bit finalizer: a fixed, process-independent integer
    mix (no salted hashing anywhere near a partition key)."""
    x = np.asarray(x, np.uint64).copy()
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return x


def _snap_cells(lat_rad: np.ndarray, lng_rad: np.ndarray,
                res: int) -> np.ndarray:
    """uint64 H3 cells at ``res`` for f32-radian coordinates, from the C++
    host snap (raises when it cannot be built)."""
    from heatmap_tpu_torch.hexgrid import native_snap

    hi, lo = native_snap.snap_arrays(np.asarray(lat_rad, np.float32),
                                     np.asarray(lng_rad, np.float32), res)
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


class ShardMap:
    """Stable H3-parent -> shard assignment for one shard.

    ``snap_res`` is the resolution events are snapped at for partitioning
    (the coarsest fold resolution); ``parent_res`` is the partition-key
    resolution (<= snap_res; -1 = snap_res)."""

    def __init__(self, n_shards: int, index: int, snap_res: int,
                 parent_res: int = -1):
        if n_shards < 1:
            raise ValueError(f"HEATMAP_SHARDS must be >= 1, got {n_shards}")
        if not 0 <= index < n_shards:
            raise ValueError(
                f"HEATMAP_SHARD_INDEX must be in 0..{n_shards - 1}, "
                f"got {index}")
        if not 0 <= snap_res <= 15:
            raise ValueError(f"snap res {snap_res} out of range")
        if parent_res == -1:
            parent_res = snap_res
        if not 0 <= parent_res <= snap_res:
            raise ValueError(
                f"HEATMAP_SHARD_RES must be in 0..{snap_res} (the snap "
                f"resolution), got {parent_res}")
        self.n_shards = int(n_shards)
        self.index = int(index)
        self.snap_res = int(snap_res)
        self.parent_res = int(parent_res)

    def cells_of(self, lat_rad: np.ndarray, lng_rad: np.ndarray
                 ) -> np.ndarray:
        """uint64 H3 cells at ``snap_res`` for f32-radian coordinates."""
        return _snap_cells(lat_rad, lng_rad, self.snap_res)

    def shard_of_cells(self, cells: np.ndarray,
                       res: int | None = None) -> np.ndarray:
        """int32 shard id per uint64 cell (uniform resolution ``res``,
        default snap_res).  Pure function of (cell, n_shards): stable
        across runs, processes, and hosts."""
        parents = parent_cells(cells, self.snap_res if res is None else res,
                               self.parent_res)
        return (_fmix64(parents) % np.uint64(self.n_shards)).astype(np.int32)
