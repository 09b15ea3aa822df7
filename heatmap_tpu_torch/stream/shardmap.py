"""H3-parent stream partitioning: which runtime shard owns an event.

A copy of ``heatmap_tpu/stream/shardmap.py``.  The event stream is split
by the H3 PARENT cell of each event's snapped location, so N runtime
shards each fold a DISJOINT cell space and the merged view is a plain
union (upsert-only fan-in, no cross-shard conflicts by construction).

The assignment is a pure, stable function of the cell index alone: every
producer, shard and tool that partitions the same stream agrees, across
processes and runs.  ``shard_of_cells`` derives the parent by H3 index
bit surgery and maps it through murmur3's 64-bit finalizer mod N.

Knobs (flat env, read by ``config.load_config``):

- ``HEATMAP_SHARDS``       total shard count N (1 = unsharded, default)
- ``HEATMAP_SHARD_INDEX``  this process's shard in ``0..N-1``
- ``HEATMAP_SHARD_RES``    parent resolution of the partition key;
  -1 (default) = the snap resolution itself.
- ``HEATMAP_SHARD_OVERSAMPLE`` feed batches of rows a shard polls a step.

Exactness: the partitioner snaps each event at the COARSEST configured
fold resolution with the snap that keys the fold, so for
single-resolution configs every (cell, window) group lands wholly in one
shard and the N-shard merged emits equal the 1-shard fold's.  The
reference takes the host snap (f64 C++) for the partition key whatever
snap keys its fold.  The port takes the fold's own snap (``snap_fn``):
the host snap on the native route, and on the in-program route the fused
kernel (``hexgrid/snap_kernel.py``, its plain version on the CPU), which
puts a point within ~0.4 m of a cell edge in the neighbouring cell.
Keyed on the host snap there, a row at an edge could be owned by one
shard while its fold cell hashes to another's space, and two shards
would emit the same tile ``_id``.  The cell -> shard function is the
reference's; only the cell it reads is the one the fold computes.
Multi-resolution pyramids partition by the coarsest resolution's cell
space; finer cells straddling a partition-parent boundary may split
across shards, as in the reference.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)

RES_SHIFT = 52
RES_MASK = np.uint64(0xF) << np.uint64(RES_SHIFT)

ENV_SHARDS = "HEATMAP_SHARDS"
ENV_SHARD_INDEX = "HEATMAP_SHARD_INDEX"
ENV_SHARD_RES = "HEATMAP_SHARD_RES"
ENV_SHARD_OVERSAMPLE = "HEATMAP_SHARD_OVERSAMPLE"


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


def join_words(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """uint64 cells from (hi, lo) index words of either signedness."""
    return ((np.asarray(hi).view(np.uint32).astype(np.uint64)
             << np.uint64(32))
            | np.asarray(lo).view(np.uint32).astype(np.uint64))


def _snap_cells(lat_rad: np.ndarray, lng_rad: np.ndarray,
                res: int) -> np.ndarray:
    """uint64 H3 cells at ``res`` for f32-radian coordinates, from the C++
    host snap (raises when it cannot be built)."""
    from heatmap_tpu_torch.hexgrid import native_snap

    hi, lo = native_snap.snap_arrays(np.asarray(lat_rad, np.float32),
                                     np.asarray(lng_rad, np.float32), res)
    return join_words(hi, lo)


class ShardMap:
    """Stable H3-parent -> shard assignment for one runtime shard.

    ``snap_res`` is the resolution events are snapped at for partitioning
    (the coarsest fold resolution); ``parent_res`` is the partition-key
    resolution (<= snap_res; -1 = snap_res).  ``snap_fn(lat_rad, lng_rad,
    res) -> uint64 cells`` is the snap that keys the fold; None takes the
    host snap (the native route's, and the reference's)."""

    def __init__(self, n_shards: int, index: int, snap_res: int,
                 parent_res: int = -1, snap_fn=None):
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
        self._snap_fn = snap_fn

    @classmethod
    def from_config(cls, cfg, snap_fn=None) -> "ShardMap | None":
        """The runtime's shard map, or None when unsharded."""
        if cfg.shards <= 1:
            return None
        return cls(cfg.shards, cfg.shard_index, min(cfg.resolutions),
                   cfg.shard_res, snap_fn=snap_fn)

    # ------------------------------------------------------------- keys
    def cells_of(self, lat_rad: np.ndarray, lng_rad: np.ndarray
                 ) -> np.ndarray:
        """uint64 H3 cells at ``snap_res`` for f32-radian coordinates,
        from the snap that keys the fold."""
        if self._snap_fn is not None:
            return self._snap_fn(np.asarray(lat_rad, np.float32),
                                 np.asarray(lng_rad, np.float32),
                                 self.snap_res)
        return _snap_cells(lat_rad, lng_rad, self.snap_res)

    def shard_of_cells(self, cells: np.ndarray,
                       res: int | None = None) -> np.ndarray:
        """int32 shard id per uint64 cell (uniform resolution ``res``,
        default snap_res).  Pure function of (cell, n_shards): stable
        across runs, processes, and hosts."""
        parents = parent_cells(cells, self.snap_res if res is None else res,
                               self.parent_res)
        return (_fmix64(parents) % np.uint64(self.n_shards)).astype(np.int32)

    def owned_mask(self, lat_rad: np.ndarray, lng_rad: np.ndarray
                   ) -> np.ndarray:
        """bool mask of the rows this shard folds."""
        if len(np.asarray(lat_rad)) == 0:
            return np.zeros(0, bool)
        return self.shard_of_cells(self.cells_of(lat_rad, lng_rad)) \
            == self.index

    def filter_columns(self, cols):
        """(owned-rows EventColumns, n_out_of_shard, owned_cells).  Row
        order is preserved (the per-group f32 accumulation order is what
        the 1-vs-N byte-identity rests on); a fully-owned batch is
        returned untouched.

        The runtime books every filtered row under a closed drop reason
        (``out_of_shard``, or ``oversample`` when foreign rows are the
        expected majority of each poll, ``stream.metrics.DROP_REASONS``).

        ``owned_cells`` are the surviving rows' uint64 cells at
        ``snap_res``: on the native route the runtime hands them to the
        fold as that resolution's keys, so a sharded feed pays the host
        snap once, not twice."""
        if len(cols) == 0:
            return cols, 0, np.zeros(0, np.uint64)
        cells = self.cells_of(cols.lat_rad, cols.lng_rad)
        mask = self.shard_of_cells(cells) == self.index
        n_foreign = int(len(mask) - np.count_nonzero(mask))
        if n_foreign == 0:
            return cols, 0, cells
        keep = np.flatnonzero(mask)
        from heatmap_tpu_torch.stream.events import take_columns

        return take_columns(cols, keep), n_foreign, cells[keep]

    def describe(self) -> str:
        return (f"shard {self.index}/{self.n_shards} "
                f"(snap res {self.snap_res}, partition parent res "
                f"{self.parent_res}, "
                f"{'fold' if self._snap_fn else 'native host'} snap)")


class MeshPartition:
    """Stable H3-parent -> mesh-device assignment for a partitioned mesh.

    Same exactness contract as :class:`ShardMap`: the partition key is
    the H3 parent of the event's cell snapped at the COARSEST fold
    resolution, mapped through murmur3 fmix64, so every (cell, window)
    group lands wholly on one device.

    ``outer_shards`` composes with process-level H3 sharding
    (``HEATMAP_SHARDS``): a shard process already filtered its rows by
    ``fmix64(parent) % N``, so the device key consumes DIFFERENT hash
    bits — the quotient ``fmix64(parent) // N`` feeds the device
    modulus.  With correlated moduli (e.g. N == D == 2) the same-hash
    assignment would park every one of a process's rows on its first
    device."""

    def __init__(self, n_devices: int, snap_res: int,
                 parent_res: int = -1, outer_shards: int = 1):
        if n_devices < 1:
            raise ValueError(f"mesh device count must be >= 1, "
                             f"got {n_devices}")
        if not 0 <= snap_res <= 15:
            raise ValueError(f"snap res {snap_res} out of range")
        if parent_res == -1:
            parent_res = snap_res
        if not 0 <= parent_res <= snap_res:
            raise ValueError(
                f"mesh partition parent res must be in 0..{snap_res} "
                f"(the snap resolution), got {parent_res}")
        self.n_devices = int(n_devices)
        self.snap_res = int(snap_res)
        self.parent_res = int(parent_res)
        self.outer_shards = max(1, int(outer_shards))

    @property
    def native(self) -> bool:
        """True: the host snap computes the partition key (it builds or
        raises), so the cells can be the fold's keys on the native
        route."""
        return True

    def cells_of(self, lat_rad: np.ndarray, lng_rad: np.ndarray
                 ) -> np.ndarray:
        return _snap_cells(lat_rad, lng_rad, self.snap_res)

    def device_of_cells(self, cells: np.ndarray,
                        res: int | None = None) -> np.ndarray:
        """int32 mesh-device id per uint64 cell.  Pure function of
        (cell, outer_shards, n_devices): stable across runs/processes."""
        parents = parent_cells(
            cells, self.snap_res if res is None else res, self.parent_res)
        mix = _fmix64(parents) // np.uint64(self.outer_shards)
        return (mix % np.uint64(self.n_devices)).astype(np.int32)

    def partition(self, lat_rad: np.ndarray, lng_rad: np.ndarray,
                  cells: np.ndarray | None = None):
        """(device ids, cells) for a batch's rows.  ``cells`` may be the
        process-level ownership filter's already-snapped cells (the same
        snap_res by construction), in which case no second snap is
        paid."""
        if cells is None:
            cells = self.cells_of(lat_rad, lng_rad)
        return self.device_of_cells(cells), cells

    def describe(self) -> str:
        return (f"{self.n_devices}-device mesh partition (snap res "
                f"{self.snap_res}, parent res {self.parent_res}, "
                f"outer shards {self.outer_shards}, native host snap)")
