"""The port's H3-parent stream partitioner (heatmap_tpu_torch/stream/
shardmap.py) against the JAX package's, on the CPU.

Counterparts of every case of ``tests/test_shardmap.py``, each run on the
port and held to the JAX package's answer on the same seeded world-wide
points: every cell owned by exactly one shard, an assignment stable across
runs and processes, the parent bit surgery (the pyramid's scalar oracle),
``filter_columns``'s rows, order, drop count and cells, the config and
knob checks, the per-shard JSONL namespace and each package's serve-side
store reading the other's shard logs, and ``MeshPartition``.  Every
comparison is exact: both packages' shard maps take the f64 host snap
here.  ``snap_fn`` (the fold's own snap, which the port's runtime passes
on the in-program route) is pinned at the end.
"""

import datetime as dt
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.query.pyramid import cell_to_parent
from heatmap_tpu.sink import make_store as jax_make_store
from heatmap_tpu.stream import shardmap as jsm
from heatmap_tpu.stream.events import columns_from_arrays as jax_columns
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.sink import make_store
from heatmap_tpu_torch.stream.events import columns_from_arrays
from heatmap_tpu_torch.stream.shardmap import (MeshPartition, ShardMap,
                                               _fmix64, join_words,
                                               parent_cells)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _world_points(n=400, seed=20260803):
    """Deterministic world-wide points: city clusters and global random
    (radians, f32), the reference test's generator."""
    rng = np.random.default_rng(seed)
    lat, lng = [], []
    for clat, clng in ((42.36, -71.06), (37.98, 23.73), (35.68, 139.69),
                       (-33.87, 151.21), (51.51, -0.13), (-23.55, -46.63)):
        lat.append(clat + rng.uniform(-0.3, 0.3, n // 8))
        lng.append(clng + rng.uniform(-0.3, 0.3, n // 8))
    lat.append(np.degrees(np.arcsin(rng.uniform(-1, 1, n // 4))))
    lng.append(rng.uniform(-180, 180, n // 4))
    return (np.radians(np.concatenate(lat)).astype(np.float32),
            np.radians(np.concatenate(lng)).astype(np.float32))


def _corpus_cells(res: int) -> np.ndarray:
    lat, lng = _world_points()
    cells = ShardMap(1, 0, res).cells_of(lat, lng)
    np.testing.assert_array_equal(cells,
                                  jsm.ShardMap(1, 0, res).cells_of(lat, lng))
    return cells


@pytest.mark.parametrize("res", [0, 5, 8])
def test_every_cell_assigned_to_exactly_one_shard(res):
    cells = _corpus_cells(res)
    n = 4
    maps = [ShardMap(n, i, res) for i in range(n)]
    owners = np.stack([m.shard_of_cells(cells) == m.index for m in maps])
    assert (owners.sum(axis=0) == 1).all()
    base = maps[0].shard_of_cells(cells)
    for m in maps[1:]:
        np.testing.assert_array_equal(m.shard_of_cells(cells), base)
    np.testing.assert_array_equal(
        base, jsm.ShardMap(n, 0, res).shard_of_cells(cells))
    assert len(np.unique(base)) == n


def test_assignment_stable_across_runs_and_processes():
    cells = _corpus_cells(8)
    sm = ShardMap(5, 0, 8, parent_res=6)
    a = sm.shard_of_cells(cells)
    np.testing.assert_array_equal(a, sm.shard_of_cells(cells.copy()))
    np.testing.assert_array_equal(
        a, jsm.ShardMap(5, 0, 8, parent_res=6).shard_of_cells(cells))
    # a fresh interpreter with another hash salt agrees: the port's map
    # there imports neither torch nor the reference
    prog = (
        "import sys, numpy as np; sys.path.insert(0, %r); "
        "from heatmap_tpu_torch.stream.shardmap import ShardMap; "
        "cells = np.fromfile(sys.argv[1], np.uint64); "
        "ShardMap(5, 0, 8, parent_res=6).shard_of_cells(cells)"
        ".astype(np.int32).tofile(sys.argv[2]); "
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules"
        % REPO)
    with tempfile.TemporaryDirectory() as td:
        cpath = os.path.join(td, "cells.u64")
        opath = os.path.join(td, "out.i32")
        cells.tofile(cpath)
        subprocess.run([sys.executable, "-c", prog, cpath, opath],
                       check=True, timeout=60,
                       env={**os.environ, "PYTHONHASHSEED": "12345"})
        np.testing.assert_array_equal(np.fromfile(opath, np.int32), a)


@pytest.mark.parametrize("res,parent_res", [(8, 5), (8, 0), (8, 8),
                                            (5, 5), (10, 7), (1, 0)])
def test_parent_bit_surgery_matches_pyramid_oracle(res, parent_res):
    cells = _corpus_cells(res)
    got = parent_cells(cells, res, parent_res)
    want = np.array([cell_to_parent(int(c), parent_res) for c in cells],
                    np.uint64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jsm.parent_cells(cells, res,
                                                        parent_res))
    if parent_res == res:
        np.testing.assert_array_equal(got, cells)


def test_parent_res_zero_groups_by_base_cell():
    cells = _corpus_cells(8)
    shards = ShardMap(7, 0, 8, parent_res=0).shard_of_cells(cells)
    np.testing.assert_array_equal(
        shards, jsm.ShardMap(7, 0, 8, parent_res=0).shard_of_cells(cells))
    base_cell = (cells >> np.uint64(45)) & np.uint64(0x7F)
    for bc in np.unique(base_cell):
        assert len(np.unique(shards[base_cell == bc])) == 1, int(bc)


def test_parent_finer_than_cell_raises():
    cells = _corpus_cells(5)
    with pytest.raises(ValueError):
        parent_cells(cells, 5, 8)
    with pytest.raises(ValueError):
        jsm.parent_cells(cells, 5, 8)


def _cols(lat, lng, make=columns_from_arrays):
    return make(np.degrees(lat), np.degrees(lng),
                np.zeros(len(lat), np.float32),
                np.full(len(lat), 1_700_000_000, np.int32))


def test_owned_mask_partitions_rows_exactly():
    """filter_columns keeps row order, gives the same rows and drop
    count as the JAX package's, and its cells are the owned rows'."""
    lat, lng = _world_points()
    n = 3
    maps = [ShardMap(n, i, 8, parent_res=6) for i in range(n)]
    masks = np.stack([m.owned_mask(lat, lng) for m in maps])
    assert (masks.sum(axis=0) == 1).all()
    cols, jcols = _cols(lat, lng), _cols(lat, lng, jax_columns)
    parts, total_foreign = [], 0
    for i, m in enumerate(maps):
        owned, n_foreign, owned_cells = m.filter_columns(cols)
        jowned, jn, jcells = jsm.ShardMap(n, i, 8, parent_res=6) \
            .filter_columns(jcols)
        assert n_foreign == jn
        for f in ("lat_rad", "lng_rad", "ts_s", "speed_kmh",
                  "vehicle_id"):
            np.testing.assert_array_equal(getattr(owned, f),
                                          getattr(jowned, f))
        np.testing.assert_array_equal(owned_cells, jcells)
        np.testing.assert_array_equal(
            owned_cells, m.cells_of(owned.lat_rad, owned.lng_rad))
        idx = np.flatnonzero(m.owned_mask(lat, lng))
        np.testing.assert_array_equal(owned.lat_rad, cols.lat_rad[idx])
        total_foreign += n_foreign
        parts.append(owned)
    assert sum(len(p) for p in parts) == len(cols)
    assert total_foreign == (n - 1) * len(cols)


def test_fully_owned_batch_passes_through_untouched():
    lat, lng = _world_points()
    cols = _cols(lat, lng)
    out, n_foreign, _ = ShardMap(1, 0, 8).filter_columns(cols)
    assert out is cols and n_foreign == 0
    assert ShardMap(1, 0, 8).owned_mask(lat, lng).all()
    empty, n0, cells0 = ShardMap(2, 0, 8).filter_columns(
        _cols(lat[:0], lng[:0]))
    assert len(empty) == 0 and n0 == 0 and cells0.size == 0


def test_fmix64_is_the_pinned_constant_mix():
    assert int(_fmix64(np.array([0], np.uint64))[0]) == 0
    assert int(_fmix64(np.array([1], np.uint64))[0]) == 0xB456BCFC34C2CB2C
    x = _corpus_cells(8)
    np.testing.assert_array_equal(_fmix64(x), jsm._fmix64(x))


def test_knob_validation():
    for mod in (jsm, None):
        cls = ShardMap if mod is None else mod.ShardMap
        for args, kw in (((0, 0, 8), {}), ((4, 4, 8), {}),
                         ((4, -1, 8), {}), ((4, 0, 8), {"parent_res": 9})):
            with pytest.raises(ValueError):
                cls(*args, **kw)
        assert cls(4, 0, 8, parent_res=-1).parent_res == 8


def test_from_config():
    assert ShardMap.from_config(load_config({})) is None
    env = {"HEATMAP_SHARDS": "4", "HEATMAP_SHARD_INDEX": "2",
           "HEATMAP_SHARD_RES": "5"}
    sm = ShardMap.from_config(load_config(env))
    jm = jsm.ShardMap.from_config(jax_load_config(env))
    assert ((sm.n_shards, sm.index, sm.snap_res, sm.parent_res)
            == (jm.n_shards, jm.index, jm.snap_res, jm.parent_res)
            == (4, 2, 8, 5))
    assert sm.describe().startswith("shard 2/4 (snap res 8, partition "
                                    "parent res 5")
    for bad in ({"HEATMAP_SHARDS": "4", "HEATMAP_SHARD_INDEX": "4"},
                {"HEATMAP_SHARDS": "2", "HEATMAP_SHARD_RES": "9"},
                {"HEATMAP_SHARD_OVERSAMPLE": "65"}):
        with pytest.raises(ValueError):
            load_config(bad)
        with pytest.raises(ValueError):
            jax_load_config(bad)


def test_sharded_jsonl_store_gets_per_shard_namespace(tmp_path):
    env = {"HEATMAP_SHARDS": "2", "HEATMAP_SHARD_INDEX": "1"}
    st = make_store(load_config(env, store="jsonl",
                                checkpoint_dir=str(tmp_path)))
    st.close()
    jst = jax_make_store(jax_load_config(env, store="jsonl",
                                         checkpoint_dir=str(tmp_path)))
    jst.close()
    assert st.path == jst.path == str(tmp_path / "shard1" / "store.jsonl")
    unsharded = make_store(load_config({}, store="jsonl",
                                       checkpoint_dir=str(tmp_path)))
    unsharded.close()
    assert unsharded.path == str(tmp_path / "store.jsonl")


_WHEN = dt.datetime(2026, 8, 3, tzinfo=dt.timezone.utc)


def _write_shard_log(tmp_path, i, cell, make, load):
    st = make(load({"HEATMAP_SHARDS": "2", "HEATMAP_SHARD_INDEX": str(i)},
                   store="jsonl", checkpoint_dir=str(tmp_path)))
    st.upsert_tiles([{
        "_id": f"bos|h3r8|{cell}|2026-08-03T00:00:00Z",
        "city": "bos", "grid": "h3r8", "cellId": cell,
        "windowStart": _WHEN, "windowEnd": _WHEN, "count": 1 + i,
        "avgSpeedKmh": 1.0, "staleAt": _WHEN + dt.timedelta(days=999),
    }])
    st.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_serve_side_jsonl_store_unions_all_shard_logs(tmp_path, writer):
    """A read-side store (``writer=False``) of either package loads the
    union of every shard's log, whichever package wrote them."""
    cells = ("892a300ca3bffff", "892a3008b4fffff")
    for i, cell in enumerate(cells):
        # shard 0 by the named writer, shard 1 by the other package
        port_writes = (i == 0) == (writer == "port")
        _write_shard_log(tmp_path, i, cell,
                         make_store if port_writes else jax_make_store,
                         load_config if port_writes else jax_load_config)
    out = []
    for make, load in ((make_store, load_config),
                       (jax_make_store, jax_load_config)):
        reader = make(load({"HEATMAP_SHARDS": "2"}, store="jsonl",
                           checkpoint_dir=str(tmp_path)), writer=False)
        out.append(sorted((t["cellId"], t["count"]) for t in
                          reader.tiles_in_window(_WHEN, grid="h3r8")))
        reader.close()
    assert out[0] == out[1] == sorted([(cells[0], 1), (cells[1], 2)])


def test_mesh_partition_every_cell_exactly_one_device():
    rng = np.random.default_rng(9)
    lat = np.radians(42.3 + rng.uniform(0, 0.3, 1024)).astype(np.float32)
    lng = np.radians(-71.2 + rng.uniform(0, 0.3, 1024)).astype(np.float32)
    ids, cells = MeshPartition(4, snap_res=8).partition(lat, lng)
    jids, jcells = jsm.MeshPartition(4, snap_res=8).partition(lat, lng)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cells, jcells)
    assert ids.dtype == np.int32 and ((ids >= 0) & (ids < 4)).all()
    by_cell = {}
    for c, d in zip(cells.tolist(), ids.tolist()):
        assert by_cell.setdefault(c, d) == d


def test_mesh_partition_quotient_decorrelates_from_outer_shards():
    rng = np.random.default_rng(13)
    lat = np.radians(42.0 + rng.uniform(0, 0.5, 2048)).astype(np.float32)
    lng = np.radians(-71.5 + rng.uniform(0, 0.5, 2048)).astype(np.float32)
    sm = ShardMap(2, 0, 8)
    cells = sm.cells_of(lat, lng)
    owned = cells[sm.shard_of_cells(cells) == 0]
    assert len(owned) > 100
    naive = MeshPartition(2, snap_res=8, outer_shards=1)
    assert set(naive.device_of_cells(owned).tolist()) == {0}
    composed = MeshPartition(2, snap_res=8, outer_shards=2)
    got = composed.device_of_cells(owned)
    assert set(got.tolist()) == {0, 1}
    np.testing.assert_array_equal(
        got, jsm.MeshPartition(2, snap_res=8, outer_shards=2)
        .device_of_cells(owned))


def test_mesh_partition_validation():
    for cls in (MeshPartition, jsm.MeshPartition):
        with pytest.raises(ValueError, match="device count"):
            cls(0, snap_res=8)
        with pytest.raises(ValueError, match="out of range"):
            cls(2, snap_res=16)
        with pytest.raises(ValueError, match="parent res"):
            cls(2, snap_res=8, parent_res=9)
        mp = cls(2, snap_res=8, parent_res=-1)
        assert mp.parent_res == 8
        assert "2-device" in mp.describe()


def test_snap_fn_keys_ownership_on_the_given_cells():
    """A shard map given the fold's snap reads ownership from that
    snap's cells: here a snap that moves every cell to its neighbour
    over the parent boundary moves the rows with it, and the cells
    filter_columns hands back are that snap's."""
    lat, lng = _world_points()
    host = ShardMap(1, 0, 8).cells_of(lat, lng)
    other = host[::-1].copy()  # a different, deterministic cell a row

    def snap(la, ln, res):
        assert res == 8 and la.dtype == np.float32
        return other[:len(la)] if len(la) == len(lat) else other

    sm = ShardMap(2, 1, 8, snap_fn=snap)
    cols = _cols(lat, lng)
    owned, n_foreign, cells = sm.filter_columns(cols)
    mask = ShardMap(2, 1, 8).shard_of_cells(other) == 1
    np.testing.assert_array_equal(owned.lat_rad, cols.lat_rad[mask])
    np.testing.assert_array_equal(cells, other[mask])
    assert n_foreign == int((~mask).sum())
    assert "fold snap" in sm.describe()
    hi = (host >> np.uint64(32)).astype(np.uint32)
    lo = host.astype(np.uint32)
    np.testing.assert_array_equal(join_words(hi.view(np.int32),
                                             lo.view(np.int32)), host)
