#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (heatmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build        compile every CUDA kernel of the package with nvcc (sm_90a).
2. snap         the fused H3 snap kernel (lat, lng -> index words hi, lo)
                against its plain PyTorch version on the card: 2^20
                Boston-box points, 2^20 global points and 12 x 2^16 points
                around the 12 pentagons, at every res 0..10, 100%
                identical words; and its time at the main path's shape
                (2^19 points, res 9).  Then (snap_main_inputs) the kernel
                against its plain version on the main path's own inputs,
                the first synthetic_backfill batch: exact.
3. fold_check   the fold on the card against the fold on the CPU (the plain
                versions the CPU tests hold against the JAX package) on a
                small stream, both fed the same cell keys.
4. fold         the synthetic_backfill pipeline end to end through
                heatmap_tpu_torch.stream: 10M events, 20 batches of 2^19,
                a 2^20-row slab with 64 histogram bins.  The snap kernel
                must launch once a batch, no group may overflow, and the
                tile docs' counts must sum to the events aggregated.  Then,
                outside the timed run, the ops one batch issues.
5. determinism  the first 3 batches twice from a fresh slab: the packed
                emits must be byte-identical.

Then one line listing every kernel (launches on the main path, agreement
with its plain version, its time, the plain version's, the bound), the
card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero; without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM data-sheet peaks (NVIDIA): HBM bandwidth and float32 rate
# outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SEED = 20261017
MAIN_RES = 9
MAIN_BATCH = 1 << 19


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def snap_ops(res: int, n: int, n_pent: int, pent_steps: int) -> int:
    """Operations the fused snap needs for ``n`` points at ``res``, of which
    ``n_pent`` lie in pentagon base cells and take ``pent_steps`` pentagon
    rotation steps in all.  The algorithm's work, stage by stage, each mul,
    add, divide, compare, shift, logic op, table read and sin/cos call
    counted once (a lower bound):

    geometry, every point:
    - unit vector: 4 trig calls + 3 mul;
    - face search: 20 x (3 mul + 2 add + 1 compare);
    - gnomonic projection: 3 div + 3 sub + 6 mul + 4 add;
    - Class III rotation (odd res): 4 mul + 2 add; scale: 2 mul;
    - hex2d -> ijk: ~40 float and int ops;
    - each of ``res`` aperture-7 rounds: ~80 int ops (coarsen 29, finer
      centre 26, the digit 26);
    - clamps and the flat27 index: 12;
    tables, every point: base cell, rotation count and pentagon flag (3
    reads) and the branch, 4; packing into (hi, lo), 10;
    digit rotations: a hexagon rotates each of its ``res`` fields once (6
    ops a field: shift, mask, index, read, shift, or); a pentagon instead
    reads its cw flag, finds its leading digit (6) and takes its steps,
    each one rotation of the fields plus a leading digit.  The pentagon's
    conditional extra rotations are not counted."""
    geometry = 7 + 20 * 6 + 16 + (6 if res % 2 == 1 else 0) + 2 + 40 \
        + 80 * res + 12
    field_pass = 6 * res
    ops = n * (geometry + 4 + 10) + (n - n_pent) * field_pass
    return ops + n_pent * 7 + pent_steps * (field_pass + 6)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / MEM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, inner: int, reps: int = 21, warm: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events around
    ``inner`` calls).  A spin kernel first keeps the card busy while the
    host queues the calls, so host launch overhead is not timed."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def region_points(rng, n, region):
    if region == "city":
        lat = rng.uniform(42.2, 42.5, n)
        lng = rng.uniform(-71.3, -70.8, n)
    else:
        lat = rng.uniform(-89.9, 89.9, n)
        lng = rng.uniform(-180.0, 180.0, n)
    return (np.radians(lat).astype(np.float32),
            np.radians(lng).astype(np.float32))


def icosahedron_vertices() -> np.ndarray:
    """(12, 3) unit vectors: the icosahedron's vertices, the centres of
    the 12 pentagon base cells.  Two faces that share an edge share its
    two end points, which lie at the same angle from both face centres."""
    from heatmap_tpu_torch.hexgrid.constants import FACE_CENTER_XYZ

    c = np.asarray(FACE_CENTER_XYZ, np.float64)
    k = np.sqrt((5 + 2 * np.sqrt(5)) / 15)  # cos(face centre, its vertex)
    dots = c @ c.T
    adjacent = np.isclose(dots, np.sort(dots, axis=1)[:, -2:-1])
    verts = []
    for f, g in zip(*np.nonzero(np.triu(adjacent, 1))):
        s = c[f] + c[g]
        a = k / (1 + dots[f, g])
        n = np.cross(c[f], c[g])
        b = np.sqrt(1 - a * a * (s @ s)) / np.linalg.norm(n)
        verts += [a * s + b * n, a * s - b * n]
    verts = np.unique(np.round(np.asarray(verts), 9), axis=0)
    if len(verts) != 12:
        raise AssertionError(f"found {len(verts)} icosahedron vertices")
    return verts


def pentagon_points(torch, snap_kernel, rng, per_pentagon):
    """``per_pentagon`` points around each pentagon centre (normal jitter of
    0.02 rad, ~130 km), where the pentagon digit rotations run."""
    from heatmap_tpu_torch.hexgrid import device as hexdev

    v = icosahedron_vertices()
    lat0 = np.arcsin(np.clip(v[:, 2], -1, 1))
    lng0 = np.arctan2(v[:, 1], v[:, 0])
    hi, _ = snap_kernel.latlng_to_cell_reference(
        *(torch.from_numpy(a.astype(np.float32)) for a in (lat0, lng0)), 0)
    if not hexdev._DeviceTables().bc_pent[(hi.numpy() >> 13) & 0x7F].all():
        raise AssertionError("an icosahedron vertex is not in a pentagon")
    jit = rng.normal(0.0, 0.02, (len(v), per_pentagon, 2))
    lat = np.clip(lat0[:, None] + jit[..., 0], -1.5707, 1.5707)
    lng = lng0[:, None] + jit[..., 1]
    return (lat.reshape(-1).astype(np.float32),
            lng.reshape(-1).astype(np.float32))


def compare_cells(torch, snap_kernel, lat, lng, res):
    """(share of identical (hi, lo) words, max abs difference of a word)
    between the kernel and its plain version on the same CUDA tensors."""
    got = snap_kernel.latlng_to_cell_kernel(lat, lng, res)
    ref = snap_kernel.latlng_to_cell_reference(lat, lng, res)
    torch.cuda.synchronize()
    same = torch.ones_like(got[0], dtype=torch.bool)
    err = 0
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape
        same &= a == b
        err = max(err, int((a.long() - b.long()).abs().max()))
    return float(same.float().mean()), err


def pentagon_work(snap_kernel, lat, lng, res):
    """(points in pentagon base cells, pentagon rotation steps they take)
    for these inputs, from the plain version's geometry and tables."""
    from heatmap_tpu_torch.hexgrid import device as hexdev

    T = hexdev._DeviceTables()
    _, flat, _ = snap_kernel.snap_geometry_reference(lat, lng, res)
    flat = flat.cpu().numpy()
    pent = T.bc_pent[T.face_ijk_bc[flat]] != 0
    return int(pent.sum()), int(T.face_ijk_rot[flat][pent].sum())


def phase_build(_build):
    t0 = time.monotonic()
    libs = _build.build_all()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "libraries": [str(p.name) for p in libs.values()],
          "nvcc": nvcc.stdout.strip().splitlines()[-1]})


def phase_snap(torch, snap_kernel, dev):
    rng = np.random.default_rng(SEED)
    pts = {r: region_points(rng, 1 << 20, r) for r in ("city", "global")}
    pts["pentagon"] = pentagon_points(torch, snap_kernel, rng, 1 << 16)
    pts = {r: tuple(torch.from_numpy(a).to(dev) for a in ab)
           for r, ab in pts.items()}
    shares = {}
    for res in range(11):
        for region, (lat, lng) in pts.items():
            share, err = compare_cells(torch, snap_kernel, lat, lng, res)
            shares[f"{region}_r{res}"] = share
            if share != 1.0 or err != 0:
                raise AssertionError(f"snap kernel vs plain, {region} res "
                                     f"{res}: {share} identical, max abs "
                                     f"err {err}")
    lat, lng = (a[:MAIN_BATCH] for a in pts["city"])
    ms = time_ms(
        torch, lambda: snap_kernel.latlng_to_cell_kernel(lat, lng, MAIN_RES),
        inner=20)
    plain_ms = time_ms(
        torch, lambda: snap_kernel.latlng_to_cell_reference(lat, lng,
                                                            MAIN_RES),
        inner=1)
    n_pent, pent_steps = pentagon_work(snap_kernel, lat, lng, MAIN_RES)
    ops = snap_ops(MAIN_RES, MAIN_BATCH, n_pent, pent_steps)
    bms, by = bound_ms(MAIN_BATCH * 16.0, ops)
    out = {"phase": "snap", "identical": shares, "points": MAIN_BATCH,
           "res": MAIN_RES, "ms": ms, "plain_ms": plain_ms,
           "ops": ops, "bytes": MAIN_BATCH * 16, "pentagon_points": n_pent,
           "bound_ms": bms, "bound_by": by}
    emit(out)
    return out


def phase_fold_check(torch, dev):
    """The fold on the card against the fold on the CPU on a small stream
    that crosses window ends, both fed the same (kernel-computed) keys."""
    from heatmap_tpu_torch.engine.multi import (MultiAggregator,
                                                stats_from_packed)
    from heatmap_tpu_torch.engine.step import I32_MIN
    from heatmap_tpu_torch.hexgrid import snap_kernel
    from heatmap_tpu_torch.stream.source import SyntheticSource

    n, cap, res = 1 << 12, 1 << 14, MAIN_RES
    src = SyntheticSource(n_events=4 * n, n_vehicles=300,
                          events_per_second=8, seed=SEED)
    aggs = {d: MultiAggregator([(res, 300)], cap, emit_capacity=n,
                               hist_bins=64, device=d)
            for d in (dev, torch.device("cpu"))}
    max_ts, worst, n_late_evict = I32_MIN, 0.0, 0
    for _ in range(4):
        cols = src.poll(n)
        lat, lng = (torch.from_numpy(a).to(dev)
                    for a in (cols.lat_rad, cols.lng_rad))
        hi, lo = snap_kernel.latlng_to_cell_kernel(lat, lng, res)
        cutoff = max_ts - 600 if max_ts > I32_MIN else I32_MIN
        packed = {}
        for d, agg in aggs.items():
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(d)
            packed[d] = agg.step_packed_all(
                t(cols.lat_rad), t(cols.lng_rad), t(cols.speed_kmh),
                t(cols.ts_s), torch.ones(n, dtype=torch.bool, device=d),
                cutoff, prekeys={res: (hi.to(d), lo.to(d))}
            ).cpu().numpy().view(np.uint32)[0]
        g, c = packed[dev], packed[torch.device("cpu")]
        int_cols = [0, 1, 2, 3, 8, 10, 11, 12]
        float_cols = [4, 5, 6, 7, 9, 10, 11, 12]
        if not (np.array_equal(g[0], c[0])
                and np.array_equal(g[1:, int_cols], c[1:, int_cols])):
            raise AssertionError("fold on the card: integer lanes or "
                                 "anchors differ from the CPU fold")
        gf = np.ascontiguousarray(g[1:, float_cols]).view(np.float32)
        cf = np.ascontiguousarray(c[1:, float_cols]).view(np.float32)
        if not (np.isfinite(gf).all() and np.isfinite(cf).all()):
            raise AssertionError("non-finite float lane in a packed emit")
        np.testing.assert_array_max_ulp(gf, cf, maxulp=2)
        worst = max(worst, float(np.abs(gf - cf).max()))
        st = stats_from_packed(g)
        n_late_evict += st.n_evicted
        max_ts = max(max_ts, st.batch_max_ts)
    if n_late_evict == 0:
        raise AssertionError("fold_check stream evicted no window")
    emit({"phase": "fold_check", "batches": 4, "evicted": n_late_evict,
          "max_abs_err_float_lanes": worst})


def phase_fold(torch, run_pipeline, snap_kernel):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snap_kernel.latlng_to_cell_kernel.launches = 0
    t0 = time.monotonic()
    rt, store = run_pipeline("synthetic_backfill", device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = snap_kernel.latlng_to_cell_kernel.launches
    m = rt.metrics
    docs = store._tiles
    total = sum(d["count"] for d in docs.values())
    if launches != m["batches"]:
        raise AssertionError(f"snap kernel launched {launches} times in "
                             f"{m['batches']} batches")
    if m["state_overflow"]:
        raise AssertionError(f"state overflow: {m['state_overflow']}")
    if not (total == m["events_valid"] == 10_000_000):
        raise AssertionError(f"counts not conserved: docs {total}, "
                             f"aggregated {m['events_valid']}")
    bad = [d["_id"] for d in docs.values()
           if not all(np.isfinite(v) for v in (
               d["avgSpeedKmh"], d["stddevSpeedKmh"], d["p95SpeedKmh"],
               *d["centroid"]["coordinates"]))]
    if bad:
        raise AssertionError(f"non-finite doc fields: {bad[:3]}")
    del rt, store
    out = {"phase": "fold", "events": m["events_valid"],
           "batches": m["batches"], "wall_s": wall,
           "events_per_s": m["events_valid"] / wall,
           "p50_batch_ms": m["p50_batch_ms"], "tiles": len(docs),
           "tiles_emitted": m["tiles_emitted"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "snap_launches": launches, "per_batch": count_batch_ops(torch)}
    emit(out)
    return out


def count_batch_ops(torch):
    """The ops one synthetic_backfill batch issues on the card (its second
    batch, after the first has made the cached tables), outside any timed
    run."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.profile_fold import ops_per_batch
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline("synthetic_backfill")
    rt = MicroBatchRuntime(p.config, p.make_source(p.config), MemoryStore(),
                           device="cuda")
    if not rt.step_once():
        raise AssertionError("synthetic_backfill ran dry")
    out = ops_per_batch(rt)
    del rt
    torch.cuda.empty_cache()
    return out


def phase_determinism(torch):
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline("synthetic_backfill")
    runs = []
    for _ in range(2):
        rt = MicroBatchRuntime(p.config, p.make_source(p.config),
                               MemoryStore(), device="cuda")
        packs = []
        for _ in range(3):
            if not rt.step_once():
                raise AssertionError("synthetic_backfill ran dry")
            packs.append(rt.last_packed.tobytes())
        runs.append(packs)
        del rt
        torch.cuda.empty_cache()
    same = [a == b for a, b in zip(*runs)]
    if not all(same):
        raise AssertionError(f"packed emits differ between runs: {same}")
    emit({"phase": "determinism", "batches": 3, "identical": same,
          "bytes_per_batch": len(runs[0][0])})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from heatmap_tpu_torch import _build
    from heatmap_tpu_torch.hexgrid import snap_kernel
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.stream.__main__ import run_pipeline

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    phase_build(_build)
    snap = phase_snap(torch, snap_kernel, dev)
    phase_fold_check(torch, dev)

    # the kernel against its plain version on the main path's own inputs
    # (the first synthetic_backfill batch); these launches are not counted.
    # Bar: exact.  Both sides round every product and sum on its own (the
    # kernel is built with -fmad=false) and divide in IEEE, so on the card
    # they agree bit for bit, as the snap phase shows on 2^20 points
    p = get_pipeline("synthetic_backfill")
    cols = p.make_source(p.config).poll(p.config.batch_size)
    lat, lng = (torch.from_numpy(a).to(dev)
                for a in (cols.lat_rad, cols.lng_rad))
    main_share, main_err = compare_cells(torch, snap_kernel, lat, lng,
                                         p.config.h3_res)
    if main_share != 1.0 or main_err != 0:
        raise AssertionError(f"snap kernel vs plain on the main path's "
                             f"first batch: {main_share} identical, max "
                             f"abs err {main_err}")
    emit({"phase": "snap_main_inputs", "points": len(cols),
          "res": p.config.h3_res, "identical": main_share,
          "max_abs_err": main_err})
    fold = phase_fold(torch, run_pipeline, snap_kernel)
    phase_determinism(torch)

    emit({"kernels": [{
        "name": "snap_cell",
        "route": "cuda",
        "source": "heatmap_tpu_torch/hexgrid/csrc/snap_cell.cu",
        "replaces": "heatmap_tpu/hexgrid/pallas_kernel.py:66",
        "launches": fold["snap_launches"],
        "max_abs_err": main_err,
        "identical_share": main_share,
        "ms": snap["ms"],
        "plain_ms": snap["plain_ms"],
        "bound_ms": snap["bound_ms"],
        "bound_by": snap["bound_by"],
        "library_ms": None,
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
