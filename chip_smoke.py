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
                small stream, both fed the same cell keys, for each merge
                impl (sort, rank, probe) with the fast path on and off: the
                six runs on the card byte-identical to one another, each
                within the bars of the CPU run, and the fast path taking
                each of its tiers 1, 2 and 3.
4. fold         the synthetic_backfill pipeline end to end through
                heatmap_tpu_torch.stream with its defaults (the fast path
                over the auto impl, an emit ring 8 batches deep with
                live-prefix pulls): 10M events, 20 batches of 2^19, a
                2^20-row slab with 64 histogram bins.  The snap kernel must
                launch once a batch, no group may overflow, the tile docs'
                counts must sum to the events aggregated, and the pulls
                must cover every batch.  Then, outside the timed run, the
                ops each of the first batches dispatches (by tier) and the
                synchronisations of a steady batch that flushes nothing:
                exactly one, the fold's tier-predicate read.
5. determinism  the first 3 batches twice from a fresh slab, then a flush:
                the host matrices of the two runs must be byte-identical,
                batch by batch.

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


# fold_check's stream: N events a batch over a 2^11-row slab
FC_N, FC_CAP, FC_T0 = 1 << 11, 1 << 11, 1_699_999_800   # T0: a window start


def fold_check_stream(rng):
    """Batches of (lat, lng radians, speed, ts, valid, hi, lo) over cells
    made from ``rng`` (res-9 index words with random variable bits) whose
    tiers under the fast path are 3 (empty slab), 1 (the same cells), 2 (a
    few new cells), 3 (a burst of 1500 new cells), 1 (half of them late),
    2 (a new window), 3 (the first window evicts), 3, 3 (fresh cells
    overflow the slab) and 2."""
    n = FC_N

    def cells(k):
        var = rng.choice((1 << 20) - 1, k, replace=False).astype(np.uint32)
        return (np.uint32(0x08900000) | var,
                rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32))

    def batch(pool, ts0, n_live=n):
        idx = rng.integers(0, len(pool[0]), n)
        return dict(
            hi=pool[0][idx], lo=pool[1][idx],
            ts=(ts0 + rng.integers(0, 200, n)).astype(np.int32),
            valid=np.arange(n) < n_live,
            speed=rng.uniform(0.0, 120.0, n).astype(np.float32),
            lat=np.radians(rng.uniform(42.3, 42.4, n)).astype(np.float32),
            lng=np.radians(rng.uniform(-71.1, -71.0, n)).astype(np.float32))

    def splice(b, other, k):
        out = {key: v.copy() for key, v in b.items()}
        idx = rng.choice(n, k, replace=False)
        for key in out:
            out[key][idx] = other[key][idx]
        return out

    a, new, burst, c = (cells(k) for k in (200, 50, 1500, 100))
    t0 = FC_T0
    b3 = batch(a, t0)
    b3["hi"][:1500], b3["lo"][:1500] = burst
    return [batch(a, t0), batch(a, t0),
            splice(batch(a, t0), batch(new, t0), 60), b3,
            splice(batch(a, t0), batch(a, t0 - 2000), n // 2),
            batch(c, t0 + 900, n_live=500), batch(c, t0 + 900),
            batch(cells(n), t0 + 900), batch(cells(n), t0 + 900),
            batch(c, t0 + 900)]


def fold_run(torch, step, batches, device, impl, fastpath):
    """Fold ``batches`` through MultiAggregator.step_packed_all on
    ``device`` with the given routing; returns per batch (packed host
    matrix, state as host bit patterns, tier taken or None)."""
    from heatmap_tpu_torch.engine.multi import (MultiAggregator,
                                                stats_from_packed)

    saved = step.MERGE_IMPL, step.FASTPATH
    step.MERGE_IMPL, step.FASTPATH = impl, fastpath
    try:
        agg = MultiAggregator([(MAIN_RES, 300)], FC_CAP, emit_capacity=FC_N,
                              hist_bins=64, device=device)
        max_ts, out = step.I32_MIN, []
        for b in batches:
            t = lambda a: torch.from_numpy(np.ascontiguousarray(
                a.view(np.int32) if a.dtype == np.uint32 else a)).to(device)
            cutoff = max_ts - 600 if max_ts > step.I32_MIN else max_ts
            tiers = dict(step._merge_fastpath.tiers)
            packed = agg.step_packed_all(
                t(b["lat"]), t(b["lng"]), t(b["speed"]), t(b["ts"]),
                t(b["valid"]), cutoff,
                prekeys={MAIN_RES: (t(b["hi"]), t(b["lo"]))})
            taken = [k for k, v in step._merge_fastpath.tiers.items()
                     if v != tiers[k]]
            host = packed.cpu().numpy().view(np.uint32)[0]
            state = [(f.view(torch.int32) if f.dtype == torch.float32
                      else f).cpu().numpy() for f in agg.states[0]]
            out.append((host, state, taken[0] if taken else None))
            max_ts = max(max_ts, stats_from_packed(host).batch_max_ts)
        return out
    finally:
        step.MERGE_IMPL, step.FASTPATH = saved


def phase_fold_check(torch, dev):
    """Every route of the fold on the card against the fold on the CPU, on
    a stream that takes each fast-path tier, both fed the same keys."""
    from heatmap_tpu_torch.engine import step
    from heatmap_tpu_torch.engine.multi import stats_from_packed

    batches = fold_check_stream(np.random.default_rng(SEED))
    cpu = fold_run(torch, step, batches, torch.device("cpu"), "sort", False)
    combos = [(i, f) for i in ("sort", "rank", "probe") for f in (True,
                                                                  False)]
    runs = {c: fold_run(torch, step, batches, dev, *c) for c in combos}
    int_cols = [0, 1, 2, 3, 8, 10, 11, 12]
    float_cols = [4, 5, 6, 7, 9, 10, 11, 12]
    worst = 0.0
    first = runs[combos[0]]
    for combo, run in runs.items():
        for k, ((g, gs, _), (g0, gs0, _), (c, cs, _)) in enumerate(
                zip(run, first, cpu)):
            if not (np.array_equal(g, g0)
                    and all(np.array_equal(x, y) for x, y in zip(gs, gs0))):
                raise AssertionError(f"fold on the card: {combo} differs "
                                     f"from {combos[0]} at batch {k}")
            if not (np.array_equal(g[0], c[0])
                    and np.array_equal(g[1:, int_cols], c[1:, int_cols])):
                raise AssertionError(f"fold on the card, {combo}, batch "
                                     f"{k}: integer lanes or anchors differ "
                                     f"from the CPU fold")
            gf = np.ascontiguousarray(g[1:, float_cols]).view(np.float32)
            cf = np.ascontiguousarray(c[1:, float_cols]).view(np.float32)
            if not (np.isfinite(gf).all() and np.isfinite(cf).all()):
                raise AssertionError("non-finite float lane in a packed "
                                     "emit")
            np.testing.assert_array_max_ulp(gf, cf, maxulp=2)
            worst = max(worst, float(np.abs(gf - cf).max()))
    tiers = {f"{i}": [t for _, _, t in runs[(i, True)]]
             for i in ("sort", "rank", "probe")}
    for impl, seq in tiers.items():
        if not {1, 2, 3} <= set(seq):
            raise AssertionError(f"fast path over {impl} took tiers {seq}")
    stats = [stats_from_packed(g) for g, _, _ in first]
    evicted = sum(s.n_evicted for s in stats)
    late = sum(s.n_late for s in stats)
    overflow = sum(s.state_overflow for s in stats)
    if not (evicted and late and overflow):
        raise AssertionError(f"fold_check stream: evicted {evicted}, late "
                             f"{late}, overflow {overflow}")
    emit({"phase": "fold_check", "batches": len(batches),
          "routes_identical_on_card": len(combos), "tiers": tiers,
          "evicted": evicted, "late": late, "overflow": overflow,
          "max_abs_err_float_lanes": worst})


def phase_fold(torch, run_pipeline, snap_kernel):
    from heatmap_tpu_torch.engine import step
    from heatmap_tpu_torch.profile_fold import per_batch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snap_kernel.latlng_to_cell_kernel.launches = 0
    for t in step._merge_fastpath.tiers:
        step._merge_fastpath.tiers[t] = 0
    t0 = time.monotonic()
    rt, store = run_pipeline("synthetic_backfill", device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = snap_kernel.latlng_to_cell_kernel.launches
    tiers = dict(step._merge_fastpath.tiers)
    m = rt.metrics
    pulls = m["pulls"]
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
    if sum(tiers.values()) != m["batches"] or not tiers[3]:
        raise AssertionError(f"fast-path tiers {tiers} in {m['batches']} "
                             f"batches (the first must take tier 3)")
    if pulls["batches"] != m["batches"] or not rt._prefix_pull:
        raise AssertionError(f"emit pulls {pulls} for {m['batches']} "
                             f"batches (prefix pull: {rt._prefix_pull})")
    bytes_per_batch = pulls["bytes"] / m["batches"]
    if bytes_per_batch >= 1 << 20:
        raise AssertionError(f"{bytes_per_batch} bytes pulled a batch")
    bad = [d["_id"] for d in docs.values()
           if not all(np.isfinite(v) for v in (
               d["avgSpeedKmh"], d["stddevSpeedKmh"], d["p95SpeedKmh"],
               *d["centroid"]["coordinates"]))]
    if bad:
        raise AssertionError(f"non-finite doc fields: {bad[:3]}")
    del rt, store
    torch.cuda.empty_cache()
    counts = per_batch_counts()
    syncs = counts["syncs"]
    if not (syncs["syncs"] == syncs["predicate_reads"] == 1
            and not syncs["flushed"]):
        raise AssertionError(f"a steady batch that flushes nothing must "
                             f"synchronise once, on its predicate read: "
                             f"{syncs}")
    out = {"phase": "fold", "events": m["events_valid"],
           "batches": m["batches"], "wall_s": wall,
           "events_per_s": m["events_valid"] / wall,
           "p50_batch_ms": m["p50_batch_ms"], "tiles": len(docs),
           "tiles_emitted": m["tiles_emitted"],
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "snap_launches": launches, "tiers": tiers, "pulls": pulls,
           "bytes_pulled_per_batch": bytes_per_batch,
           "per_batch": counts["ops"], "steady_batch_syncs": syncs}
    emit(out)
    return out


def phase_determinism(torch):
    """The first 3 batches twice from a fresh slab: the flushed host
    matrices must be byte-identical, batch by batch."""
    from heatmap_tpu_torch.profile_fold import new_runtime

    runs = []
    for _ in range(2):
        rt = new_runtime()
        for _ in range(3):
            if not rt.step_once():
                raise AssertionError("synthetic_backfill ran dry")
        rt.flush_pending()
        runs.append([b"".join(m.tobytes() for m in bufs)
                     for bufs, _ in rt.last_flush])
        del rt
        torch.cuda.empty_cache()
    same = [a == b for a, b in zip(*runs)]
    if len(same) != 3 or not all(same):
        raise AssertionError(f"flushed emits differ between runs: {same}")
    emit({"phase": "determinism", "batches": 3, "identical": same,
          "bytes_per_batch": [len(b) for b in runs[0]]})


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
