#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (heatmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build        compile every CUDA kernel of the package with nvcc (sm_90a)
                and the native host codecs with g++, all at once.
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
                heatmap_tpu_torch.stream with the reference runtime's
                defaults, in a fresh checkpoint directory: the fast path
                over the auto impl, an emit ring 8 batches deep with
                live-prefix pulls, one batch prefetched, slab growth with
                its pressure flush, a checkpoint every 20 batches and at
                close, and the positions fold into positions_latest through
                the writer thread.  10M events, 20 batches of 2^19, a slab
                of 2^20 rows with 64 histogram bins that must grow once, to
                2^21;
                the flushes by trigger must equal the JAX runtime's
                arithmetic for this stream (``reference_flushes``), and
                2 commits must land.  The snap kernel must launch once a
                batch, no group may overflow, the tile docs' counts must
                sum to the events aggregated, the pulls must cover
                every batch, and positions_latest must hold each vehicle
                at its newest second.  Then, outside the timed run, the ops each of
                the first batches dispatches (by tier) and the
                synchronisations of a steady batch that flushes nothing:
                exactly one, the fold's tier-predicate read.
5. resume       the same fold with a checkpoint every 10 batches, the
                runtime abandoned 3 batches after the commit (its commit
                joined, no close), then a new runtime on the same
                directory and store: its restored slab must equal the
                committed npz byte for byte, and the final tile and
                position docs the fold phase's exactly; prints the time to recover (construction
                plus the first batch) and the snap launches of both runs.
6. determinism  the first 3 batches twice from a fresh slab, then a flush:
                the host matrices of the two runs must be byte-identical,
                batch by batch.
7. pipelines    hex_pyramid (res 7/8/9 x 5 min) and multi_window (res 8 x
                1/5/15 min) in their presets' configs through
                heatmap_tpu_torch.stream, each over a bounded
                SyntheticSource (2^22 events, 32 batches of 2^17, 20,000
                vehicles, 2,000 events/s: ~35 minutes of event time, so
                every window length closes and evicts) in a fresh
                checkpoint directory.  The kernel against its plain version
                on the first batch's points at each res (exact, and its
                time and bound at that shape); snap launches = batches x
                unique res; each pair's docs identical, byte for byte, to a
                one-pair run of the same config at that (res, window) over
                the same stream; conservation for every pair; no overflow;
                multi_window's watermark flushes > 0.
8. opensky      opensky_global's config (res 7, a 2^19-row slab, 128
                histogram bins) for 8 batches of 2^17 over a bounded
                SyntheticSource spread over 120 x 120 degrees:
                conservation, no overflow, one snap launch a batch.
9. kafka        mbta_default through the port's own Kafka ingress on its
                native codecs (the C++ CRC32C, record framing and JSON
                decoder, built with g++ in the build phase): the port's
                MockKafkaBroker with mobility.positions.v1 on 3 partitions,
                the sources built first (they start at LATEST), then 2^20
                JSON events in the reference schema (4,096 vehicles, 512 s
                of event time) produced through the port's KafkaClient,
                keyed by vehicleId, 384 of them rejects.  The snap kernel
                against its plain version on the first Kafka batch (exact),
                then the same stream, 8 batches of 2^17, into the three
                stores that HEATMAP_STORE selects: memory, jsonl
                (<CHECKPOINT>/store.jsonl, reloaded after close) and mongo
                (the port's MockMongod over the wire client and the C++
                BSON encoders).  Every value decoded natively (no Python
                fallback blob), events valid and dropped as produced, one
                snap launch a batch; the three stores' tile and
                positions_latest docs the same (Mongo's floats within the
                reference's 1e-15 between its two encoders), the positions
                the newest event of each vehicle; the docs equal to the same
                events fed through MemorySource in the order the source's
                sweeps read them; a run killed after its commit at epoch 3
                and one more batch, resumed from the committed {partition:
                offset} map into the same Mongo database, reaches the
                uninterrupted Mongo run's docs.  Then, uncompared, the
                topic read at the default 4-MiB fetch, and each native
                codec's host time on one 2^17 batch beside its Python
                version.
10. infer       synthetic_backfill's preset (2^19 batches, 20,000
                vehicles, res 9) with HEATMAP_REDUCERS=count,kalman.  The
                rounds kernel (infer/csrc/kalman_rounds.cu) against its
                plain version on the card, exact on every output, on the
                round sets the engine builds for the first two batches (K ~
                27, M = 20,000) and on a full table (K = 8, M = 2^17): its
                time, the plain version's, the bound, and filter_rounds'
                host time with its copies.  Then 16 batches through the
                runtime: one kalman_rounds launch and one snap launch a
                batch, conservation, velocity on the docs (finite), the
                count docs equal to a kalman-off run's without the velocity
                columns, and the entity table equal, within the CPU tests'
                bar, to the same batches folded by the plain version on the
                CPU, with the same counters and anomalies by reason.

Then one line listing every kernel (launches on the main path and in
every later phase, agreement with its plain version, its time, the plain
version's, the bound, by res), the
card's name and power limit, and the last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero; without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM data-sheet peaks (NVIDIA): HBM bandwidth and float32 rate
# outside the tensor cores
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SEED = 20261017
MAIN_RES = 9
MAIN_BATCH = 1 << 19
MAIN_EVENTS = 10_000_000    # synthetic_backfill: 20 batches
MAIN_BATCHES = 20
# the pipelines phase's stream: 32 batches of the presets' 2^17
PIPE_SOURCE = dict(n_events=1 << 22, n_vehicles=20_000,
                   events_per_second=2_000)
OPENSKY_BATCHES = 8
KAFKA_EVENTS = 1 << 20      # eight batches of mbta_default
KAFKA_SOURCE = dict(n_vehicles=4_096, events_per_second=2_048)


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
    """Every CUDA kernel (nvcc) and the native host codecs (g++), built
    from the checkout's sources, all compilers started together."""
    t0 = time.monotonic()
    libs = _build.build_all()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    gxx = subprocess.run([_build.find_gxx(), "--version"],
                         capture_output=True, text=True, check=True)
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "libraries": {src: {"path": str(path), "seconds": secs,
                              "hash": path.stem.rsplit("-", 1)[1]}
                        for src, (path, secs) in libs.items()},
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "gxx": gxx.stdout.strip().splitlines()[0],
          "gxx_flags": list(_build.GXX_FLAGS)})


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
        agg = MultiAggregator([(MAIN_RES, 300)], FC_CAP, FC_N,
                              emit_capacity=FC_N,
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


def reference_flushes(n_batches, batch, cap, cap_max, k, every, peak):
    """Flushes by trigger, growths and the final slab rows that the JAX
    runtime's defaults give a stream in one window (no watermark flush)
    whose live groups, once the first flush reads them, stay at ``peak``
    (the run's largest count: at synthetic_backfill's sizes every outcome
    below is the same for any 0 < peak <= batch).
    heatmap_tpu/stream/runtime.py: the margin ``2 * batch * (pending + 2)
    // 2`` (``_grow_margin``, :1996-2017), the pressure
    flush when ``peak + margin > cap`` (``_grow_would_trigger``,
    :2019-2031, in the step loop :2300-2330, after the ring-full test),
    then ``_maybe_grow`` doubling while ``peak + margin > cap`` up to the
    ceiling (:1948-1994), the checkpoint's flush every ``every`` batches
    (:2546-2555), and the flush on the idle poll that finds the stream
    ended (:2276-2279), which leaves nothing to the close (:2985-2989)."""
    flushes = {"full": 0, "grow": 0, "checkpoint": 0, "idle": 0,
               "close": 0}
    pend, seen, grows = 0, 0, 0
    margin = lambda: 2 * batch * (pend + 2) // 2
    for b in range(n_batches):
        reason = ("full" if pend >= k
                  else "grow" if seen + margin() > cap else None)
        if reason is not None:
            flushes[reason] += 1
            pend, seen = 0, peak
            new = cap
            while seen + margin() > new and new < cap_max:
                new *= 2
            grows += new != cap
            cap = new
        pend += 1
        if every and (b + 1) % every == 0:
            flushes["checkpoint"] += 1
            pend, seen = 0, peak
    flushes["idle"] += pend > 0
    return flushes, grows, cap


def commit_record(commits):
    """Capture ms, background seconds and bytes on disk of each commit;
    raises unless each landed."""
    for c in commits:
        if "bytes" not in c or not c["bytes"]:
            raise AssertionError(f"a checkpoint commit did not land: {c}")
    return [{k: c[k] for k in ("epoch", "capture_ms", "background_s",
                               "bytes")} for c in commits]


def phase_fold(torch, run_pipeline, snap_kernel, ckpt_dir):
    from heatmap_tpu_torch.engine import step
    from heatmap_tpu_torch.profile_fold import per_batch_counts
    from heatmap_tpu_torch.sink.memory import MemoryStore

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snap_kernel.latlng_to_cell_kernel.launches = 0
    for t in step._merge_fastpath.tiers:
        step._merge_fastpath.tiers[t] = 0
    t0 = time.monotonic()
    rt, store = run_pipeline("synthetic_backfill", device="cuda",
                             checkpoint_dir=ckpt_dir, store=MemoryStore())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = snap_kernel.latlng_to_cell_kernel.launches
    tiers = dict(step._merge_fastpath.tiers)
    m = rt.metrics
    pulls = m["pulls"]
    docs, positions = store._tiles, store._positions
    total = sum(d["count"] for d in docs.values())
    if launches != m["batches"]:
        raise AssertionError(f"snap kernel launched {launches} times in "
                             f"{m['batches']} batches")
    if m["state_overflow"]:
        raise AssertionError(f"state overflow: {m['state_overflow']}")
    if not (total == m["events_valid"] == MAIN_EVENTS):
        raise AssertionError(f"counts not conserved: docs {total}, "
                             f"aggregated {m['events_valid']}")
    if sum(tiers.values()) != m["batches"] or not tiers[3]:
        raise AssertionError(f"fast-path tiers {tiers} in {m['batches']} "
                             f"batches (the first must take tier 3)")
    if pulls["batches"] != m["batches"] or not rt._prefix_pull:
        raise AssertionError(f"emit pulls {pulls} for {m['batches']} "
                             f"batches (prefix pull: {rt._prefix_pull})")
    cfg = rt.cfg
    peak = rt._n_active_peak
    if not 0 < peak <= cfg.batch_size:
        raise AssertionError(f"live groups {peak}: outside the range "
                             f"reference_flushes models")
    want, want_grown, want_cap = reference_flushes(
        m["batches"], cfg.batch_size, 1 << cfg.state_capacity_log2,
        1 << (cfg.state_capacity_log2 + 4), cfg.emit_flush_k,
        rt.checkpoint_every, peak)
    got = {k: pulls[k] for k in want}
    if (got != want or pulls["watermark"]
            or m["state_grown"] != want_grown or want_grown != 1
            or m["capacity"] != want_cap
            or want_cap != 2 << cfg.state_capacity_log2):
        raise AssertionError(
            f"flushes {pulls}, growths {m['state_grown']}, capacity "
            f"{m['capacity']}; the reference's arithmetic gives {want}, "
            f"{want_grown}, {want_cap}")
    commits = commit_record(m["commits"])
    if (m["checkpoints"] != 2 or m["batches"] != MAIN_BATCHES
            or [c["epoch"] for c in commits] != [MAIN_BATCHES] * 2):
        raise AssertionError(f"{m['checkpoints']} checkpoints: {commits}")
    bytes_per_batch = pulls["bytes"] / m["batches"]
    if bytes_per_batch >= 1 << 20:
        raise AssertionError(f"{bytes_per_batch} bytes pulled a batch")
    bad = [d["_id"] for d in docs.values()
           if not all(np.isfinite(v) for v in (
               d["avgSpeedKmh"], d["stddevSpeedKmh"], d["p95SpeedKmh"],
               *d["centroid"]["coordinates"]))]
    if bad:
        raise AssertionError(f"non-finite doc fields: {bad[:3]}")
    # positions_latest: one doc a vehicle, at its newest event's second
    # (event i is vehicle i % n_vehicles at t0 + i // events_per_second)
    src = rt.source
    v = np.arange(src.n_vehicles)
    last = v + src.n_vehicles * ((MAIN_EVENTS - 1 - v) // src.n_vehicles)
    want_ts = {f"veh-{k}": int(src.t0 + i // src.eps)
               for k, i in zip(v, last)}
    got_ts = {d["vehicleId"]: int(d["ts"].timestamp())
              for d in positions.values()}
    if (got_ts != want_ts
            or m["positions_written"] != m["positions_emitted"]):
        raise AssertionError(f"positions_latest: {len(positions)} docs for "
                             f"{src.n_vehicles} vehicles, written "
                             f"{m['positions_written']} of emitted "
                             f"{m['positions_emitted']}")
    peak_mem = torch.cuda.max_memory_allocated()
    spans = {k: m["p50_span_ms"][k] for k in ("poll", "feed", "dispatch",
                                              "positions", "prefetch")}
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
           "p50_batch_ms": m["p50_batch_ms"], "p50_span_ms": spans,
           "tiles": len(docs), "tiles_emitted": m["tiles_emitted"],
           "positions": len(positions),
           "positions_emitted": m["positions_emitted"],
           "writer": {k: m[k] for k in ("tiles_written", "positions_written",
                                        "sink_retries",
                                        "sink_backpressure_ms")},
           "peak_mem_bytes": peak_mem,
           "snap_launches": launches, "tiers": tiers, "pulls": pulls,
           "reference_flushes": want, "live_groups_peak": peak,
           "state_grown": m["state_grown"], "capacity": m["capacity"],
           "commits": commits,
           "bytes_pulled_per_batch": bytes_per_batch,
           "per_batch": counts["ops"], "steady_batch_syncs": syncs}
    emit(out)
    return out, docs, positions


def phase_resume(torch, snap_kernel, fold_docs, fold_positions, ckpt_dir):
    """Kill after a commit and 3 more batches, resume on the same
    directory and store: the restored slab equals the commit, the final
    docs equal an uninterrupted run's."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.checkpoint import CheckpointManager
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline("synthetic_backfill")
    cfg = dataclasses.replace(p.config, checkpoint_dir=ckpt_dir)
    every = 10
    store = MemoryStore()
    snap_kernel.latlng_to_cell_kernel.launches = 0
    rt = MicroBatchRuntime(cfg, p.make_source(cfg), store,
                           checkpoint_every=every)
    for _ in range(every + 3):
        if not rt.step_once():
            raise AssertionError("synthetic_backfill ran dry")
    rt._ckpt_join()          # the commit lands; then the process "dies"
    rt.writer.drain()        # (what it handed its writer had landed)
    # batch wall times and predicate waits: the commit's background
    # thread runs beside the last 3 (do its D2H and np.savez slow the
    # step thread?)
    first = {"batches": rt.counters["batches"], "pulls": dict(rt.pulls),
             "commits": commit_record(rt.commits), "batch_ms": rt.batch_ms,
             "predicate_ms": rt.span_ms["predicate"]}
    del rt
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # time to recover: construction (the npz load, the H2D, the growth,
    # the seek) plus the first batch's step; the checks between are not
    # counted
    t0 = time.monotonic()
    rt = MicroBatchRuntime(cfg, p.make_source(cfg), store,
                           checkpoint_every=every)
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    if rt.epoch != every or rt._offsets_dispatched != every * cfg.batch_size:
        raise AssertionError(f"resumed at epoch {rt.epoch}, offset "
                             f"{rt._offsets_dispatched}")
    pair = rt.pairs[0]
    committed = CheckpointManager(ckpt_dir).load_state(*pair, epoch=every)
    restored = rt.aggs[pair].snapshot()
    for name, a, b in zip(committed._fields, committed, restored):
        if (a.dtype != b.dtype or a.shape != b.shape
                or a.tobytes() != b.tobytes()):
            raise AssertionError(f"restored slab differs from the commit "
                                 f"in {name}")
    del restored
    t1 = time.monotonic()
    if not rt.step_once():
        raise AssertionError("the resumed run had nothing to fold")
    torch.cuda.synchronize()
    time_to_recover = restore_s + time.monotonic() - t1
    first_step_ms = {"batch": rt.batch_ms[0],
                     **{k: v[0] for k, v in rt.span_ms.items() if v}}
    rt.run()
    m = rt.metrics
    launches = snap_kernel.latlng_to_cell_kernel.launches
    if launches != first["batches"] + m["batches"]:
        raise AssertionError(f"snap kernel launched {launches} times in "
                             f"{first['batches']} + {m['batches']} batches")
    if (rt.epoch != MAIN_BATCHES or m["batches"] != MAIN_BATCHES - every
            or m["state_overflow"]):
        raise AssertionError(f"resumed run: epoch {rt.epoch}, {m}")
    if store._tiles != fold_docs or store._positions != fold_positions:
        raise AssertionError("the resumed run's docs differ from the "
                             "uninterrupted run's")
    out = {"phase": "resume", "killed_after_batches": first["batches"],
           "committed_epoch": every, "first_run": first,
           "restore_s": restore_s, "resume_s": rt.resume_s,
           "time_to_recover_s": time_to_recover,
           "first_step_ms": first_step_ms,
           "resumed_batches": m["batches"], "resumed_pulls": m["pulls"],
           "capacity": m["capacity"], "commits": commit_record(m["commits"]),
           "snap_launches": launches, "slab_identical": True,
           "docs_identical": True, "tiles": len(store._tiles),
           "positions": len(store._positions)}
    del rt
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_determinism(torch):
    """The first 3 batches twice from a fresh slab: the flushed host
    matrices must be byte-identical, batch by batch."""
    from heatmap_tpu_torch.profile_fold import new_runtime

    runs = []
    for _ in range(2):
        with tempfile.TemporaryDirectory() as ckpt:
            rt = new_runtime(ckpt)
            flushed = []   # every flush's batches (growth flushes one)
            for _ in range(3):
                flushes = rt.pulls["flushes"]
                if not rt.step_once():
                    raise AssertionError("synthetic_backfill ran dry")
                if rt.pulls["flushes"] > flushes:
                    flushed += rt.last_flush
            rt.flush_pending()
            flushed += rt.last_flush
            runs.append([b"".join(m.tobytes() for m in bufs)
                         for bufs, _ in flushed])
            del rt
        torch.cuda.empty_cache()
    same = [a == b for a, b in zip(*runs)]
    if len(same) != 3 or not all(same):
        raise AssertionError(f"flushed emits differ between runs: {same}")
    emit({"phase": "determinism", "batches": 3, "identical": same,
          "bytes_per_batch": [len(b) for b in runs[0]]})


def pair_docs(docs, grid):
    return {k: d for k, d in docs.items() if d["grid"] == grid}


def run_stats(m, wall, launches, peak_mem):
    """The numbers every preset phase prints."""
    return {"events": m["events_valid"], "batches": m["batches"],
            "wall_s": wall, "events_per_s": m["events_valid"] / wall,
            "p50_batch_ms": m["p50_batch_ms"],
            "flushes": m["pulls"], "capacity": m["capacity"],
            "state_grown": m["state_grown"], "snap_launches": launches,
            "peak_mem_bytes": peak_mem,
            "commits": commit_record(m["commits"])}


def check_run(name, m, docs, grids, launches, n_res, n_events):
    """Conservation per pair, no overflow, one launch a batch and res."""
    if m["state_overflow"]:
        raise AssertionError(f"{name}: state overflow {m['state_overflow']}")
    if launches != m["batches"] * n_res:
        raise AssertionError(f"{name}: snap kernel launched {launches} "
                             f"times in {m['batches']} batches x {n_res} "
                             f"res")
    if m["events_valid"] != n_events:
        raise AssertionError(f"{name}: {m['events_valid']} events "
                             f"aggregated of {n_events}")
    for grid in grids:
        total = sum(d["count"] for d in pair_docs(docs, grid).values())
        if total != n_events:
            raise AssertionError(f"{name} {grid}: counts not conserved: "
                                 f"docs {total}, events {n_events}")


def snap_at_batch(torch, snap_kernel, cols, res_list, dev):
    """The kernel against its plain version on one batch's points at each
    res (exact), and its time, the plain version's and the bound there."""
    lat, lng = (torch.from_numpy(a).to(dev)
                for a in (cols.lat_rad, cols.lng_rad))
    out = {}
    for res in res_list:
        share, err = compare_cells(torch, snap_kernel, lat, lng, res)
        if share != 1.0 or err != 0:
            raise AssertionError(f"snap kernel vs plain at res {res} on the "
                                 f"preset's first batch: {share} identical, "
                                 f"max abs err {err}")
        ms = time_ms(torch, lambda: snap_kernel.latlng_to_cell_kernel(
            lat, lng, res), inner=20)
        plain_ms = time_ms(torch, lambda: snap_kernel.latlng_to_cell_reference(
            lat, lng, res), inner=1)
        n_pent, steps = pentagon_work(snap_kernel, lat, lng, res)
        bms, by = bound_ms(len(cols) * 16.0, snap_ops(res, len(cols), n_pent,
                                                      steps))
        out[res] = {"points": len(cols), "identical": share,
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by}
    return out


def phase_pipelines(torch, run_pipeline, snap_kernel, ckpt_root, dev):
    """hex_pyramid and multi_window at their presets' widths, each pair
    against a one-pair run of its own."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    out = {"phase": "pipelines", "source": PIPE_SOURCE, "presets": {}}
    snaps = {}
    for name in ("hex_pyramid", "multi_window"):
        cfg = get_pipeline(name).config
        uniq_res = list(dict.fromkeys(cfg.resolutions))
        first = SyntheticSource(**PIPE_SOURCE).poll(cfg.batch_size)
        snaps[name] = snap_at_batch(torch, snap_kernel, first, uniq_res, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        snap_kernel.latlng_to_cell_kernel.launches = 0
        t0 = time.monotonic()
        rt, store = run_pipeline(name, device="cuda",
                                 checkpoint_dir=f"{ckpt_root}/{name}",
                                 source=SyntheticSource(**PIPE_SOURCE),
                                 store=MemoryStore())
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = snap_kernel.latlng_to_cell_kernel.launches
        peak_mem = torch.cuda.max_memory_allocated()
        m = rt.metrics
        grids = {pair: rt.cfg.pair_grid(pair[0], pair[1] // 60)
                 for pair in rt.pairs}
        check_run(name, m, store._tiles, grids.values(), launches,
                  len(uniq_res), PIPE_SOURCE["n_events"])
        if name == "multi_window" and not m["pulls"]["watermark"]:
            raise AssertionError(f"multi_window: no watermark flush "
                                 f"{m['pulls']}")
        docs, cfg_run = store._tiles, rt.cfg
        del rt, store
        torch.cuda.empty_cache()
        one_pair = {}
        for (res, win_s), grid in grids.items():
            one_cfg = dataclasses.replace(
                cfg_run, resolutions=(res,), windows_minutes=(win_s // 60,),
                checkpoint_dir=f"{ckpt_root}/{name}-{grid}")
            one = MemoryStore()
            ort = MicroBatchRuntime(one_cfg, SyntheticSource(**PIPE_SOURCE),
                                    one)
            ort.run()
            mine = pair_docs(docs, grid)
            if mine != one._tiles:
                raise AssertionError(f"{name}: pair {grid}'s docs differ "
                                     f"from its one-pair run's")
            one_pair[grid] = {"tiles": len(mine),
                              "capacity": ort.multi.capacity_per_shard}
            del ort, one
            torch.cuda.empty_cache()
        out["presets"][name] = {
            **run_stats(m, wall, launches, peak_mem),
            "pairs": [list(p) for p in grids], "tiles": len(docs),
            "one_pair_identical": one_pair,
            "snap_first_batch": {str(r): v for r, v in snaps[name].items()}}
        del docs
    emit(out)
    return out, snaps


def phase_opensky(torch, run_pipeline, snap_kernel, ckpt_dir, dev):
    """opensky_global's config (res 7, 2^19 rows, 128 bins), 8 batches."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.source import SyntheticSource

    cfg = get_pipeline("opensky_global").config
    src_args = dict(n_events=OPENSKY_BATCHES * cfg.batch_size,
                    n_vehicles=20_000, events_per_second=2_000,
                    center=(20.0, 0.0), radius_deg=60.0)
    first = SyntheticSource(**src_args).poll(cfg.batch_size)
    snap = snap_at_batch(torch, snap_kernel, first, [cfg.h3_res], dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    snap_kernel.latlng_to_cell_kernel.launches = 0
    t0 = time.monotonic()
    rt, store = run_pipeline("opensky_global", device="cuda",
                             checkpoint_dir=ckpt_dir,
                             source=SyntheticSource(**src_args),
                             store=MemoryStore())
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = snap_kernel.latlng_to_cell_kernel.launches
    m = rt.metrics
    grid = rt.cfg.pair_grid(cfg.h3_res, 5)
    check_run("opensky_global", m, store._tiles, [grid], launches, 1,
              src_args["n_events"])
    if rt.multi.states[0].hist.shape[1] != 128:
        raise AssertionError("opensky_global: the slab has "
                             f"{rt.multi.states[0].hist.shape[1]} bins")
    out = {"phase": "opensky", "source": src_args,
           **run_stats(m, wall, launches, torch.cuda.max_memory_allocated()),
           "hist_bins": cfg.speed_hist_bins, "tiles": len(store._tiles),
           "snap_first_batch": {str(r): v for r, v in snap.items()}}
    del rt, store
    torch.cuda.empty_cache()
    emit(out)
    return out


def kafka_events():
    """(keys, values, event dicts in produce order): 2^20 records in the
    reference schema from a SyntheticSource (4,096 vehicles, 2,048 events/s:
    512 s of event time, inside the 10-minute watermark however the
    partitions interleave, and each vehicle's events 2 s apart, so its
    newest is unique), ISO and epoch timestamps alternating; 3 of every
    8,192 are rejects: malformed JSON, undecodable bytes, a latitude out
    of range.  A reject's dict is one that fails the same validation."""
    from heatmap_tpu_torch.stream.source import SyntheticSource

    cols = SyntheticSource(n_events=KAFKA_EVENTS, **KAFKA_SOURCE).poll(
        KAFKA_EVENTS)
    keys, values, events = [], [], []
    for i in range(KAFKA_EVENTS):
        ts = int(cols.ts_s[i])
        e = {"provider": "mbta", "vehicleId": f"veh-{cols.vehicle_id[i]}",
             "lat": float(cols.lat_deg[i]), "lon": float(cols.lng_deg[i]),
             "speedKmh": float(cols.speed_kmh[i]),
             "ts": ts if i % 2 else time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                                  time.gmtime(ts))}
        kind = i % 8192
        if kind == 100:
            v, e = b'{"provider": "mbta", "lat": ', {"malformed": True}
        elif kind == 200:
            v, e = b"\xff\xfe", {"malformed": True}
        else:
            if kind == 300:
                e["lat"] = 95.0
            v = json.dumps(e).encode()
        keys.append(f"veh-{cols.vehicle_id[i]}".encode())
        values.append(v)
        events.append(e)
    return keys, values, events


def kafka_poll_order(by_part, batch, n_polls):
    """Record indices in the order the port's KafkaSource reads them on its
    native path: each poll one sweep of the partitions from a cursor that
    advances by one a poll, each fetch returning the rest of its partition
    (HEATMAP_FETCH_MAX_BYTES 256 MiB), until the batch is full."""
    pos = {p: 0 for p in by_part}
    order = []
    for k in range(n_polls):
        room = batch
        for j in range(len(by_part)):
            p = (k + j) % len(by_part)
            take = by_part[p][pos[p]:pos[p] + room]
            pos[p] += len(take)
            room -= len(take)
            order += take
            if not room:
                break
    return order


def newest_positions(events):
    """{vehicleId: (ts, lat, lon)} of each vehicle's newest valid event."""
    from heatmap_tpu_torch.stream.events import parse_events

    cols = parse_events(events)
    out = {}
    for i in np.argsort(cols.ts_s, kind="stable"):
        out[cols.vehicles[cols.vehicle_id[i]]] = (
            int(cols.ts_s[i]), float(cols.lat_deg[i]),
            float(cols.lng_deg[i]))
    return out


def store_contents(store):
    """(tiles by _id, positions by _id) a store holds."""
    if hasattr(store, "_b"):                 # MongoStore: read it back
        tiles = {d["_id"]: d for d in store._b.find("tiles", {})}
    else:
        tiles = store._tiles
    return tiles, {d["_id"]: d for d in store.all_positions()}


def docs_match(a, b) -> float:
    """Two stores' docs by ``_id``: the same ids, fields and values, except
    that a float may differ by the relative 1e-15 that the reference allows
    between its C++ tile encoder and its Python doc path
    (tests/test_native_encode.py; the C++ stddev rounds once more or less).
    Returns the largest relative float difference; raises on any other."""
    import math

    if a.keys() != b.keys():
        raise AssertionError(f"doc ids differ: {len(a.keys() ^ b.keys())}")
    worst = 0.0
    for k, x in a.items():
        y = b[k]
        if x.keys() != y.keys():
            raise AssertionError(f"{k}: fields differ")
        for f, u in x.items():
            v = y[f]
            if isinstance(u, float) and isinstance(v, float):
                if not math.isclose(u, v, rel_tol=1e-15, abs_tol=1e-300):
                    raise AssertionError(f"{k} {f}: {u!r} != {v!r}")
                if u != v:
                    worst = max(worst, abs(u - v) / max(abs(u), abs(v)))
            elif u != v:
                raise AssertionError(f"{k} {f}: {u!r} != {v!r}")
    return worst


def kafka_run_stats(m, wall, launches, peak_mem):
    """What the kafka phase prints for each run."""
    return {**run_stats(m, wall, launches, peak_mem),
            "p50_span_ms": {k: m["p50_span_ms"][k] for k in (
                "poll", "fetch", "decode", "feed", "dispatch", "positions",
                "sink")},
            "writer": {k: m[k] for k in (
                "tiles_written", "positions_written", "sink_retries",
                "sink_backpressure_ms")},
            "positions_emitted": m["positions_emitted"],
            "values_decoded": {k: m[f"values_decoded_{k}"]
                               for k in ("native", "python")},
            "kafka_native_fallback_blobs": m["kafka_native_fallback_blobs"]}


def check_native_path(what, m, n_values):
    """Every value went through the native codecs."""
    if (m["values_decoded_native"] != n_values
            or m["values_decoded_python"] or m["kafka_native_fallback_blobs"]
            or m["kafka_fetch_errors"] or m["kafka_offset_resets"]):
        raise AssertionError(f"kafka {what}: not all {n_values} values "
                             f"decoded natively, or transport errors: {m}")


def phase_kafka(torch, run_pipeline, snap_kernel, ckpt_root, dev):
    """mbta_default through the port's own Kafka ingress on a mock broker,
    on the native codecs, into three stores: against MemorySource, killed
    and resumed from its offsets, and once at the default fetch size."""
    # one fetch returns the rest of a partition, so each poll fills its
    # batch in one sweep and the batches cut where kafka_poll_order says,
    # where MemorySource is made to cut them
    os.environ["HEATMAP_FETCH_MAX_BYTES"] = str(256 << 20)
    try:
        return _kafka_runs(torch, run_pipeline, snap_kernel, ckpt_root, dev)
    finally:
        del os.environ["HEATMAP_FETCH_MAX_BYTES"]


def _kafka_runs(torch, run_pipeline, snap_kernel, ckpt_root, dev):
    from heatmap_tpu_torch.kafka import KafkaClient, Record
    from heatmap_tpu_torch.kafka.client import partition_for_key
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink import JsonlStore, make_store
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.sink.mongo import MongoStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import KafkaSource, MemorySource
    from heatmap_tpu_torch.testing.mock_kafka import MockKafkaBroker
    from heatmap_tpu_torch.testing.mock_mongod import MockMongod

    name = "mbta_default"
    p = get_pipeline(name)
    batch = p.config.batch_size
    n_batches = KAFKA_EVENTS // batch
    t0 = time.monotonic()
    keys, values, events = kafka_events()
    n_bad = sum(1 for e in events if "malformed" in e or e["lat"] > 90)
    n_valid = len(values) - n_bad
    out = {"phase": "kafka", "records": len(values), "rejects": n_bad,
           "partitions": 3, "batches": n_batches,
           "generate_s": time.monotonic() - t0,
           "value_bytes": sum(len(v) for v in values)}
    with MockKafkaBroker(num_partitions=3) as bootstrap, \
            MockMongod() as mongo_uri:
        over = dict(kafka_bootstrap=bootstrap)
        cfg = dataclasses.replace(p.config, **over)

        def source():
            src = p.make_source(cfg)
            if not isinstance(src, KafkaSource) or src._dec is None:
                raise AssertionError(f"{name}: not a native KafkaSource: "
                                     f"{type(src).__name__}")
            return src

        # every source starts at LATEST, so all are built before producing
        srcs = {k: source() for k in ("first", "memory", "jsonl", "mongo",
                                      "killed", "default_fetch")}
        t0 = time.monotonic()
        client = KafkaClient(bootstrap)
        by_part = {0: [], 1: [], 2: []}
        for i, k in enumerate(keys):
            by_part[partition_for_key(k, 3)].append(i)
        for part, idx in by_part.items():
            for j in range(0, len(idx), 4096):
                client.produce(p.config.kafka_topic, part, [
                    Record(0, 1_700_000_000_000 + i, keys[i], values[i])
                    for i in idx[j:j + 4096]])
        client.close()
        out["produce_s"] = time.monotonic() - t0
        order = kafka_poll_order(by_part, batch, n_batches)
        if sorted(order) != list(range(len(values))):
            raise AssertionError("kafka_poll_order does not cover the topic")

        # the snap kernel against its plain version on the first Kafka
        # batch's points (exact; these launches are not counted), and the
        # native codecs' times on that batch
        first = srcs["first"].poll(batch)
        srcs["first"].close()
        lat, lng = (torch.from_numpy(a).to(dev)
                    for a in (first.lat_rad, first.lng_rad))
        share, err = compare_cells(torch, snap_kernel, lat, lng,
                                   cfg.h3_res)
        if share != 1.0 or err != 0:
            raise AssertionError(f"snap kernel vs plain on the first Kafka "
                                 f"batch: {share} identical, max abs err "
                                 f"{err}")
        out["snap_first_kafka_batch"] = {"points": len(first),
                                         "res": cfg.h3_res,
                                         "identical": share,
                                         "max_abs_err": err}
        del lat, lng

        # the same stream into the three stores HEATMAP_STORE selects
        runs, contents, docs_bytes = {}, {}, {}
        for kind in ("memory", "jsonl", "mongo"):
            ckpt = f"{ckpt_root}/kafka-{kind}"
            # HEATMAP_STORE=<kind> (MONGO_URI at the mock server), as the
            # entry point builds it
            store = make_store(dataclasses.replace(
                cfg, store=kind, mongo_uri=mongo_uri, checkpoint_dir=ckpt))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            snap_kernel.latlng_to_cell_kernel.launches = 0
            t0 = time.monotonic()
            rt, store = run_pipeline(name, max_batches=n_batches,
                                     device="cuda", checkpoint_dir=ckpt,
                                     checkpoint_every=4,
                                     source=srcs[kind], store=store, **over)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = snap_kernel.latlng_to_cell_kernel.launches
            m = rt.metrics
            grid = rt.cfg.pair_grid(rt.cfg.h3_res, rt.cfg.tile_minutes)
            if type(store).__name__ != {"memory": "MemoryStore",
                                        "jsonl": "JsonlStore",
                                        "mongo": "MongoStore"}[kind]:
                raise AssertionError(f"kafka {kind}: {type(store)}")
            tiles, positions = contents[kind] = store_contents(store)
            check_run(f"{name} {kind}", m, tiles, [grid], launches, 1,
                      n_valid)
            check_native_path(kind, m, len(values))
            if m["events_invalid"] != n_bad or m["batches"] != n_batches:
                raise AssertionError(f"kafka {kind}: {m['batches']} batches, "
                                     f"{m['events_invalid']} dropped of "
                                     f"{n_bad} rejects")
            if kind == "memory":
                # one batch's emitted rows, for the encoders' timings
                tile_body = rt.last_flush[0][0][0][1:]
            if kind == "mongo":
                from heatmap_tpu_torch.sink import bson

                docs_bytes[kind] = sum(len(bson.encode(d)) for coll in (
                    tiles, positions) for d in coll.values())
            store.close()
            if kind == "jsonl":
                path = f"{ckpt}/store.jsonl"
                docs_bytes[kind] = os.path.getsize(path)
                again = JsonlStore(ckpt)      # the compacted file reloads
                if store_contents(again) != (tiles, positions):
                    raise AssertionError("kafka: the JSONL store reloads "
                                         "other docs")
                again.close()
            runs[kind] = {**kafka_run_stats(
                m, wall, launches, torch.cuda.max_memory_allocated()),
                "store": type(store).__name__, "tiles": len(tiles),
                "positions": len(positions),
                "docs_bytes": docs_bytes.get(kind)}
            emit({"phase": "kafka_run", "store": kind, **runs[kind]})
            del rt, store
        # the three stores hold the same docs: JSONL's (the Python doc
        # path's, through JSON) exactly, Mongo's (the C++ encoders',
        # through BSON) under docs_match's bar
        tiles, positions = contents["memory"]
        if contents["jsonl"] != (tiles, positions):
            raise AssertionError("kafka: the JSONL store's docs differ from "
                                 "the memory store's")
        mongo_rel_err = docs_match(contents["mongo"][0], tiles)
        if contents["mongo"][1] != positions:
            raise AssertionError("kafka: the Mongo store's positions differ "
                                 "from the memory store's")
        newest = newest_positions(events)
        got = {d["vehicleId"]: (int(d["ts"].timestamp()),
                                *(float(c) for c in reversed(
                                    d["loc"]["coordinates"])))
               for d in positions.values()}
        if got != newest:
            raise AssertionError("kafka: positions_latest is not the newest "
                                 "event of each vehicle")

        # the same events through MemorySource, in the order the source's
        # sweeps read them
        mrt, mstore = run_pipeline(
            name, device="cuda", checkpoint_dir=f"{ckpt_root}/memory",
            checkpoint_every=4, source=MemorySource(
                [events[i] for i in order]), max_batches=n_batches,
            store=MemoryStore(), **over)
        if store_contents(mstore) != (tiles, positions):
            raise AssertionError("kafka: docs differ from the MemorySource "
                                 "run's")
        del mrt, mstore

        # killed after the commit at epoch 3 and one batch more (a commit
        # at a multiple of the 3 partitions: the resumed source's sweep
        # starts at partition 0, as the uninterrupted 4th poll did), then
        # resumed from the committed offsets into the same Mongo database
        ckpt = f"{ckpt_root}/kafka-killed"
        killed_cfg = dataclasses.replace(cfg, checkpoint_dir=ckpt)
        kstore = MongoStore(mongo_uri, "resume")
        krt = MicroBatchRuntime(killed_cfg, srcs["killed"], kstore,
                                checkpoint_every=3)
        while krt.epoch < 4:
            if not krt.step_once():
                raise AssertionError("kafka: the killed run read nothing")
        krt._ckpt_join()
        krt.writer.drain()               # what it handed over had landed
        committed = krt.ckpt.load_meta()["offset"]
        del krt
        srcs["killed"].close()
        kstore.close()
        t0 = time.monotonic()
        rstore = MongoStore(mongo_uri, "resume")
        rrt = MicroBatchRuntime(killed_cfg, source(), rstore,
                                checkpoint_every=3)
        seeked = rrt.source.offset()
        if rrt.epoch != 3 or seeked != {int(k): v
                                        for k, v in committed.items()}:
            raise AssertionError(f"kafka: resumed at epoch {rrt.epoch}, "
                                 f"{seeked}, committed {committed}")
        rrt.run(max_batches=n_batches - 3)
        recover_s = time.monotonic() - t0
        if rrt.epoch != n_batches or store_contents(rstore) != contents[
                "mongo"]:
            raise AssertionError("kafka: the resumed run's docs differ from "
                                 "the uninterrupted run's")
        rstore.close()
        del rrt

        # uncompared: the default 4 MiB fetch (both packages' source.py),
        # partial batches, until the topic is read
        src = srcs["default_fetch"]
        src.fetch_max_bytes = 4 << 20
        drt = MicroBatchRuntime(dataclasses.replace(
            cfg, checkpoint_dir=f"{ckpt_root}/kafka-4mib"), src,
            MemoryStore(), checkpoint_every=4)
        t0 = time.monotonic()
        for _ in range(4 * n_batches):
            if sum(src.offset().values()) >= len(values):
                break
            drt.step_once()
        drt.close()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        m = drt.metrics
        check_native_path("4 MiB", m, len(values))
        if m["events_valid"] != n_valid:
            raise AssertionError(f"kafka 4 MiB: {m['events_valid']} of "
                                 f"{n_valid} events folded")
        default_fetch = {"fetch_max_bytes": 4 << 20, "wall_s": wall,
                         "events_per_s": m["events_valid"] / wall,
                         "batches": m["batches"],
                         "p50_batch_ms": m["p50_batch_ms"],
                         "p50_span_ms": {k: m["p50_span_ms"][k] for k in (
                             "poll", "fetch", "decode")}}
        del drt
    torch.cuda.empty_cache()
    codecs = native_codec_times(keys, values, order[:batch], first,
                                tile_body)
    # each run's full line is printed above (phase kafka_run)
    out.update(runs={k: {f: r[f] for f in ("store", "events_per_s", "wall_s",
                                           "p50_batch_ms", "p50_span_ms")}
                     for k, r in runs.items()},
               source="KafkaSource", stores_identical=True,
               mongo_tile_float_max_rel_err=mongo_rel_err,
               positions_newest=len(newest),
               docs_equal_memory_source=True, committed_offsets=committed,
               resumed_docs_equal=True, resume_s=recover_s,
               snap_launches=runs["memory"]["snap_launches"],
               default_fetch=default_fetch, native_codecs=codecs)
    emit(out)
    return out


def native_codec_times(keys, values, idx, cols, body):
    """Each native codec's host time for one 2^17 batch (median of 5, on
    the host clock), beside its plain Python version where one exists:
    CRC32C over the batch's record batches, kafka_decode_values of them,
    NativeDecoder.decode of the joined values, enc_tile_ops of a batch's
    emitted tile rows (``body``) and enc_position_ops of the batch's
    changed vehicles."""
    import types

    from heatmap_tpu_torch import native
    from heatmap_tpu_torch.kafka import records as rec
    from heatmap_tpu_torch.sink.base import TilePackMeta
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import _decode_json_values

    def med(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    blob = b"".join(rec.encode_batch(
        [rec.Record(0, 0, keys[i], values[i]) for i in idx[j:j + 4096]],
        base_offset=j) for j in range(0, len(idx), 4096))
    joined = b"\n".join(values[i] for i in idx) + b"\n"
    dec = native.NativeDecoder()
    meta = TilePackMeta("bos", "h3r8", 300, 45, 0, True)
    state = types.SimpleNamespace(_pos_ts=np.full(1024, -(2**62), np.int64),
                                  _pos_win=None)
    prows = MicroBatchRuntime._fold_positions(state, cols)
    tiles, poss = native.NativeTileOps(), native.NativePositionOps()
    return {
        "batch_records": len(idx), "record_bytes": len(blob),
        "tile_rows": int(np.count_nonzero(
            (body[:, 8] != 0) & (body[:, 3].view(np.int32) > 0))),
        "position_rows": len(prows.ts_ms),
        "crc32c_ms": med(lambda: native.crc32c_native(blob)),
        "crc32c_plain_ms": med(lambda: rec.crc32c_plain(blob), reps=1),
        "kafka_decode_values_ms": med(
            lambda: native.kafka_decode_values(blob, 0)),
        "native_decode_ms": med(lambda: dec.decode(joined, final=True)),
        "python_decode_ms": med(lambda: _decode_json_values(
            [values[i] for i in idx], {}, {}), reps=1),
        "enc_tile_ops_ms": med(lambda: tiles.encode(
            body, meta.city, meta.grid, meta.window_s, meta.ttl_minutes)),
        "enc_position_ops_ms": med(lambda: poss.encode(prows)),
    }


# the infer phase: synthetic_backfill's preset with the Kalman reducer
INFER_BATCHES = 16
INFER_TABLE = (8, 1 << 17)     # (K, M) of the full-table round set
# the filter's constants, as infer/engine.py passes them
KALMAN_KW = dict(q=0.5, r_m=25.0, gate=13.816, p0_pos=625.0, p0_vel=100.0)
# f32 operations of one (round, entity) of the rounds scan, each add,
# subtract, multiply, divide and compare counted once and the hypot as one
# (selects not counted; a lower bound): the clamp 1, dt2 and dt3 3, the
# predicted covariance 42, the predicted position 4, the innovation 2,
# S and its determinant 6, its inverse 4, the NIS 9, the gain 24, the
# updated state 16, B = (I - KH) Pp 64, the Joseph covariance 90, the gate
# 1 and the speed 1
ROUND_OPS = 267


def rounds_work(valid) -> tuple[float, float]:
    """(bytes, operations) the rounds scan needs on these inputs: per
    (round, entity) z 8, dt 4, valid 1 and reseed 1 in and nis 4, tele 1,
    spd 4 and inn 8 out; per entity x and P in and out, 160 B; ROUND_OPS
    for each valid (round, entity) (an invalid lane needs no filter
    work)."""
    k, m = valid.shape
    return 31.0 * k * m + 160.0 * m, float(ROUND_OPS) * int(valid.sum())


def rounds_check(torch, kalman, args, dev):
    """The kernel against its plain version on the card on one round set
    (numpy args of filter_rounds): identical share and max abs difference
    per output, the kernel's time, the plain version's, the bound, and
    filter_rounds' host time with its copies on the engine's stream.
    Bar: exact on every output (both round op by op on the card)."""
    x, P, z, dt, valid, reseed = args
    consts = kalman.filter_consts(**KALMAN_KW)
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    got = kalman.kalman_rounds(*ins, consts)
    ref = kalman.filter_rounds_reference(*ins, consts)
    torch.cuda.synchronize()
    fields = {}
    for name, a, b in zip(("x", "P", "nis", "tele", "spd", "inn"), got, ref):
        same = float((a == b).float().mean())
        err = float((a.double() - b.double()).abs().max())
        fields[name] = {"identical": same, "max_abs_err": err}
        if same != 1.0:
            raise AssertionError(f"kalman_rounds vs plain, {name} at K, M = "
                                 f"{valid.shape}: {same} identical, max abs "
                                 f"err {err}")
    ms = time_ms(torch, lambda: kalman.kalman_rounds(*ins, consts), inner=20)
    plain_ms = time_ms(
        torch, lambda: kalman.filter_rounds_reference(*ins, consts), inner=1)
    staging = kalman.RoundsStaging(dev)
    kalman.filter_rounds(*args, **KALMAN_KW, device=dev, staging=staging)
    host = []
    for _ in range(11):
        t0 = time.perf_counter()
        kalman.filter_rounds(*args, **KALMAN_KW, device=dev, staging=staging)
        host.append((time.perf_counter() - t0) * 1e3)
    n_bytes, n_ops = rounds_work(valid)
    bms, by = bound_ms(n_bytes, n_ops)
    return {"k": int(valid.shape[0]), "m": int(valid.shape[1]),
            "valid_lanes": int(valid.sum()),
            "reseed_lanes": int((valid & reseed).sum()),
            "teleport_lanes": int(got[3].sum()),
            "dt_le0_lanes": int((valid & (dt <= 0)).sum()),
            "fields": fields,
            "max_abs_err": max(f["max_abs_err"] for f in fields.values()),
            "ms": ms, "plain_ms": plain_ms, "bytes": n_bytes, "ops": n_ops,
            "bound_ms": bms, "bound_by": by,
            "filter_rounds_host_ms": float(np.median(host))}


def table_round_set(k, m):
    """A full table's round set from the seed: warm states, a
    constant-velocity walk with GPS noise, 1% teleports, 10% empty lanes,
    1% handoff re-seeds (half of the teleport lanes among them, where the
    re-seed takes precedence over the gate), and 1% each of dt = 0 and
    dt < 0 (the kernel's clamp), so every branch of the kernel is held
    against the plain version."""
    rng = np.random.default_rng(SEED)
    x = rng.normal(0, 300, (m, 4)).astype(np.float32)
    P = np.zeros((m, 4, 4), np.float32)
    P[:, [0, 1, 2, 3], [0, 1, 2, 3]] = rng.uniform(5, 50, (m, 4))
    t = np.cumsum(rng.uniform(1, 10, (k, m)), axis=0)
    z = (x[None, :, :2] + x[None, :, 2:] * t[..., None]
         + rng.normal(0, 10, (k, m, 2))).astype(np.float32)
    jump = rng.random((k, m)) < 0.01
    z[jump] += np.float32(50_000.0)
    dt = np.diff(t, axis=0, prepend=0.0).astype(np.float32)
    dt[rng.random((k, m)) < 0.01] = np.float32(0.0)
    back = rng.random((k, m)) < 0.01
    dt[back] = -dt[back]
    valid = rng.random((k, m)) < 0.9
    reseed = (rng.random((k, m)) < 0.01) | (jump & (rng.random((k, m)) < 0.5))
    return x, P, z, dt, valid, reseed


def infer_source():
    from heatmap_tpu_torch.models.pipelines import get_pipeline

    p = get_pipeline("synthetic_backfill")
    src = p.make_source(p.config)
    src.n_events = INFER_BATCHES * p.config.batch_size
    return p, src


def table_agreement(a, b) -> dict:
    """Two entity tables by entity name: the share of identical x and P
    words, the largest difference, and the integer lanes equal; raises
    beyond the CPU tests' bar (rtol 1e-5, atol 1e-3)."""
    na = {a.names[int(s)]: int(s) for s in np.nonzero(a.vid >= 0)[0]}
    nb = {b.names[int(s)]: int(s) for s in np.nonzero(b.vid >= 0)[0]}
    if na.keys() != nb.keys():
        raise AssertionError(f"entity sets differ by "
                             f"{len(na.keys() ^ nb.keys())}")
    sa = np.asarray([na[n] for n in sorted(na)])
    sb = np.asarray([nb[n] for n in sorted(na)])
    out = {"entities": len(sa)}
    for col in ("x", "P", "nis_ewma"):
        u, v = getattr(a, col)[sa], getattr(b, col)[sb]
        np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-3, err_msg=col)
        out[col] = {"identical": float((u == v).mean()),
                    "max_abs_err": float(np.abs(u.astype(np.float64)
                                                - v).max())}
    for col in ("last_ts", "n_upd", "moving", "stop_ts", "stop_alerted",
                "dev_alerted"):
        np.testing.assert_array_equal(getattr(a, col)[sa],
                                      getattr(b, col)[sb], err_msg=col)
    return out


def phase_infer(torch, run_pipeline, snap_kernel, ckpt_root, dev):
    """synthetic_backfill's preset with HEATMAP_REDUCERS=count,kalman: the
    rounds kernel against its plain version on the main path's round sets
    and on a full table, then the path itself for INFER_BATCHES batches
    (launches, spans, anomalies, velocity docs), its count docs against a
    kalman-off run's, and its entity table against the same batches folded
    by the plain version on the CPU."""
    from heatmap_tpu_torch.infer import engine as tengine
    from heatmap_tpu_torch.infer import kalman
    from heatmap_tpu_torch.sink.memory import MemoryStore

    p, src = infer_source()
    cfg = p.config
    # the main path's round sets: the rounds of its first two batches, as
    # the engine builds them, captured from a fold on the CPU
    captured = []
    real = tengine.filter_rounds

    def capture(*args, **kw):
        captured.append(args)
        return real(*args, **kw)

    tengine.filter_rounds = capture
    try:
        cpu_engine = tengine.InferenceEngine(
            dataclasses.replace(cfg, reducers=("count", "kalman")),
            device="cpu")
        cpu_src = infer_source()[1]
        cpu_batches = 0
        while len(cols := cpu_src.poll(cfg.batch_size)):
            cpu_engine.fold_batch(cols)
            cpu_engine.drain_anomalies()
            cpu_batches += 1
    finally:
        tengine.filter_rounds = real
    sets = {"backfill_batch1": rounds_check(torch, kalman, captured[0], dev),
            "backfill_batch2": rounds_check(torch, kalman, captured[1], dev),
            "full_table": rounds_check(torch, kalman,
                                       table_round_set(*INFER_TABLE), dev)}
    lanes = {k: sets["full_table"][k]
             for k in ("reseed_lanes", "teleport_lanes", "dt_le0_lanes")}
    if not all(lanes.values()):
        raise AssertionError(f"the full-table round set misses a branch of "
                             f"the kernel: {lanes}")
    # the path, counts set to 0 just before it
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kalman.kalman_rounds.launches = 0
    snap_kernel.latlng_to_cell_kernel.launches = 0
    t0 = time.monotonic()
    rt, store = run_pipeline("synthetic_backfill", device="cuda",
                             checkpoint_dir=f"{ckpt_root}/kalman",
                             source=src, store=MemoryStore(),
                             reducers=("count", "kalman"))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kalman.kalman_rounds.launches
    snap_launches = snap_kernel.latlng_to_cell_kernel.launches
    peak_mem = torch.cuda.max_memory_allocated()
    m = rt.metrics
    n_events = INFER_BATCHES * cfg.batch_size
    if launches != m["batches"] or m["batches"] != INFER_BATCHES:
        raise AssertionError(f"kalman_rounds launched {launches} times in "
                             f"{m['batches']} batches")
    check_run("synthetic_backfill+kalman", m, store._tiles,
              [cfg.pair_grid(cfg.h3_res, cfg.tile_minutes)], snap_launches,
              1, n_events)
    if m["infer_events_folded"] != n_events:
        raise AssertionError(f"the engine folded {m['infer_events_folded']} "
                             f"of {n_events} events")
    docs = store._tiles
    vel_docs = [d for d in docs.values() if "vxKmh" in d]
    if not vel_docs or not all(np.isfinite([d["vxKmh"], d["vyKmh"]]).all()
                               for d in vel_docs):
        raise AssertionError(f"{len(vel_docs)} docs carry velocity, or a "
                             f"velocity is not finite")
    block = rt.infer.member_block()
    agree = table_agreement(rt.infer.table, cpu_engine.table)
    cpu_block = cpu_engine.member_block()
    for b in (block, cpu_block):
        b.pop("last_fold_ms")
    if block != cpu_block or cpu_batches != INFER_BATCHES:
        raise AssertionError(f"engine on the card {block} vs on the CPU "
                             f"{cpu_block} ({cpu_batches} CPU batches)")
    spans = {k: m["p50_span_ms"][k] for k in ("poll", "feed", "infer",
                                              "dispatch", "positions",
                                              "sink")}
    infer_ms = list(rt.span_ms["infer"])
    del rt
    torch.cuda.empty_cache()
    # the same batches with kalman off: the count docs are the same
    off_rt, off_store = run_pipeline("synthetic_backfill", device="cuda",
                                     checkpoint_dir=f"{ckpt_root}/count",
                                     source=infer_source()[1],
                                     store=MemoryStore())
    strip = {k: {f: v for f, v in d.items() if f not in ("vxKmh", "vyKmh")}
             for k, d in docs.items()}
    if strip != off_store._tiles:
        raise AssertionError("count docs with kalman on differ from the "
                             "kalman-off run's")
    off_wall_p50 = off_rt.metrics["p50_batch_ms"]
    del off_rt, off_store
    torch.cuda.empty_cache()
    out = {"phase": "infer", "batches": m["batches"], "events": n_events,
           "vehicles": src.n_vehicles, "wall_s": wall,
           "events_per_s": n_events / wall,
           "p50_batch_ms": m["p50_batch_ms"],
           "p50_batch_ms_kalman_off": off_wall_p50,
           "p50_span_ms": spans, "infer_span_ms": infer_ms,
           "kalman_launches": launches, "snap_launches": snap_launches,
           "entities": block["entities"], "anomalies": block["anomalies"],
           "reseed_teleport": block["reseed_teleport"],
           "tiles": len(docs), "tiles_with_velocity": len(vel_docs),
           "count_docs_equal_kalman_off": True,
           "table_vs_cpu_plain": agree, "peak_mem_bytes": peak_mem,
           "round_sets": sets}
    emit(out)
    return out


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
    # each run commits to a directory of its own, removed at the end
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke-ckpt-")
    try:
        fold, fold_docs, fold_positions = phase_fold(
            torch, run_pipeline, snap_kernel, f"{ckpt_root}/fold")
        resume = phase_resume(torch, snap_kernel, fold_docs, fold_positions,
                              f"{ckpt_root}/resume")
        del fold_docs, fold_positions
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    phase_determinism(torch)
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke-ckpt-")
    try:
        pipes, pipe_snaps = phase_pipelines(torch, run_pipeline, snap_kernel,
                                            ckpt_root, dev)
        opensky = phase_opensky(torch, run_pipeline, snap_kernel,
                                f"{ckpt_root}/opensky", dev)
        kafka = phase_kafka(torch, run_pipeline, snap_kernel, ckpt_root, dev)
        infer = phase_infer(torch, run_pipeline, snap_kernel, ckpt_root, dev)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    # the rounds kernel's numbers at the main path's shape: the round set
    # of synthetic_backfill's second batch (warm states, every entity)
    main_rounds = infer["round_sets"]["backfill_batch2"]
    by_res = {}
    for snaps in pipe_snaps.values():
        for res, v in snaps.items():
            by_res.setdefault(str(res), {k: v[k] for k in (
                "points", "ms", "plain_ms", "bound_ms", "bound_by")})

    emit({"kernels": [{
        "name": "snap_cell",
        "route": "cuda",
        "source": "heatmap_tpu_torch/hexgrid/csrc/snap_cell.cu",
        "replaces": "heatmap_tpu/hexgrid/pallas_kernel.py:66",
        "launches": fold["snap_launches"],
        "launches_resume_phase": resume["snap_launches"],
        "launches_pipelines_phase": {
            k: v["snap_launches"] for k, v in pipes["presets"].items()},
        "launches_opensky_phase": opensky["snap_launches"],
        "launches_kafka_phase": kafka["snap_launches"],
        "launches_infer_phase": infer["snap_launches"],
        "max_abs_err": main_err,
        "identical_share": main_share,
        "ms": snap["ms"],
        "plain_ms": snap["plain_ms"],
        "bound_ms": snap["bound_ms"],
        "bound_by": snap["bound_by"],
        "library_ms": None,
        "by_res_at_preset_batch": by_res,
    }, {
        "name": "kalman_rounds",
        "route": "cuda",
        "source": "heatmap_tpu_torch/infer/csrc/kalman_rounds.cu",
        "replaces": "heatmap_tpu/infer/kalman.py:72",
        "launches": infer["kalman_launches"],
        "max_abs_err": main_rounds["max_abs_err"],
        "identical_share": min(f["identical"]
                               for f in main_rounds["fields"].values()),
        "ms": main_rounds["ms"],
        "plain_ms": main_rounds["plain_ms"],
        "bound_ms": main_rounds["bound_ms"],
        "bound_by": main_rounds["bound_by"],
        "library_ms": None,
        "k_m": [main_rounds["k"], main_rounds["m"]],
        "full_table": {k: infer["round_sets"]["full_table"][k] for k in (
            "k", "m", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")},
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
