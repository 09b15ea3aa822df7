#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (heatmap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py           # every phase below
    python3 chip_smoke.py obs 3     # the build, then the obs phase's runs
                                    # in 3 pairs (off, on / on, off / ...)
    python3 chip_smoke.py quality 3 # the same for the quality phase's runs

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
10. formats     mbta_default (res 8 x 5 min, batches of 2^17, memory
                store) in every event format the reference takes, each
                topic published by the port's KafkaPublisher into the
                port's MockKafkaBroker (3 partitions) from the kafka
                phase's 2^20 events: json (as there), binary (its rejects a
                bad magic byte, a truncated value and lat 95, at the same 3
                in 8,192 positions) and columnar (publish_columns, 16,384
                events a value: 64 values round-robin; its rejects rows
                with lat 95 or a timestamp out of range).  Each format runs
                in process
                and through the feeder process (HEATMAP_FEEDER=proc), and
                json once more with HEATMAP_H3_IMPL=native.  Every run:
                8 batches, the rejects dropped and no more, every value
                decoded natively, one snap launch a batch (none on the
                native route), its tile docs the json in-process run's
                (ints exact; floats under docs_match's bar for json and
                binary, which cut the same batches; a columnar poll takes
                values until its valid rows fill the batch and the runtime
                carries the rest, so its batches cut elsewhere and its
                floats are held to the CPU tests' bars, docs_close, and the
                feeder's columnar run to the in-process one under
                docs_match's) and its positions_latest the same, the newest
                event of each vehicle.  The native run's keys equal NativeH3Snap's on its
                first batch bit for bit and the kernel's on >= 99.8% of its
                events; its commit, resumed with HEATMAP_H3_IMPL unset,
                keeps the host snap.  Then the host time of decode_binary
                and colfmt decode_batch on one 2^17 batch beside
                NativeDecoder.decode.
11. infer       synthetic_backfill's preset (2^19 batches, 20,000
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
12. serve       the read path: synthetic_backfill at its preset widths
                (res 9, batches of 2^19, 20,000 vehicles, 10M events; its
                stream starts in the window before the current one, so
                that no window is stale when the view serves it), in
                turns with HEATMAP_QUERY_VIEW off, on, and on with the
                port's server on an ephemeral port during the run
                (start_background) and a client thread following
                /api/tiles/delta as the UI does: off, on, served, served
                with HEATMAP_DELTA_LOG=2^16, on, off.  Each run: one snap
                launch a batch, every event aggregated; events/s and p50
                batch printed for each.  A flush upserts more cells than
                the default 4,096-entry delta log holds, so the first
                served run's follower gets full bodies only; in the
                second, delta-mode bodies must carry cells.
                Each served run: the followed
                deltas replayed equal /api/tiles/latest, whose counts sum
                to the events; a serve-only app over the same store (its
                view rebuilt by StoreViewRefresher) serves the same
                features; ?fmt=bin decodes to the JSON body; each ?res=
                rollup's counts sum to the base counts; the ETag answers
                304; /api/positions/latest holds every vehicle.  Printed:
                the view's apply time per flush (p50, total), and p50 ms
                and bytes of /api/tiles/latest (JSON and binary, cached
                after the first render), /api/tiles/delta from 0 at the
                full view size, /api/positions/latest.
13. repl        the serve tier's second slice: synthetic_backfill at the
                serve phase's widths (delta log 2^16) with
                HEATMAP_REPL_DIR and HEATMAP_HIST_DIR (the writer
                publishes the view's feed, retires its segments into the
                history log and compacts them on its compactor thread),
                the writer's app serving /api/repl/* and /api/hist/*, a
                replica fleet (``python -m heatmap_tpu_torch.serve
                --workers 2``, HEATMAP_SERVE_CORE=epoll,
                HEATMAP_REPL_FEED=http://<writer>), a thread-core replica
                beside it, and a client following the fleet's
                /api/tiles/delta every 100 ms.  Checks: one snap launch a
                batch; after the writer closes and both workers reach its
                seq, the fleet's /api/tiles/latest (JSON and ?fmt=bin) is
                byte-equal to the writer's, ETag nonce out; the replayed
                deltas equal it, and some delta bodies carried cells;
                /api/tiles/range over the run's span sums to the events
                on the writer and on the fleet; /api/tiles/at?seq=<final>
                holds /latest's cells; /api/tiles/diff answers; the chunks
                decode to the view's cells and counts; both workers
                answered; the thread-core replica's bodies equal the
                fleet's.  Printed: events/s and p50 batch beside the
                serve phase's view-on runs, the replica lag (seqs and seconds, p50 and
                max), the feed's bytes, rotations and snapshot bytes, the
                compactor's seconds a segment and chunk bytes, and the
                range, at and diff times.
14. obs         the run's own introspection (ROADMAP A6a): synthetic_backfill
                at the serve phase's widths and t0, the writer's app
                attached, twice back to back: the knobs off, then on (on:
                HEATMAP_TRACE_JSONL, HEATMAP_FLIGHTREC_DIR with
                HEATMAP_FLIGHTREC_ALWAYS=1, HEATMAP_PROFILE_DIR over
                batches 4-7, a 1 s SLO watchdog, /debug/stacks read once).
                Checks: one snap launch a batch; one trace record a batch
                with the reference's keys in the ring, at /trace/recent
                and in the JSONL; a closed lineage record a batch crossing
                every stage, and an event-age p50; the profiler window's
                one Chrome-trace file with exactly 4 snap_cell kernel
                events and the 4 batches annotated;
                heatmap_device_hbm_watermark_bytes equal to
                torch.cuda.max_memory_allocated(); the flight record
                written at close with the reference's keys and at most one
                watchdog dump (with its /healthz verdict); the two
                runs' docs equal.  Printed: events/s and p50
                batch of each run (and outside the profiler window), the
                reference spans' p50s from /metrics.json, the summed
                compile count, /healthz's checks.
15. quality     the telemetry time machine and the inference quality
                observatory (ROADMAP A6b, A5): synthetic_backfill at the
                serve phase's widths and t0 with HEATMAP_REDUCERS=
                count,kalman, 16 batches of 2^19, the writer's app
                attached and a client asking /api/tiles/forecast at h=1,
                2 and 4 every ~200 ms, twice back to back: the knobs off,
                then on (HEATMAP_TSDB=1 with its directory, a 1 s scrape
                and a 3 s flush, HEATMAP_QUALITY=1 with
                HEATMAP_QUALITY_MATURE_S=0, HEATMAP_SLO_BUDGET_WINDOW_S=
                7200 so that the fast burn rule's windows are 2 s and
                10 s, and the flight recorder).  Checks: one snap and one
                kalman launch a batch; the two runs' tile and position
                docs equal (observe-only); registered == scored +
                expired_unscorable + pending with scored >= 1; blocks
                under the member's directory read back by TsdbReader;
                /debug/timeline holding the healthz transition to
                degraded and a fired freshness_p50 alert.  Printed:
                events/s and p50 batch of each run and their ratio, the
                scrape's seconds (p50, max), the series and points held,
                the blocks' bytes, the scorecards and the latest skill
                per (grid, h), the NIS coverage, the timeline's entries
                by kind and the flight record's slo-burn reason.

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


def docs_close(a, b, rel=1e-4, deg=1e-5) -> dict:
    """Two stores' docs by ``_id`` where the batches were cut elsewhere:
    the same ids and fields, every integer, string and time exact, speed
    floats within ``rel`` relative (or 1e-4 km/h) and centroid coordinates
    within ``deg`` degrees.  A batch's float32 sums round differently when
    its rows differ, and a stddev's subtraction of two such sums magnifies
    that; the exact float check of such a run is a fold of the same rows cut
    the same way (replay_polls).  Returns the largest relative difference
    of each float field; raises on any other difference."""
    import math

    if a.keys() != b.keys():
        raise AssertionError(f"doc ids differ: {len(a.keys() ^ b.keys())}")
    worst: dict = {}
    for k, x in a.items():
        y = b[k]
        if x.keys() != y.keys():
            raise AssertionError(f"{k}: fields differ")
        for f, u in x.items():
            v = y[f]
            if f == "centroid":
                if u["type"] != v["type"] or any(
                        abs(p - q) > deg for p, q in zip(
                            u["coordinates"], v["coordinates"])):
                    raise AssertionError(f"{k} centroid: {u} != {v}")
            elif isinstance(u, float) and isinstance(v, float):
                if not math.isclose(u, v, rel_tol=rel, abs_tol=1e-4):
                    raise AssertionError(f"{k} {f}: {u!r} != {v!r}")
                if u != v:
                    worst[f] = max(worst.get(f, 0.0),
                                   abs(u - v) / max(abs(u), abs(v)))
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
    from heatmap_tpu_torch.stream.source import _decode_raw_values

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
        "python_decode_ms": med(lambda: _decode_raw_values(None,
            [values[i] for i in idx], {}, {}), reps=1),
        "enc_tile_ops_ms": med(lambda: tiles.encode(
            body, meta.city, meta.grid, meta.window_s, meta.ttl_minutes)),
        "enc_position_ops_ms": med(lambda: poss.encode(prows)),
    }


# the infer phase: synthetic_backfill's preset with the Kalman reducer
FORMATS = ("json", "binary", "columnar")
COL_VALUE_EVENTS = 16_384     # events a columnar value (publish_columns)
FORMAT_TOPIC = "mobility.positions.{}"


class _KeyRecorder:
    """Stands in for the runtime's host snap and keeps each batch's
    inputs and keys, so the native run's keys can be held against
    NativeH3Snap and against the kernel on the same points."""

    def __init__(self, snap):
        self._snap = snap
        self.calls = []

    def snap(self, lat_rad, lng_rad, res):
        hi, lo = self._snap.snap(lat_rad, lng_rad, res)
        self.calls.append((np.array(lat_rad), np.array(lng_rad), res,
                           hi.copy(), lo.copy()))
        return hi, lo


def format_records(events):
    """Per format, the event dicts a publisher is handed, in produce order:
    the kafka phase's JSON events (its rejects carry their raw value in
    ``_value``: malformed JSON, undecodable bytes); for binary the same
    events, the rejects at the same positions being a bad magic byte, a
    truncated value and lat 95."""
    from heatmap_tpu_torch.stream import binfmt

    json_recs, bin_recs = [], []
    good = next(e for e in events if "malformed" not in e)
    for i, e in enumerate(events):
        kind = i % 8192
        veh = f"veh-{i % KAFKA_SOURCE['n_vehicles']}"
        if "malformed" in e:
            raw = (b'{"provider": "mbta", "lat": ' if kind == 100
                   else b"\xff\xfe")
            json_recs.append({"vehicleId": veh, "_value": raw})
            v = binfmt.encode_event({**good, "vehicleId": veh})
            bin_recs.append({"vehicleId": veh, "_value": (
                b"\x00" + v[1:] if kind == 100 else v[:-5])})
        else:
            json_recs.append(e)
            bin_recs.append(e)
    return json_recs, bin_recs


def publish_events(pub, recs, encode):
    """``recs`` through a KafkaPublisher in chunks of 4,096 events, one
    flush each, as a poller publishes.  The publisher's encoder is wrapped
    so that a reject is sent as its raw ``_value``, a value no publisher
    writes."""
    pub._encode_value = lambda e: e["_value"] if "_value" in e else \
        encode(e)
    for j in range(0, len(recs), 4096):
        pub.publish(recs[j:j + 4096])
        pub.flush()


def columnar_columns(cols):
    """The kafka phase's events as EventColumns for publish_columns, in
    produce order; its rejects become rows the decode drops: the malformed
    values a timestamp out of range, the latitude reject lat 95."""
    from heatmap_tpu_torch.stream.events import columns_from_arrays

    rows = np.arange(len(cols))
    lat = cols.lat_deg.copy()
    ts = cols.ts_s.astype(np.int32)
    kinds = rows % 8192
    lat[kinds == 300] = 95.0
    ts[(kinds == 100) | (kinds == 200)] = -1
    return columns_from_arrays(
        lat, cols.lng_deg, cols.speed_kmh, ts,
        provider_id=np.zeros(len(rows), np.int32),
        vehicle_id=cols.vehicle_id,
        providers=["mbta"],
        vehicles=[f"veh-{i}" for i in range(KAFKA_SOURCE["n_vehicles"])])


def _kept(polls, cols):
    polls.append(cols)
    return cols


def replay_polls(json_polls, col_polls):
    """A source that returns, poll by poll, the json run's decoded rows of
    the events each columnar poll returned (and its drop count), after
    holding each columnar row bit for bit to the json decode of its
    event: lat/lng in degrees and radians, speed, ts, vehicle."""
    from heatmap_tpu_torch.stream.events import EventColumns
    from heatmap_tpu_torch.stream.source import MemorySource

    lanes = ("lat_rad", "lng_rad", "lat_deg", "lng_deg", "speed_kmh", "ts_s")
    js = [c for c in json_polls if len(c)]
    names = js[-1].vehicles
    j = {f: np.concatenate([getattr(c, f) for c in js]) for f in lanes}
    jv = np.concatenate([c.vehicle_id for c in js])
    jp = np.concatenate([c.provider_id for c in js])
    at = {(names[v], int(t)): i for i, (v, t) in enumerate(zip(jv, j["ts_s"]))}
    if len(at) != len(jv):
        raise AssertionError("formats: (vehicle, ts) does not name an event")
    out, rows = [], 0
    for c in col_polls:
        if not isinstance(c, EventColumns):
            continue
        idx = np.array([at[(c.vehicles[v], int(t))]
                        for v, t in zip(c.vehicle_id, c.ts_s)], np.int64)
        for f in lanes:
            if getattr(c, f).tobytes() != j[f][idx].tobytes():
                raise AssertionError(f"formats: columnar {f} differs from "
                                     f"the json decode of the same events")
        rows += len(idx)
        out.append(EventColumns(**{f: j[f][idx] for f in lanes},
                                provider_id=jp[idx], vehicle_id=jv[idx],
                                providers=js[-1].providers, vehicles=names,
                                n_dropped=c.n_dropped))
    if rows != len(jv):
        raise AssertionError(f"formats: columnar polls returned {rows} rows,"
                             f" the json run {len(jv)}")

    class Replay(MemorySource):
        def poll(self, max_events):
            return self._q.popleft() if self._q else []

    src = Replay(out)
    src.finish()
    return src


def format_run_stats(m, wall, launches):
    spans = {k: v for k, v in m["p50_span_ms"].items() if v is not None}
    return {"events": m["events_valid"], "dropped": m["events_invalid"],
            "batches": m["batches"], "wall_s": wall,
            "events_per_s": m["events_valid"] / wall,
            "p50_batch_ms": m["p50_batch_ms"], "p50_span_ms": spans,
            "snap_launches": launches,
            "values_decoded": {k: m[f"values_decoded_{k}"]
                               for k in ("native", "python")}}


def decode_times(values, bin_recs, order, col_values, batch):
    """Host ms of one 2^17 batch's decode in each format (median of 5):
    NativeDecoder.decode of the joined JSON values, decode_binary of the
    length-prefixed binary values, colfmt decode_batch of the batch's
    columnar values (with the intern tables and LUT memo warm, as a
    source holds them; and cold, with the native and the Python
    string-table parse), beside the Python binary path
    (binfmt.decode_events + parse_events, once)."""
    from heatmap_tpu_torch import native
    from heatmap_tpu_torch.stream import binfmt, colfmt
    from heatmap_tpu_torch.stream.events import parse_events

    def med(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    idx = order[:batch]
    joined = b"\n".join(values[i] for i in idx) + b"\n"
    bin_values = [bin_recs[i]["_value"] if "_value" in bin_recs[i]
                  else binfmt.encode_event(bin_recs[i]) for i in idx]
    framed = binfmt.frame_lp(bin_values)
    dec = native.NativeDecoder()

    def columnar(native_strtab, warm=None):
        ip, iv, cache = warm if warm is not None else ({}, {}, {})
        for v in col_values:
            colfmt.decode_batch(v, ip, iv, cache, native=native_strtab)

    # warm: the intern tables and LUT memo a source keeps across polls,
    # with this vehicle set already seen (its steady state)
    steady = ({}, {}, {})
    columnar(True, steady)

    def binary_python():
        dicts, _ = binfmt.decode_events(bin_values)
        parse_events(dicts, {}, {})

    out = {"json_native_decode_ms": med(lambda: dec.decode(joined,
                                                           final=True)),
           "binary_decode_binary_ms": med(lambda: dec.decode_binary(framed)),
           "columnar_decode_batch_ms": med(lambda: columnar(True, steady)),
           "columnar_decode_batch_cold_ms": med(lambda: columnar(True)),
           "columnar_decode_batch_python_strtab_cold_ms": med(
               lambda: columnar(False)),
           "binary_python_ms": med(binary_python, reps=1),
           "columnar_values": len(col_values),
           "json_bytes": len(joined), "binary_bytes": len(framed),
           "columnar_bytes": sum(len(v) for v in col_values)}
    dec.close()
    return out


def phase_formats(torch, run_pipeline, snap_kernel, ckpt_root, dev):
    """mbta_default through each event format the reference takes (json,
    binary, columnar), published by the port's KafkaPublisher, each in
    process and through the feeder process (HEATMAP_FEEDER=proc), plus one
    JSON run keyed by the host snap (HEATMAP_H3_IMPL=native)."""
    os.environ["HEATMAP_FETCH_MAX_BYTES"] = str(256 << 20)
    try:
        return _format_runs(torch, run_pipeline, snap_kernel, ckpt_root,
                            dev)
    finally:
        for k in ("HEATMAP_FETCH_MAX_BYTES", "HEATMAP_EVENT_FORMAT",
                  "HEATMAP_FEEDER", "HEATMAP_H3_IMPL"):
            os.environ.pop(k, None)


def _format_runs(torch, run_pipeline, snap_kernel, ckpt_root, dev):
    from heatmap_tpu_torch.kafka import KafkaClient
    from heatmap_tpu_torch.kafka.client import LATEST, partition_for_key
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.native import NativeH3Snap
    from heatmap_tpu_torch.producers.base import KafkaPublisher
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream import binfmt
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.shmfeed import ShmFeederSource
    from heatmap_tpu_torch.stream.source import KafkaSource, SyntheticSource
    from heatmap_tpu_torch.testing.mock_kafka import MockKafkaBroker

    name = "mbta_default"
    p = get_pipeline(name)
    batch = p.config.batch_size
    n_batches = KAFKA_EVENTS // batch
    n_values = KAFKA_EVENTS // COL_VALUE_EVENTS
    t0 = time.monotonic()
    keys, values, events = kafka_events()
    cols = SyntheticSource(n_events=KAFKA_EVENTS, **KAFKA_SOURCE).poll(
        KAFKA_EVENTS)
    json_recs, bin_recs = format_records(events)
    n_bad = sum(1 for e in events if "malformed" in e or e["lat"] > 90)
    n_valid = len(events) - n_bad
    by_part = {0: [], 1: [], 2: []}
    for i, k in enumerate(keys):
        by_part[partition_for_key(k, 3)].append(i)
    order = kafka_poll_order(by_part, batch, n_batches)
    col_cols = columnar_columns(cols)
    out = {"phase": "formats", "records": len(events), "rejects": n_bad,
           "partitions": 3, "batches": n_batches,
           "columnar_values": n_values,
           "generate_s": time.monotonic() - t0}
    publish_s = {}
    runs, contents = {}, {}
    with MockKafkaBroker(num_partitions=3) as bootstrap:
        topics = {f: FORMAT_TOPIC.format(f) for f in FORMATS}
        for fmt in FORMATS:
            t0 = time.monotonic()
            pub = KafkaPublisher(bootstrap, topics[fmt], event_format=fmt)
            if fmt == "json":
                publish_events(pub, json_recs,
                               lambda e: json.dumps(e).encode("utf-8"))
            elif fmt == "binary":
                publish_events(pub, bin_recs, binfmt.encode_event)
            elif pub.publish_columns(col_cols) != KAFKA_EVENTS:
                raise AssertionError("formats: publish_columns fell short")
            pub.close()
            publish_s[fmt] = time.monotonic() - t0
        out["publish_s"] = publish_s
        # the topics as the sources will read them: the same record at each
        # (partition, offset) in json and binary, the same batches in all
        client = KafkaClient(bootstrap)
        ends = {f: client.list_offsets(topics[f], LATEST) for f in FORMATS}
        client.close()
        if not (ends["json"] == ends["binary"]
                == {k: len(v) for k, v in by_part.items()}):
            raise AssertionError(f"formats: topics not keyed as the kafka "
                                 f"phase's: {ends}")

        # the mock broker encodes a fetched segment once and keeps it: a
        # first reader of a topic pays that encode (the kafka phase's first
        # run does), so each topic is read once, as the runs read it,
        # before any timed run
        warm_s = {}
        for fmt in FORMATS:
            t0 = time.monotonic()
            os.environ["HEATMAP_EVENT_FORMAT"] = fmt
            src = KafkaSource(bootstrap, topics[fmt])
            src.seek({0: 0, 1: 0, 2: 0})
            for _ in range(4 * n_batches):
                if sum(src.offset().values()) >= sum(ends[fmt].values()):
                    break
                src.poll(batch)
            src.close()
            warm_s[fmt] = time.monotonic() - t0
        out["warm_read_s"] = warm_s
        polls = {}

        def run(label, fmt, feeder, h3_impl=None, ckpt_every=4):
            os.environ["HEATMAP_EVENT_FORMAT"] = fmt
            os.environ.pop("HEATMAP_FEEDER", None)
            os.environ.pop("HEATMAP_H3_IMPL", None)
            if feeder:
                os.environ["HEATMAP_FEEDER"] = "proc"
            if h3_impl:
                os.environ["HEATMAP_H3_IMPL"] = h3_impl
            cfg = dataclasses.replace(
                p.config, kafka_bootstrap=bootstrap,
                kafka_topic=topics[fmt],
                checkpoint_dir=f"{ckpt_root}/formats-{label}")
            src = p.make_source(cfg)
            want = ShmFeederSource if feeder else KafkaSource
            if type(src) is not want:
                raise AssertionError(f"formats {label}: {type(src)}")
            src.seek({0: 0, 1: 0, 2: 0})       # the topic from its start
            if label in ("json", "columnar"):
                # keep what each poll returned, for the columnar check
                polls[label] = []
                poll = src.poll
                src.poll = lambda n: _kept(polls[label], poll(n))
            store = MemoryStore()
            torch.cuda.synchronize()
            snap_kernel.latlng_to_cell_kernel.launches = 0
            t0 = time.monotonic()
            rt = MicroBatchRuntime(cfg, src, store, checkpoint_every=ckpt_every)
            recorder = None
            if h3_impl == "native":
                if rt.snap_impl != "native":
                    raise AssertionError("formats: HEATMAP_H3_IMPL=native "
                                         "did not take the host snap")
                recorder = rt._host_snap = _KeyRecorder(rt._host_snap)
            # until the topic is read and nothing is carried or prefetched
            # (a columnar run folds more batches than 8: see below)
            end = sum(ends[fmt].values())
            for _ in range(4 * n_batches):
                if (sum(src.offset().values()) >= end and not rt._prefetched
                        and rt._carry_cols is None and rt.epoch):
                    break
                rt.step_once()
            rt.close()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = snap_kernel.latlng_to_cell_kernel.launches
            m = rt.metrics
            stats = format_run_stats(m, wall, launches)
            if feeder:
                stats["feeder_wait_ms_p50"] = m["p50_span_ms"]["wait"]
            tiles, positions = store_contents(store)
            want_launches = 0 if h3_impl == "native" else m["batches"]
            if launches != want_launches:
                raise AssertionError(f"formats {label}: {launches} snap "
                                     f"launches in {m['batches']} batches, "
                                     f"want {want_launches}")
            want_batches = (m["batches"] >= n_batches if fmt == "columnar"
                            else m["batches"] == n_batches)
            if not want_batches or m["events_valid"] != n_valid \
                    or m["events_invalid"] != n_bad or m["state_overflow"]:
                raise AssertionError(
                    f"formats {label}: {m['batches']} batches, "
                    f"{m['events_valid']} valid of {n_valid}, "
                    f"{m['events_invalid']} dropped of {n_bad} rejects, "
                    f"overflow {m['state_overflow']}")
            if m["values_decoded_python"] or m["values_decoded_native"] == 0:
                raise AssertionError(f"formats {label}: not every value "
                                     f"decoded natively: {m}")
            if sum(d["count"] for d in tiles.values()) != n_valid:
                raise AssertionError(f"formats {label}: counts not "
                                     f"conserved")
            runs[label] = {"format": fmt, "feeder": feeder,
                           "snap": rt.snap_impl, **stats,
                           "tiles": len(tiles), "positions": len(positions)}
            emit({"phase": "formats_run", "run": label, **runs[label]})
            contents[label] = (tiles, positions)
            return rt, recorder

        run("json", "json", False)
        for fmt in FORMATS:
            if fmt != "json":
                run(fmt, fmt, False)
            run(f"{fmt}_proc", fmt, True)
        rt, recorder = run("json_native", "json", False, h3_impl="native")
        ckpt_dir = rt.cfg.checkpoint_dir
        del rt
        os.environ.pop("HEATMAP_H3_IMPL")   # auto from here: the kernel

        # every run's docs and positions are the json in-process run's.
        # json and binary values are counted alike, so their runs cut the
        # same batches: docs under docs_match's bar.  A columnar poll takes
        # whole values until its valid rows fill the batch and the runtime
        # carries the rest, so its batches cut elsewhere, and a batch's
        # float32 sums round differently when its rows differ (~1e-8
        # relative).  The comparison stays exact in three steps: every
        # row a columnar poll returned is, bit for bit, the json run's
        # decode of the same event (vehicle and second identify it); the
        # json run's rows, polled as the columnar run polled, fold to the
        # columnar run's docs under docs_match's bar; and the columnar
        # docs' integers, cells and windows are the json run's exactly
        # (docs_close, which holds their floats to the CPU tests' bars).
        # The feeder's columnar run cuts as the in-process one: docs_match.
        tiles, positions = contents["json"]
        replay = replay_polls(polls["json"], polls["columnar"])
        rrt = MicroBatchRuntime(dataclasses.replace(
            p.config, checkpoint_dir=f"{ckpt_root}/formats-replay"),
            replay, MemoryStore(), checkpoint_every=4)
        rrt.run()
        replay_docs = store_contents(rrt.store)
        del rrt
        worst = {}
        for label, (t, pos) in contents.items():
            if label == "json_native":
                continue
            if label == "columnar":
                worst[label] = docs_match(t, replay_docs[0])
                worst["columnar_vs_json"] = docs_close(t, tiles)
            elif label == "columnar_proc":
                worst[label] = docs_match(t, contents["columnar"][0])
            else:
                worst[label] = docs_match(t, tiles)
            if pos != positions or (label == "columnar"
                                    and replay_docs[1] != pos):
                raise AssertionError(f"formats {label}: positions_latest "
                                     f"differs from the json run's")
        newest = newest_positions(events)
        got = {d["vehicleId"]: (int(d["ts"].timestamp()),
                                *(float(c) for c in reversed(
                                    d["loc"]["coordinates"])))
               for d in positions.values()}
        if got != newest:
            raise AssertionError("formats: positions_latest is not the "
                                 "newest event of each vehicle")

        # the native run: its keys NativeH3Snap's bit for bit on its first
        # batch, the kernel's on >= 99.8% of its events (the reference's bar
        # between its snaps), and its docs the same events
        first = KafkaSource(bootstrap, topics["json"])
        first.seek({0: 0, 1: 0, 2: 0})
        first_cols = first.poll(batch)
        first.close()
        lat0, lng0, res, hi0, lo0 = recorder.calls[0]
        want_hi, want_lo = NativeH3Snap().snap(first_cols.lat_rad,
                                               first_cols.lng_rad, res)
        if (len(recorder.calls) != n_batches
                or lat0.tobytes() != first_cols.lat_rad.tobytes()
                or hi0.tobytes() != want_hi.tobytes()
                or lo0.tobytes() != want_lo.tobytes()):
            raise AssertionError("formats: the native run's first-batch keys "
                                 "are not NativeH3Snap's")
        same = total = 0
        for lat, lng, res, hi, lo in recorder.calls:
            khi, klo = snap_kernel.latlng_to_cell_kernel(
                torch.from_numpy(lat).to(dev), torch.from_numpy(lng).to(dev),
                res)
            same += int(np.count_nonzero(
                (khi.cpu().numpy().view(np.uint32) == hi)
                & (klo.cpu().numpy().view(np.uint32) == lo)))
            total += len(lat)
        agree = same / total
        ntiles, npositions = contents["json_native"]
        key = lambda d: (d["cellId"], d["windowStart"])
        cells_k = {key(d) for d in tiles.values()}
        cells_n = {key(d) for d in ntiles.values()}
        cell_share = len(cells_k & cells_n) / len(cells_k | cells_n)
        if agree < 0.998 or npositions != positions:
            raise AssertionError(f"formats: native vs kernel keys agree on "
                                 f"{agree} of events (bar 0.998), or the "
                                 f"positions differ")

        # its commit, resumed with HEATMAP_H3_IMPL unset (auto: the kernel
        # on the card), keeps the host snap
        os.environ["HEATMAP_EVENT_FORMAT"] = "json"
        resumed = MicroBatchRuntime(
            dataclasses.replace(p.config, kafka_bootstrap=bootstrap,
                                kafka_topic=topics["json"],
                                checkpoint_dir=ckpt_dir),
            KafkaSource(bootstrap, topics["json"]), MemoryStore(),
            checkpoint_every=0)
        pinned = resumed.snap_impl
        resumed_epoch = resumed.epoch
        resumed.close()
        if pinned != "native" or resumed_epoch != n_batches:
            raise AssertionError(f"formats: the native commit resumed with "
                                 f"the knob unset took {pinned!r} at epoch "
                                 f"{resumed_epoch}")
        col_values = _read_values(bootstrap, topics["columnar"],
                                  batch // COL_VALUE_EVENTS)
    torch.cuda.empty_cache()
    out.update(runs={k: {f: r[f] for f in (
        "format", "feeder", "snap", "events_per_s", "wall_s", "p50_batch_ms",
        "p50_span_ms", "snap_launches")} for k, r in runs.items()},
        docs_equal_json_run=True, docs_float_max_rel_diff=worst,
        positions_equal=True, native_first_batch_keys_identical=True,
        native_vs_kernel_event_agreement=agree,
        native_vs_kernel_cell_window_jaccard=cell_share,
        native_commit_pinned=pinned,
        decode_ms=decode_times(values, bin_recs, order, col_values, batch))
    emit(out)
    return out


def _read_values(bootstrap, topic, n):
    """The first ``n`` record values of a topic, in the order the columnar
    source reads them (its first poll: partition 0's first values)."""
    from heatmap_tpu_torch.kafka import KafkaClient

    c = KafkaClient(bootstrap)
    fr = c.fetch(topic, 0, 0, max_bytes=256 << 20, max_wait_ms=0)
    c.close()
    return [r.value for r in fr.records[:n]]


INFER_BATCHES = 16
INFER_TABLE = (8, 1 << 17)     # (K, M) of the full-table round set
# round sets at the edges of the rounds kernel's tiling (tiles of 64
# entities, chunks of 8 rounds, a ring of 4 chunks): (K, M)
INFER_EDGES = {"m20001": (27, 20_001),   # M not a multiple of 16 or a tile
               "m5": (27, 5),            # under one tile
               "k1": (1, 20_000),
               "k13": (13, 20_000),      # K not a multiple of the chunk
               "k200": (200, 20_000)}    # the ring wraps many times
# the filter's constants, as infer/engine.py passes them
KALMAN_KW = dict(q=0.5, r_m=25.0, gate=13.816, p0_pos=625.0, p0_vel=100.0)


def rounds_check(torch, kalman, args, dev):
    """The kernel against its plain version on the card on one round set
    (numpy args of filter_rounds, staged with the planes pitched as the
    engine stages them): identical share and max abs difference per
    output, the kernel's time, the plain version's, the bound, and
    filter_rounds' host time with its copies on the engine's stream.
    Bar: exact on every output (both round op by op on the card)."""
    from heatmap_tpu_torch.infer import roundset

    valid, reseed, dt = args[4], args[5], args[3]
    consts = kalman.filter_consts(**KALMAN_KW)
    k, m = valid.shape
    ins = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in args[:2]]
    for a in args[2:]:
        t = torch.from_numpy(np.ascontiguousarray(a))
        ins.append(kalman.pitched(k, m, a.shape[2:], t.dtype, dev))
        ins[-1].copy_(t)
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
    n_bytes, n_ops = roundset.rounds_work(valid)
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


def rounds_empty_check(torch, kalman, dev):
    """M = 0: the wrapper launches nothing and counts nothing, and hands
    back outputs of the right shapes."""
    k = 27
    before = kalman.kalman_rounds.launches
    ins = [torch.empty((0, 4), device=dev), torch.empty((0, 4, 4), device=dev),
           *(kalman.pitched(k, 0, tail, dtype, dev) for tail, dtype in (
               ((2,), torch.float32), ((), torch.float32),
               ((), torch.bool), ((), torch.bool)))]
    out = kalman.kalman_rounds(*ins, kalman.filter_consts(**KALMAN_KW))
    shapes = [tuple(t.shape) for t in out]
    if (kalman.kalman_rounds.launches != before
            or shapes != [(0, 4), (0, 4, 4), (k, 0), (k, 0), (k, 0),
                          (k, 0, 2)]):
        raise AssertionError(f"kalman_rounds at M = 0: launches "
                             f"{kalman.kalman_rounds.launches - before}, "
                             f"shapes {shapes}")
    return {"k": k, "m": 0, "launches": 0, "shapes": shapes}


def table_round_set(k, m):
    """A round set from the seed that takes every branch of the kernel
    (``roundset.round_set``)."""
    from heatmap_tpu_torch.infer import roundset

    return roundset.round_set(k, m, SEED)


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
    edges = {name: rounds_check(torch, kalman, table_round_set(k, m), dev)
             for name, (k, m) in INFER_EDGES.items()}
    edges["m0"] = rounds_empty_check(torch, kalman, dev)
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
           "round_sets": sets, "edge_sets": edges}
    emit(out)
    return out


# the serve phase: synthetic_backfill's preset widths, its stream moved to
# the current time so that no window is stale when the view serves it
SERVE_SOURCE = dict(n_events=MAIN_EVENTS, n_vehicles=20_000,
                    events_per_second=1_000_000)


def http_get(port, path, headers=None):
    """(status, headers, body, ms) of one GET on the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            body = r.read()
            return (r.status, dict(r.headers), body,
                    (time.perf_counter() - t0) * 1e3)
    except urllib.error.HTTPError as e:
        return (e.code, dict(e.headers), e.read(),
                (time.perf_counter() - t0) * 1e3)


class DeltaFollower:
    """A client that follows /api/tiles/delta as the UI does: replace its
    cell set on mode "full", upsert by cellId on "delta", feed the seq
    back as ``since``."""

    def __init__(self, port):
        import threading

        self.port = port
        self.cells: dict = {}
        self.seq = 0
        self.modes = {"full": 0, "delta": 0}
        # delta-mode polls that carried cells, and the cells they carried
        self.deltas_with_cells = 0
        self.delta_cells = 0
        self.poll_ms: list = []
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="delta-follower")

    def poll(self):
        status, _, body, ms = http_get(self.port,
                                       f"/api/tiles/delta?since={self.seq}")
        if status != 200:
            raise AssertionError(f"delta poll answered {status}: "
                                 f"{body[:200]}")
        d = json.loads(body)
        if d["mode"] == "full":
            self.cells = {}
        elif d["features"]:
            self.deltas_with_cells += 1
            self.delta_cells += len(d["features"])
        for f in d["features"]:
            self.cells[f["properties"]["cellId"]] = f
        self.seq = d["seq"]
        self.modes[d["mode"]] += 1
        self.poll_ms.append(ms)

    def _run(self):
        try:
            while not self._stop.is_set():
                self.poll()
                self._stop.wait(0.1)
        except BaseException as e:  # surfaced by stop()
            self.error = e

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=300)
        if self._thread.is_alive():
            raise AssertionError("the delta follower did not stop")
        if self.error is not None:
            raise AssertionError("the delta follower failed") from self.error


def wsgi_get(app, path, qs=""):
    """One GET through a WSGI app in process: (status, body)."""
    out = {}
    it = app({"PATH_INFO": path, "QUERY_STRING": qs,
              "REQUEST_METHOD": "GET"},
             lambda status, headers, exc=None: out.update(status=status))
    try:
        return out["status"], b"".join(it)
    finally:
        if hasattr(it, "close"):
            it.close()


def serve_run(torch, snap_kernel, ckpt_dir, dev, view: bool, served: bool,
              delta_log: int | None):
    """synthetic_backfill at its preset widths, the view on or off; when
    ``served``, the port's server on an ephemeral port and a delta
    follower during the run.  ``delta_log`` sets HEATMAP_DELTA_LOG (None:
    the default)."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.serve import start_background, stop_background
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    p = get_pipeline("synthetic_backfill")
    cfg = dataclasses.replace(p.config, checkpoint_dir=ckpt_dir,
                              query_view=view, serve_port=0)
    if delta_log is not None:
        cfg = dataclasses.replace(cfg, delta_log=delta_log)
    # one window, the one before the current one: 10 s of event time
    t0 = (int(time.time()) // 300 - 1) * 300
    store = MemoryStore()
    snap_kernel.latlng_to_cell_kernel.launches = 0
    rt = MicroBatchRuntime(cfg, SyntheticSource(t0=t0, **SERVE_SOURCE),
                           store, device=dev)
    server = follower = None
    if served:
        httpd, thread, port = start_background(store, cfg, rt)
        server = (httpd, thread, port)
        follower = DeltaFollower(port)
        follower.start()
    t_start = time.monotonic()
    try:
        rt.run()
    finally:
        if follower is not None:
            follower.stop()
    wall = time.monotonic() - t_start
    launches = snap_kernel.latlng_to_cell_kernel.launches
    m = rt.metrics
    want = m["batches"] if dev.type == "cuda" else 0
    if launches != want or m["events_valid"] != MAIN_EVENTS:
        raise AssertionError(f"serve run (view {view}): {launches} snap "
                             f"launches in {m['batches']} batches, "
                             f"{m['events_valid']} events")
    out = {"view": view, "served": served, "delta_log": cfg.delta_log,
           "events": m["events_valid"],
           "batches": m["batches"], "wall_s": wall,
           "events_per_s": m["events_valid"] / wall,
           "p50_batch_ms": m["p50_batch_ms"], "snap_launches": launches,
           "writer": {k: m[k] for k in ("tiles_written", "positions_written",
                                        "sink_backpressure_ms")},
           "p50_span_ms": {k: m["p50_span_ms"][k] for k in (
               "poll", "feed", "dispatch", "positions", "sink", "prefetch")}}
    if served:
        try:
            out.update(serve_checks(torch, rt, store, cfg, server[2],
                                    follower, delta_log is not None))
        finally:
            stop_background(server[0], server[1])
    del rt, store
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_checks(torch, rt, store, cfg, port, follower, need_deltas: bool):
    """What the serve phase holds the view-on run to, and its read-path
    numbers: the followed deltas replay to /api/tiles/latest (with
    ``need_deltas``, some of them as delta-mode bodies that carried
    cells), the writer-fed body equals a serve-only app's over the same
    store, the binary frame decodes to the JSON body, the rollups
    conserve, the ETag answers 304, positions_latest holds every vehicle;
    the view's apply time per flush and each route's time and bytes."""
    from heatmap_tpu_torch.serve import api as tapi
    from heatmap_tpu_torch.serve import wire

    view = rt.matview
    follower.poll()     # the last changes, after the writer drained
    status, hdr, latest, latest_cold_ms = http_get(port, "/api/tiles/latest")
    feats = {f["properties"]["cellId"]: f
             for f in json.loads(latest)["features"]}
    if status != 200 or follower.cells != feats or not feats:
        raise AssertionError(f"followed deltas ({len(follower.cells)} "
                             f"cells, {follower.modes}) differ from "
                             f"/api/tiles/latest ({len(feats)} cells)")
    if need_deltas and not follower.deltas_with_cells:
        raise AssertionError(f"no delta-mode poll carried a cell "
                             f"({follower.modes}, delta log "
                             f"{cfg.delta_log}): the replay held only "
                             f"full bodies")
    base_total = sum(f["properties"]["count"] for f in feats.values())
    if base_total != MAIN_EVENTS:
        raise AssertionError(f"the latest window holds {base_total} of "
                             f"{MAIN_EVENTS} events")
    # the same store through a serve-only app (its view rebuilt by the
    # StoreViewRefresher): the same features; the order of a store scan
    # may differ from the writer's apply order
    app = tapi.make_wsgi_app(store, cfg)
    try:
        s, body = wsgi_get(app, "/api/tiles/latest")
    finally:
        app.close()
    scan = {f["properties"]["cellId"]: f
            for f in json.loads(body)["features"]}
    if not s.startswith("200") or scan != feats:
        raise AssertionError("the serve-only app's /api/tiles/latest "
                             "differs from the writer-fed one's")
    # the binary frame decodes to the JSON body's docs
    status, bhdr, frame, bin_cold_ms = http_get(
        port, "/api/tiles/latest?fmt=bin")
    dec = wire.decode(frame)
    if (tapi._features_collection_json(dec["docs"]).encode() != latest
            or bhdr["ETag"] != hdr["ETag"][:-1] + '.bin"'
            or dec["seq"] != view.seq):
        raise AssertionError("the binary frame does not decode to the JSON "
                             "body")
    rollups = {}
    for res in range(cfg.h3_res - cfg.pyramid_levels, cfg.h3_res):
        _, _, b, _ = http_get(port, f"/api/tiles/latest?res={res}")
        fs = json.loads(b)["features"]
        total = sum(f["properties"]["count"] for f in fs)
        if total != base_total:
            raise AssertionError(f"res={res} rollup counts {total} != "
                                 f"{base_total}")
        rollups[res] = len(fs)
    status, _, b, _ = http_get(port, "/api/tiles/latest",
                               {"If-None-Match": hdr["ETag"]})
    if status != 304 or b:
        raise AssertionError(f"If-None-Match answered {status}")
    _, _, pos, pos_ms = http_get(port, "/api/positions/latest")
    vehicles = {f["properties"]["vehicleId"]
                for f in json.loads(pos)["features"]}
    want = {f"veh-{k}" for k in range(SERVE_SOURCE["n_vehicles"])}
    if vehicles != want:
        raise AssertionError(f"/api/positions/latest holds {len(vehicles)} "
                             f"of {len(want)} vehicles")
    # the read path's numbers (view warm: cached renders after the first)
    timed = {}
    for name, path, n in (("latest_json", "/api/tiles/latest", 11),
                          ("latest_bin", "/api/tiles/latest?fmt=bin", 11),
                          ("delta_full", "/api/tiles/delta?since=0", 5),
                          ("positions", "/api/positions/latest", 5)):
        runs = [http_get(port, path) for _ in range(n)]
        timed[name] = {"p50_ms": float(np.median([r[3] for r in runs])),
                       "bytes": len(runs[0][2])}
    timed["latest_json"]["cold_ms"] = latest_cold_ms
    timed["latest_bin"]["cold_ms"] = bin_cold_ms
    timed["positions"]["first_ms"] = pos_ms
    apply = view._h_apply
    health = json.loads(http_get(port, "/healthz")[2])
    return {"view_cells": view.cells_live(), "view_seq": view.seq,
            "view_applies": apply.count,
            "view_apply_p50_ms": apply.quantile(0.5) * 1e3,
            "view_apply_total_s": apply.sum,
            "followed": {"polls": len(follower.poll_ms),
                         "modes": follower.modes,
                         "deltas_with_cells": follower.deltas_with_cells,
                         "delta_cells": follower.delta_cells,
                         "p50_poll_ms": float(np.median(follower.poll_ms)),
                         "replay_equals_latest": True},
            "rollup_cells": rollups, "routes": timed,
            "healthz": health["status"], "vehicles": len(vehicles),
            "serve_only_equal": True, "bin_decodes_to_json": True}


# A flush at these widths upserts ~8,000 res-9 cells, more than the
# default 4,096-entry delta log holds, so a follower there gets only full
# bodies; a log of 2^16 holds eight such flushes, and the second served
# run follows real deltas through it
SERVE_DELTA_LOG = 1 << 16
# (view, served, delta_log) of each serve-phase run, in turns: the view
# off, the view on, the view on with the server and a follower (the
# default delta log, then SERVE_DELTA_LOG), and back
SERVE_RUNS = ((False, False, None), (True, False, None), (True, True, None),
              (True, True, SERVE_DELTA_LOG), (True, False, None),
              (False, False, None))


def phase_serve(torch, snap_kernel, ckpt_root, dev):
    """synthetic_backfill with the view off, on, and on with the port's
    server and a delta follower running, in turns on the same card:
    events/s and p50 batch of each, and the served runs' read-path
    checks."""
    runs = [serve_run(torch, snap_kernel, f"{ckpt_root}/serve{i}", dev,
                      view, served, delta_log)
            for i, (view, served, delta_log) in enumerate(SERVE_RUNS)]
    out = {"phase": "serve", "source": dict(SERVE_SOURCE, t0="now-aligned"),
           "runs": runs}
    for label, kind in (("view_off", (False, False, None)),
                        ("view_on", (True, False, None)),
                        ("served", (True, True, None)),
                        ("served_log2_16", (True, True, SERVE_DELTA_LOG))):
        mine = [r for r, k in zip(runs, SERVE_RUNS) if k == kind]
        out[f"events_per_s_{label}"] = [r["events_per_s"] for r in mine]
        out[f"p50_batch_ms_{label}"] = [r["p50_batch_ms"] for r in mine]
    emit(out)
    return out

# the repl phase: the writer publishes the view's feed (HEATMAP_REPL_DIR)
# and retires it into the history tier (HEATMAP_HIST_DIR); a replica fleet
# of two epoll workers follows it over HTTP, and a thread-core replica
# beside it; a client follows the fleet's /api/tiles/delta (through a
# delta log of SERVE_DELTA_LOG, so its deltas carry cells)

def start_fleet(args, env, what):
    """``python -m heatmap_tpu_torch.serve`` with ``args``; returns (the
    process, the port its log names)."""
    import re

    proc = subprocess.Popen(
        [sys.executable, "-m", "heatmap_tpu_torch.serve", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stderr=subprocess.PIPE, text=True)
    pat = re.compile(r"(?:serve fleet: \d+ workers on|serving on) "
                     r"http://127\.0\.0\.1:(\d+)/")
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        m = pat.search(line)
        if m:
            # drain the rest of its log so a full pipe never blocks it
            import threading

            threading.Thread(target=proc.stderr.read, daemon=True).start()
            return proc, int(m.group(1))
    stop_process(proc)
    raise AssertionError(f"{what} never named its port")


def stop_process(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


class LagProbe:
    """Polls a replica's /healthz during the run: the replication lag in
    seqs and seconds the follower reports."""

    def __init__(self, port):
        import threading

        self.port = port
        self.seq_lag: list = []
        self.lag_s: list = []
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lag-probe")
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.wait(0.25):
                status, _, body, _ = http_get(self.port, "/healthz")
                chk = json.loads(body)["checks"].get("repl_lag_s")
                if chk is None or chk["value"] == "inf":
                    continue    # not bootstrapped yet
                self.seq_lag.append(chk["seq_lag"])
                self.lag_s.append(chk["value"])
        except BaseException as e:  # surfaced by stop()
            self.error = e

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=120)
        if self._thread.is_alive() or self.error is not None:
            raise AssertionError("the lag probe failed") from self.error
        if not self.lag_s:
            raise AssertionError("the lag probe read no lag")
        return {"seq_lag_p50": float(np.median(self.seq_lag)),
                "seq_lag_max": max(self.seq_lag),
                "lag_s_p50": float(np.median(self.lag_s)),
                "lag_s_max": max(self.lag_s), "samples": len(self.lag_s)}


def wait_replicas(port, seq, n_pids, timeout=300):
    """Polls /debug/view until ``n_pids`` distinct workers behind the port
    answered with ``seq`` applied; returns their pids.  A fleet names its
    port before its workers listen on it, so until the deadline a refused
    connection means a worker is still starting."""
    import urllib.error

    done = set()
    deadline = time.monotonic() + timeout
    while len(done) < n_pids:
        if time.monotonic() > deadline:
            raise AssertionError(f"replicas at seq {seq}: {done} of "
                                 f"{n_pids} workers")
        try:
            body = http_get(port, "/debug/view")[2]
        except urllib.error.URLError as e:
            if not isinstance(e.reason, ConnectionRefusedError):
                raise
            time.sleep(0.05)
            continue
        v = json.loads(body)
        if v["mode"] != "replica":
            raise AssertionError(f"a worker serves in mode {v['mode']}")
        if v["repl"]["applied_seq"] == seq:
            done.add(v["pid"])
        else:
            time.sleep(0.05)
    return done


def etag_shape(etag):
    """An ETag with its per-process nonce taken out."""
    return etag.split(".", 1)[1]


def timed_get(port, path, n=5):
    runs = [http_get(port, path) for _ in range(n)]
    if any(r[0] != 200 for r in runs):
        raise AssertionError(f"{path} answered {runs[0][0]}: "
                             f"{runs[0][2][:200]}")
    return {"p50_ms": float(np.median([r[3] for r in runs])),
            "first_ms": runs[0][3], "bytes": len(runs[0][2])}, runs[0]


def dir_bytes(pattern):
    import glob

    paths = glob.glob(pattern)
    return len(paths), sum(os.path.getsize(p) for p in paths)


def repl_run(torch, snap_kernel, ckpt_dir, dev):
    """synthetic_backfill with the feed and the history tier on, the
    writer's app serving them, a two-worker epoll fleet and a thread-core
    replica following it, and a delta client on the fleet."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.query import history as thist
    from heatmap_tpu_torch.serve import start_background, stop_background
    from heatmap_tpu_torch.serve import wire
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    p = get_pipeline("synthetic_backfill")
    feed, hist = f"{ckpt_dir}/feed", f"{ckpt_dir}/hist"
    cfg = dataclasses.replace(p.config, checkpoint_dir=ckpt_dir,
                              serve_port=0, repl_dir=feed, hist_dir=hist,
                              delta_log=SERVE_DELTA_LOG)
    t0 = (int(time.time()) // 300 - 1) * 300
    store = MemoryStore()
    snap_kernel.latlng_to_cell_kernel.launches = 0
    t_phase = time.monotonic()
    rt = MicroBatchRuntime(cfg, SyntheticSource(t0=t0, **SERVE_SOURCE),
                           store, device=dev)
    # the compactor's time per step, and the records each step ingested
    steps = []
    comp = rt.hist_compactor
    comp_step = comp.step

    def timed_step():
        t = time.perf_counter()
        n = comp_step()
        steps.append((time.perf_counter() - t, n))
        return n

    comp.step = timed_step
    httpd, thread, wport = start_background(store, cfg, rt)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env.update(HEATMAP_STORE="memory", SERVE_HOST="127.0.0.1",
               HEATMAP_REPL_FEED=f"http://127.0.0.1:{wport}",
               H3_RES=str(cfg.h3_res),
               H3_RESOLUTIONS=",".join(map(str, cfg.resolutions)),
               TILE_MINUTES=str(cfg.tile_minutes),
               WINDOW_MINUTES=",".join(map(str, cfg.windows_minutes)),
               HEATMAP_DELTA_LOG=str(cfg.delta_log),
               HEATMAP_PYRAMID_LEVELS=str(cfg.pyramid_levels))
    procs = []
    follower = probe = None
    try:
        fleet, fport = start_fleet(
            ["--workers", "2", "--port", "0"],
            dict(env, HEATMAP_SERVE_CORE="epoll"), "the replica fleet")
        procs.append(fleet)
        single, sport = start_fleet(
            ["--workers", "1", "--port", "0"],
            dict(env, HEATMAP_SERVE_CORE="thread"), "the thread replica")
        procs.append(single)
        wait_replicas(fport, 0, 2)
        wait_replicas(sport, 0, 1)
        follower = DeltaFollower(fport)
        follower.start()
        probe = LagProbe(fport)
        t_start = time.monotonic()
        rt.run()
        wall = time.monotonic() - t_start
        follower.stop()
        lag = probe.stop()
        probe = None
        launches = snap_kernel.latlng_to_cell_kernel.launches
        m = rt.metrics
        want = m["batches"] if dev.type == "cuda" else 0
        if launches != want or m["events_valid"] != MAIN_EVENTS:
            raise AssertionError(f"repl run: {launches} snap launches in "
                                 f"{m['batches']} batches, "
                                 f"{m['events_valid']} events")
        seq = rt.matview.seq
        t_catch = time.monotonic()
        pids = wait_replicas(fport, seq, 2)
        wait_replicas(sport, seq, 1)
        catch_up_s = time.monotonic() - t_catch
        out = {"events": m["events_valid"], "batches": m["batches"],
               "wall_s": wall, "events_per_s": m["events_valid"] / wall,
               "p50_batch_ms": m["p50_batch_ms"], "snap_launches": launches,
               "view_seq": seq, "fleet_pids": sorted(pids),
               "catch_up_after_close_s": catch_up_s, "lag": lag}
        # the fleet's /latest (JSON, binary) == the writer's, ETag nonce out
        fleet_bodies = {}
        for qs in ("", "?fmt=bin"):
            ws_, wh, wb, _ = http_get(wport, f"/api/tiles/latest{qs}")
            fs_, fh, fb, _ = http_get(fport, f"/api/tiles/latest{qs}")
            if (ws_, wb) != (fs_, fb) or (etag_shape(wh["ETag"])
                                          != etag_shape(fh["ETag"])):
                raise AssertionError(f"the fleet's /api/tiles/latest{qs} "
                                     f"differs from the writer's")
            fleet_bodies[qs] = fb
        feats = {f["properties"]["cellId"]: f
                 for f in json.loads(fleet_bodies[""])["features"]}
        if wire.decode(fleet_bodies["?fmt=bin"])["seq"] != seq:
            raise AssertionError("the fleet's binary frame names another "
                                 "seq")
        # the client's replayed deltas == the fleet's /latest
        follower.poll()
        if follower.cells != feats or not feats:
            raise AssertionError(f"replayed deltas ({len(follower.cells)} "
                                 f"cells, {follower.modes}) differ from "
                                 f"the fleet's /api/tiles/latest "
                                 f"({len(feats)} cells)")
        if not follower.deltas_with_cells:
            raise AssertionError(f"no delta body from the fleet carried a "
                                 f"cell ({follower.modes})")
        out["followed"] = {"polls": len(follower.poll_ms),
                           "modes": follower.modes,
                           "deltas_with_cells": follower.deltas_with_cells,
                           "delta_cells": follower.delta_cells,
                           "p50_poll_ms": float(np.median(
                               follower.poll_ms))}
        # range over the run's span: every event, writer and replica
        span = f"t0={t0 - 300}&t1={t0 + 600}"
        routes = {}
        for name, port in (("writer", wport), ("fleet", fport)):
            routes[f"range_{name}"], r = timed_get(
                port, f"/api/tiles/range?{span}")
            agg = json.loads(r[2])["aggregate"]["features"]
            total = sum(f["properties"]["count"] for f in agg)
            if total != MAIN_EVENTS:
                raise AssertionError(f"the {name}'s range holds {total} "
                                     f"of {MAIN_EVENTS} events")
            routes[f"range_bin_{name}"], _ = timed_get(
                port, f"/api/tiles/range?{span}&fmt=bin")
            routes[f"diff_{name}"], r = timed_get(
                port, f"/api/tiles/diff?t0={t0 - 300}&t1={t0 + 1}")
            if not json.loads(r[2])["features"]:
                raise AssertionError(f"the {name}'s diff holds no cell")
        # view-at-seq on the writer (the sealed log is local there)
        routes["at_writer"], r = timed_get(wport, f"/api/tiles/at?seq={seq}")
        at = {f["properties"]["cellId"]: f
              for f in json.loads(r[2])["features"]}
        if at != feats:
            raise AssertionError(f"/api/tiles/at?seq={seq} holds "
                                 f"{len(at)} cells, /latest {len(feats)}")
        out["routes"] = routes
        # the same routes on the thread-core replica: the same bodies
        same = []
        for path in ("/api/tiles/latest", "/api/tiles/latest?fmt=bin",
                     "/api/tiles/latest?res=7", "/api/tiles/topk?k=10",
                     f"/api/tiles/delta?since={seq}",
                     f"/api/tiles/range?{span}",
                     f"/api/tiles/range?{span}&fmt=bin&res=8",
                     f"/api/tiles/diff?t0={t0 - 300}&t1={t0 + 1}"):
            es, eh, eb, _ = http_get(fport, path)
            ts_, th, tb, _ = http_get(sport, path)
            if (es, eb) != (ts_, tb) or (
                    "ETag" in eh and etag_shape(eh["ETag"])
                    != etag_shape(th["ETag"])):
                raise AssertionError(f"{path}: the thread-core replica's "
                                     f"body differs from the epoll one's")
            same.append(path)
        out["thread_equals_epoll"] = same
        # both workers answered: the pids that reached the final seq
        if len(pids) != 2:
            raise AssertionError(f"fleet workers seen: {pids}")
        # the feed and the history tier
        st = thist.compaction_status(hist)
        n_seg, seg_bytes = dir_bytes(f"{hist}/log/seg-*.jsonl")
        n_live, live_bytes = dir_bytes(f"{feed}/seg-*.jsonl")
        n_snap, snap_bytes = dir_bytes(f"{hist}/log/snap-*.json")
        out["feed"] = {"records": seq, "segments": n_seg + n_live,
                       "rotations": n_seg + n_live - 1,
                       "bytes": seg_bytes + live_bytes,
                       "snapshots": n_snap, "snapshot_bytes": snap_bytes,
                       "seg_bytes_knob": cfg.repl_seg_bytes}
        # the chunks decode to the view's window: every cell, every event
        import glob

        docs = {}
        for path in glob.glob(f"{hist}/chunks/*.hst"):
            with open(path, "rb") as fh:
                _, windows = thist.decode_chunk(fh.read())
            for part in windows.values():
                for d in part["docs"]:
                    docs[d["cellId"]] = d["count"]
        counts = {c: f["properties"]["count"] for c, f in feats.items()}
        if docs != counts:
            raise AssertionError(f"the chunks hold {len(docs)} cells, "
                                 f"the view {len(counts)}")
        blk = comp.member_block()
        busy = [(t, n) for t, n in steps if n]
        out["compactor"] = {
            "chunks": st["chunks"], "chunk_bytes": st["chunk_bytes"],
            "chunk_writes": blk["chunk_writes"],
            "records": blk["records"], "steps": len(steps),
            "busy_steps": len(busy),
            "s_per_segment": (sum(t for t, _ in busy)
                              / max(1, n_seg + n_live)),
            "busy_step_s_max": max((t for t, _ in busy), default=0.0),
            "decoded_equal_view": True,
            # the digests need an audited feed (HEATMAP_AUDIT, ROADMAP A6)
            "digest_verified": blk["verified"],
            "mismatches": blk["mismatches"]}
        if not st["chunks"] or blk["mismatches"]:
            raise AssertionError(f"compactor: {out['compactor']}")
        out["phase_wall_s"] = time.monotonic() - t_phase
        return out
    finally:
        if follower is not None:
            follower._stop.set()
        if probe is not None:
            probe._stop.set()
        for proc in procs:
            stop_process(proc)
        stop_background(httpd, thread)
        del rt, store
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def phase_repl(torch, snap_kernel, ckpt_root, dev, serve):
    """synthetic_backfill with the feed, the history tier, the replica
    fleet and a delta client: its checks and numbers, its events/s and p50
    batch beside the serve phase's view-on runs (the same call, the same
    card)."""
    out = {"phase": "repl", "source": dict(SERVE_SOURCE, t0="now-aligned"),
           **repl_run(torch, snap_kernel, f"{ckpt_root}/repl", dev)}
    on = [r for r, k in zip(serve["runs"], SERVE_RUNS)
          if k == (True, False, None)]
    out["view_on_serve_phase"] = {
        "events_per_s": [r["events_per_s"] for r in on],
        "p50_batch_ms": [r["p50_batch_ms"] for r in on]}
    out["events_per_s_vs_view_on"] = [out["events_per_s"] / r["events_per_s"]
                                      for r in on]
    emit(out)
    return out


# the obs phase: the run's own introspection (ROADMAP A6a) over the serve
# phase's deployment, with its knobs off and then on
OBS_PROFILE_SKIP = 4        # the profiler window: batches 4..7
OBS_PROFILE_BATCHES = 4
# the trace record's keys (heatmap_tpu/stream/runtime.py::tracering.record)
TRACE_KEYS = {"seq", "epoch", "t_wall", "latency_ms", "spans_ms", "n_events",
              "n_late", "overflow_groups", "late_dropped"}
# the flight record's top-level keys on the reference's single-device path
FLIGHT_KEYS = {"reason", "t_wall", "pid", "trace_tail", "lineage_tail",
               "metrics", "config", "run_state", "audit", "quality",
               "runtimeinfo", "stacks"}


def obs_env(tmp):
    """The knobs of the instrumented run."""
    return {"HEATMAP_TRACE_JSONL": f"{tmp}/trace.jsonl",
            "HEATMAP_FLIGHTREC_ALWAYS": "1",
            "HEATMAP_PROFILE_DIR": f"{tmp}/prof",
            "HEATMAP_PROFILE_SKIP": str(OBS_PROFILE_SKIP),
            "HEATMAP_PROFILE_BATCHES": str(OBS_PROFILE_BATCHES),
            "HEATMAP_SLO_WATCHDOG_S": "1"}


def profile_window(torch, dev, prof_dir, batches):
    """The profiler window's one Chrome-trace file: its kernel events
    named after the snap kernel, and the batches annotated in it."""
    files = sorted(os.listdir(prof_dir))
    if len(files) != 1 or not files[0].endswith(".pt.trace.json"):
        raise AssertionError(f"profiler window wrote {files}")
    with open(os.path.join(prof_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    snaps = [e for e in events if e.get("cat") == "kernel"
             and "snap_cell_kernel" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    annotated = sorted({e["name"] for e in events
                        if str(e.get("name", "")).startswith("microbatch#")})
    want = [f"microbatch#{OBS_PROFILE_SKIP + i}" for i in range(batches)]
    if sorted(annotated, key=lambda s: int(s.split("#")[1])) != want:
        raise AssertionError(f"profiler window annotated {annotated}")
    want_snaps = batches if dev.type == "cuda" else 0
    if len(snaps) != want_snaps:
        raise AssertionError(
            f"profiler window holds {len(snaps)} snap_cell kernel events "
            f"({len(kernels)} kernel events in all) for {batches} batches: "
            f"the CUDA activity (CUPTI) did not trace the card")
    return {"file": files[0], "bytes": os.path.getsize(
                os.path.join(prof_dir, files[0])),
            "snap_kernel_events": len(snaps), "kernel_events": len(kernels),
            "snap_kernel_us": [e.get("dur") for e in snaps],
            "batches_annotated": annotated}


def obs_run(torch, snap_kernel, ckpt_dir, dev, on: bool, t0: int):
    """synthetic_backfill at its preset widths from ``t0`` (the serve
    phase's shift, one for both runs), the writer's app attached; ``on`` sets the introspection knobs (trace
    export, flight recorder with HEATMAP_FLIGHTREC_ALWAYS, a profiler
    window, a 1 s watchdog) and reads /debug/stacks once before the run.
    Returns the run's numbers, checks and docs."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.obs.lineage import STAGES
    from heatmap_tpu_torch.serve import start_background, stop_background
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    tmp = f"{ckpt_dir}/obs"
    os.makedirs(tmp)
    env = obs_env(tmp) if on else {}
    saved = {k: os.environ.get(k) for k in obs_env(tmp)}
    for k in saved:
        os.environ.pop(k, None)
    os.environ.update(env)
    p = get_pipeline("synthetic_backfill")
    cfg = dataclasses.replace(p.config, checkpoint_dir=f"{ckpt_dir}/ck",
                              serve_port=0,
                              flightrec_dir=f"{tmp}/fr" if on else "")
    store = MemoryStore()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        rt = MicroBatchRuntime(cfg, SyntheticSource(t0=t0, **SERVE_SOURCE),
                               store, device=dev)
        httpd, thread, port = start_background(store, cfg, rt)
        try:
            if on:
                status, _, b, _ = http_get(port, "/debug/stacks?n=5")
                if status != 200 or not json.loads(b)["running"]:
                    raise AssertionError(f"/debug/stacks: {status} {b}")
            snap_kernel.latlng_to_cell_kernel.launches = 0
            t_start = time.monotonic()
            rt.run()
            wall = time.monotonic() - t_start
            launches = snap_kernel.latlng_to_cell_kernel.launches
            metrics_json = json.loads(http_get(port, "/metrics.json")[2])
            traces = json.loads(http_get(
                port, "/trace/recent?n=1024")[2])["traces"]
            fresh = json.loads(http_get(port, "/debug/freshness?n=256")[2])
            status, _, hb, _ = http_get(port, "/healthz")
            health = json.loads(hb)
            text = http_get(port, "/metrics")[2].decode()
        finally:
            stop_background(httpd, thread)
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    m = rt.metrics
    n = m["batches"]
    want = n if dev.type == "cuda" else 0
    if launches != want or m["events_valid"] != MAIN_EVENTS:
        raise AssertionError(f"obs run (on {on}): {launches} snap launches "
                             f"in {n} batches, {m['events_valid']} events")
    # one trace record a batch, with the reference's keys, in the ring, at
    # /trace/recent and (on) in the JSONL export
    recs = rt.tracering.recent(1024)
    bad = [r for r in traces if set(r) != TRACE_KEYS]
    if len(recs) != n or len(traces) != n or bad:
        raise AssertionError(f"{len(recs)} trace records, {len(traces)} at "
                             f"/trace/recent, for {n} batches; keys "
                             f"{sorted(set(bad[0])) if bad else None}")
    if on:
        with open(f"{tmp}/trace.jsonl") as fh:
            lines = [json.loads(x) for x in fh]
        if [x["epoch"] for x in lines] != list(range(n)):
            raise AssertionError(f"the JSONL export holds {len(lines)} "
                                 f"records for {n} batches")
    # every closed lineage record crosses every stage (the view is on)
    recs_l = fresh["records"]
    if (len(recs_l) != n or any(set(r["stages"]) != set(STAGES)
                                for r in recs_l)
            or sum(r["n_events"] for r in recs_l) != MAIN_EVENTS
            or "event_age_p50_s" not in fresh["summary"]):
        raise AssertionError(f"/debug/freshness: {len(recs_l)} records, "
                             f"summary {fresh['summary']}")
    # the batches outside the profiler window (epochs 4-7): their step
    # times and the events they folded
    outside = [i for i in range(n) if not OBS_PROFILE_SKIP <= i
               < OBS_PROFILE_SKIP + OBS_PROFILE_BATCHES]
    n_ev = {r["epoch"]: r["n_events"] for r in recs}
    out = {"on": on, "events": m["events_valid"], "batches": n,
           "wall_s": wall, "events_per_s": m["events_valid"] / wall,
           "p50_batch_ms": m["p50_batch_ms"],
           "p50_batch_ms_outside_window": float(np.median(
               [rt.batch_ms[i] for i in outside])),
           "events_per_step_s_outside_window": (
               sum(n_ev[i] for i in outside)
               / (sum(rt.batch_ms[i] for i in outside) / 1e3)),
           "window_batch_ms": rt.batch_ms[
               OBS_PROFILE_SKIP:OBS_PROFILE_SKIP + OBS_PROFILE_BATCHES],
           "snap_launches": launches,
           "p50_span_ms_reference": {
               k[len("span_"):-len("_p50_ms")]: v
               for k, v in metrics_json.items()
               if k.startswith("span_") and k.endswith("_p50_ms")},
           "batch_latency_p50_ms": metrics_json["batch_latency_p50_ms"],
           "event_age_p50_s": fresh["summary"]["event_age_p50_s"],
           "freshness_p50_s": metrics_json.get("freshness_p50_s"),
           "trace_records": len(recs), "lineage_records": len(recs_l),
           "healthz": {"status": health["status"],
                       "checks": health["checks"]}}
    # compiles: builds or loads during a wrapped step (the kernels were
    # loaded by the earlier phases, so none is expected here)
    out["compile_total"] = sum(
        c.value for c in rt.registry._families[
            "heatmap_compile_total"].children.values())
    if dev.type == "cuda":
        # the watermark reads the allocator's peak: one more sample after
        # the close sees the peak torch.cuda.max_memory_allocated reports
        rt.runtimeinfo.memory.sample()
        wm = rt.registry._families[
            "heatmap_device_hbm_watermark_bytes"].labels(
                device=str(dev.index)).value
        peak = torch.cuda.max_memory_allocated(dev)
        if wm != peak:
            raise AssertionError(f"heatmap_device_hbm_watermark_bytes "
                                 f"{wm} != max_memory_allocated {peak}")
        out["hbm_watermark_bytes"] = wm
        out["max_memory_allocated"] = peak
        out["exposition_has_watermark"] = (
            f'heatmap_device_hbm_watermark_bytes{{device="{dev.index}"}}'
            in text)
    if on:
        out["profile"] = profile_window(torch, dev, f"{tmp}/prof",
                                        OBS_PROFILE_BATCHES)
        dumps = []
        for name in sorted(os.listdir(f"{tmp}/fr")):
            with open(f"{tmp}/fr/{name}") as fh:
                dumps.append(json.load(fh))
        close = [d for d in dumps if d["reason"].startswith("clean close")]
        watch = [d for d in dumps if "healthz" in d]
        wd = rt.slo_watchdog.n_captures
        if (len(close) != 1 or set(close[0]) != FLIGHT_KEYS
                or len(watch) != wd or wd > 1
                or len(dumps) != len(close) + len(watch)):
            raise AssertionError(
                f"flight records: {[d['reason'] for d in dumps]}, keys "
                f"{sorted(close[0]) if close else None}, {wd} watchdog "
                f"captures")
        out["flight_records"] = {
            "close_keys": sorted(close[0]),
            "watchdog_dumps": [{"reason": d["reason"],
                                "healthz_status": d["healthz"]["status"]}
                               for d in watch]}
    docs = (dict(store._tiles), dict(store._positions))
    del rt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, docs


# the obs phase's runs, back to back: the knobs off, then on (the serve
# phase's two view-on runs, the same deployment without the app, give the
# spread between runs in the same call)
OBS_RUNS = (False, True)


def phase_obs(torch, snap_kernel, ckpt_root, dev):
    """synthetic_backfill with the introspection knobs off, then on, back
    to back on the same card: events/s and p50 batch of each
    (outside the profiler window too), the reference spans' p50s, one
    trace record a batch, closed lineage records, the profiler window's
    snap_cell kernel events, the HBM watermark against the allocator's
    peak, the flight records; the on run's docs equal to the off run's."""
    t0 = (int(time.time()) // 300 - 1) * 300
    runs, docs = [], []
    for i, on in enumerate(OBS_RUNS):
        r, d = obs_run(torch, snap_kernel, f"{ckpt_root}/obs{i}", dev, on,
                       t0)
        runs.append(r)
        docs.append(d)
        if d != docs[0]:
            raise AssertionError(f"obs run {i} (on {on}): its docs differ "
                                 f"from the first run's")
    out = {"phase": "obs", "source": dict(SERVE_SOURCE, t0="now-aligned"),
           "runs": runs, "docs_equal": True}
    for label, on in (("off", False), ("on", True)):
        mine = [r for r in runs if r["on"] == on]
        out[f"events_per_s_{label}"] = [r["events_per_s"] for r in mine]
        out[f"p50_batch_ms_outside_window_{label}"] = [
            r["p50_batch_ms_outside_window"] for r in mine]
    emit(out)
    return out


def obs_pairs(torch, snap_kernel, dev, n_pairs: int) -> None:
    """The obs phase's runs in ``n_pairs`` pairs after an uncounted warm
    run, each pair's order the other's reverse (off, on, then on, off,
    ...): every run's line, then
    the medians of each side, so the layer's cost is read against the
    spread between runs of one side in the same call."""
    t0 = (int(time.time()) // 300 - 1) * 300
    root = tempfile.mkdtemp(prefix="chip_smoke-obs-")
    runs = []
    try:
        # a first run, not counted: it loads the kernels and warms the
        # allocator, which the whole smoke run's earlier phases do
        obs_run(torch, snap_kernel, f"{root}/warm", dev, False, t0)
        for i in range(2 * n_pairs):
            on = (i % 2 == 0) == (i // 2 % 2 == 1)
            r, _ = obs_run(torch, snap_kernel, f"{root}/r{i}", dev, on, t0)
            emit({"obs_pair_run": i, **{k: r[k] for k in (
                "on", "events_per_s", "events_per_step_s_outside_window",
                "p50_batch_ms", "p50_batch_ms_outside_window",
                "window_batch_ms")}})
            runs.append(r)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"obs_pairs": n_pairs}
    for label, on in (("off", False), ("on", True)):
        mine = [r for r in runs if r["on"] == on]
        for k in ("events_per_s", "events_per_step_s_outside_window",
                  "p50_batch_ms_outside_window"):
            vals = sorted(r[k] for r in mine)
            out[f"{k}_{label}"] = {"median": float(np.median(vals)),
                                   "min": vals[0], "max": vals[-1]}
    emit(out)


# the quality phase: the depth of the infer phase; the budget window that
# scales default_rules' fast pair to 2 s / 10 s at a 1 s scrape
QUALITY_BATCHES = INFER_BATCHES
QUALITY_HORIZONS = (1, 2, 4)
QUALITY_SCRAPE_S = 1.0
QUALITY_FLUSH_S = 3.0
QUALITY_BUDGET_WINDOW_S = 7200.0


class ForecastClient:
    """A client asking /api/tiles/forecast at each of QUALITY_HORIZONS
    every ~200 ms, as a dashboard polling the forecast would."""

    def __init__(self, port):
        import threading

        self.port = port
        self.n = 0
        self.ms: list = []
        self.error = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="forecast-client")

    def _run(self):
        try:
            while not self._stop.is_set():
                for h in QUALITY_HORIZONS:
                    status, _, body, ms = http_get(
                        self.port, f"/api/tiles/forecast?h={h}")
                    if status != 200:
                        raise AssertionError(f"forecast h={h}: {status} "
                                             f"{body[:200]}")
                    self.n += 1
                    self.ms.append(ms)
                self._stop.wait(0.2)
        except BaseException as e:  # surfaced by stop()
            self.error = e

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=300)
        if self._thread.is_alive():
            raise AssertionError("the forecast client did not stop")
        if self.error is not None:
            raise AssertionError("the forecast client failed") from self.error


def quality_run(torch, snap_kernel, kalman, ckpt_dir, dev, on: bool,
                t0: int):
    """synthetic_backfill with the kalman reducer for QUALITY_BATCHES
    batches from ``t0``, the writer's app attached and a ForecastClient on
    it; ``on`` sets the telemetry history, the SLO engine, the quality
    observatory and the flight recorder.  The on run folds its first batch
    only once the recorder has taken a verdict, so the timeline starts
    from the run's ok state.  Returns the run's numbers and docs."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.obs.tsdb import TsdbReader
    from heatmap_tpu_torch.serve import start_background, stop_background
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    tmp = f"{ckpt_dir}/quality"
    os.makedirs(tmp)
    p = get_pipeline("synthetic_backfill")
    cfg = dataclasses.replace(p.config, checkpoint_dir=f"{ckpt_dir}/ck",
                              serve_port=0, reducers=("count", "kalman"))
    if on:
        cfg = dataclasses.replace(
            cfg, tsdb=True, tsdb_dir=f"{tmp}/tsdb",
            tsdb_scrape_s=QUALITY_SCRAPE_S, tsdb_flush_s=QUALITY_FLUSH_S,
            slo_budget_window_s=QUALITY_BUDGET_WINDOW_S, quality=True,
            quality_mature_s=0.0, flightrec_dir=f"{tmp}/fr")
    n_events = QUALITY_BATCHES * cfg.batch_size
    source = dict(SERVE_SOURCE, n_events=n_events)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, SyntheticSource(t0=t0, **source), store,
                           device=dev)
    scrape_s: list = []
    if on:
        # every scrape's own seconds, beside the histogram it feeds
        fam = rt.tsdb._m_scrape
        observe = fam.observe
        fam.observe = lambda v: (scrape_s.append(v), observe(v))
        deadline = time.monotonic() + 30
        while not rt.tsdb._hz:
            if time.monotonic() > deadline:
                raise AssertionError("the recorder took no verdict in 30 s")
            time.sleep(0.05)
    httpd, thread, port = start_background(store, cfg, rt)
    client = ForecastClient(port)
    try:
        client.start()
        kalman.kalman_rounds.launches = 0
        snap_kernel.latlng_to_cell_kernel.launches = 0
        t_start = time.monotonic()
        try:
            rt.run()
        finally:
            client.stop()
        wall = time.monotonic() - t_start
        launches = snap_kernel.latlng_to_cell_kernel.launches
        k_launches = kalman.kalman_rounds.launches
        m = rt.metrics
        n = m["batches"]
        want = n if dev.type == "cuda" else 0
        if (launches != want or k_launches != want
                or n != QUALITY_BATCHES or m["events_valid"] != n_events):
            raise AssertionError(
                f"quality run (on {on}): {launches} snap and {k_launches} "
                f"kalman launches in {n} batches, {m['events_valid']} "
                f"events")
        out = {"on": on, "events": m["events_valid"], "batches": n,
               "wall_s": wall, "events_per_s": m["events_valid"] / wall,
               "p50_batch_ms": m["p50_batch_ms"],
               "p50_infer_ms": m["p50_span_ms"]["infer"],
               "snap_launches": launches, "kalman_launches": k_launches,
               "forecasts": client.n,
               "forecast_p50_ms": float(np.median(client.ms))}
        if on:
            out.update(quality_checks(rt, port, cfg, scrape_s, tmp,
                                      TsdbReader))
        else:
            for path in ("/debug/quality", "/debug/timeline",
                         "/fleet/timeline"):
                status = http_get(port, path)[0]
                if status != 503:
                    raise AssertionError(f"{path} answered {status} with "
                                         f"the knobs off")
    finally:
        stop_background(httpd, thread)
    docs = (dict(store._tiles), dict(store._positions))
    del rt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out, docs


def quality_checks(rt, port, cfg, scrape_s, tmp, TsdbReader):
    """The on run's gates and numbers: the scorecard identity, the blocks
    read back, the timeline's degraded transition and freshness alert,
    the flight record's slo-burn reason."""
    import glob
    from collections import Counter

    q = json.loads(http_get(port, "/debug/quality")[2])
    ident = rt.quality.identity()
    if not ident["ok"] or ident["scored"] < 1 or q["scorecards"] != ident:
        raise AssertionError(f"scorecards: {ident}, /debug/quality "
                             f"{q['scorecards']}")
    tag = rt.tsdb.tag
    reader = TsdbReader(cfg.tsdb_dir)
    blocks = reader.blocks(tag)
    held = reader.series(tag, names=["heatmap_tsdb_scrapes_total"])
    if reader.members() != [tag] or not blocks or not held:
        raise AssertionError(f"tsdb: members {reader.members()}, "
                             f"{len(blocks)} blocks, {list(held)}")
    tl = json.loads(http_get(port, "/debug/timeline")[2])
    entries = tl["entries"]
    degraded = [e for e in entries if e["kind"] == "healthz"
                and e["to"] == "degraded"]
    fired = [e for e in entries if e["kind"] == "slo_alert"
             and e["slo"] == "freshness_p50"]
    if tl["member"] != tag or not degraded or not fired:
        raise AssertionError(f"/debug/timeline of {tl['member']}: "
                             f"{Counter(e['kind'] for e in entries)}")
    burns = []
    for name in sorted(os.listdir(f"{tmp}/fr")):
        with open(f"{tmp}/fr/{name}") as fh:
            reason = json.load(fh)["reason"]
        if reason.startswith("slo-burn:"):
            burns.append(reason)
    if "slo-burn:freshness_p50:fast" not in burns:
        raise AssertionError(f"flight records' slo-burn reasons: {burns}")
    with rt.tsdb._lock:
        series = len(rt.tsdb._rings)
        points = sum(len(r) for r in rt.tsdb._rings.values())
    blk = rt.quality.member_block()
    hist = rt.registry._families["heatmap_tsdb_scrape_seconds"]
    return {
        "tsdb_scrapes": len(scrape_s),
        "tsdb_scrape_s": {"p50": float(np.median(scrape_s)),
                          "max": max(scrape_s),
                          "histogram_p50": hist.quantile(0.5)},
        "tsdb_series": series, "tsdb_points": points,
        "tsdb_blocks": len(blocks),
        "tsdb_block_files_bytes": dir_bytes(os.path.join(
            glob.escape(cfg.tsdb_dir), glob.escape(tag), "block-*.json")),
        "scorecards": ident, "skill": blk["skill"], "nis": blk["nis"],
        "anomaly_rate": blk["anomaly_rate"],
        "timeline_kinds": dict(Counter(e["kind"] for e in entries)),
        "first_degraded": {k: degraded[0][k] for k in ("t", "failing")},
        "freshness_alert": {k: fired[0][k] for k in (
            "t", "rule", "burn_short", "burn_long", "value")},
        "slo_burn_reasons": burns,
        "healthz_failing": sorted(
            k for k, c in json.loads(http_get(port, "/healthz")[2])[
                "checks"].items() if not c.get("ok", True)),
    }


def phase_quality(torch, snap_kernel, ckpt_root, dev):
    """synthetic_backfill with the kalman reducer, the time machine and the
    observatory off, then on, back to back on the same card; the two runs'
    docs equal; events/s of each and the on/off ratio, the recorder's and
    the observatory's numbers from the on run."""
    from heatmap_tpu_torch.infer import kalman

    t0 = (int(time.time()) // 300 - 1) * 300
    runs, docs = [], []
    for i, on in enumerate((False, True)):
        r, d = quality_run(torch, snap_kernel, kalman,
                           f"{ckpt_root}/quality{i}", dev, on, t0)
        runs.append(r)
        docs.append(d)
    if docs[1] != docs[0]:
        raise AssertionError("the quality phase's on run's docs differ "
                             "from the off run's")
    out = {"phase": "quality",
           "source": dict(SERVE_SOURCE, t0="now-aligned",
                          n_events=runs[0]["events"]),
           "budget_window_s": QUALITY_BUDGET_WINDOW_S,
           "scrape_s": QUALITY_SCRAPE_S, "flush_s": QUALITY_FLUSH_S,
           "runs": runs, "docs_equal": True,
           "events_per_s_on_over_off": (runs[1]["events_per_s"]
                                        / runs[0]["events_per_s"])}
    emit(out)
    return out


def quality_pairs(torch, snap_kernel, dev, n_pairs: int) -> None:
    """The quality phase's runs in ``n_pairs`` pairs after an uncounted
    warm run, each pair's order the other's reverse, as ``obs_pairs``
    does: every run's line, then the medians of each side."""
    from heatmap_tpu_torch.infer import kalman

    t0 = (int(time.time()) // 300 - 1) * 300
    root = tempfile.mkdtemp(prefix="chip_smoke-quality-")
    runs = []
    keys = ("on", "events_per_s", "p50_batch_ms", "p50_infer_ms",
            "forecasts", "forecast_p50_ms")
    try:
        quality_run(torch, snap_kernel, kalman, f"{root}/warm", dev, False,
                    t0)
        for i in range(2 * n_pairs):
            on = (i % 2 == 0) == (i // 2 % 2 == 1)
            r, _ = quality_run(torch, snap_kernel, kalman, f"{root}/r{i}",
                               dev, on, t0)
            line = {"quality_pair_run": i, **{k: r[k] for k in keys}}
            if on:
                line.update({k: r[k] for k in (
                    "tsdb_scrapes", "tsdb_scrape_s", "tsdb_series",
                    "scorecards")})
            emit(line)
            runs.append(r)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"quality_pairs": n_pairs}
    for label, on in (("off", False), ("on", True)):
        mine = [r for r in runs if r["on"] == on]
        for k in ("events_per_s", "p50_batch_ms", "p50_infer_ms"):
            vals = sorted(r[k] for r in mine)
            out[f"{k}_{label}"] = {"median": float(np.median(vals)),
                                   "min": vals[0], "max": vals[-1]}
    out["events_per_s_on_over_off_medians"] = (
        out["events_per_s_on"]["median"] / out["events_per_s_off"]["median"])
    emit(out)


PAIRS = {"obs": obs_pairs, "quality": quality_pairs}


def main(argv=()) -> int:
    """The whole smoke run; ``obs N`` / ``quality N`` run the build and
    ``obs_pairs`` / ``quality_pairs`` with N pairs instead (a measurement
    of that phase's knobs)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv and (len(argv) != 2 or argv[0] not in PAIRS):
        print("usage: chip_smoke.py [obs|quality N_PAIRS]", file=sys.stderr)
        return 2
    from heatmap_tpu_torch import _build
    from heatmap_tpu_torch.hexgrid import snap_kernel
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.stream.__main__ import run_pipeline

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    phase_build(_build)
    if argv:
        PAIRS[argv[0]](torch, snap_kernel, dev, int(argv[1]))
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
        print(smi.stdout.strip().splitlines()[0], flush=True)
        return 0
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
        formats = phase_formats(torch, run_pipeline, snap_kernel, ckpt_root,
                                dev)
        infer = phase_infer(torch, run_pipeline, snap_kernel, ckpt_root, dev)
        serve = phase_serve(torch, snap_kernel, ckpt_root, dev)
        repl = phase_repl(torch, snap_kernel, ckpt_root, dev, serve)
        obs = phase_obs(torch, snap_kernel, ckpt_root, dev)
        quality = phase_quality(torch, snap_kernel, ckpt_root, dev)
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
        "launches_formats_phase": {
            k: v["snap_launches"] for k, v in formats["runs"].items()},
        "launches_infer_phase": infer["snap_launches"],
        "launches_serve_phase": [r["snap_launches"] for r in serve["runs"]],
        "launches_repl_phase": repl["snap_launches"],
        "launches_obs_phase": [r["snap_launches"] for r in obs["runs"]],
        "launches_quality_phase": [r["snap_launches"]
                                   for r in quality["runs"]],
        "obs_profile_window_kernel_events": [
            r["profile"]["snap_kernel_events"] for r in obs["runs"]
            if r["on"]],
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
        "launches_quality_phase": [r["kalman_launches"]
                                   for r in quality["runs"]],
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
        "edge_sets": {name: {k: v[k] for k in (
            "k", "m", "ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err") if k in v}
            for name, v in infer["edge_sets"].items()},
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
    sys.exit(main(sys.argv[1:]))
