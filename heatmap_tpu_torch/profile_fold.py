"""Where a batch of the ``synthetic_backfill`` fold spends its time.

    python -m heatmap_tpu_torch.profile_fold [--batches N]

Runs the pipeline on the CUDA device: two warm-up batches, then N timed
batches, whose per-batch spans (host clock: poll, feed, the emit ring's
flush as pull + sink, the fold's dispatch and its tier-predicate wait),
the fold's device time (CUDA events), tiers and emit pulls it prints as
one JSON line.  Then, after two batches under the PyTorch profiler, one
JSON line from a fresh run: the ops each of its first batches dispatches,
with the fast-path tier it took, and the synchronisations of one steady
batch; then the profiler's table of the ops, by device time and by host
time.  Needs a CUDA device.

    python -m heatmap_tpu_torch.profile_fold --census [--device cpu]

prints instead, batch by batch, the cells and miss events that decide the
fast path's tier (``miss_census``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import traceback
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from heatmap_tpu_torch.engine import step


def kernel_launches() -> int:
    """Launches so far of the port's own kernels: the sum of the
    ``launches`` counters that their wrappers carry."""
    from heatmap_tpu_torch.hexgrid import snap_kernel

    return sum(getattr(f, "launches", 0) for f in vars(snap_kernel).values()
               if callable(f))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _step(rt):
    """One ``rt.step_once()``; raises if the source ran dry."""
    if not rt.step_once():
        raise RuntimeError("the source ran dry before the counted batch")


def _tier_and_flush(rt, fn):
    """Run ``fn``; return the fast-path tier the batch took (None with the
    fast path off) and whether it flushed the emit ring."""
    tiers = dict(step._merge_fastpath.tiers)
    flushes = rt.pulls["flushes"]
    fn()
    taken = [t for t, n in step._merge_fastpath.tiers.items()
             if n != tiers[t]]
    return (taken[0] if taken else None), rt.pulls["flushes"] > flushes


def ops_per_batch(rt) -> dict:
    """What one batch (``rt.step_once()``: feed, a flush if one is due,
    fold) asks of the host: the PyTorch ops it dispatches and the launches
    of the port's own kernels, which no dispatcher sees; ``ops`` is their
    sum.  ``tier`` and ``flushed`` say which path the batch took."""
    before = kernel_launches()
    count = _CountOps()

    def run():
        with count:
            _step(rt)

    tier, flushed = _tier_and_flush(rt, run)
    launches = kernel_launches() - before
    return {"ops": count.n + launches, "torch_ops": count.n,
            "kernel_launches": launches, "tier": tier, "flushed": flushed}


def syncs_per_batch(rt) -> dict:
    """The host-device synchronisations of one CUDA batch, counted under
    ``torch.cuda.set_sync_debug_mode("warn")`` (one warning per
    synchronising call PyTorch makes), beside the fold's predicate reads
    (``step._read_flags``) and the call sites of the warnings."""
    reads = step._read_flags.reads
    sites = []
    in_step = [False]   # count the batch's syncs, not the mode switches'

    def record(message, category, filename, lineno, file=None, line=None):
        if in_step[0] and "synchroniz" in str(message):
            # the Python frames that made the call, innermost first
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            sites.append(" < ".join(
                f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}"
                for f in reversed(frames[-4:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            in_step[0] = True
            tier, flushed = _tier_and_flush(rt, lambda: _step(rt))
        finally:
            in_step[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return {"syncs": len(sites),
            "predicate_reads": step._read_flags.reads - reads,
            "tier": tier, "flushed": flushed, "sites": sites}


def new_runtime():
    """A fresh ``synthetic_backfill`` runtime on the CUDA device."""
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline("synthetic_backfill")
    return MicroBatchRuntime(p.config, p.make_source(p.config),
                             MemoryStore(), device="cuda")


def per_batch_counts(batches: int = 4) -> dict:
    """On a fresh runtime: the ops each of the first ``batches`` batches
    dispatches (each with its tier: the first takes tier 3), then the
    synchronisations of the next one, a steady batch that flushes
    nothing (the ring holds fewer than ``emit_flush_k`` batches)."""
    rt = new_runtime()
    ops = [ops_per_batch(rt) for _ in range(batches)]
    syncs = syncs_per_batch(rt)
    del rt
    torch.cuda.empty_cache()
    return {"ops": ops, "syncs": syncs}


def miss_census(device: str) -> list[dict]:
    """For each ``synthetic_backfill`` batch: its events, distinct cells,
    cells no earlier batch had, the events on those (the fast path's
    misses) and the tier the fast path takes for it, from the snap alone
    (the kernel on CUDA, its plain version on the CPU), in chunks of 2^17
    points.  The stream
    stays in one window and never fills the slab, so a cell is a group."""
    from heatmap_tpu_torch.hexgrid import snap_kernel
    from heatmap_tpu_torch.models.pipelines import get_pipeline

    p = get_pipeline("synthetic_backfill")
    src = p.make_source(p.config)
    budget = max(1024, p.config.batch_size // 16)
    seen = np.zeros(0, np.int64)
    out = []
    while not src.exhausted:
        cols = src.poll(p.config.batch_size)
        keys = []
        for i in range(0, len(cols), 1 << 17):
            lat, lng = (torch.from_numpy(a[i:i + (1 << 17)]).to(device)
                        for a in (cols.lat_rad, cols.lng_rad))
            hi, lo = snap_kernel.latlng_to_cell_kernel(lat, lng,
                                                       p.config.h3_res)
            keys.append(((hi.long() << 32) | (lo.long() & 0xFFFFFFFF))
                        .cpu().numpy())
        k = np.concatenate(keys)
        cells = np.unique(k)
        new = np.setdiff1d(cells, seen)
        miss = int(np.isin(k, new).sum())
        tier = (3 if not len(seen) or miss > budget
                else 1 if not miss else 2)
        out.append({"events": len(cols), "cells": len(cells),
                    "new_cells": len(new), "miss_events": miss,
                    "windows": len(np.unique(cols.ts_s // 300)),
                    "tier": tier})
        seen = np.union1d(seen, cells)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, default=14,
                    help="batches timed by spans (after 2 warm-up)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the profiled batches here")
    ap.add_argument("--census", action="store_true",
                    help="print miss_census() as JSON lines and stop")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the census's device (the profile needs cuda)")
    args = ap.parse_args(argv)
    if args.census:
        for row in miss_census(args.device):
            print(json.dumps(row))
        return
    from torch.profiler import ProfilerActivity, profile

    rt = new_runtime()
    rt.time_device_fold = True
    for _ in range(2):
        _step(rt)
    for v in rt.span_ms.values():
        v.clear()
    rt.batch_ms.clear()
    tiers = dict(step._merge_fastpath.tiers)
    pulls = dict(rt.pulls)
    for _ in range(args.batches):
        _step(rt)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    m = rt.metrics
    mean = lambda xs: float(np.mean(xs)) if xs else None
    print(json.dumps({
        "card": smi, "batches": args.batches,
        "p50_batch_ms": m["p50_batch_ms"],
        "p50_span_ms": m["p50_span_ms"],
        "mean_span_ms": {k: mean(v) for k, v in rt.span_ms.items()},
        "flush_ms": [(p, s) for p, s in zip(rt.span_ms["pull"],
                                            rt.span_ms["sink"]) if p or s],
        "tiers": {t: n - tiers[t]
                  for t, n in step._merge_fastpath.tiers.items()},
        "pulls": {k: v - pulls[k] for k, v in rt.pulls.items()},
    }), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            _step(rt)
        torch.cuda.synchronize()
    rt.close()
    del rt
    torch.cuda.empty_cache()
    print(json.dumps({"per_batch": per_batch_counts()}), flush=True)
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=30,
                   max_name_column_width=60))
    print(ka.table(sort_by="cpu_time_total", row_limit=20,
                   max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
