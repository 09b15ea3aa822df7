"""Where a batch of the ``synthetic_backfill`` fold spends its time.

    python -m heatmap_tpu_torch.profile_fold [--batches N]

Runs the pipeline on the CUDA device for a few warm-up batches, prints the
runtime's per-batch spans (host clock), the fold's device time (CUDA
events) and the ops one batch issues as one JSON line, then the PyTorch
profiler's table of the ops over two more batches, by device time and by
host time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


def ops_per_batch(rt) -> dict:
    """What one batch (``rt.step_once()``: feed, fold, pull, sink) asks of
    the host: the PyTorch ops it dispatches and the launches of the port's
    own kernels, which no dispatcher sees; ``ops`` is their sum."""
    before = kernel_launches()
    with _CountOps() as count:
        if not rt.step_once():
            raise RuntimeError("the source ran dry before the counted batch")
    launches = kernel_launches() - before
    return {"ops": count.n + launches, "torch_ops": count.n,
            "kernel_launches": launches}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, default=6,
                    help="batches timed by spans (after 2 warm-up)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the profiled batches here")
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile

    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline("synthetic_backfill")
    rt = MicroBatchRuntime(p.config, p.make_source(p.config), MemoryStore(),
                           device="cuda")
    rt.time_device_fold = True
    rt.run(max_batches=2)
    for v in rt.span_ms.values():
        v.clear()
    rt.batch_ms.clear()
    rt.run(max_batches=args.batches)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    m = rt.metrics
    print(json.dumps({"card": smi, "batches": args.batches,
                      "p50_batch_ms": m["p50_batch_ms"],
                      "p50_span_ms": m["p50_span_ms"],
                      "per_batch": ops_per_batch(rt)}), flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.run(max_batches=2)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=30,
                   max_name_column_width=60))
    print(ka.table(sort_by="cpu_time_total", row_limit=20,
                   max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
