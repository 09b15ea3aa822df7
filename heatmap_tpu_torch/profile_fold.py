"""Where a batch of the ``synthetic_backfill`` fold spends its time.

    python -m heatmap_tpu_torch.profile_fold [--batches N]

Runs the pipeline on the CUDA device for a few warm-up batches, prints the
runtime's per-batch spans (host clock) and the fold's device time (CUDA
events) as one JSON line, then the PyTorch profiler's table of the ops over
two more batches, by device time and by host time.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


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
                      "p50_span_ms": m["p50_span_ms"]}), flush=True)
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
