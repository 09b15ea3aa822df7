"""Streaming job: ``python -m heatmap_tpu_torch.stream [pipeline]``.

Consumes the pipeline's source, folds it on the device and upserts the
tile docs into an in-memory store, then prints the run's metrics as one
JSON line.  Runs on the CUDA device unless ``--device cpu`` is given; with
no CUDA device and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json

from heatmap_tpu_torch.models.pipelines import PIPELINES, get_pipeline


def run_pipeline(name: str, max_batches: int | None = None,
                 device: str = "cuda"):
    """Run pipeline ``name`` into a fresh MemoryStore; returns
    (runtime, store)."""
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline(name)
    store = MemoryStore()
    rt = MicroBatchRuntime(p.config, p.make_source(p.config), store,
                           device=device)
    rt.run(max_batches=max_batches)
    return rt, store


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pipeline", nargs="?", default="synthetic_backfill",
                    choices=sorted(PIPELINES))
    ap.add_argument("--max-batches", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rt, store = run_pipeline(args.pipeline, args.max_batches, args.device)
    out = {"pipeline": args.pipeline, "device": str(rt.device),
           **rt.metrics, "tiles": store.n_tiles}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
