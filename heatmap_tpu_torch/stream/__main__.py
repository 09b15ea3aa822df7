"""Streaming job: ``python -m heatmap_tpu_torch.stream [pipeline]``.

Consumes the pipeline's source, folds it on the device and upserts the
tile docs into an in-memory store, committing checkpoints to the
directory that ``CHECKPOINT`` names (default ``heatmap-checkpoint`` under
the temp directory, ``TMPDIR``, read with the rest of the environment when the pipelines are built) and
resuming from its latest commit; then prints the run's metrics as one JSON
line.  Every run that must not resume another's commits needs its own
``CHECKPOINT``.  Runs on the CUDA device unless ``--device cpu`` is given;
with no CUDA device and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from heatmap_tpu_torch.models.pipelines import PIPELINES, get_pipeline


def run_pipeline(name: str, max_batches: int | None = None,
                 device: str = "cuda", checkpoint_dir: str | None = None):
    """Run pipeline ``name`` into a fresh MemoryStore; returns
    (runtime, store).  ``checkpoint_dir`` replaces the pipeline's
    (which came from ``CHECKPOINT`` when the pipelines were built)."""
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline(name)
    cfg = p.config
    if checkpoint_dir is not None:
        cfg = dataclasses.replace(cfg, checkpoint_dir=checkpoint_dir)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, p.make_source(cfg), store, device=device)
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
