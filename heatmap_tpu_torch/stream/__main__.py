"""Streaming job: ``python -m heatmap_tpu_torch.stream [pipeline]``.

Consumes the pipeline's source, folds it on the device and upserts the
tile docs into an in-memory store, committing checkpoints to the
directory that ``CHECKPOINT`` names (default ``heatmap-checkpoint`` under
the temp directory, ``TMPDIR``, read with the rest of the environment when
the pipelines are built) and resuming from its latest commit; then prints
the run's metrics (the source's transport counters among them) as one JSON
line.  Every run that must not resume another's commits needs its own
``CHECKPOINT``.

The live pipelines (``mbta_default``, ``opensky_global``, ``hex_pyramid``,
``multi_window``) read the Kafka topic ``KAFKA_TOPIC`` at
``KAFKA_BOOTSTRAP`` from its LATEST offsets, or, when no broker answers,
an unbounded synthetic stream; they run until ``--max-batches`` batches
are folded (or forever).  ``synthetic_backfill`` ends with its 10M events.
Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from heatmap_tpu_torch.models.pipelines import PIPELINES, get_pipeline


def run_pipeline(name: str, max_batches: int | None = None,
                 device: str = "cuda", checkpoint_dir: str | None = None,
                 checkpoint_every: int = 20, source=None, **overrides):
    """Run pipeline ``name`` into a fresh MemoryStore; returns
    (runtime, store).  ``checkpoint_dir`` and ``overrides`` (Config
    fields, e.g. ``kafka_bootstrap``) replace the pipeline's settings
    (which came from the environment when the pipelines were built);
    ``source`` replaces the pipeline's own source."""
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline(name)
    cfg = p.config
    if checkpoint_dir is not None:
        overrides["checkpoint_dir"] = checkpoint_dir
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, source if source is not None
                           else p.make_source(cfg), store, device=device,
                           checkpoint_every=checkpoint_every)
    rt.run(max_batches=max_batches)
    return rt, store


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pipeline", nargs="?", default="synthetic_backfill",
                    choices=sorted(PIPELINES))
    ap.add_argument("--max-batches", type=int, default=None,
                    help="stop after this many folded batches (bounds the "
                         "live pipelines' unbounded sources)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    rt, store = run_pipeline(args.pipeline, args.max_batches, args.device)
    out = {"pipeline": args.pipeline, "device": str(rt.device),
           "source": type(rt.source).__name__,
           **rt.metrics, "tiles": store.n_tiles}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
