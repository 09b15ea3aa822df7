"""Streaming job: ``python -m heatmap_tpu_torch.stream [pipeline]``.

Consumes the pipeline's source (default ``mbta_default``, as the
reference's entry point), folds it on the device and, through the runtime's
writer thread, upserts the tile docs and the ``positions_latest`` docs into
the store that ``HEATMAP_STORE`` selects: ``memory``, ``jsonl``
(``<CHECKPOINT>/store.jsonl``), ``mongo`` (``MONGO_URI``, ``MONGO_DB``,
over pymongo or the stdlib wire client), or ``auto`` (Mongo when a server
answers, else memory; the default).  It commits checkpoints to the
directory that ``CHECKPOINT`` names (default ``heatmap-checkpoint`` under
the temp directory, ``TMPDIR``, read with the rest of the environment when
the pipelines are built) and resumes from its latest commit; then prints
the run's metrics (the source's transport counters and the writer's among
them) as one JSON line.  Every run that must not resume another's commits
needs its own ``CHECKPOINT``.

The live pipelines (``mbta_default``, ``opensky_global``, ``hex_pyramid``,
``multi_window``) read the Kafka topic ``KAFKA_TOPIC`` at
``KAFKA_BOOTSTRAP`` from its LATEST offsets, or, when no broker answers,
an unbounded synthetic stream; they run until ``--max-batches`` batches
are folded (or forever).  ``synthetic_backfill`` ends with its 10M events.
Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no ``--device cpu`` it raises.

With ``HEATMAP_FLIGHTREC_DIR`` set, SIGTERM becomes ``SystemExit(143)``
in the main thread, so the runtime's close sees the unwinding exit and
writes its flight record, and an ``atexit`` hook dumps for an exit that
bypasses the close.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from heatmap_tpu_torch.models.pipelines import PIPELINES, get_pipeline


def install_flightrec_handlers(rt) -> None:
    """The flight recorder's process hooks for a standalone job (nothing
    without an armed recorder): SIGTERM raises ``SystemExit(143)`` in the
    main thread, so ``run()``'s finally reaches the runtime's close, which
    sees the unwinding exit and dumps; the ``atexit`` hook dumps for an
    exit that bypasses the close, and does nothing once the close dumped
    or disarmed the recorder."""
    rec = rt.flightrec
    if rec is None:
        return
    import atexit
    import signal

    def _on_term(signum, frame):  # noqa: ARG001
        raise SystemExit(143)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:  # not the main thread (embedded use)
        pass
    atexit.register(
        lambda: rec.dump("atexit: interpreter exit bypassed close()"))


def build_runtime(name: str, device: str = "cuda",
                  checkpoint_dir: str | None = None,
                  checkpoint_every: int = 20, source=None, store=None,
                  **overrides):
    """The runtime of pipeline ``name``, not run yet; returns (runtime,
    store).  ``checkpoint_dir`` and ``overrides`` (Config fields, e.g.
    ``kafka_bootstrap``, ``store``) replace the pipeline's settings (which
    came from the environment when the pipelines were built); ``source``
    replaces the pipeline's own source, and ``store`` the one
    ``make_store`` would build from the config."""
    from heatmap_tpu_torch.sink import make_store
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime

    p = get_pipeline(name)
    cfg = p.config
    if checkpoint_dir is not None:
        overrides["checkpoint_dir"] = checkpoint_dir
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if store is None:
        store = make_store(cfg)
    rt = MicroBatchRuntime(cfg, source if source is not None
                           else p.make_source(cfg), store, device=device,
                           checkpoint_every=checkpoint_every)
    return rt, store


def run_pipeline(name: str, max_batches: int | None = None,
                 device: str = "cuda", **kwargs):
    """Run pipeline ``name`` (``build_runtime``'s arguments); returns
    (runtime, store).  The caller closes the store."""
    rt, store = build_runtime(name, device=device, **kwargs)
    rt.run(max_batches=max_batches)
    return rt, store


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pipeline", nargs="?", default="mbta_default",
                    choices=sorted(PIPELINES))
    ap.add_argument("--max-batches", type=int, default=None,
                    help="stop after this many folded batches (bounds the "
                         "live pipelines' unbounded sources)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from heatmap_tpu_torch.sink import make_store

    store = make_store(get_pipeline(args.pipeline).config)
    try:
        rt, _ = build_runtime(args.pipeline, args.device, store=store)
        install_flightrec_handlers(rt)
        rt.run(max_batches=args.max_batches)
        out = {"pipeline": args.pipeline, "device": str(rt.device),
               "source": type(rt.source).__name__,
               "store": type(store).__name__, **rt.metrics,
               # docs held, where the store keeps them in this process
               # (memory, jsonl); the writer's counters count every store
               "tiles": getattr(store, "n_tiles", None),
               "positions": getattr(store, "n_positions", None)}
    finally:
        store.close()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
