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
them, its wall seconds and the kernels' launches) as one JSON line.  Every run that must not resume another's commits
needs its own ``CHECKPOINT``.

The live pipelines (``mbta_default``, ``opensky_global``, ``hex_pyramid``,
``multi_window``) read the Kafka topic ``KAFKA_TOPIC`` at
``KAFKA_BOOTSTRAP`` from its LATEST offsets, or, when no broker answers,
an unbounded synthetic stream; they run until ``--max-batches`` batches
are folded (or forever).  ``synthetic_backfill`` ends with its 10M events.
Runs on the CUDA device unless ``--device cpu`` is given; with no CUDA
device and no ``--device cpu`` it raises.

``--supervise`` runs the job as a child of a supervisor
(``stream.supervisor``), which restarts it from its checkpoint when it
crashes or when its heartbeat stalls; ``--supervise --shards N`` runs N
H3-partitioned shard children (``HEATMAP_SHARDS``, ``HEATMAP_SHARD_INDEX``
set per child), each folding a disjoint cell space.  The policy comes from
``HEATMAP_SUPERVISE_*``.  The supervising parent imports no ``torch`` and
touches no device; each child runs with the parent's ``--device`` and
``--max-batches``.

With ``HEATMAP_FLIGHTREC_DIR`` set, SIGTERM becomes ``SystemExit(143)``
in the main thread, so the runtime's close sees the unwinding exit and
writes its flight record, and an ``atexit`` hook dumps for an exit that
bypasses the close.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

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
    ap.add_argument("--supervise", action="store_true",
                    help="run the job as a supervised child: restart on "
                         "crash and on heartbeat stall, resuming from the "
                         "checkpoint; policy via HEATMAP_SUPERVISE_* "
                         "(stream/supervisor.py)")
    ap.add_argument("--shards", type=int, default=None,
                    help="with --supervise: fan out N H3-partitioned "
                         "runtime shard children (stream/shardmap.py), "
                         "each folding a disjoint cell space into the "
                         "shared store; defaults to HEATMAP_SHARDS (1)")
    args = ap.parse_args(argv)
    shards = (args.shards if args.shards is not None
              else int(os.environ.get("HEATMAP_SHARDS", "1") or 1))
    if args.shards is not None and args.shards > 1 and not args.supervise:
        # only the supervisor fans out a fleet; one shard of a fleet run
        # by hand is configured with HEATMAP_SHARDS + HEATMAP_SHARD_INDEX
        raise SystemExit("--shards needs --supervise (the fleet "
                         "supervisor spawns one child per shard)")
    if args.shards == 1 and args.supervise:
        # an explicit --shards 1 wins over an inherited fleet env: the
        # single-child supervisor passes the env through unchanged
        os.environ["HEATMAP_SHARDS"] = "1"
        os.environ["HEATMAP_SHARD_INDEX"] = "0"
    if args.supervise:
        # the parent runs no device op: each child reaches the card
        import logging
        import sys

        from heatmap_tpu_torch.stream.supervisor import supervise_cli

        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s %(message)s")
        child = [sys.executable, "-m", "heatmap_tpu_torch.stream",
                 args.pipeline, "--device", args.device]
        if args.max_batches is not None:
            child += ["--max-batches", str(args.max_batches)]
        raise SystemExit(supervise_cli(child, shards=shards))
    from heatmap_tpu_torch.sink import make_store

    store = make_store(get_pipeline(args.pipeline).config)
    try:
        rt, _ = build_runtime(args.pipeline, args.device, store=store)
        install_flightrec_handlers(rt)
        from heatmap_tpu_torch.hexgrid import snap_kernel
        from heatmap_tpu_torch.infer import kalman

        # the launches of the run alone: construction may launch too (the
        # governor's ladder warm-up dispatches once a bucket)
        snap_kernel.latlng_to_cell_kernel.launches = 0
        kalman.kalman_rounds.launches = 0
        t0 = time.monotonic()
        rt.run(max_batches=args.max_batches)
        out = {"pipeline": args.pipeline, "device": str(rt.device),
               "source": type(rt.source).__name__,
               "store": type(store).__name__,
               # the run's wall seconds (construction excluded, the close
               # included) and the kernels' launches in it
               "wall_s": time.monotonic() - t0,
               "snap_launches": snap_kernel.latlng_to_cell_kernel.launches,
               "kalman_launches": kalman.kalman_rounds.launches,
               "shard_index": rt.cfg.shard_index, "shards": rt.cfg.shards,
               **rt.metrics,
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
