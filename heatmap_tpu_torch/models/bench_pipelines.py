"""Per-config benchmark sweep: every registered pipeline through the
port's streaming runtime (synthetic source -> device fold -> memory
store), one JSON line per config.

``python -m heatmap_tpu_torch.models.bench_pipelines [--events N]
[--batch B] [--pipelines NAME ...] [--device cuda|cpu] [--no-positions]``

The port's copy of ``heatmap_tpu/models/bench_pipelines.py``: each
pipeline's (res, window) topology, histogram bins and range, and slab
size (at least 2^16 rows) over a forced synthetic source (20,000
vehicles, one batch of event time a second), so the sweep needs no
broker.  Each run commits to a fresh checkpoint directory under the temp
directory, removed afterwards.  Runs on the CUDA device unless
``--device cpu`` is given.  ``--no-positions`` turns the runtime's
positions fold off (``positions_enabled=False``, as the reference's
``tools/e2e_rate.py --no-positions`` does), to read what the positions
fold and its writes cost the fold.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time


def bench_one(name: str, n_events: int, batch: int,
              device: str = "cuda", positions: bool = True) -> dict:
    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.models.pipelines import get_pipeline
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    p = get_pipeline(name)
    ckpt = tempfile.mkdtemp(prefix=f"bench-pipelines-{name}-")
    try:
        cfg = load_config(
            {},
            resolutions=p.config.resolutions,
            windows_minutes=p.config.windows_minutes,
            h3_res=p.config.h3_res,
            tile_minutes=p.config.tile_minutes,
            speed_hist_bins=p.config.speed_hist_bins,
            speed_hist_max_kmh=p.config.speed_hist_max_kmh,
            state_capacity_log2=max(p.config.state_capacity_log2, 16),
            batch_size=batch,
            checkpoint_dir=ckpt,
        )
        src = SyntheticSource(n_events=n_events, n_vehicles=20_000,
                              t0=int(time.time()) - 300,
                              events_per_second=batch)
        rt = MicroBatchRuntime(cfg, src, MemoryStore(), device=device,
                               checkpoint_every=0,
                               positions_enabled=positions)
        # warmup outside the timed region: one batch (its events are
        # excluded from the throughput numerator below)
        rt.step_once()
        rt.flush_pending()  # stats are pulled one batch behind the dispatch
        warm = rt.counters["events_valid"]
        t0 = time.monotonic()
        rt.run()
        wall = time.monotonic() - t0
        m = rt.metrics
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    n_timed = m["events_valid"] - warm
    return {
        "pipeline": name,
        "device": str(rt.device),
        "pairs": len(rt.pairs),
        "events": m["events_valid"],
        "events_per_sec": (n_timed / wall if wall > 0 and n_timed
                           else None),
        "batch_p50_ms": m["p50_batch_ms"],
        "p50_span_ms": {k: m["p50_span_ms"][k] for k in (
            "poll", "dispatch", "positions", "prefetch")},
        "positions_enabled": positions,
        "positions_emitted": m["positions_emitted"],
        "tiles_emitted": m["tiles_emitted"],
        "capacity": m["capacity"],
        "state_grown": m["state_grown"],
    }


def main(argv=None) -> list[dict]:
    from heatmap_tpu_torch.models.pipelines import PIPELINES

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--events", type=int, default=1 << 18)
    ap.add_argument("--batch", type=int, default=1 << 14)
    ap.add_argument("--pipelines", nargs="*", default=sorted(PIPELINES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--no-positions", action="store_true",
                    help="run without the positions fold")
    args = ap.parse_args(argv)

    out = []
    for name in args.pipelines:
        r = bench_one(name, args.events, args.batch, args.device,
                      positions=not args.no_positions)
        print(json.dumps(r), flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
