"""End-to-end demo: synthetic city traffic → device fold → live map.

``python -m heatmap_tpu_torch.models.demo [--events N] [--port P] [--serve]
[--device cuda|cpu]`` runs the whole stack in one process: SyntheticSource →
MicroBatchRuntime (H3 snap + windowed fold on the device) → MemoryStore →
HTTP API/UI at http://127.0.0.1:P/ (``--port 0`` binds a free port).  It
runs on the CUDA device; without one it raises unless ``--device cpu`` is
passed.
"""

from __future__ import annotations

import argparse
import logging
import tempfile
import time

log = logging.getLogger("demo")


def main(argv=None) -> dict:
    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.serve import start_background, stop_background
    from heatmap_tpu_torch.sink import MemoryStore
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import SyntheticSource

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--events", type=int, default=500_000)
    ap.add_argument("--batch", type=int, default=1 << 14)
    ap.add_argument("--vehicles", type=int, default=2000)
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--serve", action="store_true",
                    help="keep serving after the replay finishes")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    with tempfile.TemporaryDirectory(prefix="heatmap-demo-ckpt-") as ckpt:
        cfg = load_config({}, batch_size=args.batch, store="memory",
                          checkpoint_dir=ckpt)
        store = MemoryStore()
        src = SyntheticSource(
            n_events=args.events, n_vehicles=args.vehicles,
            t0=int(time.time()) - 600, events_per_second=args.batch,
        )
        rt = MicroBatchRuntime(cfg, src, store, device=args.device)
        httpd, thread, port = start_background(store, cfg, rt,
                                               port=args.port)
        try:
            log.info("UI at http://127.0.0.1:%d/ — replaying %d events",
                     port, args.events)
            t0 = time.monotonic()
            rt.run()
            wall = time.monotonic() - t0
            snap = rt.metrics_snapshot()
            log.info(
                "done: %d events in %.2fs (%.0f ev/s), %d tiles, p50 "
                "batch %.1f ms", snap.get("events_valid", 0), wall,
                snap.get("events_valid", 0) / max(wall, 1e-9),
                snap.get("tiles_emitted", 0),
                snap.get("batch_latency_p50_ms", 0))
            if args.serve:
                log.info("serving until interrupted (ctrl-c)")
                try:
                    while True:
                        time.sleep(3600)
                except KeyboardInterrupt:
                    pass
        finally:
            stop_background(httpd, thread)
    return snap


if __name__ == "__main__":
    main()
