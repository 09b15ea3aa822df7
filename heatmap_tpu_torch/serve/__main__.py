"""Standalone server: ``python -m heatmap_tpu_torch.serve``.

Reads the same env config as the reference's server (MONGO_URI/MONGO_DB/
REFRESH_MS, SERVE_HOST/SERVE_PORT) and serves the store HEATMAP_STORE
selects (``jsonl`` reads ``<CHECKPOINT>/store.jsonl``), through a view
rebuilt from the store (``StoreViewRefresher``).  ``--workers 1`` (the
default) is the one worker this slice runs: more workers (the reference's
SO_REUSEPORT fleet) are not ported yet, and ``HEATMAP_SERVE_WORKERS`` > 1
makes ``load_config`` raise.  Serving touches no device.
"""

from __future__ import annotations

import argparse
import logging
import sys

log = logging.getLogger("heatmap_tpu_torch.serve")


def main(argv=None) -> int:
    from heatmap_tpu_torch.config import load_config

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    ap = argparse.ArgumentParser(
        prog="python -m heatmap_tpu_torch.serve", description=__doc__)
    ap.add_argument("--workers", type=int, default=None,
                    help="serve worker processes (default: "
                         "HEATMAP_SERVE_WORKERS, 1; only 1 is ported)")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = load_config()
    workers = (args.workers if args.workers is not None
               else cfg.serve_workers)
    if workers != 1:
        raise NotImplementedError(
            f"--workers {workers}: the multi-process serve fleet is not "
            f"ported to heatmap_tpu_torch yet (ROADMAP A4, the serve "
            f"tier's second slice); run one worker")
    host = args.host or cfg.serve_host
    port = args.port if args.port is not None else cfg.serve_port

    from heatmap_tpu_torch.serve.api import serve_forever
    from heatmap_tpu_torch.sink import make_store

    store = make_store(cfg)
    try:
        serve_forever(store, cfg, host=host, port=port)
    finally:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
