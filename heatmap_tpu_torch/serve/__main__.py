"""Standalone server: ``python -m heatmap_tpu_torch.serve [--workers N]``.

Reads the same env config as the reference's server (MONGO_URI/MONGO_DB/
REFRESH_MS, SERVE_HOST/SERVE_PORT) and serves the store HEATMAP_STORE
selects (``jsonl`` reads ``<CHECKPOINT>/store.jsonl``), through a view
rebuilt from the store (``StoreViewRefresher``) or, with
``HEATMAP_REPL_FEED``, a replica view following a writer's replication
feed.  ``HEATMAP_SERVE_CORE`` picks the thread core or the epoll event
loop; the log names it.  Serving touches no device.

``--workers N`` (or ``HEATMAP_SERVE_WORKERS``) runs a multi-process
serve fleet on ONE port: the parent supervises N child processes that
each bind the same (host, port) with ``SO_REUSEPORT`` — the kernel
balances accepted connections across their listen queues, so the tier
scales past the interpreter lock without a fronting load balancer.  Each
worker runs its own ``ReplicaViewFollower`` off the shared
``HEATMAP_REPL_FEED``.  The parent restarts crashed workers (short
backoff) and fans SIGTERM/SIGINT out for a clean fleet stop.

A copy of ``heatmap_tpu/serve/__main__.py`` with two differences.  The
parent holds the fleet's port with ``SO_REUSEPORT`` whatever the port, and
a host without the option raises (the reference would log a warning and
let each worker bind exclusively, so a fleet could serve on one worker
unnoticed).  The workers publish no fleet member snapshot: that needs
the supervisor channel (ROADMAP A7), so ``/fleet/*`` answer 503 on
every worker.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import subprocess
import sys
import time

log = logging.getLogger("heatmap_tpu_torch.serve")


def _hold_port(host: str, port: int = 0) -> tuple[socket.socket, int]:
    """Bind ``port`` (a free one for 0) and KEEP the (REUSEPORT) holder
    socket open: the workers bind the same port alongside it, and the
    holder never listens, so it receives no connections — but releasing
    it before every worker bound would let another process steal the
    port.  Raises where the host cannot share a port."""
    from heatmap_tpu_torch.utils.netio import set_reuseport

    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        set_reuseport(s)
        s.bind((host, port))
    except BaseException:
        s.close()
        raise
    return s, s.getsockname()[1]


def _spawn_worker(host: str, port: int) -> subprocess.Popen:
    env = dict(os.environ)
    env["HEATMAP_SERVE_REUSEPORT"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "heatmap_tpu_torch.serve", "--workers", "1",
         "--host", host, "--port", str(port)],
        env=env)


def supervise(workers: int, host: str, port: int,
              core: str = "thread") -> int:
    holder, port = _hold_port(host, port)
    log.info("serve fleet: %d workers on http://%s:%d/ "
             "(SO_REUSEPORT, %s core)", workers, host, port, core)
    procs = [_spawn_worker(host, port) for _ in range(workers)]
    stopping = {"flag": False}

    def _stop(signum, _frame):
        stopping["flag"] = True
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        while True:
            time.sleep(0.5)
            if stopping["flag"]:
                break
            for i, p in enumerate(procs):
                rc = p.poll()
                if rc is not None:
                    # a worker died underneath the fleet: restart it
                    # (backoff so a boot-crash loop can't spin)
                    log.warning("serve worker pid=%d exited rc=%s; "
                                "restarting", p.pid, rc)
                    time.sleep(0.5)
                    if not stopping["flag"]:
                        procs[i] = _spawn_worker(host, port)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        deadline = time.monotonic() + 10
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        holder.close()
    return 0


def main(argv=None) -> int:
    from heatmap_tpu_torch.config import load_config

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    ap = argparse.ArgumentParser(
        prog="python -m heatmap_tpu_torch.serve", description=__doc__)
    ap.add_argument("--workers", type=int, default=None,
                    help="serve worker processes sharing one "
                         "SO_REUSEPORT port (default: "
                         "HEATMAP_SERVE_WORKERS, 1)")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)

    cfg = load_config()
    workers = (args.workers if args.workers is not None
               else cfg.serve_workers)
    if workers < 1:
        raise ValueError(f"--workers must be >= 1, got {workers}")
    host = args.host or cfg.serve_host
    port = args.port if args.port is not None else cfg.serve_port
    if workers > 1:
        # children inherit HEATMAP_SERVE_CORE through the environment;
        # naming the core here makes a mixed-core fleet (a config bug)
        # visible in the supervisor log
        return supervise(workers, host, port, core=cfg.serve_core)

    from heatmap_tpu_torch.serve.api import serve_forever
    from heatmap_tpu_torch.sink import make_store

    log.info("serve core: %s", cfg.serve_core)
    store = make_store(cfg)
    try:
        serve_forever(store, cfg, host=host, port=port,
                      reuse_port=os.environ.get(
                          "HEATMAP_SERVE_REUSEPORT") == "1")
    finally:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
