"""What a checkpoint commit's background work costs the step thread.

    python -m heatmap_tpu_torch.commit_probe [--log2 21] [--bins 64]
                                             [--reps 2]

``MicroBatchRuntime._checkpoint`` clones each slab on the step thread,
then copies the clone to the host and writes its npz on a background
thread.  This probe builds one slab at ``synthetic_backfill``'s grown size
(2^21 rows, 64 histogram bins, ~663 MB) and runs on a background thread,
one at a time, each part of that work or its alternative:

- ``pageable``: the runtime's copy, ``to_host`` (``.cpu()`` into pageable
  host memory), on a side stream;
- ``pinned``: the same bytes into pinned host buffers allocated once
  beforehand, on a side stream;
- ``write``: ``CheckpointManager.commit`` of a host copy (``np.savez``).

Meanwhile the main thread loops as a step thread does: 50 small device
ops, then a blocking read of two words.  Each mode's line gives the
background seconds and the loop's iteration times (ms: p50, max, count)
beside those of a loop with nothing in the background, run before each
mode.  One JSON line per mode and rep, then the card's name and power
limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from heatmap_tpu_torch.engine.state import init_state, to_host
from heatmap_tpu_torch.stream.checkpoint import CheckpointManager


def _loop(dev, stop: threading.Event, min_iters: int = 20) -> list[float]:
    """Step-thread stand-in until ``stop``: ms per iteration of 50 small
    device ops and one blocking two-word read."""
    work = torch.zeros(1 << 16, device=dev)
    flag = torch.zeros(2, dtype=torch.int32, device=dev)
    out = []
    while not stop.is_set() or len(out) < min_iters:
        t0 = time.monotonic()
        for _ in range(50):
            work.add_(1.0)
        flag.add_(1).tolist()
        out.append((time.monotonic() - t0) * 1e3)
        time.sleep(0.002)
    return out


def _stats(ms: list[float]) -> dict:
    return {"p50": float(np.median(ms)), "max": max(ms), "n": len(ms)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2", type=int, default=21)
    ap.add_argument("--bins", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("commit_probe needs a CUDA device")
    dev = torch.device("cuda")
    slab = init_state(1 << args.log2, args.bins, dev)
    nbytes = sum(t.numel() * t.element_size() for t in slab)
    side = torch.cuda.Stream(dev)
    t0 = time.monotonic()
    pinned_bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                   for t in slab]
    pin_alloc_s = time.monotonic() - t0
    host = to_host(slab)
    tmp = tempfile.mkdtemp(prefix="commit-probe-")

    def pageable():
        with torch.cuda.stream(side):
            to_host(slab)

    def pinned():
        with torch.cuda.stream(side):
            for b, t in zip(pinned_bufs, slab):
                b.copy_(t, non_blocking=True)
        side.synchronize()

    epochs = iter(range(1, 1 << 20))

    def write():
        CheckpointManager(tmp).commit(0, 0, next(epochs),
                                      {(8, 300): host}, shards=1)

    modes = {"pageable": pageable, "pinned": pinned, "write": write}
    print(json.dumps({"slab_bytes": nbytes, "rows": 1 << args.log2,
                      "hist_bins": args.bins, "pin_alloc_s": pin_alloc_s}))
    try:
        for rep in range(args.reps):
            order = list(modes) if rep % 2 == 0 else list(modes)[::-1]
            for name in order:
                torch.cuda.synchronize()
                stop = threading.Event()
                stop.set()
                idle = _loop(dev, stop)
                done = {}

                def bg(fn=modes[name]):
                    t1 = time.monotonic()
                    try:
                        fn()
                    finally:
                        done["s"] = time.monotonic() - t1
                        stop.set()

                stop = threading.Event()
                th = threading.Thread(target=bg)
                th.start()
                busy = _loop(dev, stop)
                th.join()
                print(json.dumps({"rep": rep, "mode": name,
                                  "background_s": done["s"],
                                  "loop_ms": _stats(busy),
                                  "idle_loop_ms": _stats(idle)}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
