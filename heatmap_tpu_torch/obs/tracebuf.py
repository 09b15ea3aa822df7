"""Structured per-micro-batch trace records in a bounded ring buffer.

A copy of ``heatmap_tpu/obs/tracebuf.py``.  Each record is one
micro-batch: its epoch, wall time, span timings, event counts and loss
flags (overflow, late drops).  The ring is what ``/trace/recent`` serves,
newest first.

Optional JSONL export: with ``HEATMAP_TRACE_JSONL=/path/file.jsonl`` every
record is also appended as one JSON line, flushed per batch.  Export errors
are logged once and never take the pipeline down.  Once the file exceeds
``HEATMAP_TRACE_JSONL_MAX_BYTES`` (default 64 MiB) it rotates to a single
``.1`` rollover (replacing any previous one), so a long-running stream
holds at most ~2x the limit on disk; ``0`` disables rotation.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

ENV_JSONL = "HEATMAP_TRACE_JSONL"
ENV_JSONL_MAX = "HEATMAP_TRACE_JSONL_MAX_BYTES"
DEFAULT_JSONL_MAX = 64 << 20


class TraceRing:
    def __init__(self, capacity: int = 256, jsonl_path: str | None = None,
                 env=None, jsonl_max_bytes: int | None = None):
        e = os.environ if env is None else env
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self._jsonl_path = (jsonl_path if jsonl_path is not None
                            else e.get(ENV_JSONL) or None)
        if jsonl_max_bytes is not None:
            self._jsonl_max = int(jsonl_max_bytes)
        else:
            try:
                self._jsonl_max = int(
                    e.get(ENV_JSONL_MAX, DEFAULT_JSONL_MAX))
            except ValueError:
                log.warning("%s=%r is not an integer; using %d",
                            ENV_JSONL_MAX, e.get(ENV_JSONL_MAX),
                            DEFAULT_JSONL_MAX)
                self._jsonl_max = DEFAULT_JSONL_MAX
        self._jsonl_bytes = 0
        self._jsonl_fh = None
        self._jsonl_dead = False

    def record(self, epoch: int, latency_s: float, spans: dict,
               n_events: int = 0, n_late: int = 0,
               overflow_groups: int = 0, late_dropped: int = 0,
               **extra) -> dict:
        rec = {
            "seq": 0,  # filled under the lock
            "epoch": int(epoch),
            "t_wall": round(time.time(), 3),
            "latency_ms": round(latency_s * 1e3, 3),
            "spans_ms": {k: round(v * 1e3, 3) for k, v in spans.items()},
            "n_events": int(n_events),
            "n_late": int(n_late),
            "overflow_groups": int(overflow_groups),
            "late_dropped": int(late_dropped),
        }
        rec.update(extra)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
        self._export(rec)
        return rec

    def recent(self, n: int = 50) -> list:
        with self._lock:
            items = list(self._ring)
        return items[::-1][: max(0, int(n))]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def _export(self, rec: dict) -> None:
        if self._jsonl_path is None or self._jsonl_dead:
            return
        try:
            if self._jsonl_fh is None:
                self._jsonl_fh = open(self._jsonl_path, "a",
                                      encoding="utf-8")
                try:
                    self._jsonl_bytes = os.path.getsize(self._jsonl_path)
                except OSError:
                    self._jsonl_bytes = 0
            line = json.dumps(rec, separators=(",", ":")) + "\n"
            self._jsonl_fh.write(line)
            self._jsonl_fh.flush()
            # default json is ASCII (ensure_ascii), so chars == bytes
            self._jsonl_bytes += len(line)
            if 0 < self._jsonl_max <= self._jsonl_bytes:
                # size rotation: keep exactly one .1 rollover so the
                # export can never fill the disk on a long-running
                # stream (a rotation failure latches the export dead,
                # same as any other export error)
                self._jsonl_fh.close()
                self._jsonl_fh = None
                os.replace(self._jsonl_path, self._jsonl_path + ".1")
                self._jsonl_bytes = 0
        except OSError as e:
            self._jsonl_dead = True  # log once; never crash the pipeline
            log.warning("trace JSONL export to %s disabled: %s",
                        self._jsonl_path, e)

    def close(self) -> None:
        if self._jsonl_fh is not None:
            try:
                self._jsonl_fh.close()
            except OSError:
                pass
            self._jsonl_fh = None
