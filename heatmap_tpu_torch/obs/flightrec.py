"""Flight recorder: a crash-time state dump for post-mortem diagnosis.

A copy of ``heatmap_tpu/obs/flightrec.py``.  On an abnormal runtime exit
(a fail-mode overflow, a poisoned sink, an exception unwinding through
``run()``, SIGTERM through ``stream/__main__.py``) the runtime dumps the
trace-ring tail, the freshness-lineage tail, the metrics snapshot, the
resolved config and the runtime introspection to a timestamped
``flightrec-*.json`` under ``HEATMAP_FLIGHTREC_DIR``.

Contract:

- armed only when ``HEATMAP_FLIGHTREC_DIR`` is set;
- a normal close writes nothing unless ``HEATMAP_FLIGHTREC_ALWAYS=1``;
- one dump per recorder (the first reason wins: a SIGTERM that unwinds
  into close() does not write twice);
- sources are callables evaluated at dump time, each guarded: a broken
  source contributes its error string instead of killing the dump;
- the file is written atomically (tmp + rename);
- the directory keeps the newest ``RETAIN`` dumps.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time

from heatmap_tpu_torch.obs.lineage import json_safe
from heatmap_tpu_torch.obs.xproc import atomic_write_json

log = logging.getLogger(__name__)

ENV_DIR = "HEATMAP_FLIGHTREC_DIR"
ENV_ALWAYS = "HEATMAP_FLIGHTREC_ALWAYS"

# process-wide dump counter: several recorders (runtime + supervisor, or
# repeated child failures) in one second must not collide on a filename
_DUMP_SEQ = itertools.count(1)


class FlightRecorder:
    # dumps retained per directory: a supervised stream that flaps for
    # weeks writes one record per failure, and an unbounded directory
    # is the disk-filling failure mode the trace JSONL rotation exists
    # to prevent — after each dump the oldest files beyond this cap are
    # pruned
    RETAIN = 16

    def __init__(self, dir_path: str):
        self.dir = dir_path
        self._sources: dict = {}
        self._lock = threading.Lock()
        self._dumped: str | None = None  # path of the dump, once written
        self._disarmed = False

    def add_source(self, name: str, fn) -> None:
        """Register ``fn() -> JSON-serializable`` evaluated at dump time."""
        self._sources[name] = fn

    def disarm(self) -> None:
        """A clean close: the atexit backstop must not dump after this."""
        self._disarmed = True

    def spawn(self) -> "FlightRecorder":
        """A fresh recorder sharing this one's directory and sources —
        the SLO watchdog's repeated auto-captures need the once-only
        dump contract PER EPISODE, not per process lifetime."""
        rec = FlightRecorder(self.dir)
        rec._sources = dict(self._sources)
        return rec

    @property
    def dumped(self) -> str | None:
        return self._dumped

    def dump(self, reason: str, episode_id: str | None = None) -> str | None:
        """Write the flight record; returns its path, or None when this
        recorder already dumped / was disarmed / cannot write.  Never
        raises — the recorder runs on dying codepaths.

        ``episode_id`` is the fleet correlation id (obs.xproc episode
        broadcast): every member's dump for one incident carries the
        same id top-level, so post-mortem tooling can collect the dump
        SET for an episode with one grep instead of mtime archaeology."""
        with self._lock:
            if self._dumped is not None or self._disarmed:
                return None
            self._dumped = ""  # claim before the (slow) source walk
        payload = {
            "reason": str(reason)[:500],
            "t_wall": round(time.time(), 3),
            "pid": os.getpid(),
        }
        if episode_id:
            payload["episode_id"] = str(episode_id)
        for name, fn in self._sources.items():
            try:
                payload[name] = json_safe(fn())
            except Exception as e:  # noqa: BLE001 - partial dump > no dump
                payload[name] = f"<source failed: {type(e).__name__}: {e}>"
        stamp = time.strftime("%Y%m%d-%H%M%S")
        fname = (f"flightrec-{stamp}-{os.getpid()}"
                 f"-{next(_DUMP_SEQ)}.json")
        path = os.path.join(self.dir, fname)
        try:
            os.makedirs(self.dir, exist_ok=True)
            atomic_write_json(path, payload)
        except (OSError, TypeError, ValueError) as e:
            log.warning("flight record write to %s failed: %s", path, e)
            with self._lock:
                self._dumped = None  # release the claim: the atexit
                # backstop (or a later close) may retry on a dying disk
            return None
        self._dumped = path
        log.error("flight record written: %s (%s)", path, reason)
        self._prune()
        return path

    def _prune(self) -> None:
        """Keep the newest RETAIN flightrec-*.json in the directory."""
        import glob

        try:
            files = sorted(
                glob.glob(os.path.join(glob.escape(self.dir),
                                       "flightrec-*.json")),
                key=os.path.getmtime)
            for p in files[: max(0, len(files) - self.RETAIN)]:
                os.remove(p)
        except OSError:  # retention is best-effort on a dying codepath
            pass


def from_env(env=None) -> FlightRecorder | None:
    """A recorder for ``HEATMAP_FLIGHTREC_DIR``, or None when unset."""
    e = os.environ if env is None else env
    d = e.get(ENV_DIR, "")
    return FlightRecorder(d) if d else None


def dump_snapshot(dir_path: str, reason: str, sources: dict,
                  episode_id: str | None = None) -> str | None:
    """One-shot dump of already-materialized values (the supervisor's
    child-failure hook: it has no live runtime to source from)."""
    rec = FlightRecorder(dir_path)
    for name, value in sources.items():
        rec.add_source(name, lambda v=value: v)
    return rec.dump(reason, episode_id=episode_id)
