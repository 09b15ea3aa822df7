"""Sampling Python stack profiler: always available, low overhead.

A copy of ``heatmap_tpu/obs/prof.py``.  A daemon thread wakes at
``HEATMAP_STACKPROF_HZ`` (default 29, co-prime with common 10/100 Hz
periodic work so the samples do not alias onto it), walks
``sys._current_frames()`` once and counts the top frame of every other
thread.  The aggregate (top-of-stack counts per frame and thread name)
serves at ``/debug/stacks`` and rides the flight-recorder dump.  Each wake
takes the interpreter lock for the walk.

One sampler per process (``get_sampler``): ``/debug/stacks`` and the
runtime's watchdog share it; ``ensure_started()`` is idempotent and
thread-safe, and ``HEATMAP_STACKPROF_HZ=0`` disables it.
"""

from __future__ import annotations

import collections
import logging
import os
import sys
import threading
import time

log = logging.getLogger(__name__)

ENV_HZ = "HEATMAP_STACKPROF_HZ"
DEFAULT_HZ = 29.0


def _env_hz(env=None) -> float:
    e = os.environ if env is None else env
    raw = e.get(ENV_HZ, "")
    if not raw:
        return DEFAULT_HZ
    try:
        hz = float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %s", ENV_HZ, raw,
                    DEFAULT_HZ)
        return DEFAULT_HZ
    if hz <= 0:
        return 0.0  # explicit disable
    return min(hz, 250.0)  # ceiling: the GIL makes faster pointless


class StackSampler:
    """Counts top-of-stack frames across threads at a fixed rate."""

    def __init__(self, hz: float | None = None):
        self.hz = _env_hz() if hz is None else float(hz)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._samples = 0
        self._t_started: float | None = None
        # (thread_name, file, line, func) -> count
        self._counts: collections.Counter = collections.Counter()

    # ------------------------------------------------------------ control
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def ensure_started(self) -> bool:
        """Start the sampler thread if not running; False when disabled
        (hz <= 0)."""
        if self.hz <= 0:
            return False
        with self._lock:
            if self.running:
                return True
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="stackprof", daemon=True)
            self._t_started = time.monotonic()
            self._thread.start()
        # join the sampler before interpreter finalization: a daemon
        # thread walking sys._current_frames() while native libraries
        # tear down can abort the process at exit
        import atexit

        atexit.register(self.stop)
        return True

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            self._stop.set()
            t.join(timeout=2.0)

    # ------------------------------------------------------------ sampling
    @staticmethod
    def _walk(me: int, names: dict) -> list:
        """One frame walk, isolated in its own scope so the frames dict
        (and every frame it references) is freed the moment this
        returns.  Holding frames any longer keeps OTHER threads' locals
        alive — observed: a dead serve thread's listening socket held
        open into the next bind (EADDRINUSE), an exported shm
        memoryview blocking close() (BufferError)."""
        frames = sys._current_frames()
        return [
            (names.get(tid, str(tid)), frame.f_code.co_filename,
             frame.f_lineno, frame.f_code.co_name)
            for tid, frame in frames.items() if tid != me
        ]

    def _loop(self) -> None:
        interval = 1.0 / self.hz
        me = threading.get_ident()
        names = {}
        while not self._stop.wait(interval):
            if len(names) != threading.active_count():
                names = {t.ident: t.name for t in threading.enumerate()}
            try:
                now_keys = self._walk(me, names)
            except Exception:  # noqa: BLE001 - never kill the process
                continue
            with self._lock:
                self._samples += 1
                for k in now_keys:
                    self._counts[k] += 1

    # ------------------------------------------------------------ reads
    def snapshot(self, n: int = 40) -> dict:
        """Aggregated top-of-stack output: the n hottest frames with
        their share of samples, newest aggregate first."""
        with self._lock:
            samples = self._samples
            top = self._counts.most_common(max(1, int(n)))
            started = self._t_started
        frames = [{
            "thread": t_name,
            "frame": f"{fname}:{lineno}:{func}",
            "count": count,
            "share": round(count / samples, 4) if samples else 0.0,
        } for (t_name, fname, lineno, func), count in top]
        return {
            "running": self.running,
            "hz": self.hz,
            "samples": samples,
            "uptime_s": (round(time.monotonic() - started, 3)
                         if started is not None else 0.0),
            "frames": frames,
        }

    def tail(self, n: int = 20) -> list:
        """The flight-recorder view: the n hottest frames only."""
        return self.snapshot(n)["frames"]


_SAMPLER: StackSampler | None = None
_SAMPLER_LOCK = threading.Lock()


def get_sampler() -> StackSampler:
    """The process-wide sampler (created on first use; not started)."""
    global _SAMPLER
    with _SAMPLER_LOCK:
        if _SAMPLER is None:
            _SAMPLER = StackSampler()
        return _SAMPLER
