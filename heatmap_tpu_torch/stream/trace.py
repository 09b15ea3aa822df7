"""A ``torch.profiler`` trace over a window of micro-batches.

The counterpart of ``heatmap_tpu/stream/trace.py``, with its state
machine.  The wall-clock spans of every batch feed ``stream.metrics``
(always on); this module adds a profiler trace over a window of batches,
armed two ways:

* at boot by env: ``HEATMAP_PROFILE_DIR=/tmp/trace`` captures
  ``HEATMAP_PROFILE_BATCHES`` (default 16) batches starting at epoch
  ``HEATMAP_PROFILE_SKIP`` (default 2);
* at run time by :meth:`ProfilerTracer.arm`, which ``POST /debug/profile``
  (serve.api) calls for a fresh window without a restart.

Where the reference runs ``jax.profiler.start_trace``/``stop_trace``, the
port starts a ``torch.profiler.profile`` with the CPU activity and, on a
CUDA runtime, the CUDA activity (CUPTI), and at the window's end writes
one Chrome-trace JSON, ``trace-<pid>-<first epoch>.pt.trace.json``, into
the directory (the reference writes TensorBoard's ``*.xplane.pb``).  Each
batch runs under a ``record_function`` named ``microbatch#<epoch>``.  One
window may be in flight at a time: ``arm`` refuses (False, HTTP 409) while
a window is pending or active.  A partial window is written at ``stop``
(the runtime's close) and when an exception escapes a batch.

CUPTI takes effect some milliseconds after the profiler enables it: on an
H100 a window started at its first batch lost that batch's first kernels
in about one run of three.  So the profiler is prepared (its activities
enabled) at the batch before the window's first, where there is one, and
the trace starts with the window; a window stopped while only prepared
is discarded.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import threading

log = logging.getLogger(__name__)


def _parse_window(e, skip: int, batches: int) -> tuple[int, int]:
    """Window knobs from env, defaults on garbage, clamped to sane
    bounds (a negative skip or a zero-batch window would arm a capture
    that can never produce a usable trace)."""
    try:
        skip = int(e.get("HEATMAP_PROFILE_SKIP", skip))
        batches = int(e.get("HEATMAP_PROFILE_BATCHES", batches))
    except ValueError as err:
        log.warning("bad profiler env value (%s); using skip=%d "
                    "batches=%d", err, skip, batches)
    return max(0, skip), max(1, batches)


class _TorchWindow:
    """One ``torch.profiler`` capture: prepared at construction, started
    by ``start``, each batch annotated, written as Chrome-trace JSON by
    ``finish`` or dropped by ``cancel``."""

    def __init__(self, cuda: bool):
        import torch

        self._cuda = cuda
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.prepare_trace()

    def start(self) -> None:
        self._prof.start_trace()

    def annotate(self, epoch: int):
        import torch

        return torch.profiler.record_function(f"microbatch#{epoch}")

    def finish(self, path: str) -> None:
        import torch

        if self._cuda:
            # the window's last kernels may still be queued: a trace
            # stopped before they run leaves them out
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(path)

    def cancel(self) -> None:
        """Disable a prepared window that never started."""
        self._prof.start_trace()
        self._prof.stop()


# the profiler seam: (cuda) -> a prepared window with start(),
# annotate(epoch), finish(path) and cancel(); the tests put a fake here
open_window = _TorchWindow


class ProfilerTracer:
    """``torch.profiler`` trace over a window of micro-batches.

    State machine: idle -> pending (armed, epoch < skip) -> active
    (tracing) -> idle (window complete / stop()).  ``arm`` may re-enter
    only from idle.  The lock covers state transitions; the per-batch
    fast path (idle, nothing armed) is one attribute read.
    """

    def __init__(self, env=None, device=None):
        e = os.environ if env is None else env
        self._lock = threading.Lock()
        self._cuda = device is not None and device.type == "cuda"
        self.dir = e.get("HEATMAP_PROFILE_DIR", "")
        self.skip, self.batches = 2, 16
        if self.dir:  # only parse knobs when profiling is requested
            self.skip, self.batches = _parse_window(e, self.skip,
                                                    self.batches)
        self._active = False
        self._done = bool(not self.dir)
        self._stop_at = 0
        self._window = None
        self._path = ""
        self.written: list[str] = []  # the trace files, in order

    # ------------------------------------------------------------ status
    @property
    def busy(self) -> bool:
        """A window is pending or actively tracing (arm would refuse)."""
        return self._active or not self._done

    def arm(self, dir_path: str, batches: int = 16, skip: int = 0,
            base_epoch: int = 0) -> bool:
        """Arm a capture window at run time: trace ``batches``
        micro-batches starting ``skip`` batches after ``base_epoch`` (the
        runtime's current epoch, so ``skip`` counts forward from now).
        False when a window is already pending or active: the caller
        answers 409."""
        if not dir_path:
            return False
        with self._lock:
            if self.busy:
                return False
            self.dir = dir_path
            self.skip = base_epoch + max(0, int(skip))
            self.batches = max(1, int(batches))
            self._done = False
            self._active = False
        log.info("profiler armed: %d batches from epoch %d -> %s",
                 self.batches, self.skip, self.dir)
        return True

    # ------------------------------------------------------------ window
    def batch(self, epoch: int):
        """Context manager wrapping one micro-batch."""
        if self._done and not self._active:
            return contextlib.nullcontext()
        return self._batch_ctx(epoch)

    @contextlib.contextmanager
    def _batch_ctx(self, epoch: int):
        with self._lock:
            pending = not self._active and not self._done
            if pending and epoch >= self.skip - 1:
                try:
                    if self._window is None:   # prepared a batch ahead
                        self._window = open_window(self._cuda)
                    if epoch >= self.skip:
                        os.makedirs(self.dir, exist_ok=True)
                        self._window.start()
                        self._path = os.path.join(
                            self.dir,
                            f"trace-{os.getpid()}-{epoch}.pt.trace.json")
                        self._active = True
                        self._stop_at = epoch + self.batches
                        log.info("profiler: tracing %d batches -> %s",
                                 self.batches, self.dir)
                except Exception as e:  # profiler races / unsupported
                    log.warning("profiler start failed: %s", e)
                    self._done = True
                    self._window = None
            active, window = self._active, self._window
        if active:
            try:
                with window.annotate(epoch):
                    yield
            finally:
                # stop at window end, and on an exception escaping the
                # batch: a dangling trace would be lost and would block
                # any later capture in this process
                if epoch + 1 >= self._stop_at or sys.exc_info()[0]:
                    self.stop()
        else:
            yield

    def stop(self) -> None:
        """Write an in-flight trace (the runtime's close calls this, so a
        short stream still writes its partial capture).  Safe to call
        twice, and from a pending window, which it cancels."""
        with self._lock:
            was_active, self._active = self._active, False
            self._done = True
            window, self._window = self._window, None
        if not was_active:
            if window is not None:
                try:
                    window.cancel()
                except Exception as e:
                    log.warning("profiler cancel failed: %s", e)
            return
        try:
            window.finish(self._path)
            self.written.append(self._path)
            log.info("profiler: trace written to %s", self._path)
        except Exception as e:
            log.warning("profiler stop failed: %s", e)


# the reference's short name
Tracer = ProfilerTracer
