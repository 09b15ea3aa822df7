"""Runtime introspection: compile/retrace tracking, device memory
telemetry, and the SLO-triggered auto-capture watchdog.

The counterpart of ``heatmap_tpu/obs/runtimeinfo.py``, with the same
families, labels and rules.  What differs is what a "compile" is and where
the memory numbers come from:

- **A compile is a library build or load.**  Eager PyTorch has no jit
  cache to probe.  What does cost a step seconds of compiler time here is
  the first use of a kernel or of the host C++ codecs, which ``_build.py``
  compiles (``nvcc``, ``g++``) or loads.  ``CompileTracker`` reads
  ``_build.loads()`` (the libraries this process has built or loaded)
  around each call of a wrapped entry point: a call during which it moved
  counts as a compile, and its wall time as compile seconds.  A compile
  after a function's warmup (``HEATMAP_WARMUP_BATCHES`` calls, default 4)
  is a retrace after warmup and degrades /healthz while recent
  (``HEATMAP_SLO_RETRACES`` over the trailing
  ``HEATMAP_SLO_RETRACE_WINDOW_S``).  Slab growth, which retraces in the
  reference, reshapes tensors without a build, so it is not a compile
  here.  The counter is process-wide: a library another thread loads
  during a wrapped call counts for that call.
- **Device memory from the caching allocator.**  On a CUDA runtime
  ``MemoryMonitor.sample`` reads ``torch.cuda.memory_stats``:
  ``allocated_bytes.all.current`` as bytes in use and
  ``allocated_bytes.all.peak`` (the allocator's own peak) into the
  watermark, and the card's ``total_memory`` as the limit; the device
  label is the card's index.  A failed read raises.  There is no
  ``jax.live_arrays()``: ``heatmap_live_buffer_bytes`` is the bytes of the
  tensors the runtime itself holds (the slabs, the emit ring, the staged
  feeds), on the CPU and the card alike.

``HEATMAP_SLO_MEM_BYTES`` (default 0, disabled) turns the watermark into a
/healthz budget.  ``SloWatchdog`` re-evaluates the /healthz verdict every
``HEATMAP_SLO_WATCHDOG_S`` (default 10) off the request path and, on the
transition into degraded or down, writes an enriched flight record (the
runtime's sources plus the verdict).  One dump per episode,
``HEATMAP_SLO_CAPTURE_COOLDOWN_S`` (default 300) between dumps.  The
reference's fleet episodes (one correlated dump per member, over the
supervisor channel) come with the process fleet (ROADMAP A7).
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

from heatmap_tpu_torch import _build

log = logging.getLogger(__name__)

ENV_WARMUP = "HEATMAP_WARMUP_BATCHES"
ENV_SLO_RETRACES = "HEATMAP_SLO_RETRACES"
ENV_RETRACE_WINDOW = "HEATMAP_SLO_RETRACE_WINDOW_S"
ENV_SLO_MEM = "HEATMAP_SLO_MEM_BYTES"
ENV_WATCHDOG_S = "HEATMAP_SLO_WATCHDOG_S"
ENV_COOLDOWN_S = "HEATMAP_SLO_CAPTURE_COOLDOWN_S"

# compile wall-time buckets, the reference's: a g++ build of the host
# codecs takes seconds, an nvcc build of a kernel tens of seconds
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0, 300.0)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("%s=%r is not a number; using %s", name, raw, default)
        return default


class _FnState:
    __slots__ = ("calls", "compiles", "last_compile_s", "last_retrace_wall")

    def __init__(self):
        self.calls = 0
        self.compiles = 0
        self.last_compile_s = 0.0
        self.last_retrace_wall: float | None = None


class CompileTracker:
    """Per-function compile counts / compile seconds / retrace-after-
    warmup detection for the runtime's step entry points, by probing the
    libraries ``_build.py`` has built or loaded around each call."""

    def __init__(self, registry, warmup: int | None = None):
        self.warmup = (max(1, int(_env_float(ENV_WARMUP, 4)))
                       if warmup is None else max(1, int(warmup)))
        self._lock = threading.Lock()
        self._fns: dict[str, _FnState] = {}
        # bounded trail of retrace wall times (the /healthz trailing-
        # window check and the snapshot both read it)
        self._retraces: collections.deque = collections.deque(maxlen=256)
        self._c_compiles = registry.counter(
            "heatmap_compile_total",
            "libraries built or loaded (CUDA kernels and host C++, "
            "_build.py) during a call of each wrapped step function",
            labels=("fn",))
        self._h_compile_s = registry.histogram(
            "heatmap_compile_seconds",
            "wall seconds of the step call that built or loaded a library "
            "(build + load + first execute)", labels=("fn",),
            buckets=COMPILE_BUCKETS)
        self._c_retrace = registry.counter(
            "heatmap_retrace_after_warmup_total",
            "builds or loads observed after a step function's warmup "
            "(HEATMAP_WARMUP_BATCHES calls); each degrades /healthz while "
            "recent", labels=("fn",))

    def wrap(self, name: str, fn):
        """Wrap a callable; the wrapper is transparent apart from the
        build probe and the wall clock around each call."""
        st = self._fns.setdefault(name, _FnState())
        # the counters' children exist from the start, so an exposition
        # shows a wrapped function that never built at 0
        self._c_compiles.labels(fn=name)
        self._c_retrace.labels(fn=name)

        def wrapped(*args, **kwargs):
            before = _build.loads()
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            n_new = _build.loads() - before
            with self._lock:
                st.calls += 1
                if n_new > 0:
                    st.compiles += n_new
                    st.last_compile_s = time.monotonic() - t0
                    self._c_compiles.labels(fn=name).inc(n_new)
                    self._h_compile_s.labels(fn=name).observe(
                        st.last_compile_s)
                    if st.calls > self.warmup:
                        now = time.time()
                        st.last_retrace_wall = now
                        self._retraces.append(now)
                        self._c_retrace.labels(fn=name).inc(n_new)
                        log.warning(
                            "post-warmup build of %s (call %d, +%d "
                            "librar%s, %.2fs)", name, st.calls, n_new,
                            "y" if n_new == 1 else "ies",
                            st.last_compile_s)
            return out

        wrapped._inner = fn  # tests and debugging reach the wrapped fn
        return wrapped

    # ------------------------------------------------------------ reads
    @property
    def retraces_total(self) -> int:
        """Lifetime post-warmup retrace count."""
        with self._lock:
            return len(self._retraces)

    def retraces_recent(self, window_s: float) -> int:
        cut = time.time() - window_s
        with self._lock:
            return sum(1 for t in self._retraces if t >= cut)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "warmup_calls": self.warmup,
                "retraces_after_warmup": len(self._retraces),
                "functions": {
                    name: {
                        "calls": st.calls,
                        "compiles": st.compiles,
                        "last_compile_s": round(st.last_compile_s, 4),
                        "last_retrace_wall": st.last_retrace_wall,
                    } for name, st in self._fns.items()
                },
            }


class MemoryMonitor:
    """Device memory telemetry sampled on the runtime loop.

    On a CUDA ``device`` the allocator's bytes in use, the card's memory
    and the allocator's peak land in labeled gauges; on the CPU only the
    live-buffer gauges (``live_bytes_fn``: the bytes of the tensors the
    runtime holds) carry the watermark, so the /healthz budget works on
    both."""

    def __init__(self, registry, ring_bytes_fn=None, live_bytes_fn=None,
                 device=None):
        self._lock = threading.Lock()
        self._device = (device if device is not None
                        and device.type == "cuda" else None)
        if self._device is not None and self._device.index is None:
            # pinned to an index here: a bare "cuda" would mean whatever
            # device is current on the sampling thread
            import torch

            self._device = torch.device("cuda", torch.cuda.current_device())
        self._live_bytes_fn = live_bytes_fn
        self._device_peak: dict[str, float] = {}
        self._live_peak = 0.0
        self._last_sample = 0.0
        self._g_in_use = registry.gauge(
            "heatmap_device_bytes_in_use",
            "bytes the CUDA caching allocator has allocated per device "
            "(torch.cuda.memory_stats; absent on the CPU)",
            labels=("device",))
        self._g_limit = registry.gauge(
            "heatmap_device_bytes_limit",
            "total memory of each CUDA device", labels=("device",))
        self._g_peak = registry.gauge(
            "heatmap_device_hbm_watermark_bytes",
            "high-water of device bytes allocated since the runtime "
            "started (max of sampled in-use and the allocator's own peak)",
            labels=("device",))
        self._g_live = registry.gauge(
            "heatmap_live_buffer_bytes",
            "bytes of the tensors the runtime itself holds (state slabs, "
            "emit ring, staged feeds), on the CPU and the card alike")
        self._g_live_peak = registry.gauge(
            "heatmap_live_buffer_watermark_bytes",
            "high-water of heatmap_live_buffer_bytes since the runtime "
            "started")
        self._g_ring = registry.gauge(
            "heatmap_emit_ring_slab_bytes",
            "bytes of packed emit batches parked on device in the emit "
            "ring (EmitRing slab accounting)",
            fn=ring_bytes_fn)

    def sample(self, min_interval_s: float = 0.0) -> bool:
        """One telemetry sample; rate-limited when ``min_interval_s`` is
        set (the runtime loop calls this per step with 1.0).  On a CUDA
        device a failed allocator read raises."""
        now = time.monotonic()
        with self._lock:
            if min_interval_s and now - self._last_sample < min_interval_s:
                return False
            self._last_sample = now
        live = (float(self._live_bytes_fn())
                if self._live_bytes_fn is not None else 0.0)
        with self._lock:
            self._live_peak = max(self._live_peak, live)
            self._g_live.set(live)
            self._g_live_peak.set(self._live_peak)
        if self._device is None:
            return True
        import torch

        stats = torch.cuda.memory_stats(self._device)
        label = str(self._device.index)
        in_use = float(stats["allocated_bytes.all.current"])
        peak = float(stats["allocated_bytes.all.peak"])
        limit = float(torch.cuda.get_device_properties(
            self._device).total_memory)
        with self._lock:
            self._device_peak[label] = max(
                self._device_peak.get(label, 0.0), in_use, peak)
            self._g_in_use.labels(device=label).set(in_use)
            self._g_limit.labels(device=label).set(limit)
            self._g_peak.labels(device=label).set(self._device_peak[label])
        return True

    @property
    def watermark_bytes(self) -> float:
        """The high-water the /healthz budget compares against: max of
        the per-device peaks, falling back to the live-buffer peak."""
        with self._lock:
            if self._device_peak:
                return max(self._device_peak.values())
            return self._live_peak

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "live_buffer_bytes_peak": self._live_peak,
                "device_peak_bytes": dict(self._device_peak),
                "watermark_bytes": (max(self._device_peak.values())
                                    if self._device_peak
                                    else self._live_peak),
            }


class RuntimeIntrospection:
    """The runtime's introspection bundle: compile tracker + memory
    monitor, one snapshot for the flight recorder."""

    def __init__(self, registry, ring_bytes_fn=None,
                 warmup: int | None = None, live_bytes_fn=None,
                 device=None):
        self.compile = CompileTracker(registry, warmup=warmup)
        self.memory = MemoryMonitor(registry, ring_bytes_fn=ring_bytes_fn,
                                    live_bytes_fn=live_bytes_fn,
                                    device=device)

    def snapshot(self) -> dict:
        return {"compile": self.compile.snapshot(),
                "memory": self.memory.snapshot()}


# ------------------------------------------------------------ healthz
def healthz_checks(runtime) -> tuple[dict, bool]:
    """The runtime-introspection /healthz checks (serve.api merges them
    into the payload): recent post-warmup retraces over budget, and the
    memory watermark over ``HEATMAP_SLO_MEM_BYTES`` when set."""
    checks: dict = {}
    degraded = False
    ri = getattr(runtime, "runtimeinfo", None)
    if ri is None:
        return checks, degraded
    window = _env_float(ENV_RETRACE_WINDOW, 600.0)
    budget = _env_float(ENV_SLO_RETRACES, 0.0)
    recent = ri.compile.retraces_recent(window)
    if recent or budget:
        ok = recent <= budget
        checks["retrace_after_warmup"] = {
            "value": recent, "budget": budget,
            "window_s": window, "ok": ok}
        degraded |= not ok
    mem_budget = _env_float(ENV_SLO_MEM, 0.0)
    if mem_budget > 0:
        wm = ri.memory.watermark_bytes
        ok = wm <= mem_budget
        checks["memory_watermark_bytes"] = {
            "value": wm, "budget": mem_budget, "ok": ok}
        degraded |= not ok
    return checks, degraded


class SloWatchdog:
    """Re-evaluates the /healthz verdict off the request path and
    auto-captures an enriched flight-recorder dump when it degrades.

    One capture per degradation episode: the episode is claimed only once
    a dump lands, so a degradation that begins inside the cooldown (or
    while the disk refuses the write) is retried on later ticks; recovery
    to ok re-arms."""

    def __init__(self, runtime, interval_s: float | None = None,
                 cooldown_s: float | None = None, *, flightrec=None):
        from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL

        if os.environ.get(ENV_CHANNEL):
            raise NotImplementedError(
                f"{ENV_CHANNEL}: fleet episodes are not ported to "
                f"heatmap_tpu_torch yet (ROADMAP A7); unset it")
        self.runtime = runtime
        self.interval_s = (_env_float(ENV_WATCHDOG_S, 10.0)
                           if interval_s is None else float(interval_s))
        self.cooldown_s = (_env_float(ENV_COOLDOWN_S, 300.0)
                           if cooldown_s is None else float(cooldown_s))
        self._flightrec = flightrec
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._was_bad = False
        self._last_dump = -float("inf")
        self.n_captures = 0

    @property
    def flightrec(self):
        return (self._flightrec if self._flightrec is not None
                else getattr(self.runtime, "flightrec", None))

    def start(self) -> bool:
        if self.interval_s <= 0 or self._thread is not None:
            return False
        self._thread = threading.Thread(
            target=self._loop, name="slo-watchdog", daemon=True)
        self._thread.start()
        return True

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 - the watchdog never kills
                log.exception("SLO watchdog check failed")

    def check_once(self) -> str | None:
        """One evaluation; returns the dump path when a capture fired."""
        from heatmap_tpu_torch.serve.api import healthz_payload

        payload, down = healthz_payload(self.runtime)
        bad = down or payload.get("status") == "degraded"
        now = time.monotonic()
        if not bad:
            self._was_bad = False
            return None
        if self._was_bad:
            return None
        if now - self._last_dump < self.cooldown_s:
            return None
        rec = self.flightrec
        if rec is None:
            return None
        failing = [k for k, c in payload.get("checks", {}).items()
                   if isinstance(c, dict) and not c.get("ok", True)]
        reason = "slo degraded: " + (", ".join(failing)
                                     or payload.get("status", "?"))
        snap = rec.spawn()
        snap.add_source("healthz", lambda p=payload: p)
        path = snap.dump(reason)
        if path is not None:
            self._was_bad = True
            self._last_dump = now
            self.n_captures += 1
        return path
