"""Adaptive micro-batching: a feedback governor for the step loop.

A copy of ``heatmap_tpu/stream/govern.py``: the same control law,
guardrails, trail, ``force`` and metric families, under the reference's
names and labels.

``BATCH_SIZE``, ``HEATMAP_EMIT_FLUSH_K`` and ``HEATMAP_PREFETCH_BATCHES``
are static env knobs, but a stream system tuned for one offered load is
wrong at every other load.  The runtime's telemetry already measures
what a controller needs: the event-age lineage (the freshness quantity
``HEATMAP_SLO_FRESHNESS_P50_MS`` budgets), emit-ring residency,
post-warmup builds and device-memory watermarks.  ``BatchGovernor``
closes that loop: with ``HEATMAP_GOVERN=1`` the static knobs become
*initial* values and the governor resizes all three within guardrails,
every ``HEATMAP_GOVERN_INTERVAL_S``.

Control law (AIMD along a bucket ladder; one move per interval):

- **breach** (recent event-age p50 over the SLO):
  - feed **saturated** (dispatch fill >= 90%): the system is
    throughput-bound — step the batch bucket UP, raise prefetch
    (``reason="saturated"``).
  - otherwise the staleness is hold/padding-bound — multiplicative
    back-off toward latency: halve flush-K; once flush-K is already 1
    and the fill is low, step the batch bucket DOWN
    (``reason="latency"``).
- **healthy** (p50 under ``HEATMAP_GOVERN_HEALTHY_FRAC`` x SLO):
  - feed **starved** (idle polls): additive recovery toward
    throughput — one bucket up, flush-K/prefetch back toward their
    configured initial values (``reason="starved"``).
  - feed **full** with headroom: one bucket up, flush-K/prefetch +1 up
    to the hard bounds (``reason="headroom"``).
- in between: hold.

Hard guardrails:

1. **No retrace storms.**  Batch sizes move only along a bucket ladder
   of power-of-two pad shapes, each dispatched once at startup as an
   all-invalid batch (an identity on the state, so the warmup never
   perturbs results).  A post-warmup build observed by the runtime's
   ``CompileTracker`` immediately FREEZES the governor at its current
   values and latches the offending bucket out of the ladder;
   ``/healthz`` degrades naming it.  In the port a build is a library
   built or loaded during a wrapped step (``obs.runtimeinfo``): eager
   PyTorch keeps no per-shape program cache, so a slab grow or a new
   pad shape builds nothing and does not freeze the governor.
2. **Memory.**  With ``HEATMAP_SLO_MEM_BYTES`` set, a watermark over
   budget blocks all growth and steps prefetch/bucket down
   (``reason="mem"``); the EmitRing growth-pressure flush path can
   force a flush-K step-down (``reason="growth_pressure"``).

A governed run over a fixed corpus produces byte-identical merged emits
to an ungoverned run: knob changes re-partition batching, never results.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

# fill-ratio threshold of the control law (rows dispatched per bucket
# slot over the interval): >= SAT_FILL reads as throughput-bound.
# Starvation is the literal "engine idle, queue empty" signal — idle
# polls (which force ring flushes, so latency is safe while starved).
SAT_FILL = 0.9


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        log.warning("%s=%r is not a number; using %s", name,
                    os.environ.get(name), default)
        return float(default)


def bucket_ladder(batch_size: int, min_batch: int) -> list:
    """The precompiled pad-bucket ladder: every power of two in
    [min_batch, batch_size), plus ``batch_size`` itself as the top
    bucket (the configured static shape, whether or not it is a power
    of two).  Ascending; always non-empty (a min at/above the batch
    size degenerates to the single static bucket)."""
    batch_size = int(batch_size)
    min_batch = max(64, int(min_batch))
    if min_batch >= batch_size:
        return [batch_size]
    sizes = []
    b = 1 << (min_batch - 1).bit_length()  # min rounded up to a pow2
    while b < batch_size:
        sizes.append(b)
        b <<= 1
    sizes.append(batch_size)
    return sizes


class BatchGovernor:
    """Resizes the live batch bucket / flush-K / prefetch depth to hold
    the freshness SLO.  Owned by the step loop: ``decide()`` runs the
    (rate-limited) control step; the runtime applies the decision
    properties at the next step boundary.  All mutation happens under
    one lock so /metrics scrapes and the step loop never tear a
    decision."""

    def __init__(self, cfg, registry, *, event_age=None,
                 compile_tracker=None, memory=None, clock=time.monotonic,
                 shard=None):
        self.cfg = cfg
        self.clock = clock
        # ``shard``: mesh-shard index for the partitioned mesh fast path
        # (stream/runtime.py runs one governor PER mesh device, so
        # skewed devices converge to different batch buckets).  The
        # metric families then carry a shard= label; None keeps the
        # historical unlabeled single-governor exposition.  All mesh
        # governors share ONE CompileTracker, so the retrace-freeze
        # guardrail latches per-LADDER: a post-warmup retrace anywhere
        # on the mesh freezes every shard's governor (the warmed-shape
        # invariant is a property of the shared ladder, not of the
        # shard that happened to trip it).
        self.shard = None if shard is None else int(shard)
        self.interval_s = float(cfg.govern_interval_s)
        self._age = event_age          # histogram child (bound="mean")
        self._tracker = compile_tracker
        self._memory = memory
        self._lock = threading.Lock()
        self.ladder = bucket_ladder(cfg.batch_size, cfg.govern_min_batch)
        # decisions: static knobs are the INITIAL values, clamped into
        # the governor's bounds
        self._idx = len(self.ladder) - 1          # start at the top
        # ceilings never override the operator's INITIAL values: a
        # configured emit_flush_k/prefetch above the growth ceiling
        # raises the ceiling rather than being silently clamped down
        # on enable (the static knobs BECOME the initial values)
        self.flush_k_min = 1
        self.flush_k_max = max(int(cfg.govern_max_flush_k),
                               int(cfg.emit_flush_k))
        self.prefetch_min = 0
        self.prefetch_max = max(int(cfg.govern_max_prefetch),
                                int(cfg.prefetch_batches))
        self._flush_k = max(cfg.emit_flush_k, self.flush_k_min)
        self._prefetch = max(cfg.prefetch_batches, self.prefetch_min)
        # recovery targets: "toward throughput" recovers to the
        # operator's configured values, not the hard ceiling
        self._flush_k_initial = self._flush_k
        self._prefetch_initial = self._prefetch
        self.frozen = False
        self.frozen_why = ""
        self.latched_bucket: int | None = None
        self._pinned_batch: int | None = None
        self._last_decide = self.clock()
        self._last_adjust: float | None = None
        # interval accounting (note_* feed these from the step loop)
        self._rows = 0
        self._dispatches = 0
        self._idles = 0
        self._growth_pressure = False
        self._age_count_last = (self._age.count
                                if self._age is not None else 0)
        self._retrace_base = (self._retraces()
                              if self._tracker is not None else 0)
        self.trail: collections.deque = collections.deque(maxlen=256)
        # ---- the metric families, the reference's names and labels.
        # With a mesh shard index the same family
        # names carry a shard= label (one child per device governor);
        # the fleet aggregator re-labels either shape with proc=.
        labelnames = () if self.shard is None else ("shard",)

        def _child(fam):
            return (fam if self.shard is None
                    else fam.labels(shard=str(self.shard)))

        self._g_batch = _child(registry.gauge(
            "heatmap_govern_batch_rows",
            "live feed-batch pad bucket the governor currently targets "
            "(rows; moves only along the precompiled bucket ladder)",
            labels=labelnames))
        self._g_flush = _child(registry.gauge(
            "heatmap_govern_flush_k",
            "live emit-ring flush interval the governor currently "
            "targets (batches per pull)", labels=labelnames))
        self._g_prefetch = _child(registry.gauge(
            "heatmap_govern_prefetch",
            "live prefetch depth the governor currently targets "
            "(batches polled ahead of the fold)", labels=labelnames))
        self._g_frozen = _child(registry.gauge(
            "heatmap_govern_frozen",
            "1 when the governor is frozen (post-warmup retrace "
            "guardrail latched a bucket out of the ladder); knobs stay "
            "at their last values", labels=labelnames))
        self._adjust_fam = registry.counter(
            "heatmap_govern_adjust_total",
            "governor knob adjustments by direction (up/down/set/"
            "freeze) and control-law reason (latency/saturated/"
            "starved/headroom/mem/growth_pressure/forced/retrace)",
            labels=("dir", "reason") + labelnames)
        age = _child(registry.gauge(
            "heatmap_govern_last_adjust_age_seconds",
            "seconds since the governor last changed any knob (NaN "
            "before the first adjustment)",
            labels=labelnames,
            fn=self._last_adjust_age if self.shard is None else None))
        if self.shard is not None:
            # labeled children share the family's make_child, so the
            # callback must be attached per child, not per family
            age.fn = self._last_adjust_age
        self._publish()

    def _adjust_inc(self, direction: str, reason: str) -> None:
        kw = {"dir": direction, "reason": reason}
        if self.shard is not None:
            kw["shard"] = str(self.shard)
        self._adjust_fam.labels(**kw).inc()

    # ------------------------------------------------------------ reads
    @property
    def batch_rows(self) -> int:
        # frozen pins the LIVE value even though the latched bucket
        # left the ladder: the current shape just (re)compiled, so
        # staying put is the only move that cannot retrace again
        if self.frozen and self._pinned_batch is not None:
            return self._pinned_batch
        return self.ladder[self._idx]

    @property
    def flush_k(self) -> int:
        return self._flush_k

    @property
    def prefetch(self) -> int:
        return self._prefetch

    def _last_adjust_age(self) -> float:
        t = self._last_adjust
        return float("nan") if t is None else max(0.0, self.clock() - t)

    def snapshot(self) -> dict:
        """Decision state for artifacts / flight records / the fleet
        member snapshot (the gauges carry the same values at /metrics)."""
        with self._lock:
            return {
                "batch_rows": self.batch_rows,
                "flush_k": self._flush_k,
                "prefetch": self._prefetch,
                "ladder": list(self.ladder),
                "frozen": self.frozen,
                "frozen_why": self.frozen_why,
                "latched_bucket": self.latched_bucket,
                "adjustments": len(self.trail),
            }

    def bounds(self) -> dict:
        """The guardrail bounds, for artifact provenance stamps."""
        return {
            "enabled": True,
            "interval_s": self.interval_s,
            "min_batch": self.ladder[0],
            "max_batch": self.ladder[-1],
            "flush_k_max": self.flush_k_max,
            "prefetch_max": self.prefetch_max,
        }

    # ---------------------------------------------------- step-loop feed
    def note_dispatch(self, n_rows: int) -> None:
        """One batch dispatched with ``n_rows`` live rows (fill
        accounting for the saturated/starved classification)."""
        self._rows += int(n_rows)
        self._dispatches += 1

    def note_idle(self) -> None:
        """One idle poll (source empty) — the starvation signal."""
        self._idles += 1

    def note_growth_pressure(self) -> None:
        """The step loop flushed the ring under state-growth pressure:
        parked batches were holding unaccounted minting against the
        slab — the next control step backs flush-K off one halving."""
        self._growth_pressure = True

    # ------------------------------------------------------------ control
    def _retraces(self) -> int:
        n = getattr(self._tracker, "retraces_total", None)
        if n is not None:  # the cheap per-step accessor (CompileTracker)
            return int(n)
        snap = self._tracker.snapshot()
        return int(snap.get("retraces_after_warmup", 0))

    def freeze(self, why: str, bucket: int | None = None) -> None:
        """Latch the governor: knobs stay at their current values, the
        offending bucket leaves the ladder, /healthz degrades naming it
        (serve.api.healthz_payload)."""
        with self._lock:
            if self.frozen:
                return
            self.frozen = True
            self.frozen_why = why
            # pin the LIVE batch value first: the freeze must not move
            # the shape (the current one just recompiled and is the
            # only warm shape left — stepping off it would retrace
            # AGAIN, observed in the live drive), even though the
            # latched bucket leaves the ladder
            self._pinned_batch = self.batch_rows
            self.latched_bucket = (self.batch_rows
                                   if bucket is None else int(bucket))
            if len(self.ladder) > 1 and self.latched_bucket in self.ladder:
                at = self.ladder.index(self.latched_bucket)
                self.ladder.pop(at)
                if self._idx >= at:
                    self._idx = max(0, self._idx - 1)
            self.trail.append({"t": self.clock(), "dir": "freeze",
                               "reason": why,
                               "bucket": self.latched_bucket})
            self._adjust_inc("freeze", "retrace")
            self._publish()
        log.warning("governor FROZEN (%s); bucket %s latched out of the "
                    "ladder, knobs pinned at batch=%d flush_k=%d "
                    "prefetch=%d", why, self.latched_bucket,
                    self.batch_rows, self._flush_k, self._prefetch)

    def check_retrace(self) -> bool:
        """The retrace guardrail, checked on the step loop (cheap: one
        locked deque read).  True when it froze the governor."""
        if self.frozen or self._tracker is None:
            return self.frozen
        if self._retraces() > self._retrace_base:
            self.freeze("post-warmup retrace detected "
                        "(CompileTracker)")
            return True
        return False

    def decide(self, now: float | None = None) -> bool:
        """One rate-limited control step; True when any knob changed.
        Runs on the step thread (the runtime applies the new decisions
        at the same step boundary)."""
        now = self.clock() if now is None else now
        if now - self._last_decide < self.interval_s:
            return False
        if self.check_retrace():
            self._last_decide = now
            return False
        with self._lock:
            self._last_decide = now
            rows, self._rows = self._rows, 0
            disp, self._dispatches = self._dispatches, 0
            idles, self._idles = self._idles, 0
            pressure, self._growth_pressure = self._growth_pressure, False
            # the interval's OWN event-age p50: only the samples that
            # landed since the last control step (the histogram's
            # 512-sample recent window spans far more than one interval,
            # and a quantile over it would see a load swing minutes
            # late).  Copy under the histogram lock — the writer thread
            # appends concurrently.
            window: list = []
            if self._age is not None:
                with self._age._lock:
                    age_n = self._age.count
                    new = min(max(0, age_n - self._age_count_last),
                              len(self._age.samples))
                    if new:
                        window = list(self._age.samples)[-new:]
                self._age_count_last = age_n
            p50_ms = None
            if window:
                window.sort()
                p50_ms = window[len(window) // 2] * 1e3
            fresh = bool(window)
            slo_ms = _env_float("HEATMAP_SLO_FRESHNESS_P50_MS", 10000.0)
            fill = (rows / (disp * self.batch_rows)) if disp else 0.0
            starved = idles > 0 or disp == 0

            before = (self._idx, self._flush_k, self._prefetch)
            mem_over = False
            if self._memory is not None:
                budget = _env_float("HEATMAP_SLO_MEM_BYTES", 0.0)
                mem_over = (budget > 0
                            and self._memory.watermark_bytes > budget)
            if mem_over:
                # memory guardrail outranks the SLO: cap prefetch x batch
                # growth and actively step both down
                self._prefetch = self.prefetch_min
                self._idx = max(0, self._idx - 1)
                reason, direction = "mem", "down"
            elif pressure:
                # the ring's growth-pressure flush already fired; hold
                # fewer batches so occupancy stats stay fresh
                self._flush_k = max(self.flush_k_min, self._flush_k // 2)
                reason, direction = "growth_pressure", "down"
            elif not fresh or p50_ms is None:
                reason, direction = "hold", None    # nothing measured
            elif p50_ms > slo_ms:
                if fill >= SAT_FILL and not starved:
                    # throughput-bound: shrinking would run away —
                    # grow capacity instead
                    self._idx = min(len(self.ladder) - 1, self._idx + 1)
                    self._prefetch = min(self.prefetch_max,
                                         self._prefetch + 1)
                    reason, direction = "saturated", "up"
                else:
                    # hold/padding staleness: multiplicative back-off
                    # toward latency — flush-K first (the ring hold is
                    # the dominant term), the bucket only once flush-K
                    # is exhausted and the fill says padding waste
                    if self._flush_k > self.flush_k_min:
                        self._flush_k = max(self.flush_k_min,
                                            self._flush_k // 2)
                    elif disp > 0 and fill < 0.5:
                        # bucket moves need fill EVIDENCE: an interval
                        # with zero dispatches (acks of earlier batches
                        # only) says nothing about padding waste
                        self._idx = max(0, self._idx - 1)
                        self._prefetch = max(self.prefetch_min,
                                             self._prefetch - 1)
                    reason, direction = "latency", "down"
            elif p50_ms < self.cfg.govern_healthy_frac * slo_ms:
                if starved:
                    # engine idle / queue empty: additive recovery
                    # toward throughput (idle polls force ring flushes,
                    # so growing costs no staleness while starved);
                    # flush-K/prefetch recover only to their configured
                    # initial values
                    self._idx = min(len(self.ladder) - 1, self._idx + 1)
                    self._flush_k = min(max(self._flush_k_initial,
                                            self.flush_k_min),
                                        self._flush_k + 1)
                    self._prefetch = min(self._prefetch_initial,
                                         self._prefetch + 1)
                    reason, direction = "starved", "up"
                elif fill >= SAT_FILL:
                    # full feed with SLO headroom: one additive step up
                    self._idx = min(len(self.ladder) - 1, self._idx + 1)
                    self._flush_k = min(self.flush_k_max,
                                        self._flush_k + 1)
                    self._prefetch = min(self.prefetch_max,
                                         self._prefetch + 1)
                    reason, direction = "headroom", "up"
                else:
                    reason, direction = "hold", None
            else:
                reason, direction = "hold", None

            changed = (self._idx, self._flush_k,
                       self._prefetch) != before
            if changed:
                self._last_adjust = now
                self.trail.append({
                    "t": now, "dir": direction, "reason": reason,
                    "batch_rows": self.batch_rows,
                    "flush_k": self._flush_k,
                    "prefetch": self._prefetch,
                    "p50_ms": (round(p50_ms, 3)
                               if p50_ms is not None else None),
                    "fill": round(fill, 4), "idles": idles,
                })
                self._adjust_inc(direction or "hold", reason)
                self._publish()
            return changed

    def force(self, batch_rows: int | None = None,
              flush_k: int | None = None, prefetch: int | None = None,
              reason: str = "forced") -> None:
        """Pin decisions directly (tests / operator tooling).  Batch
        values must be ladder buckets — the no-retrace guarantee only
        covers warmed shapes."""
        with self._lock:
            if batch_rows is not None:
                if batch_rows not in self.ladder:
                    raise ValueError(
                        f"{batch_rows} is not a ladder bucket "
                        f"{self.ladder}")
                self._idx = self.ladder.index(batch_rows)
            if flush_k is not None:
                self._flush_k = min(max(int(flush_k), self.flush_k_min),
                                    self.flush_k_max)
            if prefetch is not None:
                self._prefetch = min(max(int(prefetch),
                                         self.prefetch_min),
                                     self.prefetch_max)
            self._last_adjust = self.clock()
            self.trail.append({"t": self._last_adjust, "dir": "set",
                               "reason": reason,
                               "batch_rows": self.batch_rows,
                               "flush_k": self._flush_k,
                               "prefetch": self._prefetch})
            self._adjust_inc("set", reason)
            self._publish()

    def _publish(self) -> None:
        self._g_batch.set(self.batch_rows)
        self._g_flush.set(self._flush_k)
        self._g_prefetch.set(self._prefetch)
        self._g_frozen.set(1.0 if self.frozen else 0.0)
