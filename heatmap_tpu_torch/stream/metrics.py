"""Runtime metrics: the registry families and counters of one runtime.

A copy of ``heatmap_tpu/stream/metrics.py``.  Batch latency, freshness,
event age, emit-ring residency and the per-batch spans are fixed-bucket
histograms in the runtime's one registry (``/metrics``), while
``snapshot()`` gives the reference's JSON keys (``/metrics.json``); the
recent-window quantiles come from each histogram's bounded sample window.
The spans carry the reference's names and boundaries (poll, build, pad,
transfer, pull, snap, device, sink_submit, prefetch, poll_fetch,
poll_decode, poll_wait, infer), whatever finer splits the port's runtime
also keeps.

Named event counters stay a plain ``collections.Counter`` (names are
dynamic, e.g. per-pair late counts) and are rendered into the exposition
generically as ``heatmap_<name>_total``.  Every path that discards an
event accounts it through ``drop`` under one reason of the closed
``DROP_REASONS`` set.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Mapping

from heatmap_tpu_torch.obs.registry import (
    DEFAULT_LAG_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Registry,
    render_flat_counters,
)

# Counter-dict entries that are point-in-time values, not monotonic
# counts — typed as gauges in the exposition
GAUGE_NAMES = frozenset({
    "state_overflow_last_epoch", "state_capacity_per_shard",
    "uptime_s", "events_per_sec",
})

# The CLOSED set of event-drop reasons (integrity observatory,
# obs.audit): every path that discards an event must account it under
# exactly one of these labels — an untagged drop is a permanent
# conservation-ledger residual (polled == folded + dropped{reason}).
#   invalid       parse/validation rejects (stream.events)
#   late          watermark-late (incl. the clock-skew future-window
#                 poison drop, which the device fold folds into late)
#   out_of_shard  rows owned by another H3 shard (stream/shardmap.py)
#   oversample    the same ownership drop in HEATMAP_SHARD_OVERSAMPLE
#                 mode, where foreign rows are the EXPECTED majority of
#                 every poll — labeled apart so partition-skew drops
#                 don't read as misrouted-topic trouble
#   exchange      all_to_all lane-skew overflow (parallel.sharded)
#   handoff       cross-shard entity handoff re-seeds (infer.engine):
#                 the event itself WAS folded by the count path — the
#                 tag records the Kalman reducer discarding an entity's
#                 cross-shard filter history, so it is always accounted
#                 with audit=False (outside the event-conservation
#                 identity, which stays closed without it)
# ``Metrics.drop`` validates against this set (tests pin it closed) and
# keeps the legacy flat counters in lockstep.
DROP_REASONS = ("invalid", "late", "out_of_shard", "oversample",
                "exchange", "handoff")
_DROP_LEGACY = {
    "invalid": "events_invalid",
    "late": "events_late",
    "out_of_shard": "events_out_of_shard",
    "oversample": "events_out_of_shard",
    "exchange": "events_bucket_dropped",
    "handoff": "infer_handoff_reseed",
}


class Metrics:
    def __init__(self):
        self.t_start = time.monotonic()
        self.counters: collections.Counter = collections.Counter()
        self.registry = Registry()
        self.batch_latency = self.registry.histogram(
            "heatmap_batch_latency_seconds",
            "end-to-end wall time of one micro-batch step",
            buckets=DEFAULT_TIME_BUCKETS)
        self.freshness = self.registry.histogram(
            "heatmap_freshness_seconds",
            "emit wall time minus the batch's newest event timestamp",
            buckets=DEFAULT_LAG_BUCKETS)
        self._span_fam = self.registry.histogram(
            "heatmap_batch_span_seconds",
            "per-batch span wall time (poll/build/pull/snap/device/"
            "sink_submit; span=total is the whole step)",
            labels=("span",), buckets=DEFAULT_TIME_BUCKETS)
        # ---- freshness lineage series (obs.lineage): these measure the
        # END-TO-END quantity the batch spans cannot — event timestamp
        # to sink-commit ack, through prefetch queueing and the
        # device-resident emit ring (batches park up to
        # HEATMAP_EMIT_FLUSH_K deep, which the per-stage spans
        # systematically understate)
        self.event_age = self.registry.histogram(
            "heatmap_event_age_seconds",
            "event timestamp to sink commit ack per flushed batch "
            "(bound=oldest/mean/newest event of the batch) — the "
            "end-to-end ingest-to-durability freshness",
            labels=("bound",), buckets=DEFAULT_LAG_BUCKETS)
        self.ring_residency = self.registry.histogram(
            "heatmap_emit_ring_residency_seconds",
            "wall seconds a packed emit batch stayed parked in the "
            "device emit ring before the flush that pulled it",
            buckets=DEFAULT_TIME_BUCKETS)
        self.ring_residency_batches = self.registry.histogram(
            "heatmap_emit_ring_residency_batches",
            "ring appends from a batch's own (inclusive) to the flush "
            "that pulled it — how many batches deep it was held",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        # reason-labeled drop accounting (integrity observatory): one
        # family every drop path increments via ``drop`` — children
        # materialized up front so the exposition carries the full
        # closed reason set from step one
        self.dropped = self.registry.counter(
            "heatmap_events_dropped_total",
            "events discarded per closed drop reason (invalid, late, "
            "out_of_shard, oversample, exchange, handoff) — the "
            "conservation ledger's dropped{reason} term; an untagged "
            "drop path is a permanent audit residual (handoff is "
            "filter-state-only and rides outside the ledger)",
            labels=("reason",))
        for r in DROP_REASONS:
            self.dropped.labels(reason=r)
        # the integrity observatory's ledger (obs.audit.AuditState),
        # attached by the runtime under HEATMAP_AUDIT=1: ``drop`` forwards
        # every tagged drop into it, so the conservation identity closes
        self.audit = None
        # name -> histogram child, in observation order (snapshot() keys)
        self.spans: dict[str, object] = {}

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def drop(self, reason: str, n: int = 1, audit: bool = True) -> None:
        """Account ``n`` discarded events under a CLOSED drop reason:
        bumps the reason-labeled family, the legacy flat counter, and
        (when attached, for the primary accounting stream only —
        ``audit=False`` keeps secondary-pair drops out of the event
        conservation identity) the audit ledger.  An unknown reason
        raises — the set stays closed by construction."""
        legacy = _DROP_LEGACY.get(reason)
        if legacy is None:
            raise ValueError(
                f"unknown drop reason {reason!r}; the closed set is "
                f"{DROP_REASONS}")
        if n <= 0:
            return
        self.counters[legacy] += n
        self.dropped.labels(reason=reason).inc(n)
        if audit and self.audit is not None:
            self.audit.add(f"dropped_{reason}", n)

    def gauge(self, name: str, help_: str = "", fn=None, labels=()):
        """Registry gauge pass-through for the layers this Metrics is
        threaded into (runtime state capacity, writer queue depth, …)."""
        return self.registry.gauge(name, help_, labels=labels, fn=fn)

    def observe_batch(self, latency_s: float,
                      spans: Mapping[str, float]) -> None:
        self.batch_latency.observe(latency_s)
        for k, v in spans.items():
            h = self.spans.get(k)
            if h is None:
                h = self.spans[k] = self._span_fam.labels(span=k)
            h.observe(v)
        # span=total rides in the span family too, so PER-STAGE vs
        # WHOLE-STEP comparisons (and the event-age-vs-step acceptance
        # check) stay within one labeled series
        t = self.spans.get("total")
        if t is None:
            t = self.spans["total"] = self._span_fam.labels(span="total")
        t.observe(latency_s)

    def freshness_summary(self) -> dict:
        """Event-age / ring-residency summary keys — what bench &
        e2e_rate stamp into their artifacts and the per-child xproc
        freshness files publish.  {} until the first flushed batch.
        The quantiles come from the histogram's bounded RECENT window
        (not lifetime buckets) — ``window_batches`` rides along so an
        artifact reader knows how much of the run the p50/p99 cover;
        the mean is lifetime (sum/count)."""
        out: dict = {}
        mean = self.event_age.labels(bound="mean")
        if mean.count:
            out["event_age_p50_s"] = round(mean.quantile(0.5), 6)
            out["event_age_p99_s"] = round(mean.quantile(0.99), 6)
            out["window_batches"] = len(mean.samples)
        if self.ring_residency.count:
            out["ring_residency_mean_s"] = round(
                self.ring_residency.sum / self.ring_residency.count, 6)
        return out

    def snapshot(self) -> dict:
        elapsed = max(time.monotonic() - self.t_start, 1e-9)
        out = dict(self.counters)
        out["uptime_s"] = round(elapsed, 3)
        out["events_per_sec"] = round(self.counters.get("events_valid", 0) / elapsed, 1)
        out["batch_latency_p50_ms"] = round(self.batch_latency.quantile(0.5) * 1e3, 3)
        out["batch_latency_p95_ms"] = round(self.batch_latency.quantile(0.95) * 1e3, 3)
        if self.freshness.samples:
            out["freshness_p50_s"] = round(self.freshness.quantile(0.5), 3)
            out["freshness_p95_s"] = round(self.freshness.quantile(0.95), 3)
        # list() snapshot: observe_batch (step thread) inserts new span
        # keys mid-run (conditional sub-spans like poll_wait appear on
        # first observation) while scrapes iterate from the HTTP thread
        for k, p in list(self.spans.items()):
            out[f"span_{k}_p50_ms"] = round(p.quantile(0.5) * 1e3, 3)
        out.update(self.freshness_summary())
        return out

    def expose_text(self, extra_counters: Mapping[str, float] | None = None,
                    extra_lines: Iterable[str] = ()) -> str:
        """Prometheus text exposition: the registry's typed series, then
        the ad-hoc counter dict (plus any caller-merged dicts — writer /
        source counters) as generically-typed series."""
        flat = dict(self.counters)
        elapsed = max(time.monotonic() - self.t_start, 1e-9)
        flat["uptime_s"] = round(elapsed, 3)
        flat["events_per_sec"] = round(
            self.counters.get("events_valid", 0) / elapsed, 1)
        if extra_counters:
            flat.update({k: v for k, v in extra_counters.items()
                         if isinstance(v, (int, float))})
        lines = render_flat_counters(flat, prefix="heatmap_",
                                     gauge_names=GAUGE_NAMES)
        lines.extend(extra_lines)
        return self.registry.expose_text(extra=lines)
