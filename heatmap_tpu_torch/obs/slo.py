"""slo — declarative SLOs with error budgets and burn-rate alerts.

A copy of ``heatmap_tpu/obs/slo.py``.  The instant thresholds in
/healthz answer "is this value over budget RIGHT NOW" — they can neither
tell a momentary blip from a sustained burn nor say how much incident
budget the day has already spent.  This module implements the standard
SRE answer on top of the telemetry history (:mod:`obs.tsdb`):

- :class:`SloSpec` — a declarative objective over an EXISTING metric
  family (emit freshness p50, delivered-age p99, serve loop p99, repl
  lag, audit mismatches, post-warmup retraces, forecast skill, NIS
  band); each scrape tick classifies one sample good/bad against the
  spec's threshold.
- :class:`SloEngine` — rolling error-budget accounting (bad seconds
  consumed out of ``budget_frac x budget_window_s`` allowed) and
  multi-window multi-burn-rate alerting: a rule fires only when BOTH
  its short window (fast detection) and its long window (confirmation,
  kills one-tick blips) burn faster than its threshold multiple of the
  budget rate — the Google SRE workbook construction, scaled from the
  canonical 30-day windows to ``HEATMAP_SLO_BUDGET_WINDOW_S``.

A firing alert records a durable event into the tsdb (the flush happens
at fire time, exactly when the process may die next), dumps the flight
record enriched with the budget ledger and the offending series' recent
window, and surfaces in /healthz as a degradation that distinguishes
"error budget burning fast" from "momentary blip — within budget" (a
warn, never a degradation).  Recovery resolves the alert.

The reference's engine also claims one fleet episode over the
supervisor channel per alert (``channel_path``); fleet episodes belong
to the process fleet (ROADMAP A7), so here a ``channel_path`` raises.

Everything rides the recorder's injected clock, so tests script the
error rate and pin the firing tick exactly.
"""

from __future__ import annotations

import logging
import math
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Mapping

log = logging.getLogger(__name__)

ENV_BUDGET_FRAC = "HEATMAP_SLO_BUDGET_FRAC"
ENV_BUDGET_WINDOW = "HEATMAP_SLO_BUDGET_WINDOW_S"
ENV_SERVE_P99_MS = "HEATMAP_SLO_SERVE_P99_MS"
ENV_DELIVERED_P99_MS = "HEATMAP_SLO_DELIVERED_P99_MS"


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclass(frozen=True)
class SloSpec:
    """One objective.  ``kind``:

    - ``gauge`` — the latest sample is bad when ``> threshold``;
    - ``counter`` — the reset-aware increase since the previous tick
      is bad when ``> threshold`` (0 = any increase is bad);
    - ``quantile`` — the interpolated quantile of the histogram's
      traffic SINCE the previous tick (cumulative-bucket diff) is bad
      when ``> threshold``; a tick with no traffic contributes no
      sample (no data is neither good nor bad).

    ``op`` flips the badness direction for objectives where LOWER is
    worse (the quality observatory's forecast-skill floor): ``"gt"``
    (default) marks a sample bad when it exceeds the threshold,
    ``"lt"`` when it falls below.  For multi-series gauges the
    aggregate follows the direction too — worst case is the max for
    ``gt``, the min for ``lt``.
    """

    name: str
    kind: str
    series: str
    threshold: float
    q: float = 0.5
    labels: tuple = ()
    op: str = "gt"

    def label_map(self) -> dict:
        return dict(self.labels)


@dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate rule: fires when BOTH windows burn
    at >= ``burn`` times the budget rate."""

    name: str
    short_s: float
    long_s: float
    burn: float
    severity: str = "page"


def default_specs(env: Mapping[str, str] | None = None) -> tuple:
    """The declarative registry over today's families.  Thresholds
    reuse the /healthz SLO knobs where one exists, so the instant
    check and the budgeted check disagree only about duration, never
    about the objective."""
    e = os.environ if env is None else env

    def f(name, default):
        try:
            return float(e.get(name, default))
        except (TypeError, ValueError):
            return default

    return (
        SloSpec("freshness_p50", "quantile", "heatmap_event_age_seconds",
                f("HEATMAP_SLO_FRESHNESS_P50_MS", 10000.0) / 1000.0,
                q=0.5),
        SloSpec("delivered_p99", "quantile",
                "heatmap_delivered_age_seconds",
                f(ENV_DELIVERED_P99_MS, 5000.0) / 1000.0, q=0.99),
        SloSpec("serve_p99", "quantile",
                "heatmap_serve_loop_iteration_seconds",
                f(ENV_SERVE_P99_MS, 250.0) / 1000.0, q=0.99),
        SloSpec("repl_lag", "gauge", "heatmap_repl_lag_seconds",
                f("HEATMAP_SLO_REPL_LAG_S", 10.0)),
        SloSpec("audit_mismatch", "counter",
                "heatmap_audit_digest_mismatch_total", 0.0),
        SloSpec("retraces", "counter",
                "heatmap_retrace_after_warmup_total", 0.0),
        # quality-drift objectives (obs.quality, HEATMAP_QUALITY=1):
        # inert when the observatory is off — the series never exist,
        # so no tick produces a sample.  Skill is the first
        # lower-is-worse objective (op="lt": a forecast WORSE than the
        # configured floor burns budget); band error is a distance
        # (0 inside the band), so any positive sample is bad.
        SloSpec("forecast_skill", "gauge",
                "heatmap_quality_forecast_skill",
                f("HEATMAP_SLO_FORECAST_SKILL", 0.0), op="lt"),
        SloSpec("nis_band", "gauge",
                "heatmap_quality_nis_band_error", 0.0),
    )


def default_rules(budget_window_s: float,
                  scrape_s: float) -> tuple:
    """The canonical 30-day page/ticket window pairs (5m+1h @ 14.4x,
    30m+6h @ 6x) scaled linearly to the configured budget window, and
    clamped so a window always spans >= 2 scrape ticks."""
    lo = 2.0 * scrape_s

    def w(canon_s: float) -> float:
        return max(lo, canon_s * budget_window_s / (30.0 * 86400.0))

    return (
        BurnRule("fast", w(300.0), w(3600.0), 14.4, "page"),
        BurnRule("slow", w(1800.0), w(21600.0), 6.0, "ticket"),
    )


@dataclass
class _SpecState:
    samples: deque = field(default_factory=deque)   # (t, bad01)
    prev_totals: dict = field(default_factory=dict)  # counter kind
    prev_buckets: dict = field(default_factory=dict)  # quantile kind
    last_t: float = 0.0
    last_value: float | None = None
    last_bad: bool = False
    firing: str | None = None        # rule name while an alert is open
    severity: str | None = None
    episode: str | None = None       # the fleet's (A7); None here
    alerts_total: int = 0
    worst_burn: float = 0.0


class SloEngine:
    """Burn-rate evaluation driven by a :class:`TsdbRecorder`'s scrape
    ticks (``recorder.add_listener``): same thread, same clock."""

    def __init__(self, recorder, *, registry=None, tag: str = "",
                 specs=None, rules=None,
                 budget_frac: float | None = None,
                 budget_window_s: float | None = None,
                 channel_path: str | None = None, flightrec=None):
        if channel_path:
            raise NotImplementedError(
                "SloEngine(channel_path=...): fleet episodes are not "
                "ported to heatmap_tpu_torch yet (ROADMAP A7); unset "
                "HEATMAP_SUPERVISOR_CHANNEL")
        self.rec = recorder
        self.tag = str(tag or recorder.tag)
        self.budget_frac = float(
            budget_frac if budget_frac is not None
            else _env_f(ENV_BUDGET_FRAC, 0.01))
        self.budget_window_s = float(
            budget_window_s if budget_window_s is not None
            else _env_f(ENV_BUDGET_WINDOW, 86400.0))
        self.specs = tuple(specs if specs is not None
                           else default_specs())
        self.rules = tuple(rules if rules is not None
                           else default_rules(self.budget_window_s,
                                              recorder.scrape_s))
        self.flightrec = flightrec
        maxn = max(8, int(math.ceil(
            self.budget_window_s / max(recorder.scrape_s, 1e-6))) + 1)
        self._state = {s.name: _SpecState(
            samples=deque(maxlen=min(maxn, 200_000)))
            for s in self.specs}
        if flightrec is not None:
            flightrec.add_source("slo", self.snapshot)
        if registry is not None:
            self._m_bad = registry.counter(
                "heatmap_slo_bad_samples_total",
                "scrape ticks classified bad against the SLO's "
                "threshold (the error-budget spend unit)",
                labels=("slo",))
            self._m_alerts = registry.counter(
                "heatmap_slo_alerts_total",
                "burn-rate alerts fired (both windows of a rule over "
                "its threshold multiple of the budget rate)",
                labels=("slo", "severity"))
            self._m_firing = registry.gauge(
                "heatmap_slo_alert_firing",
                "1 while a burn-rate alert is open for the SLO "
                "(resolves when no rule's window pair trips)",
                labels=("slo",))
            self._m_burn = registry.gauge(
                "heatmap_slo_burn_rate",
                "current burn-rate multiple over the fastest rule's "
                "short window (1.0 = exactly the budget rate)",
                labels=("slo",))
            self._m_budget = registry.gauge(
                "heatmap_slo_budget_remaining_frac",
                "fraction of the rolling HEATMAP_SLO_BUDGET_WINDOW_S "
                "error budget not yet consumed", labels=("slo",))
        else:
            self._m_bad = self._m_alerts = self._m_firing = None
            self._m_burn = self._m_budget = None
        recorder.add_listener(self.evaluate)

    # ------------------------------------------------------ observation
    def _observe(self, spec: SloSpec, st: _SpecState, t: float):
        """(value, has_sample) for this tick from the recorder rings."""
        keys = self.rec.match(spec.series, spec.label_map())
        if spec.kind == "gauge":
            vals = []
            for k in keys:
                p = self.rec.latest(k)
                if p is not None and p[0] >= t - self.rec.scrape_s * 1.5:
                    vals.append(p[1])
            if not vals:
                return (None, False)
            # worst case across series follows the badness direction
            return (min(vals) if spec.op == "lt" else max(vals), True)
        if spec.kind == "counter":
            total_inc = 0.0
            seen = False
            for k in keys:
                p = self.rec.latest(k)
                if p is None:
                    continue
                seen = True
                prev = st.prev_totals.get(k)
                cur = p[1]
                if prev is not None:
                    total_inc += cur - prev if cur >= prev else cur
                st.prev_totals[k] = cur
            return (total_inc, seen)
        # quantile: diff the cumulative buckets of the histogram's
        # _bucket series since the previous tick; reset-aware (a bucket
        # going backwards means the writer restarted — the new
        # cumulative IS the window)
        cums: dict = {}
        bucket_keys = self.rec.match(spec.series + "_bucket",
                                     spec.label_map())
        any_traffic = False
        for k in bucket_keys:
            p = self.rec.latest(k)
            if p is None:
                continue
            _name, lbls = self.rec.parsed(k)
            le = lbls.get("le")
            if le is None:
                continue
            try:
                bound = float(le.replace("+Inf", "inf"))
            except ValueError:
                continue
            cur = p[1]
            prev = st.prev_buckets.get(k, 0.0)
            if cur < prev:
                prev = 0.0
            st.prev_buckets[k] = cur
            d = cur - prev
            cums[bound] = cums.get(bound, 0.0) + d
            if d > 0:
                any_traffic = True
        if not any_traffic:
            return (None, False)
        from heatmap_tpu_torch.obs.fleet import interp_quantile

        v = interp_quantile(cums, spec.q)
        return (v, v is not None)

    @staticmethod
    def _bad_frac(samples: deque, now: float, window: float) -> float:
        n = bad = 0
        for t, b in reversed(samples):
            if t <= now - window:
                break
            n += 1
            bad += b
        return bad / n if n else 0.0

    # ------------------------------------------------------- evaluation
    def evaluate(self, t: float) -> None:
        for spec in self.specs:
            st = self._state[spec.name]
            try:
                self._eval_spec(spec, st, t)
            except Exception:  # noqa: BLE001 - never kill the sampler
                log.warning("slo eval failed for %s", spec.name,
                            exc_info=True)
        self._persist()

    def _eval_spec(self, spec: SloSpec, st: _SpecState,
                   t: float) -> None:
        value, has = self._observe(spec, st, t)
        if not has:
            return
        bad = (value < spec.threshold if spec.op == "lt"
               else value > spec.threshold)
        st.samples.append((t, 1 if bad else 0))
        st.last_t, st.last_value, st.last_bad = t, value, bad
        if bad and self._m_bad is not None:
            self._m_bad.labels(slo=spec.name).inc()
        tripped = None
        burn_now = 0.0
        for rule in self.rules:
            bs = self._bad_frac(st.samples, t, rule.short_s) \
                / self.budget_frac
            bl = self._bad_frac(st.samples, t, rule.long_s) \
                / self.budget_frac
            burn_now = max(burn_now, min(bs, bl))
            st.worst_burn = max(st.worst_burn, min(bs, bl))
            if tripped is None and bs >= rule.burn and bl >= rule.burn:
                tripped = (rule, bs, bl)
        if self._m_burn is not None:
            self._m_burn.labels(slo=spec.name).set(round(burn_now, 4))
            self._m_budget.labels(slo=spec.name).set(
                round(self.budget(spec.name)["remaining_frac"], 4))
        if tripped is not None and st.firing is None:
            self._fire(spec, st, t, *tripped)
        elif tripped is None and st.firing is not None:
            self._resolve(spec, st, t)
        if self._m_firing is not None:
            self._m_firing.labels(slo=spec.name).set(
                1 if st.firing else 0)

    # ------------------------------------------------------ transitions
    def _fire(self, spec: SloSpec, st: _SpecState, t: float,
              rule: BurnRule, burn_short: float,
              burn_long: float) -> None:
        st.firing, st.severity = rule.name, rule.severity
        st.alerts_total += 1
        if self._m_alerts is not None:
            self._m_alerts.labels(slo=spec.name,
                                  severity=rule.severity).inc()
        ev = {"t": t, "kind": "slo_alert", "slo": spec.name,
              "rule": rule.name, "severity": rule.severity,
              "burn_short": round(burn_short, 3),
              "burn_long": round(burn_long, 3),
              "value": st.last_value,
              "threshold": spec.threshold,
              "budget": self.budget(spec.name)}
        self.rec.record_event(ev)
        self.rec.flush()        # durable NOW — this is the incident
        if self.flightrec is not None:
            # a fresh recorder's once-only dump, enriched by the "slo"
            # source registered at construction (budget ledger +
            # offending series window)
            self.flightrec.spawn().dump(
                f"slo-burn:{spec.name}:{rule.name}")

    def _resolve(self, spec: SloSpec, st: _SpecState,
                 t: float) -> None:
        ev = {"t": t, "kind": "slo_resolve", "slo": spec.name,
              "rule": st.firing, "budget": self.budget(spec.name)}
        self.rec.record_event(ev)
        self.rec.flush()
        st.firing = st.severity = None

    # --------------------------------------------------------- surfaces
    def budget(self, name: str) -> dict:
        """The rolling error-budget ledger for one SLO: seconds of
        badness allowed in the window vs consumed (bad ticks x scrape
        step)."""
        st = self._state[name]
        total = self.budget_frac * self.budget_window_s
        consumed = sum(b for _t, b in st.samples) * self.rec.scrape_s
        remaining = max(0.0, total - consumed)
        return {
            "window_s": self.budget_window_s,
            "budget_frac": self.budget_frac,
            "budget_s": round(total, 3),
            "consumed_s": round(consumed, 3),
            "remaining_s": round(remaining, 3),
            "remaining_frac": round(remaining / total, 6)
            if total > 0 else 0.0,
        }

    def healthz_checks(self) -> dict:
        """Check blocks merged into /healthz.  A firing burn-rate
        alert DEGRADES ("budget burning fast"); a bad latest sample
        without a tripped rule is a warn ("momentary blip") — visible,
        never down."""
        out = {}
        for spec in self.specs:
            st = self._state[spec.name]
            if st.last_value is None:
                continue
            key = f"slo_{spec.name}"
            check = {"value": round(float(st.last_value), 6),
                     "budget": spec.threshold,
                     "ok": st.firing is None}
            if st.firing is not None:
                check["detail"] = (
                    f"error budget burning fast (rule={st.firing}, "
                    f"severity={st.severity}, consumed="
                    f"{self.budget(spec.name)['consumed_s']}s of "
                    f"{self.budget(spec.name)['budget_s']}s)")
            elif st.last_bad:
                check["warn"] = True
                check["detail"] = ("momentary blip — within error "
                                   "budget, no burn rule tripped")
            out[key] = check
        return out

    def snapshot(self) -> dict:
        """The flight-record enrichment: every spec's budget ledger +
        alert state, and the offending series' recent window for any
        firing spec."""
        specs = {}
        offending = {}
        for spec in self.specs:
            st = self._state[spec.name]
            specs[spec.name] = {
                "kind": spec.kind, "series": spec.series,
                "threshold": spec.threshold,
                "last_value": st.last_value,
                "last_bad": st.last_bad,
                "firing": st.firing, "severity": st.severity,
                "episode": st.episode,
                "alerts_total": st.alerts_total,
                "worst_burn": round(st.worst_burn, 3),
                "budget": self.budget(spec.name),
            }
            if st.firing is not None:
                horizon = max(r.long_s for r in self.rules)
                win = {}
                for k in self.rec.match(spec.series, spec.label_map()):
                    win[k] = self.rec.window(k, st.last_t - horizon)
                offending[spec.name] = win
        return {"tag": self.tag, "specs": specs,
                "offending": offending,
                "rules": [vars(r) for r in self.rules]}

    def _persist(self) -> None:
        """slo-state.json next to the member's tsdb blocks (atomic),
        so bench runs stamp budget/burn provenance cross-process."""
        if self.rec.dir is None:
            return
        from heatmap_tpu_torch.obs.xproc import atomic_write_json

        specs = {}
        worst = 0.0
        alerts = 0
        for spec in self.specs:
            st = self._state[spec.name]
            b = self.budget(spec.name)
            specs[spec.name] = {
                "firing": st.firing,
                "alerts_total": st.alerts_total,
                "worst_burn": round(st.worst_burn, 3),
                "consumed_s": b["consumed_s"],
                "budget_s": b["budget_s"],
                "remaining_frac": b["remaining_frac"],
            }
            worst = max(worst, st.worst_burn)
            alerts += st.alerts_total
        mdir = os.path.join(self.rec.dir, self.tag)
        try:
            os.makedirs(mdir, exist_ok=True)
            atomic_write_json(os.path.join(mdir, "slo-state.json"), {
                "tag": self.tag,
                "updated_unix": round(float(self.rec.clock()), 3),
                "alerts_fired_total": alerts,
                "worst_burn": round(worst, 3),
                "budget_consumed_frac": round(max(
                    (1.0 - s["remaining_frac"] for s in specs.values()),
                    default=0.0), 6),
                "specs": specs,
            })
        except OSError:
            log.warning("slo state persist failed", exc_info=True)


def slo_stamp(dir_path: str | None = None,
              env: Mapping[str, str] | None = None) -> dict:
    """The ``slo`` artifact block bench.py / tools/bench_serve.py /
    tools/bench_history.py stamp when the telemetry history ran during
    the round: budget consumed, worst burn-rate multiple, and alerts
    fired, aggregated over every member's persisted slo-state.json.

    {} when HEATMAP_TSDB is off — a knob-off artifact stays
    byte-compatible with pre-tsdb rounds.  Refusal provenance:
    tools/check_bench_regress.py REFUSES an artifact whose run fired a
    burn-rate alert (a number earned while the pipeline was violating
    its own SLOs must never become the bar), and refuses mixed
    tsdb-knob pairs."""
    from heatmap_tpu_torch.obs.tsdb import ENV_DIR, tsdb_enabled

    e = os.environ if env is None else env
    if not tsdb_enabled(e):
        return {}
    d = dir_path if dir_path is not None else e.get(ENV_DIR, "")
    out = {"enabled": True, "alerts_fired": 0, "worst_burn": 0.0,
           "budget_consumed_frac": 0.0, "members": 0}
    if d:
        import glob as _glob
        import json as _json

        for p in sorted(_glob.glob(os.path.join(
                _glob.escape(d), "*", "slo-state.json"))):
            try:
                with open(p, "r", encoding="utf-8") as fh:
                    st = _json.load(fh)
            except (OSError, ValueError):
                continue
            if not isinstance(st, dict):
                continue
            out["members"] += 1
            out["alerts_fired"] += int(st.get("alerts_fired_total", 0))
            out["worst_burn"] = max(out["worst_burn"],
                                    float(st.get("worst_burn", 0.0)))
            out["budget_consumed_frac"] = max(
                out["budget_consumed_frac"],
                float(st.get("budget_consumed_frac", 0.0)))
    return {"slo": out}
