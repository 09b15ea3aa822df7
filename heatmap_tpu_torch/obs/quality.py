"""quality — the inference quality observatory.

A copy of ``heatmap_tpu/obs/quality.py``.  The Kalman reducer emits
*model outputs* (velocity fields, advected occupancy forecasts,
reason-tagged anomalies); without this module every quality number stays
offline — ``tools/score_forecast.py`` is a CLI you remember to run, and a
silently mis-calibrated filter serves wrong forecasts under a green
/healthz.  It turns statistical correctness into live production
invariants, in three coupled ledgers:

1. **Online forecast scoring.**  Every ``/api/tiles/forecast`` horizon
   registers a pending *scorecard* (the forecast's cell map plus the
   persistence baseline captured eagerly, while the base window is
   still live in the view).  When the target time matures in the event
   stream — or lands in the history tier after a restart — the card is
   scored with the *same* :func:`score_maps` skill-vs-persistence math
   the reference's offline CLI uses, into rolling per-(grid, horizon)
   skill gauges.  The ledger carries a conservation identity::

       registered == scored + expired_unscorable + pending

   pinned by tests across window advance, fake-clock eviction, and a
   kill+resume restart that scores via the history tier (scorecards
   ride the checkpoint extras).

2. **Filter-calibration ledgers.**  NIS coverage against the
   chi-square reference — a well-calibrated filter puts ~95% of
   innovations inside the 95% gate, so the observed fraction must sit
   in the ``HEATMAP_SLO_NIS_BAND`` band — plus innovation-mean bias
   (meters), anomaly rates by reason over rolling event-time windows,
   and entity-table pressure (occupancy, TTL-vs-LRU eviction mix,
   handoff rate).  The engine feeds it from the rounds kernel's ``nis``,
   ``inn`` and ``tele`` planes after their one copy to the host.  The
   anomaly reason set is CLOSED (:data:`infer.engine.ANOMALY_REASONS`):
   an unknown reason raises — a new detector must be documented, never
   silently binned.

3. **Drift → incident.**  The gauges ride the registry, so the tsdb
   records them and the SLO engine evaluates
   ``HEATMAP_SLO_FORECAST_SKILL`` (skill BELOW the floor is bad — the
   lower-is-worse objective, ``SloSpec(op="lt")``) and
   ``HEATMAP_SLO_NIS_BAND`` (distance outside the coverage band) as
   burn-rate SLOs: sustained drift burns error budget, degrades
   /healthz naming (grid, reducer, shard), and dumps a flight record
   enriched with the calibration snapshot (the runtime registers
   :meth:`QualityObservatory.snapshot` as a flightrec source).
   ``/debug/timeline`` reconstructs a model regression from the
   retained series.

Gated by ``HEATMAP_QUALITY=1`` with the kalman reducer; knob-off,
nothing is constructed, no family registers, and the runtime stays
byte-identical (tiles, feed bytes, conservation counters, window seqs).
Knob-ON is observe-only too: registration happens after the forecast
body is built and scoring never touches view state, so the same
surfaces stay byte-identical either way.  Unlike the reference's, the
identity counts the cards ``mature`` is scoring as pending, so a reader on
another thread (``/healthz``, the recorder's scrape) never sees it broken
while they are scored.  ``member_block`` is what the
fleet snapshot would publish (ROADMAP A7); ``/debug/quality`` serves
:meth:`QualityObservatory.snapshot`.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import deque
from typing import Mapping

log = logging.getLogger(__name__)

ENV_QUALITY = "HEATMAP_QUALITY"
ENV_NIS_BAND = "HEATMAP_SLO_NIS_BAND"            # "lo,hi" coverage band
ENV_FORECAST_SKILL = "HEATMAP_SLO_FORECAST_SKILL"  # rolling-skill floor

# the quality-drift objectives obs/slo.py evaluates; quality_stamp
# counts THEIR fired alerts as the artifact's drift provenance
QUALITY_SLOS = ("forecast_skill", "nis_band")

DEFAULT_NIS_BAND = (0.85, 0.995)
# calibration verdicts need statistics, not anecdotes: below this many
# update rounds in the rolling window the coverage gauges stay neutral
MIN_WINDOW_UPDATES = 100
# bounded pending set: past it the OLDEST card is evicted as
# expired_unscorable (accounted — the conservation identity still holds)
MAX_PENDING = 4096
# rolling skill per (grid, horizon): mean of the last N scored cards
SKILL_ROLL_N = 32

SCORE_OUTCOMES = ("scored", "expired_unscorable")


def quality_enabled(env: Mapping[str, str] | None = None) -> bool:
    e = os.environ if env is None else env
    return e.get(ENV_QUALITY, "0") not in ("0", "false", "")


def parse_nis_band(env: Mapping[str, str] | None = None) -> tuple:
    """(lo, hi) from ``HEATMAP_SLO_NIS_BAND="lo,hi"``; the default band
    brackets the chi-square 95% expectation with room for f32 rounding
    and short-window noise."""
    e = os.environ if env is None else env
    raw = e.get(ENV_NIS_BAND, "")
    if raw:
        try:
            lo_s, hi_s = raw.split(",")
            lo, hi = float(lo_s), float(hi_s)
            if 0.0 <= lo < hi <= 1.0:
                return (lo, hi)
        except ValueError:
            pass
        log.warning("bad %s=%r (want 'lo,hi' in [0,1]); using default",
                    ENV_NIS_BAND, raw)
    return DEFAULT_NIS_BAND


# --------------------------------------------------------------- scoring
# THE scoring implementation: the reference's tools/score_forecast.py
# imports its copy of these, so the offline CLI and the live
# observatories score with the same math, and the differential test
# pins the two copies equal.

def features_to_counts(features) -> dict:
    """{cellId: count} from a features list (forecast or range docs)."""
    out: dict = {}
    for f in features or ():
        cid = f.get("cellId")
        if cid is None:
            continue
        out[str(cid)] = out.get(str(cid), 0.0) + float(f.get("count", 0))
    return out


def normalize(counts: dict) -> dict:
    """Counts -> occupancy fractions (sum 1.0); {} stays {}."""
    total = sum(counts.values())
    if total <= 0:
        return {}
    return {k: v / total for k, v in counts.items()}


def mae(pred: dict, actual: dict) -> float:
    keys = set(pred) | set(actual)
    if not keys:
        return 0.0
    return sum(abs(pred.get(k, 0.0) - actual.get(k, 0.0))
               for k in keys) / len(keys)


def score_maps(forecast: dict, persistence: dict, actual: dict) -> dict:
    """Shape-only skill of normalized forecast vs persistence."""
    f, p, a = normalize(forecast), normalize(persistence), normalize(actual)
    mae_f, mae_p = mae(f, a), mae(p, a)
    skill = (1.0 - mae_f / mae_p) if mae_p > 0 else None
    return {
        "cells_forecast": len(f),
        "cells_persistence": len(p),
        "cells_actual": len(a),
        "mae_forecast": round(mae_f, 6),
        "mae_persistence": round(mae_p, 6),
        "skill_vs_persistence": round(skill, 4)
        if skill is not None else None,
    }


# ----------------------------------------------------------- observatory
class QualityObservatory:
    """The three coupled ledgers; one per runtime shard (like the
    audit/infer blocks), attached to the inference engine's fold."""

    def __init__(self, cfg, *, registry=None, view=None, tag: str = ""):
        self.cfg = cfg
        self.view = view
        self.tag = str(tag)
        self.reducer = "kalman"
        self.window_s = float(getattr(cfg, "quality_window_s", 600.0))
        self.lookback_s = float(getattr(cfg, "quality_lookback_s", 300.0))
        self.mature_s = float(getattr(cfg, "quality_mature_s", 60.0))
        self.ttl_s = float(getattr(cfg, "quality_ttl_s", 3600.0))
        self.band = parse_nis_band()
        try:
            self.skill_floor = float(
                os.environ.get(ENV_FORECAST_SKILL, 0.0))
        except (TypeError, ValueError):
            self.skill_floor = 0.0
        self._lock = threading.Lock()
        self._hist_reader = None
        self._hist_tried = False
        # scorecard ledger
        self._pending: deque = deque()
        # cards taken off the pending set by mature() and not resolved yet:
        # still pending to identity(), which another thread (/healthz, the
        # recorder's scrape) may read while mature() scores them
        self._maturing = 0
        self._registered = 0
        self._outcomes = {o: 0 for o in SCORE_OUTCOMES}
        self._skill_roll: dict = {}          # (grid, h) -> deque of skill
        self._last_score: dict | None = None
        # calibration ledger: event-time rolling window of per-fold
        # (t, updates, inside, inn_n, inn_e, {reason: delta}) entries
        self._folds: deque = deque()
        self._anom_last: dict = {}
        self._drift_checks = 0
        self._table: dict = {}
        self._tbl_first: dict | None = None
        # registered only when the observatory is constructed (the knob
        # gate), so knob-off exposition stays byte-identical
        self._g_skill = self._g_cov = self._g_band = None
        self._g_bias = self._g_pending = self._c_cards = None
        self._g_rate = None
        if registry is not None:
            self._g_skill = registry.gauge(
                "heatmap_quality_forecast_skill",
                "rolling live skill-vs-persistence of served forecasts "
                "per (grid, horizon), scored at target maturity with "
                "the offline CLI's exact math (obs.quality.score_maps)",
                labels=("grid", "h"))
            self._g_cov = registry.gauge(
                "heatmap_quality_nis_coverage",
                "fraction of filter-update innovations inside the "
                "chi-square 95% gate over the rolling window "
                "(calibrated ~0.95; HEATMAP_SLO_NIS_BAND bounds it)")
            self._g_band = registry.gauge(
                "heatmap_quality_nis_band_error",
                "distance of NIS coverage outside the configured band "
                "(0 inside; the drift SLO burns while it is positive)")
            self._g_bias = registry.gauge(
                "heatmap_quality_innovation_bias_m",
                "magnitude of the mean innovation vector (meters) over "
                "the rolling window — a persistent offset means the "
                "motion model or the measurements are biased")
            self._g_pending = registry.gauge(
                "heatmap_quality_pending_scorecards",
                "forecast scorecards registered but not yet matured "
                "(registered == scored + expired_unscorable + pending)",
                fn=lambda: float(len(self._pending) + self._maturing))
            self._c_cards = registry.counter(
                "heatmap_quality_scorecards_total",
                "forecast scorecards resolved by outcome (scored | "
                "expired_unscorable); with the pending gauge this is "
                "the scorecard conservation identity",
                labels=("outcome",))
            for o in SCORE_OUTCOMES:
                self._c_cards.labels(outcome=o)
            self._g_rate = registry.gauge(
                "heatmap_quality_anomaly_rate",
                "reason-tagged anomaly events per second over the "
                "rolling calibration window (closed reason set)",
                labels=("reason",))

    # ------------------------------------------------------- span reads
    def _grid_for_res(self, res: int) -> str:
        """The grid label the runtime writes for ``res`` under the
        reference window — the same default rule as the serve tier's
        bare endpoints (config.default_grid, generalized per res)."""
        wins = self.cfg.windows_minutes or (self.cfg.tile_minutes,)
        wmin = (self.cfg.tile_minutes
                if self.cfg.tile_minutes in wins else wins[0])
        return self.cfg.pair_grid(int(res), wmin)

    def _reader(self):
        """A history-tier reader (view overlaid) for spans the live
        view no longer holds — the restart scoring path.  Built
        lazily; None without HEATMAP_HIST_DIR."""
        if self._hist_tried:
            return self._hist_reader
        self._hist_tried = True
        hist_dir = getattr(self.cfg, "hist_dir", "") or ""
        if hist_dir:
            try:
                from heatmap_tpu_torch.query.history import (FileHistorySource,
                                                       HistoryReader)

                self._hist_reader = HistoryReader(
                    FileHistorySource(hist_dir), view=self.view)
            except Exception:  # noqa: BLE001 - observe-only tier
                log.warning("quality history reader unavailable",
                            exc_info=True)
        return self._hist_reader

    def _span_counts(self, grid: str, t0: float, t1: float) -> dict:
        """{cellId: count} summed over windows with t0 <= ws < t1 —
        exactly the offline CLI's ``/api/tiles/range`` aggregate
        semantics (history.windows_in_range + aggregate_range), read
        from the history tier when configured (live view overlaid),
        else from the live view alone."""
        out: dict = {}
        reader = self._reader()
        if reader is not None:
            per_window = reader.windows_in_range(grid, t0, t1)
            for ws in per_window:
                for d in per_window[ws]["docs"]:
                    cid = str(d.get("cellId"))
                    out[cid] = out.get(cid, 0.0) + float(
                        d.get("count", 0))
            return out
        if self.view is None:
            return out
        for ws, (_ws_dt, _we_dt, docs) in \
                self.view.window_docs(grid).items():
            if t0 <= ws < t1:
                for d in docs:
                    cid = str(d.get("cellId"))
                    out[cid] = out.get(cid, 0.0) + float(
                        d.get("count", 0))
        return out

    # ------------------------------------------------------- scorecards
    def register_forecast(self, res: int, h_s: float,
                          base_ts: int | None, cells: dict) -> None:
        """Register one served forecast as a pending scorecard.  Called
        from the serve handler AFTER the response body is built — the
        response stays byte-identical to a knob-off run.  The
        persistence baseline (history around base_ts) is captured NOW,
        while its windows are still live; the card itself carries both
        maps so a restart can still score it."""
        if base_ts is None:
            return  # nothing folded yet: unanchored, unscorable
        grid = self._grid_for_res(int(res))
        forecast = {format(int(c), "x"): float(n)
                    for c, n in (cells or {}).items()}
        persistence = self._span_counts(
            grid, float(base_ts) - self.lookback_s, float(base_ts) + 1)
        card = {
            "grid": grid,
            "res": int(res),
            "h": float(h_s),
            "base_ts": int(base_ts),
            "target_ts": int(base_ts) + int(h_s),
            "forecast": forecast,
            "persistence": persistence,
        }
        with self._lock:
            self._registered += 1
            self._pending.append(card)
            if len(self._pending) > MAX_PENDING:
                # bounded like every ledger: the oldest card leaves as
                # expired_unscorable, never silently dropped
                self._resolve_locked(self._pending.popleft(),
                                     "expired_unscorable")

    def _resolve_locked(self, card: dict, outcome: str,
                        skill=None) -> None:
        self._outcomes[outcome] += 1
        if self._c_cards is not None:
            self._c_cards.labels(outcome=outcome).inc()
        if outcome != "scored" or skill is None:
            return
        key = (card["grid"], int(card["h"]))
        roll = self._skill_roll.get(key)
        if roll is None:
            roll = self._skill_roll[key] = deque(maxlen=SKILL_ROLL_N)
        roll.append(float(skill))
        if self._g_skill is not None:
            self._g_skill.labels(grid=key[0], h=str(key[1])).set(
                round(sum(roll) / len(roll), 4))

    def mature(self, now_ts: int) -> None:
        """Advance the scorecard lifecycle against the event-time high
        watermark: cards whose target has matured score against the
        view/history span; cards unscorable for ``ttl_s`` past their
        target expire as ``expired_unscorable``.  Deterministic — a
        function of the event stream, never the wall clock (the
        fake-clock eviction test pins it)."""
        due: list = []
        with self._lock:
            if not self._pending:
                return
            keep: deque = deque()
            for card in self._pending:
                if now_ts >= card["target_ts"] + self.mature_s:
                    due.append(card)
                else:
                    keep.append(card)
            self._pending = keep
            self._maturing += len(due)
        for card in due:
            outcome, skill = "expired_unscorable", None
            try:
                actual = self._span_counts(
                    card["grid"],
                    card["target_ts"] - self.lookback_s,
                    card["target_ts"] + 1)
            except Exception:  # noqa: BLE001 - observe-only tier
                log.warning("scorecard span read failed", exc_info=True)
                actual = {}
            if actual:
                s = score_maps(card["forecast"], card["persistence"],
                               actual)
                outcome = "scored"
                skill = s["skill_vs_persistence"]
                self._last_score = {**s, "grid": card["grid"],
                                    "h": card["h"],
                                    "base_ts": card["base_ts"],
                                    "target_ts": card["target_ts"]}
            elif now_ts < card["target_ts"] + self.ttl_s:
                # matured but the span isn't answerable YET (history
                # compaction lag after a restart): stays pending until
                # the TTL calls it unscorable
                with self._lock:
                    self._pending.append(card)
                    self._maturing -= 1
                continue
            with self._lock:
                self._resolve_locked(card, outcome, skill)
                self._maturing -= 1

    def identity(self) -> dict:
        """The scorecard conservation identity."""
        with self._lock:
            reg = self._registered
            scored = self._outcomes["scored"]
            expired = self._outcomes["expired_unscorable"]
            pending = len(self._pending) + self._maturing
        return {
            "registered": reg,
            "scored": scored,
            "expired_unscorable": expired,
            "pending": pending,
            "ok": reg == scored + expired + pending,
        }

    # ------------------------------------------------------ calibration
    def note_fold(self, *, t: int, updates: int, inside: int,
                  inn_n: float, inn_e: float, anomalies: dict,
                  table: dict) -> None:
        """One fold's calibration contribution, called by the engine
        under its fold lock.  ``anomalies`` is the engine's CUMULATIVE
        per-reason counter dict; the reason set is CLOSED — an unknown
        reason raises (a new detector must be wired through the docs
        and the metric label set, never silently binned)."""
        from heatmap_tpu_torch.infer.engine import ANOMALY_REASONS

        unknown = set(anomalies) - set(ANOMALY_REASONS)
        if unknown:
            raise ValueError(
                f"unknown anomaly reason(s) {sorted(unknown)}: the "
                f"quality ledger's reason set is pinned closed to "
                f"{ANOMALY_REASONS}")
        with self._lock:
            deltas = {}
            for r in ANOMALY_REASONS:
                cur = int(anomalies.get(r, 0))
                deltas[r] = cur - self._anom_last.get(r, 0)
                self._anom_last[r] = cur
            self._folds.append((int(t), int(updates), int(inside),
                                float(inn_n), float(inn_e), deltas))
            cutoff = int(t) - self.window_s
            while self._folds and self._folds[0][0] <= cutoff:
                self._folds.popleft()
            self._table = dict(table)
            if self._tbl_first is None:
                self._tbl_first = dict(table)
            self._publish_locked()

    def _window_stats_locked(self) -> dict:
        upd = sum(f[1] for f in self._folds)
        inside = sum(f[2] for f in self._folds)
        inn_n = sum(f[3] for f in self._folds)
        inn_e = sum(f[4] for f in self._folds)
        rates: dict = {}
        if self._folds:
            t0 = self._folds[0][0]
            t1 = self._folds[-1][0]
            span = max(float(t1 - t0), 1.0)
            for _t, _u, _i, _n, _e, d in self._folds:
                for r, n in d.items():
                    rates[r] = rates.get(r, 0.0) + n
            rates = {r: round(n / span, 4) for r, n in rates.items()}
        cov = inside / upd if upd else None
        bias = ((inn_n / upd) ** 2 + (inn_e / upd) ** 2) ** 0.5 \
            if upd else None
        band_err = 0.0
        if cov is not None and upd >= MIN_WINDOW_UPDATES:
            lo, hi = self.band
            band_err = max(0.0, lo - cov, cov - hi)
        return {"updates": upd, "inside": inside, "coverage": cov,
                "band_error": round(band_err, 4), "bias_m": bias,
                "anomaly_rate": rates}

    def _publish_locked(self) -> None:
        if self._g_cov is None:
            return
        s = self._window_stats_locked()
        if s["coverage"] is not None:
            self._g_cov.set(round(s["coverage"], 4))
            self._g_band.set(s["band_error"])
        if s["bias_m"] is not None:
            self._g_bias.set(round(s["bias_m"], 3))
        for r, v in s["anomaly_rate"].items():
            self._g_rate.labels(reason=r).set(v)

    # --------------------------------------------------------- surfaces
    def _worst_skill_locked(self):
        """(grid, h, rolling skill) of the worst-scoring horizon."""
        worst = None
        for (grid, h), roll in self._skill_roll.items():
            if not roll:
                continue
            v = sum(roll) / len(roll)
            if worst is None or v < worst[2]:
                worst = (grid, h, v)
        return worst

    def healthz_checks(self) -> tuple[dict, bool]:
        """Instant quality checks merged into /healthz; the burn-rate
        duration discipline lives in obs/slo.py over the same gauges —
        these provide the NAMING (grid, reducer, shard) the generic
        slo_* checks cannot."""
        checks: dict = {}
        degraded = False
        with self._lock:
            cal = self._window_stats_locked()
            worst = self._worst_skill_locked()
        ident = self.identity()
        if cal["coverage"] is not None \
                and cal["updates"] >= MIN_WINDOW_UPDATES:
            lo, hi = self.band
            ok = cal["band_error"] <= 0.0
            check = {"value": round(cal["coverage"], 4),
                     "budget": f"[{lo:g}, {hi:g}]", "ok": ok}
            if not ok:
                check["detail"] = (
                    f"NIS coverage {cal['coverage']:.3f} outside the "
                    f"calibration band (reducer={self.reducer}, "
                    f"shard={self.tag or '?'}, "
                    f"updates={cal['updates']})")
            checks["quality_nis_coverage"] = check
            degraded |= not ok
        if worst is not None:
            grid, h, v = worst
            ok = v >= self.skill_floor
            check = {"value": round(v, 4), "budget": self.skill_floor,
                     "ok": ok}
            if not ok:
                check["detail"] = (
                    f"live forecast skill {v:.3f} below the SLO floor "
                    f"(grid={grid}, h={h}s, reducer={self.reducer}, "
                    f"shard={self.tag or '?'})")
            checks["quality_forecast_skill"] = check
            degraded |= not ok
        if not ident["ok"]:
            checks["quality_scorecards"] = {
                "value": (f"registered={ident['registered']} != "
                          f"scored={ident['scored']} + expired="
                          f"{ident['expired_unscorable']} + pending="
                          f"{ident['pending']}"),
                "ok": False,
                "detail": "scorecard conservation identity violated "
                          f"(shard={self.tag or '?'})"}
            degraded = True
        return checks, degraded

    def member_block(self) -> dict:
        """The fleet snapshot's ``quality`` block — the reference's
        /fleet/quality plain-sums these and names the worst shard (the
        port's fleet is ROADMAP A7); ``snapshot`` builds on it."""
        with self._lock:
            cal = self._window_stats_locked()
            skill = {f"{g}|{h}": round(sum(r) / len(r), 4)
                     for (g, h), r in self._skill_roll.items() if r}
            table = dict(self._table)
            first = dict(self._tbl_first or {})
        ident = self.identity()
        pressure = {}
        if table:
            cap = max(int(table.get("capacity", 0)), 1)
            ev_ttl = int(table.get("evicted_ttl", 0)) \
                - int(first.get("evicted_ttl", 0))
            ev_lru = int(table.get("evicted_lru", 0)) \
                - int(first.get("evicted_lru", 0))
            pressure = {
                "occupancy": int(table.get("entities", 0)),
                "capacity": cap,
                "occupancy_frac": round(
                    int(table.get("entities", 0)) / cap, 4),
                "evicted_ttl": ev_ttl,
                "evicted_lru": ev_lru,
                "lru_evict_frac": round(
                    ev_lru / max(ev_ttl + ev_lru, 1), 4),
                "reseed_handoff": int(table.get("reseed_handoff", 0)),
                "reseed_teleport": int(table.get("reseed_teleport", 0)),
            }
        return {
            "enabled": True,
            "scorecards": ident,
            "skill": skill,
            "skill_floor": self.skill_floor,
            "nis": {
                "coverage": (round(cal["coverage"], 4)
                             if cal["coverage"] is not None else None),
                "band": list(self.band),
                "band_error": cal["band_error"],
                "updates": cal["updates"],
                "bias_m": (round(cal["bias_m"], 3)
                           if cal["bias_m"] is not None else None),
            },
            "anomaly_rate": cal["anomaly_rate"],
            "table": pressure,
        }

    def snapshot(self) -> dict:
        """The flight-record enrichment: the full calibration picture
        at dump time — what the SLO engine's drift dump carries."""
        blk = self.member_block()
        with self._lock:
            blk["last_score"] = self._last_score
            blk["pending_tail"] = [
                {k: card[k] for k in ("grid", "h", "base_ts",
                                      "target_ts")}
                for card in list(self._pending)[-8:]]
        return blk

    # ------------------------------------------------------- checkpoint
    def snapshot_extra(self) -> dict:
        """Checkpoint extras payload (numpy-array dict, like the infer
        table): the pending scorecards + resolved counters as one JSON
        blob, committed atomically WITH the entity table and offsets so
        a kill+resume keeps the conservation identity exact and scores
        restored cards via the history tier."""
        import numpy as np

        with self._lock:
            state = {
                "registered": self._registered,
                "outcomes": dict(self._outcomes),
                "pending": list(self._pending),
            }
        blob = json.dumps(state).encode("utf-8")
        return {"state": np.frombuffer(blob, dtype=np.uint8)}

    def restore_extra(self, data: dict) -> int:
        """Restore a :meth:`snapshot_extra` payload; returns the number
        of pending scorecards resumed."""
        import numpy as np

        raw = data.get("state")
        if raw is None:
            return 0
        try:
            state = json.loads(np.asarray(raw, np.uint8).tobytes()
                               .decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            log.warning("quality checkpoint extra unreadable; starting "
                        "cold", exc_info=True)
            return 0
        with self._lock:
            self._registered = int(state.get("registered", 0))
            for o in SCORE_OUTCOMES:
                self._outcomes[o] = int(
                    (state.get("outcomes") or {}).get(o, 0))
            self._pending = deque(state.get("pending") or ())
            return len(self._pending)


# ------------------------------------------------------------ provenance
def quality_stamp(block: dict | None = None,
                  env: Mapping[str, str] | None = None) -> dict:
    """The ``quality`` artifact block bench.py / tools/bench_infer.py
    stamp: knob state, the run's live skill and NIS coverage (from the
    observatory's member block when the caller has one), and how many
    quality-drift SLO alerts fired (from the members' persisted
    slo-state.json, the same cross-process path as slo_stamp).

    {} when HEATMAP_QUALITY is off — a knob-off artifact stays
    byte-compatible with pre-quality rounds.  Refusal provenance:
    tools/check_bench_regress.py REFUSES an artifact whose run fired a
    drift alert and refuses mixed quality-knob pairs, and ratchets
    live_skill when both rounds carry one."""
    e = os.environ if env is None else env
    if not quality_enabled(e):
        return {}
    out = {"enabled": True, "live_skill": None, "nis_coverage": None,
           "drift_alerts": 0}
    if isinstance(block, dict):
        skills = [v for v in (block.get("skill") or {}).values()
                  if isinstance(v, (int, float))]
        if skills:
            out["live_skill"] = round(min(skills), 4)
        cov = (block.get("nis") or {}).get("coverage")
        if isinstance(cov, (int, float)):
            out["nis_coverage"] = round(float(cov), 4)
    # drift alerts: the quality SLOs' fired counts across every
    # member's persisted slo-state.json (absent/neutral without tsdb)
    from heatmap_tpu_torch.obs.tsdb import ENV_DIR

    d = e.get(ENV_DIR, "")
    if d:
        import glob as _glob

        for p in sorted(_glob.glob(os.path.join(
                _glob.escape(d), "*", "slo-state.json"))):
            try:
                with open(p, "r", encoding="utf-8") as fh:
                    st = json.load(fh)
            except (OSError, ValueError):
                continue
            specs = st.get("specs") if isinstance(st, dict) else None
            if not isinstance(specs, dict):
                continue
            for name in QUALITY_SLOS:
                s = specs.get(name)
                if isinstance(s, dict):
                    out["drift_alerts"] += int(
                        s.get("alerts_total", 0))
    return {"quality": out}
