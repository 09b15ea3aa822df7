"""Fleet observatory: federate per-member snapshots into fleet surfaces.

A copy of ``heatmap_tpu/obs/fleet.py``.  Every scale-out direction
(the replicated serve fleet, a sharded runtime, shard fan-in) runs N
processes, while the observability stack of one process — registries,
lineage, /healthz, the flight recorder — stops at the process boundary.
Cluster-wide latency and throughput accounting is the prerequisite for
partitioned scaling decisions, so the fleet view comes before anything
shards.  The exposition parser and merged-bucket quantile here also
serve the telemetry history (``obs.tsdb``) and the SLO engine
(``obs.slo``).

Members publish full snapshots next to the supervisor channel
(``obs/xproc.py`` ``publish_member_snapshot``: registry exposition
text + freshness summary + /healthz verdict + compact lineage tail).
:class:`FleetAggregator` merges them into the surfaces served by any
process holding the channel path (``serve/api.py``):

- ``/fleet/metrics`` — every member's series re-emitted with a
  ``proc="<tag>"`` label, plus fleet rollups: counters SUMMED across
  members (``heatmap_fleet_<name>``), watermark gauges MAXED, and
  fleet-level interpolated quantiles from the merged histogram buckets
  (``heatmap_fleet_event_age_p50_s`` …).  Legacy freshness-only child
  files keep surfacing as the unchanged ``heatmap_child_*`` gauges.
- ``/fleet/healthz`` — aggregate SLO verdict: any member degraded/down
  degrades/downs the fleet, and a STALE or VANISHED member (snapshot
  older than ``HEATMAP_FLEET_MAX_AGE_S``, corrupt, clock-skewed, or
  deleted after having been seen) degrades the fleet NAMING the member
  — a dead shard must never read as a healthy fleet.
- ``/fleet/freshness`` — the cross-process event-age decomposition:
  per-batch lineage records are stitched BY LINEAGE ID across members
  (a runtime shard contributes poll→fold→ring→sink stages, the member
  applying the materialized view contributes ``view_apply``), and the
  merged stages telescope conservation-exactly against the final
  stamp, the same invariant the lineage pins in-process.
- ``/fleet/delivery``, ``/fleet/audit``, ``/fleet/quality`` — the
  members' delivery, integrity and inference-quality blocks stitched.

All reads are hardened (``members_from``): a torn member file or a
skewed clock is skipped and counted (``heatmap_fleet_stale_members``),
never raised.
"""

from __future__ import annotations

import re
import threading
import time

from heatmap_tpu_torch.obs.lineage import STAGES
from heatmap_tpu_torch.obs.registry import _escape_label, _fmt
from heatmap_tpu_torch.obs.xproc import (
    FRESHNESS_FIELDS,
    SupervisorChannel,
    child_freshness_from,
    members_from,
    read_episode,
)

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

# gauge families that SUM across members (rates/depths are additive even
# though they are point-in-time); every other gauge stays per-member
# unless its name says watermark (maxed — a fleet high-water is the
# worst member's high-water)
_SUM_GAUGES = frozenset({
    "heatmap_events_per_sec", "heatmap_sink_queue_depth",
    "heatmap_emit_ring_pending", "heatmap_serve_sse_clients",
})

# The fleet's OWN metric families (everything else at /fleet/metrics is
# a member's series re-labeled, or a ``heatmap_fleet_<name>`` rollup of
# one).  This table is the single source for the exposition HELP/TYPE
# lines.
FAMILIES = (
    ("heatmap_fleet_members", "gauge",
     "member snapshots currently fresh on the channel"),
    ("heatmap_fleet_stale_members", "gauge",
     "member snapshots skipped this scrape: stale past "
     "HEATMAP_FLEET_MAX_AGE_S, torn/corrupt, clock-skewed, or vanished "
     "after having been seen"),
    ("heatmap_fleet_member_up", "gauge",
     "1 per fresh member (with role=), 0 per skipped member"),
    ("heatmap_fleet_member_age_seconds", "gauge",
     "age of each member's latest snapshot publish"),
    ("heatmap_fleet_member_event_age_p50_s", "gauge",
     "each member's recent end-to-end event-age p50, from its "
     "published freshness summary"),
    ("heatmap_fleet_member_event_age_p99_s", "gauge",
     "each member's recent end-to-end event-age p99, from its "
     "published freshness summary"),
    ("heatmap_fleet_member_delivered_age_p50_s", "gauge",
     "each member's recent delivered-age p50 (event occurrence to "
     "subscriber socket write), from its published delivery block"),
    ("heatmap_fleet_member_delivered_age_p99_s", "gauge",
     "each member's recent delivered-age p99, from its published "
     "delivery block"),
    ("heatmap_fleet_event_age_p50_s", "gauge",
     "fleet-level interpolated event-age p50 over the members' MERGED "
     "cumulative histogram buckets (per-member p50s do not average)"),
    ("heatmap_fleet_event_age_p99_s", "gauge",
     "fleet-level interpolated event-age p99 over the merged buckets"),
    ("heatmap_fleet_batch_latency_p50_s", "gauge",
     "fleet-level interpolated batch-latency p50 over the merged "
     "buckets"),
)
_FAMILY_META = {name: (mtype, help_) for name, mtype, help_ in FAMILIES}


def parse_exposition(text: str):
    """Minimal Prometheus text parse: (types {name: type}, samples
    [(series, label_block, value)]).  Unparseable lines are skipped —
    one member's garbage must not break the federation."""
    types: dict = {}
    samples: list = []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) == 4:
                types[parts[2]] = parts[3]
            continue
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            v = float(m.group(3))
        except ValueError:
            continue
        samples.append((m.group(1), m.group(2) or "", v))
    return types, samples


def _family_of(series: str, types: dict) -> str:
    """Histogram sample names fold back to their family name."""
    for suffix in ("_bucket", "_sum", "_count"):
        base = series[: -len(suffix)] if series.endswith(suffix) else None
        if base and types.get(base) == "histogram":
            return base
    return series


def interp_quantile(bucket_cums: dict, q: float) -> float | None:
    """Interpolated quantile over merged cumulative buckets
    ({le_float: cumulative_count}); None on an empty histogram.  The
    open-ended +Inf bucket reports the last finite bound (the honest
    floor — same rule as tools/obs_top.py)."""
    bounds = sorted(bucket_cums)
    if not bounds:
        return None
    total = bucket_cums[bounds[-1]]
    if total <= 0:
        return None
    target = q * total
    lo = 0.0
    prev_cum = 0.0
    for le in bounds:
        cum = max(prev_cum, bucket_cums[le])
        if cum >= target and cum > prev_cum:
            if le == float("inf"):
                return lo
            frac = (target - prev_cum) / (cum - prev_cum)
            return lo + frac * (le - lo)
        prev_cum = cum
        if le != float("inf"):
            lo = le
    return lo


def child_freshness_lines(channel_path: str | None) -> list:
    """Legacy per-child freshness summaries -> the UNCHANGED
    ``heatmap_child_<key>{child=}`` gauges (the legacy wire surface; old
    freshness-only children keep reporting next to the new member
    snapshots)."""
    kids = child_freshness_from(channel_path)
    if not kids:
        return []
    lines = []
    for k in FRESHNESS_FIELDS:
        samples = [
            (tag, d[k]) for tag, d in sorted(kids.items())
            if isinstance(d.get(k), (int, float))]
        if not samples:
            continue
        lines.append(f"# TYPE heatmap_child_{k} gauge")
        for tag, v in samples:
            lines.append(
                f'heatmap_child_{k}{{child="{_escape_label(tag)}"}} '
                f"{_fmt(v)}")
    return lines


class FleetAggregator:
    """Merges the channel's member snapshots into the fleet surfaces.

    One instance per serving process: it remembers which member tags it
    has seen, so a member whose snapshot file VANISHES (deleted, lost
    volume) degrades /fleet/healthz instead of silently shrinking the
    fleet."""

    def __init__(self, channel_path: str, max_age_s: float | None = None,
                 clock=time.time):
        self.path = channel_path
        self.max_age_s = max_age_s
        self.clock = clock
        self._lock = threading.Lock()
        self._seen: set = set()
        # per-(member, series, labels) monotonic-counter state: a member
        # restart resets its cumulative counters to zero, and a naive
        # fleet sum would DROP by the lost total — poisoning every rate
        # computed off the rollup.  (last_raw, carried_base): the rollup
        # reports base + raw, and a reset folds the pre-restart total
        # into the base so the fleet sum never goes backwards.
        self._ctr_state: dict = {}

    def _monotonic(self, tag: str, series: str, labels: str,
                   v: float) -> float:
        """Reset-aware cumulative value for one member counter series:
        identity while the counter grows, resumes from the reset point
        (prior total carried forward) after a member restart."""
        k = (tag, series, labels)
        with self._lock:
            prev, base = self._ctr_state.get(k, (v, 0.0))
            if v < prev:  # member restarted: counter came back at ~0
                base += prev
            self._ctr_state[k] = (v, base)
            if len(self._ctr_state) > 65536:  # bounded against churn
                self._ctr_state.pop(next(iter(self._ctr_state)))
        return base + v

    # ------------------------------------------------------------ collect
    def collect(self) -> tuple[dict, dict]:
        """({tag: snapshot}, {tag: reason-not-counted}) with vanished
        members folded into the second dict.  A member that published a
        departure tombstone (clean close, ``left=True``) appears in
        NEITHER: it left on purpose, so it must not degrade the fleet
        as stale — and it is forgotten here, so it cannot resurface as
        "vanished" either."""
        members, skipped = members_from(self.path,
                                        max_age_s=self.max_age_s)
        left = [tag for tag, why in skipped.items() if why == "left"]
        for tag in left:
            del skipped[tag]
        with self._lock:
            for tag in left:
                self._seen.discard(tag)
            for tag in list(self._seen)[: max(0, len(self._seen) - 256)]:
                self._seen.discard(tag)  # bounded against tag churn
            self._seen.update(members)
            self._seen.update(skipped)
            for tag in self._seen - set(members) - set(skipped):
                skipped[tag] = "vanished"
        return members, skipped

    # ------------------------------------------------------------ metrics
    def metrics_text(self) -> str:
        """The federation exposition: fleet gauges, per-member series
        with an injected ``proc`` label, rollups, and the legacy
        ``heatmap_child_*`` gauges."""
        members, skipped = self.collect()
        out: list = []
        typed: set = set()

        def own(name: str) -> None:
            """HELP/TYPE lines for one of the fleet's own families
            (FAMILIES), once per exposition."""
            if name not in typed:
                typed.add(name)
                mtype, help_ = _FAMILY_META[name]
                out.append(f"# HELP {name} {help_}")
                out.append(f"# TYPE {name} {mtype}")

        own("heatmap_fleet_members")
        out.append(f"heatmap_fleet_members {len(members)}")
        own("heatmap_fleet_stale_members")
        out.append(f"heatmap_fleet_stale_members {len(skipped)}")
        counter_sums: dict = {}     # (family, labels) -> sum
        gauge_maxes: dict = {}      # (family, labels) -> max
        gauge_sums: dict = {}       # (family, labels) -> sum
        age_buckets: dict = {}      # le -> cum (event_age, bound=mean)
        latency_buckets: dict = {}  # le -> cum (batch_latency)
        up_lines: list = []
        age_lines: list = []
        fresh_lines: dict = {
            "heatmap_fleet_member_event_age_p50_s": [],
            "heatmap_fleet_member_event_age_p99_s": [],
            "heatmap_fleet_member_delivered_age_p50_s": [],
            "heatmap_fleet_member_delivered_age_p99_s": [],
        }
        # per-member series regrouped BY FAMILY: the exposition format
        # requires one contiguous block per metric name, and with N
        # members every member contributes samples to the same families
        member_fams: dict = {}      # fam -> {"type": t, "lines": [...]}
        for tag in sorted(members):
            snap = members[tag]
            types, samples = parse_exposition(
                str(snap.get("metrics_text", "")))
            up_lbl = f'proc="{_escape_label(tag)}"'
            role = _escape_label(str(snap.get("role", "?")))
            up_lines.append(f'heatmap_fleet_member_up{{{up_lbl},'
                            f'role="{role}"}} 1')
            upd = snap.get("updated_unix", 0.0)
            age_lines.append(
                f"heatmap_fleet_member_age_seconds{{{up_lbl}}} "
                f"{_fmt(max(0.0, round(self.clock() - upd, 3)))}")
            # per-member freshness gauges from the published summary —
            # the rows obs_top --fleet renders without histogram math
            fresh = snap.get("freshness") or {}
            for key, fam in (("event_age_p50_s",
                              "heatmap_fleet_member_event_age_p50_s"),
                             ("event_age_p99_s",
                              "heatmap_fleet_member_event_age_p99_s")):
                v = fresh.get(key)
                if isinstance(v, (int, float)):
                    fresh_lines[fam].append(
                        f"{fam}{{{up_lbl}}} {_fmt(v)}")
            # per-member delivered-age gauges from the published
            # delivery block — same shape as the freshness pair
            delv = snap.get("delivery") or {}
            for key, fam in (
                    ("age_p50_s",
                     "heatmap_fleet_member_delivered_age_p50_s"),
                    ("age_p99_s",
                     "heatmap_fleet_member_delivered_age_p99_s")):
                v = delv.get(key)
                if isinstance(v, (int, float)):
                    fresh_lines[fam].append(
                        f"{fam}{{{up_lbl}}} {_fmt(v)}")
            for series, labels, v in samples:
                fam = _family_of(series, types)
                ftype = types.get(fam, "untyped")
                lbl = up_lbl + ("," + labels if labels else "")
                group = member_fams.setdefault(
                    fam, {"type": ftype, "lines": []})
                group["lines"].append(f"{series}{{{lbl}}} {_fmt(v)}")
                # ---- rollups ----------------------------------------
                key = (fam, labels)
                if ftype == "counter":
                    counter_sums[key] = (counter_sums.get(key, 0.0)
                                         + self._monotonic(
                                             tag, series, labels, v))
                elif ftype == "gauge":
                    if fam in _SUM_GAUGES:
                        gauge_sums[key] = gauge_sums.get(key, 0.0) + v
                    elif "watermark" in fam:
                        gauge_maxes[key] = max(
                            gauge_maxes.get(key, float("-inf")), v)
                elif ftype == "histogram" and series == fam + "_bucket":
                    pairs = dict(_LABEL_RE.findall(labels))
                    le_raw = pairs.pop("le", None)
                    if le_raw is None:
                        continue
                    le = (float("inf") if le_raw == "+Inf"
                          else float(le_raw))
                    if (fam == "heatmap_event_age_seconds"
                            and pairs.get("bound") == "mean"):
                        age_buckets[le] = age_buckets.get(le, 0.0) + v
                    elif fam == "heatmap_batch_latency_seconds":
                        latency_buckets[le] = (
                            latency_buckets.get(le, 0.0) + v)
        for tag in sorted(skipped):
            up_lines.append(f'heatmap_fleet_member_up{{proc='
                            f'"{_escape_label(tag)}",role="?"}} 0')
        if up_lines:
            own("heatmap_fleet_member_up")
            out.extend(up_lines)
        if age_lines:
            own("heatmap_fleet_member_age_seconds")
            out.extend(age_lines)
        for fam, lines in fresh_lines.items():
            if lines:
                own(fam)
                out.extend(lines)
        for fam, group in member_fams.items():
            if group["type"] != "untyped" and fam not in typed:
                typed.add(fam)
                out.append(f"# TYPE {fam} {group['type']}")
            out.extend(group["lines"])
        # fleet rollups: counters summed, watermarks maxed, additive
        # gauges summed — each under its own heatmap_fleet_<name>
        for (fam, labels), v in sorted(counter_sums.items()):
            self._rollup(out, typed, fam, labels, v, "counter")
        for (fam, labels), v in sorted(gauge_sums.items()):
            self._rollup(out, typed, fam, labels, v, "gauge")
        for (fam, labels), v in sorted(gauge_maxes.items()):
            self._rollup(out, typed, fam, labels, v, "gauge")
        # fleet-level interpolated quantiles over the MERGED buckets —
        # the per-member p50s do not average into a fleet p50; the
        # summed cumulative histograms do interpolate into one
        for name, buckets, qs in (
                ("heatmap_fleet_event_age", age_buckets,
                 ((0.5, "p50"), (0.99, "p99"))),
                ("heatmap_fleet_batch_latency", latency_buckets,
                 ((0.5, "p50"),))):
            for q, qname in qs:
                val = interp_quantile(buckets, q)
                if val is None:
                    continue
                own(f"{name}_{qname}_s")
                out.append(f"{name}_{qname}_s {_fmt(round(val, 6))}")
        out.extend(child_freshness_lines(self.path))
        return "\n".join(out) + "\n"

    @staticmethod
    def _rollup(out: list, typed: set, fam: str, labels: str, v: float,
                mtype: str) -> None:
        name = "heatmap_fleet_" + fam.removeprefix("heatmap_")
        if name not in typed:
            typed.add(name)
            out.append(f"# TYPE {name} {mtype}")
        suffix = "{" + labels + "}" if labels else ""
        out.append(f"{name}{suffix} {_fmt(v)}")

    # ------------------------------------------------------------ healthz
    def healthz(self) -> tuple[dict, bool]:
        """(payload, down): the aggregate fleet SLO verdict.  Any
        member degraded → fleet degraded; any member down → fleet down;
        a stale/corrupt/skewed/vanished member degrades NAMING it."""
        members, skipped = self.collect()
        checks: dict = {}
        degraded = down = False
        for tag, reason in sorted(skipped.items()):
            checks[f"member_{tag}"] = {"value": reason, "ok": False}
            degraded = True
        for tag in sorted(members):
            hz = members[tag].get("healthz") or {}
            status = hz.get("status", "ok")
            ok = status == "ok"
            failing = [k for k, c in (hz.get("checks") or {}).items()
                       if isinstance(c, dict) and not c.get("ok", True)]
            checks[f"member_{tag}"] = {
                "value": status, "ok": ok,
                **({"failing": failing} if failing else {})}
            degraded |= not ok
            down |= status == "down"
        chan = SupervisorChannel.metrics_from(self.path)
        if chan.get("gave_up"):
            checks["supervisor"] = {"value": "gave_up", "ok": False}
            down = True
        payload = {
            "ok": not down,
            "status": ("down" if down
                       else "degraded" if degraded else "ok"),
            "checks": checks,
            "members": sorted(members),
            "stale_members": sorted(skipped),
        }
        ep = read_episode(self.path)
        if ep:
            payload["episode"] = ep
        return payload, down

    # ---------------------------------------------------------- freshness
    def freshness(self, n: int = 32) -> dict:
        """The cross-process event-age decomposition: every member's
        compact lineage contributions stitched by lineage id.  Each
        merged record carries the union of stage contributions, the
        total age to the LAST stamp any member reported, and the
        conservation residual |age - sum(stages)| — exactly 0 when the
        stamps telescope (the lineage's invariant, across processes)."""
        members, skipped = self.collect()
        by_lid: dict = {}
        for tag in sorted(members):
            for rec in members[tag].get("lineage") or []:
                if not isinstance(rec, dict):
                    continue
                lid = rec.get("lid")
                stages = rec.get("stages")
                if not lid or not isinstance(stages, dict):
                    continue
                agg = by_lid.setdefault(lid, {
                    "lid": lid, "procs": [], "stages": {},
                    "ev_mean_ts": None, "t_last": None,
                    "n_events": rec.get("n_events")})
                agg["procs"].append(tag)
                for k, v in stages.items():
                    if isinstance(v, (int, float)):
                        agg["stages"][k] = v
                ts = rec.get("ev_mean_ts")
                if isinstance(ts, (int, float)):
                    agg["ev_mean_ts"] = (ts if agg["ev_mean_ts"] is None
                                         else min(agg["ev_mean_ts"], ts))
                tl = rec.get("t_last")
                if isinstance(tl, (int, float)):
                    agg["t_last"] = (tl if agg["t_last"] is None
                                     else max(agg["t_last"], tl))
        records = []
        for agg in by_lid.values():
            if agg["ev_mean_ts"] is None or agg["t_last"] is None:
                continue
            agg["age_s"] = agg["t_last"] - agg["ev_mean_ts"]
            agg["residual_s"] = agg["age_s"] - sum(agg["stages"].values())
            records.append(agg)
        records.sort(key=lambda r: r["t_last"], reverse=True)
        records = records[: max(0, int(n))]
        summary: dict = {}
        for stage in STAGES:
            vals = sorted(r["stages"][stage] for r in records
                          if stage in r["stages"])
            if vals:
                summary[f"{stage}_p50_s"] = round(
                    vals[min(len(vals) - 1, len(vals) // 2)], 6)
        if records:
            summary["max_abs_residual_s"] = round(
                max(abs(r["residual_s"]) for r in records), 6)
        return {
            "records": records,
            "stage_order": list(STAGES),
            "summary": summary,
            "members": sorted(members),
            "stale_members": sorted(skipped),
        }

    # ----------------------------------------------------------- delivery
    def delivery(self) -> tuple[dict, bool]:
        """``/fleet/delivery``: every member's delivery-lineage block
        (obs.delivery ``member_block``: delivered-age quantiles,
        per-stage p50s, worst stage, residual bound) rolled up, with
        the WORST replica named by delivered-age p50 — the row an
        operator pages on.  A stale/vanished member degrades the
        surface NAMING it (second return True → the endpoint serves
        503): a SIGKILLed replica must never read as a healthy delivery
        fleet, and the active episode (obs.xproc broadcast) rides along
        so the degradation correlates with the incident's flight
        recorder dumps."""
        from heatmap_tpu_torch.obs.delivery import (
            CROSS_HOST_STAGES,
            DELIVERY_STAGES,
        )

        members, skipped = self.collect()
        per: dict = {}
        degraded = bool(skipped)
        worst: tuple | None = None  # (age_p50_s, tag)
        reporting = 0
        for tag, reason in sorted(skipped.items()):
            per[tag] = {"skipped": reason}
        for tag in sorted(members):
            block = members[tag].get("delivery")
            if not isinstance(block, dict) or not block.get("count"):
                # a member without subscribers (or with the knob off)
                # is absent, not degraded — delivery is per-replica
                per[tag] = {"count": 0}
                continue
            per[tag] = block
            reporting += 1
            v = block.get("age_p50_s")
            if isinstance(v, (int, float)) and (worst is None
                                                or v > worst[0]):
                worst = (float(v), tag)
        payload = {
            "ok": not degraded,
            "members": per,
            "member_tags": sorted(members),
            "stale_members": sorted(skipped),
            "reporting": reporting,
            "stage_order": list(DELIVERY_STAGES),
            "cross_host": list(CROSS_HOST_STAGES),
        }
        if worst is not None:
            payload["worst"] = {
                "proc": worst[1],
                "age_p50_s": round(worst[0], 6),
                "worst_stage": (per[worst[1]].get("worst_stage")
                                if isinstance(per[worst[1]], dict)
                                else None),
            }
        ep = read_episode(self.path)
        if ep:
            payload["episode"] = ep
        return payload, degraded

    # -------------------------------------------------------------- audit
    def audit(self) -> dict:
        """``/fleet/audit``: member integrity ledgers stitched
        cross-process (summed counts re-checked against the same
        conservation identities) + the per-window shard-digest combine
        against the merged-view digest — see :func:`fleet_audit`."""
        members, skipped = self.collect()
        out = fleet_audit(members)
        out["member_tags"] = sorted(members)
        out["stale_members"] = sorted(skipped)
        return out

    def quality(self) -> dict:
        """``/fleet/quality``: member inference-quality blocks stitched
        cross-process (scorecard ledgers summed + the conservation
        identity re-checked, calibration coverage update-weighted) with
        the worst shard named — see :func:`fleet_quality`."""
        members, skipped = self.collect()
        out = fleet_quality(members)
        out["member_tags"] = sorted(members)
        out["stale_members"] = sorted(skipped)
        return out


def _hex_digest(v) -> int | None:
    try:
        return int(str(v), 16)
    except (TypeError, ValueError):
        return None


def _member_audit_summary(blk: dict) -> dict:
    verify = blk.get("verify") or {}
    res = blk.get("residuals") or {}
    worst = None
    numeric = {b: r for b, r in res.items()
               if isinstance(r, (int, float))}
    if numeric:
        b = max(numeric, key=lambda k: abs(numeric[k]))
        if numeric[b]:
            worst = {"boundary": b, "residual": numeric[b]}
    return {
        "ledger": blk.get("ledger") or {},
        "residuals": res,
        "worst_boundary": worst,
        "verify": verify,
        "repl": blk.get("repl") or {},
    }


def fleet_audit(members: dict) -> dict:
    """The cross-process integrity stitch behind ``/fleet/audit``
    (obs/audit.py is the per-member half): member conservation ledgers
    are SUMMED and re-checked against the same boundary identities
    (`residuals_from_counts` — the fleet's books must balance exactly
    as each member's do), and every member's per-shard window digests
    are XOR-combined per (grid, windowStart) against the merged-view
    owner's published view digest (disjoint cell spaces -> the combine
    must be exact).  A window whose combine mismatches names the
    member set that contributed — the production form of the 1-vs-N
    differential test."""
    from heatmap_tpu_torch.obs.audit import combine_digests, \
        residuals_from_counts

    per_member: dict = {}
    totals: dict = {}
    view_digests: dict = {}   # (grid, ws) -> (hex, owner tag)
    shard_digests: dict = {}  # (grid, ws) -> [(tag, shard, int)]
    mismatches = 0
    has_view = False
    for tag in sorted(members):
        blk = members[tag].get("audit")
        if not isinstance(blk, dict):
            continue
        per_member[tag] = _member_audit_summary(blk)
        for stage, v in (blk.get("ledger") or {}).items():
            if isinstance(v, (int, float)):
                totals[stage] = totals.get(stage, 0) + int(v)
        verify = blk.get("verify") or {}
        if isinstance(verify.get("mismatches"), (int, float)):
            mismatches += int(verify["mismatches"])
        digests = blk.get("digests") or {}
        view = digests.get("view")
        if isinstance(view, dict) and view:
            has_view = True
            for grid, per_ws in view.items():
                for ws, d in (per_ws or {}).items():
                    view_digests[(grid, ws)] = (
                        (d or {}).get("digest"), tag)
        for label, table in (digests.get("shard") or {}).items():
            for grid, per_ws in (table or {}).items():
                for ws, d in (per_ws or {}).items():
                    h = _hex_digest((d or {}).get("digest"))
                    if h is not None:
                        shard_digests.setdefault(
                            (grid, ws), []).append((tag, label, h))
    # per-window combine verdicts, for every window the merged view
    # holds: XOR over every contributing shard must equal the view —
    # a shard whose merge was skipped (or double-applied) breaks it
    combine: list = []
    combine_mismatches = 0
    if not shard_digests:
        view_digests = {}  # no emitting shards on the channel: nothing
        #                    to combine (serve-only fleets)
    for (grid, ws), (view_hex, owner) in sorted(view_digests.items()):
        want = _hex_digest(view_hex)
        contrib = shard_digests.get((grid, ws), [])
        if not contrib:
            # no shard emitted into this window THIS boot (a restart's
            # store-seeded window, or a pre-boot window) — unverifiable,
            # NOT a mismatch: flagging it would false-alarm on every
            # restart against a durable store.  A SKIPPED shard merge
            # is still caught: its surviving peers' contributions exist
            # and the XOR below comes up short.
            combine.append({
                "grid": grid, "ws": int(ws), "view": view_hex,
                "ok": None, "skipped": "no emitting shard this boot",
                "view_owner": owner, "shards": []})
            continue
        got = combine_digests(h for _t, _l, h in contrib)
        ok = want is not None and got == want
        if not ok:
            combine_mismatches += 1
        combine.append({
            "grid": grid, "ws": int(ws), "view": view_hex,
            "combined": format(got, "016x"), "ok": ok,
            "view_owner": owner,
            "shards": sorted(f"{t}/{lbl}" for t, lbl, _h in contrib),
        })
    residuals = residuals_from_counts(totals, has_view=has_view)
    worst = None
    if residuals:
        b = max(residuals, key=lambda k: abs(residuals[k]))
        if residuals[b]:
            worst = {"boundary": b, "residual": residuals[b]}
    return {
        "members": per_member,
        "ledger": totals,
        "residuals": residuals,
        "worst_boundary": worst,
        "digest_mismatches": mismatches,
        "combine": combine,
        "combine_mismatches": combine_mismatches,
        "ok": (mismatches == 0 and combine_mismatches == 0),
    }


def fleet_quality(members: dict) -> dict:
    """The cross-process inference-quality stitch behind
    ``/fleet/quality`` (obs/quality.py is the per-member half):
    scorecard ledgers are plain-summed and the summed conservation
    identity re-checked (registered == scored + expired_unscorable +
    pending must hold for the fleet exactly as for each member),
    calibration coverage is update-weighted across shards, and the
    WORST shard is named — worst calibration drift (band error) first,
    worst live skill as the tiebreak — so a fleet-level drift page
    starts with the shard to look at."""
    per_member: dict = {}
    ledger = {"registered": 0, "scored": 0, "expired_unscorable": 0,
              "pending": 0}
    upd_total = 0
    inside_total = 0
    anom: dict = {}
    worst = None          # (band_err desc, skill asc) -> naming block
    worst_key = None
    for tag in sorted(members):
        blk = members[tag].get("quality")
        if not isinstance(blk, dict):
            continue
        cards = blk.get("scorecards") or {}
        nis = blk.get("nis") or {}
        skill = blk.get("skill") or {}
        per_member[tag] = {
            "scorecards": cards,
            "nis": nis,
            "skill": skill,
            "anomaly_rate": blk.get("anomaly_rate") or {},
            "table": blk.get("table") or {},
        }
        for k in ledger:
            v = cards.get(k)
            if isinstance(v, (int, float)):
                ledger[k] += int(v)
        upd = nis.get("updates")
        cov = nis.get("coverage")
        if isinstance(upd, (int, float)) and isinstance(
                cov, (int, float)):
            upd_total += int(upd)
            inside_total += int(round(cov * upd))
        for r, v in (blk.get("anomaly_rate") or {}).items():
            if isinstance(v, (int, float)):
                anom[r] = round(anom.get(r, 0.0) + v, 4)
        band_err = nis.get("band_error")
        band_err = float(band_err) if isinstance(
            band_err, (int, float)) else 0.0
        skills = [v for v in skill.values()
                  if isinstance(v, (int, float))]
        min_skill = min(skills) if skills else None
        key = (-band_err, min_skill if min_skill is not None
               else float("inf"))
        if worst_key is None or key < worst_key:
            worst_key = key
            worst = {"tag": tag, "band_error": band_err,
                     "min_skill": min_skill}
            if skills:
                gh = min((k for k, v in skill.items()
                          if isinstance(v, (int, float))),
                         key=lambda k: skill[k])
                grid, _, h = gh.partition("|")
                worst.update({"grid": grid, "h": h})
    ident_ok = (ledger["registered"] == ledger["scored"]
                + ledger["expired_unscorable"] + ledger["pending"])
    return {
        "members": per_member,
        "scorecards": {**ledger, "ok": ident_ok},
        "nis": {
            "updates": upd_total,
            "coverage": (round(inside_total / upd_total, 4)
                         if upd_total else None),
        },
        "anomaly_rate": anom,
        "worst_shard": worst,
        "ok": ident_ok,
    }


def fleet_stamp(rate: float | None = None,
                role: str = "runtime") -> dict:
    """The ``fleet`` artifact block a benchmark stamps: how many
    members were live on the supervisor channel during the run (1 =
    standalone) and the headline normalized per member — so a sharded
    runtime's artifacts compare like-for-like against single-process
    baselines instead of conflating fleet width with per-member speed.

    Only members of ``role`` count toward the divisor: the headline is
    produced by the runtime shards (or, for a serve benchmark, the serve
    workers) — the supervisor and other sidecar members on the same
    channel do no data-path work, and dividing by them would corrupt
    the per-member baseline the stamp exists to protect."""
    import os

    from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL

    members, _skipped = members_from(os.environ.get(ENV_CHANNEL))
    workers = sorted(t for t, d in members.items()
                     if d.get("role") == role)
    n = max(1, len(workers))
    out: dict = {"members": n}
    if workers:
        out["member_tags"] = workers
    if isinstance(rate, (int, float)):
        out["per_member_rate"] = round(rate / n, 1)
    return {"fleet": out}


def repl_stamp() -> dict:
    """The ``repl`` artifact block a benchmark stamps when a REPLICATED
    serve fleet is attached to the channel: how many members are
    following a replication feed (their snapshots expose
    ``heatmap_repl_seq_lag``) and the worst seq lag among them.  {}
    when none — a standalone run's artifact stays byte-compatible with
    an unreplicated one.  Artifacts whose replica counts differ do not
    compare, so an N-replica aggregate can never mask a single-replica
    regression."""
    import os

    from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL

    members, _skipped = members_from(os.environ.get(ENV_CHANNEL))
    lags = []
    for _tag, snap in sorted(members.items()):
        _types, samples = parse_exposition(
            str(snap.get("metrics_text", "")))
        for series, _labels, v in samples:
            if series == "heatmap_repl_seq_lag":
                lags.append(v)
    if not lags:
        return {}
    return {"repl": {"replicas": len(lags),
                     "max_seq_lag": int(max(lags))}}


def compact_lineage(records: list) -> list:
    """Closed lineage records -> the compact cross-process form a
    member snapshot publishes: lid, event-time anchor, stage
    contributions, and the member's LAST stamp (view apply when the
    member applied the view, else the sink-commit ack)."""
    out = []
    for r in records:
        lid = r.get("lid")
        stages = r.get("stages")
        if not lid or not isinstance(stages, dict):
            continue
        t_last = r.get("t_view", r.get("t_sink"))
        if not isinstance(t_last, (int, float)):
            continue
        out.append({
            "lid": lid,
            "ev_mean_ts": r.get("ev_mean_ts"),
            "n_events": r.get("n_events"),
            "stages": {k: v for k, v in stages.items()
                       if isinstance(v, (int, float))},
            "t_last": t_last,
        })
    return out
