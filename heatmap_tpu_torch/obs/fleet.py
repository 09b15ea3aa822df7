"""The Prometheus exposition parser and the merged-bucket quantile.

A copy of the parser half of ``heatmap_tpu/obs/fleet.py``
(``_SAMPLE_RE``, ``_LABEL_RE``, ``parse_exposition``, ``_family_of``,
``interp_quantile``): the telemetry history (``obs.tsdb``) parses its
member's own ``/metrics`` text with it, and the SLO engine (``obs.slo``)
reads its quantile objectives through ``interp_quantile``.

The fleet aggregator itself (``FleetAggregator``, the ``fleet_*``
stitches, ``fleet_stamp``, ``repl_stamp``, ``compact_lineage``) belongs to
the process fleet (ROADMAP A7) and is not ported yet.
"""

from __future__ import annotations

import re

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


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
