"""Dependency-free metrics registry with Prometheus text exposition.

A copy of ``heatmap_tpu/obs/registry.py``: counters, gauges (optionally
callback-backed, evaluated at collect time) and fixed-bucket histograms,
each with optional labels, plus ``Registry.expose_text()`` producing the
Prometheus text exposition format (``# HELP``/``# TYPE`` +
``_bucket``/``_sum``/``_count`` series).

- **No dependencies.**  The format is simple enough to emit directly.
- **Per-instance registries.**  A registry belongs to whoever creates it
  (the runtime, or a serve-only app) — no global mutable state, so
  concurrent runtimes in one process (tests!) never share counters.
  Registration is idempotent per registry: asking for an existing
  (name, type, labels) family returns it.
- **Histograms are cumulative** (Prometheus semantics) *and* keep a
  small bounded window of recent raw samples so ``quantile(q)`` answers
  "recent p50" exactly.
- **Locked, but cheap.**  One registry-wide lock; every operation under
  it is a few arithmetic ops.
"""

from __future__ import annotations

import bisect
import collections
import math
import threading
from typing import Callable, Iterable, Mapping, Sequence

# Latency-shaped default buckets (seconds): spans 100 µs .. 30 s, dense
# around the paper's 500 ms p50 budget.
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# Freshness / lag-shaped buckets (seconds): 100 ms .. 1 h (a replay of old
# events shows the replay lag, which can be large and is the honest answer).
DEFAULT_LAG_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0, 900.0, 3600.0,
)


def _fmt(v: float) -> str:
    """Prometheus sample-value rendering: integers without a decimal
    point, floats via repr (shortest round-trip), inf/nan spelled the
    way the exposition format requires."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_suffix(labelnames: Sequence[str], labelvalues: Sequence[str],
                   extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(v)}"'
             for n, v in zip(labelnames, labelvalues)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonic counter (one labelset child of a family)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += n


class Gauge:
    """Settable value; ``fn`` makes it callback-backed (read at collect
    time — e.g. a queue depth that lives in someone else's object)."""

    __slots__ = ("_lock", "_value", "fn")

    def __init__(self, lock: threading.Lock,
                 fn: Callable[[], float] | None = None):
        self._lock = lock
        self._value = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:  # a dead callback must not break /metrics
                return float("nan")
        return self._value


class Histogram:
    """Fixed-bucket cumulative histogram + a bounded recent-sample
    window for exact recent quantiles (``quantile``), which the
    Prometheus series intentionally don't provide client-side."""

    __slots__ = ("_lock", "bounds", "bucket_counts", "sum", "count",
                 "samples")

    def __init__(self, lock: threading.Lock,
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                 window: int = 512):
        self._lock = lock
        self.bounds = tuple(sorted(float(b) for b in buckets))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bucket_counts = [0] * (len(self.bounds) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0
        self.samples: collections.deque = collections.deque(maxlen=window)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
            self.sum += v
            self.count += 1
            self.samples.append(v)

    # drop-in for the old stream.metrics.Percentiles surface
    add = observe

    def quantile(self, q: float) -> float:
        """Exact quantile over the recent window (same pick rule as the
        pre-obs Percentiles deque: index int(q*n), clamped)."""
        with self._lock:
            s = sorted(self.samples)
        if not s:
            return 0.0
        return s[min(len(s) - 1, int(q * len(s)))]


class _Family:
    """One metric name: help, type, labelnames, children by labelvalues."""

    def __init__(self, name: str, help_: str, mtype: str,
                 labelnames: Sequence[str], make_child, lock):
        self.name = name
        self.help = help_
        self.type = mtype
        self.labelnames = tuple(labelnames)
        self._make_child = make_child
        self._lock = lock
        self.children: dict[tuple, object] = {}
        if not self.labelnames:
            self.children[()] = make_child()

    def labels(self, **kw):
        if set(kw) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: labels {sorted(kw)} != declared "
                f"{sorted(self.labelnames)}")
        key = tuple(str(kw[n]) for n in self.labelnames)
        # insertion under the registry lock: the scrape thread iterates
        # children while the step loop lazily creates labelsets
        with self._lock:
            child = self.children.get(key)
            if child is None:
                child = self.children[key] = self._make_child()
        return child

    # unlabeled families proxy the single child so callers can write
    # registry.counter(...).inc() without .labels()
    def _solo(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; use .labels()")
        return self.children[()]

    def inc(self, n: float = 1):
        self._solo().inc(n)

    def set(self, v: float):
        self._solo().set(v)

    def observe(self, v: float):
        self._solo().observe(v)

    add = observe

    def quantile(self, q: float) -> float:
        return self._solo().quantile(q)

    @property
    def value(self):
        return self._solo().value

    @property
    def count(self):
        return self._solo().count

    @property
    def sum(self):
        return self._solo().sum

    @property
    def samples(self):
        return self._solo().samples


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(self, name: str, help_: str, mtype: str,
                  labelnames: Sequence[str], make_child) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.type != mtype or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered as {mtype}"
                        f"{tuple(labelnames)} (was {fam.type}"
                        f"{fam.labelnames})")
                return fam
            fam = _Family(name, help_, mtype, labelnames, make_child,
                          self._lock)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register(name, help_, "counter", labels,
                              lambda: Counter(self._lock))

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = (),
              fn: Callable[[], float] | None = None) -> _Family:
        return self._register(name, help_, "gauge", labels,
                              lambda: Gauge(self._lock, fn=fn))

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  window: int = 512) -> _Family:
        return self._register(
            name, help_, "histogram", labels,
            lambda: Histogram(self._lock, buckets=buckets, window=window))

    # ------------------------------------------------------- exposition
    def expose_text(self, extra: Iterable[str] = ()) -> str:
        """Prometheus text exposition format (0.0.4).  ``extra`` lines
        (already formatted) are appended — the serve layer uses this to
        merge ad-hoc counter dicts and the supervisor channel."""
        out: list[str] = []
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            out.append(f"# HELP {fam.name} {fam.help}")
            out.append(f"# TYPE {fam.name} {fam.type}")
            with self._lock:  # lazy labels() insertions race this walk
                children = sorted(fam.children.items())
            for lv, child in children:
                if fam.type == "histogram":
                    with self._lock:
                        counts = list(child.bucket_counts)
                        s, c = child.sum, child.count
                    cum = 0
                    for bound, n in zip(child.bounds, counts):
                        cum += n
                        suff = _labels_suffix(fam.labelnames, lv,
                                              f'le="{_fmt(bound)}"')
                        out.append(f"{fam.name}_bucket{suff} {cum}")
                    cum += counts[-1]
                    suff = _labels_suffix(fam.labelnames, lv, 'le="+Inf"')
                    out.append(f"{fam.name}_bucket{suff} {cum}")
                    plain = _labels_suffix(fam.labelnames, lv)
                    out.append(f"{fam.name}_sum{plain} {_fmt(s)}")
                    out.append(f"{fam.name}_count{plain} {c}")
                else:
                    suff = _labels_suffix(fam.labelnames, lv)
                    out.append(f"{fam.name}{suff} {_fmt(child.value)}")
        out.extend(extra)
        return "\n".join(out) + "\n"


def render_flat_counters(pairs: Mapping[str, float], prefix: str = "",
                         gauge_names: frozenset = frozenset()) -> list[str]:
    """Ad-hoc name->value dicts (stream.metrics counters, writer
    counters, source counters) rendered as exposition lines.  Names in
    ``gauge_names`` type as gauges; everything else as counters with a
    ``_total`` suffix (the Prometheus naming convention)."""
    out = []
    for name, v in sorted(pairs.items()):
        if not isinstance(v, (int, float)):
            continue
        base = prefix + "".join(
            ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
        if name in gauge_names:
            out.append(f"# TYPE {base} gauge")
            out.append(f"{base} {_fmt(v)}")
        else:
            out.append(f"# TYPE {base}_total counter")
            out.append(f"{base}_total {_fmt(v)}")
    return out
