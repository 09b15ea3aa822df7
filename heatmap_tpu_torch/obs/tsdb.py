"""tsdb — self-hosted telemetry history (the fleet's memory).

A copy of ``heatmap_tpu/obs/tsdb.py``.  Every series the observability
substrate exposes is scrape-or-lose: /metrics answers "now", /healthz is
an instant threshold, and the only post-hoc artifact is a flight-recorder
dump with no surrounding timeline.  This module gives the system a memory
of its OWN telemetry, the retrospective move the space-time history tier
made for tile data:

- :class:`TsdbRecorder` — a sampler thread scrapes the local registry
  exposition every ``HEATMAP_TSDB_SCRAPE_S`` into fixed-step in-memory
  rings (gauges last-value, counters monotonic totals with read-side
  reset detection, histograms as cumulative merged-bucket snapshots —
  uniformly: every exposition sample is one (t, value) point), records
  the member's /healthz verdict alongside, and persists append-only
  block files under ``HEATMAP_TSDB_DIR/<member-tag>/`` on the
  atomic-rename discipline of ``obs.xproc`` (tmp + rename,
  ``updated_unix`` staleness meta, ``.tmp`` skipped by readers) with
  bounded retention and a downsampled older tier.
- :class:`TsdbReader` — the cross-process read side: any member (or a
  survivor after a SIGKILL) can reassemble any member's historical
  series, healthz transitions, and recorded events from the retained
  blocks alone.  The two packages' blocks are one format: each package's
  reader reads the other's.
- :func:`member_timeline` / :func:`fleet_timeline` — the retrospective
  incident surfaces behind ``/debug/timeline`` and ``/fleet/timeline``:
  healthz transitions, SLO alerts, governor adjustments, audit
  mismatches, shed/lagged bursts, retraces, and flight-recorder
  episodes merged into one ordered timeline; the fleet form NAMES
  which member degraded first.  The governor (ROADMAP A7b) is not
  ported: its counters never appear in a port member's blocks, so its
  event kind never does either.

Everything is gated by ``HEATMAP_TSDB=1``; knob-off, nothing here is
imported on the hot path and no families register (tests pin the
exposition byte-identical).  The recorder self-reports its scrape cost
(``heatmap_tsdb_scrape_seconds``) so its overhead is bounded by a
metric, not a promise.
"""

from __future__ import annotations

import collections
import glob
import json
import logging
import os
import threading
import time
from typing import Callable, Iterable, Mapping

log = logging.getLogger(__name__)

ENV_TSDB = "HEATMAP_TSDB"
ENV_DIR = "HEATMAP_TSDB_DIR"
ENV_SCRAPE = "HEATMAP_TSDB_SCRAPE_S"
ENV_RETAIN = "HEATMAP_TSDB_RETAIN_S"
ENV_HOT = "HEATMAP_TSDB_HOT_S"
ENV_FLUSH = "HEATMAP_TSDB_FLUSH_S"
ENV_RING = "HEATMAP_TSDB_RING"

_HZ_STATUS = {"ok": 0, "degraded": 1, "down": 2}
_HZ_NAMES = {v: k for k, v in _HZ_STATUS.items()}

# counter families whose increases become timeline events, with the
# event kind they surface as (reset-aware: a restarted member's counter
# restarting at zero is resumed from the reset point, never a negative)
EVENT_COUNTERS = (
    ("heatmap_govern_adjust_total", "govern_adjust"),
    ("heatmap_audit_digest_mismatch_total", "audit_mismatch"),
    ("heatmap_serve_shed_total", "shed"),
    ("heatmap_sse_lagged_total", "lagged"),
    ("heatmap_retrace_after_warmup_total", "retrace"),
)


def tsdb_enabled(env: Mapping[str, str] | None = None) -> bool:
    e = os.environ if env is None else env
    return e.get(ENV_TSDB, "") not in ("", "0", "false")


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def series_key(name: str, labels: Mapping[str, str] | None) -> str:
    """Canonical ring key for one exposition sample: the series name
    with its labels re-rendered in sorted order, so the same sample
    always lands in the same ring regardless of emission order."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


def counter_increases(points: Iterable[tuple]) -> list:
    """Reset-aware per-interval increases of a monotonic-total series:
    ``new < previous`` means the writer restarted and the new total IS
    the increase since the reset point (the satellite fix obs_top and
    the fleet aggregator share)."""
    out = []
    prev = None
    for t, v in points:
        if prev is not None:
            d = v - prev if v >= prev else v
            if d > 0:
                out.append((t, d))
        prev = v
    return out


class TsdbRecorder:
    """In-process metrics history recorder for ONE fleet member.

    ``scrape_fn() -> exposition text`` is the member's own /metrics
    body (full registry + flat counters — exactly what the member
    snapshot publishes), ``healthz_fn() -> payload`` its /healthz
    verdict.  Construction registers the self-accounting families in
    ``registry`` (only ever called knob-on, so knob-off exposition is
    untouched); ``start()`` runs the sampler thread; listeners (the
    SLO engine) run after every ingest with the scrape timestamp —
    same thread, same injected clock, so burn-rate math is
    synthetic-clock testable tick by tick."""

    def __init__(self, scrape_fn: Callable[[], str], *, tag: str,
                 dir_path: str | None = None,
                 healthz_fn: Callable[[], dict] | None = None,
                 registry=None, scrape_s: float | None = None,
                 retain_s: float | None = None,
                 hot_s: float | None = None,
                 flush_s: float | None = None,
                 ring: int | None = None,
                 clock: Callable[[], float] = time.time):
        self.scrape_fn = scrape_fn
        self.healthz_fn = healthz_fn
        self.tag = str(tag)
        self.dir = dir_path or None
        self.clock = clock
        self.scrape_s = float(scrape_s if scrape_s is not None
                              else _env_f(ENV_SCRAPE, 5.0))
        self.retain_s = float(retain_s if retain_s is not None
                              else _env_f(ENV_RETAIN, 3 * 86400.0))
        self.hot_s = float(hot_s if hot_s is not None
                           else _env_f(ENV_HOT, 3600.0))
        self.flush_s = float(flush_s if flush_s is not None
                             else _env_f(ENV_FLUSH, 60.0))
        self._ring_n = int(ring if ring is not None
                           else _env_f(ENV_RING, 2048))
        # coarse tier step: ~10 scrapes per retained point, never finer
        # than 30 s — old enough to be cold, coarse enough to be cheap
        self.coarse_s = max(30.0, self.scrape_s * 10.0)
        self._lock = threading.Lock()
        self._rings: dict[str, collections.deque] = {}
        self._parsed: dict[str, tuple] = {}     # key -> (name, labels)
        self._types: dict[str, str] = {}        # family -> type
        self._hz: collections.deque = collections.deque(
            maxlen=self._ring_n)
        self._events: collections.deque = collections.deque(maxlen=512)
        self._pending: list = []                # scrapes since last flush
        self._pending_events: list = []
        self._listeners: list = []
        self._last_flush = None
        self._seq = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if registry is not None:
            self._m_scrape = registry.histogram(
                "heatmap_tsdb_scrape_seconds",
                "wall time of one telemetry-history scrape (parse the "
                "local exposition + ingest rings + due block flush) — "
                "the recorder's self-reported overhead, asserted under "
                "budget in-suite",
                buckets=(0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1,
                         0.25, 1.0))
            self._m_scrapes = registry.counter(
                "heatmap_tsdb_scrapes_total",
                "telemetry-history scrapes taken since boot")
            self._m_series = registry.gauge(
                "heatmap_tsdb_series",
                "distinct series currently held in the telemetry-"
                "history in-memory rings", fn=lambda: len(self._rings))
            self._m_blocks = registry.counter(
                "heatmap_tsdb_blocks_written_total",
                "telemetry-history block files persisted under "
                "HEATMAP_TSDB_DIR (raw + downsampled tiers)")
            self._m_pruned = registry.counter(
                "heatmap_tsdb_pruned_blocks_total",
                "telemetry-history block files removed by retention "
                "(HEATMAP_TSDB_RETAIN_S) or merged into the "
                "downsampled tier")
            self._m_events = registry.counter(
                "heatmap_tsdb_events_total",
                "discrete incident events (SLO alerts/resolves, ...) "
                "recorded into the telemetry history")
        else:
            self._m_scrape = self._m_scrapes = self._m_series = None
            self._m_blocks = self._m_pruned = self._m_events = None

    # ------------------------------------------------------- listeners
    def add_listener(self, fn: Callable[[float], None]) -> None:
        """``fn(t)`` runs after each ingest, on the sampler thread."""
        self._listeners.append(fn)

    # --------------------------------------------------------- scraping
    def scrape_once(self) -> float:
        """One scrape tick: parse the exposition, ingest every sample
        into its ring, record the healthz verdict, notify listeners,
        flush when due.  Returns the tick timestamp.  Never raises —
        telemetry history must not take its member down."""
        t0_cost = time.perf_counter()
        t = float(self.clock())
        try:
            self._ingest(t)
        except Exception:  # noqa: BLE001 - recorder never kills the host
            log.warning("tsdb scrape failed", exc_info=True)
        for fn in self._listeners:
            try:
                fn(t)
            except Exception:  # noqa: BLE001
                log.warning("tsdb listener failed", exc_info=True)
        try:
            if self._flush_due(t):
                self.flush(now=t)
        except Exception:  # noqa: BLE001
            log.warning("tsdb flush failed", exc_info=True)
        if self._m_scrape is not None:
            self._m_scrape.observe(time.perf_counter() - t0_cost)
            self._m_scrapes.inc()
        return t

    def _ingest(self, t: float) -> None:
        from heatmap_tpu_torch.obs.fleet import _LABEL_RE, parse_exposition

        types, samples = parse_exposition(self.scrape_fn())
        point = {}
        with self._lock:
            self._types.update(types)
            for name, labels, v in samples:
                # labels is the raw label block ("k=\"v\",...") — our
                # own registry emits it in stable order, so it is a
                # stable ring-key suffix as-is
                key = f"{name}{{{labels}}}" if labels else name
                ring = self._rings.get(key)
                if ring is None:
                    ring = self._rings[key] = collections.deque(
                        maxlen=self._ring_n)
                    self._parsed[key] = (
                        name, dict(_LABEL_RE.findall(labels or "")))
                ring.append((t, v))
                point[key] = v
        hz = None
        if self.healthz_fn is not None:
            try:
                payload = self.healthz_fn() or {}
                status = _HZ_STATUS.get(str(payload.get("status")), 1)
                failing = sorted(
                    n for n, c in (payload.get("checks") or {}).items()
                    if isinstance(c, dict) and c.get("ok") is False)
                hz = (t, status, failing)
                with self._lock:
                    self._hz.append(hz)
            except Exception:  # noqa: BLE001 - verdict is best-effort
                log.warning("tsdb healthz sample failed", exc_info=True)
        self._pending.append((t, point, hz))

    def record_event(self, ev: dict) -> None:
        """Append a discrete incident event (SLO alert, ...) to the
        history.  ``t`` defaults to the recorder clock; callers that
        need durability NOW (an alert just fired — exactly when the
        process may die next) follow with :meth:`flush`."""
        ev = dict(ev)
        ev.setdefault("t", float(self.clock()))
        ev.setdefault("member", self.tag)
        with self._lock:
            self._events.append(ev)
        self._pending_events.append(ev)
        if self._m_events is not None:
            self._m_events.inc()

    # ------------------------------------------------------ persistence
    def _flush_due(self, now: float) -> bool:
        if self.dir is None or not self._pending:
            return False
        if self._last_flush is None:
            self._last_flush = now
            return False
        return now - self._last_flush >= self.flush_s

    def flush(self, now: float | None = None) -> str | None:
        """Persist pending scrapes as one append-only block file
        (atomic tmp + rename), refresh the member meta, then apply
        downsampling + retention.  No-op without a directory."""
        now = float(self.clock()) if now is None else now
        pending, events = self._pending, self._pending_events
        self._pending, self._pending_events = [], []
        self._last_flush = now
        if self.dir is None or not (pending or events):
            return None
        from heatmap_tpu_torch.obs.xproc import atomic_write_json

        mdir = os.path.join(self.dir, self.tag)
        os.makedirs(mdir, exist_ok=True)
        series: dict[str, list] = {}
        hz = []
        for t, point, hz_s in pending:
            for key, v in point.items():
                series.setdefault(key, []).append([round(t, 3), v])
            if hz_s is not None:
                hz.append([round(hz_s[0], 3), hz_s[1], hz_s[2]])
        ts = ([p[0] for p in pending]
              + [float(e.get("t", now)) for e in events])
        t0, t1 = (min(ts), max(ts)) if ts else (now, now)
        self._seq += 1
        block = {
            "tag": self.tag, "schema": 1, "tier": 0,
            "t0": round(t0, 3), "t1": round(t1, 3),
            "scrape_s": self.scrape_s,
            "types": dict(self._types),
            "series": series, "hz": hz, "events": events,
        }
        path = os.path.join(mdir, f"block-{int(t0 * 1000):015d}"
                                  f"-{self._seq:06d}.json")
        atomic_write_json(path, block)
        atomic_write_json(os.path.join(mdir, "meta.json"), {
            "tag": self.tag, "schema": 1,
            "scrape_s": self.scrape_s,
            "updated_unix": round(float(self.clock()), 3),
        })
        if self._m_blocks is not None:
            self._m_blocks.inc()
        try:
            self._maintain(now)
        except Exception:  # noqa: BLE001 - retention is best-effort
            log.warning("tsdb retention failed", exc_info=True)
        return path

    def _maintain(self, now: float) -> None:
        """Downsample raw blocks past the hot window into the coarse
        tier (last sample per ``coarse_s`` stride; healthz transitions
        only; every event kept), then drop ANY block past retention."""
        from heatmap_tpu_torch.obs.xproc import atomic_write_json

        mdir = os.path.join(self.dir, self.tag)
        raws = sorted(glob.glob(os.path.join(glob.escape(mdir),
                                             "block-*.json")))
        cold = []
        for p in raws:
            blk = _read_block(p)
            if blk is not None and blk.get("t1", now) < now - self.hot_s:
                cold.append((p, blk))
        if cold:
            merged: dict[str, list] = {}
            types: dict[str, str] = {}
            hz, events = [], []
            for _p, blk in cold:
                types.update(blk.get("types") or {})
                for key, pts in (blk.get("series") or {}).items():
                    merged.setdefault(key, []).extend(pts)
                hz.extend(blk.get("hz") or [])
                events.extend(blk.get("events") or [])
            series = {key: _downsample(sorted(pts), self.coarse_s)
                      for key, pts in merged.items()}
            hz.sort()
            t0 = min(blk["t0"] for _p, blk in cold)
            t1 = max(blk["t1"] for _p, blk in cold)
            self._seq += 1
            atomic_write_json(
                os.path.join(mdir, f"tier1-{int(t0 * 1000):015d}"
                                   f"-{self._seq:06d}.json"),
                {"tag": self.tag, "schema": 1, "tier": 1,
                 "t0": t0, "t1": t1, "scrape_s": self.coarse_s,
                 "types": types, "series": series,
                 "hz": _hz_transitions(hz), "events": events})
            if self._m_blocks is not None:
                self._m_blocks.inc()
            for p, _blk in cold:
                try:
                    os.remove(p)
                except OSError:
                    pass
                if self._m_pruned is not None:
                    self._m_pruned.inc()
        for p in glob.glob(os.path.join(glob.escape(mdir),
                                        "tier1-*.json")):
            blk = _read_block(p)
            if blk is not None and blk.get("t1", now) < now - self.retain_s:
                try:
                    os.remove(p)
                except OSError:
                    pass
                if self._m_pruned is not None:
                    self._m_pruned.inc()

    # -------------------------------------------------------- ring reads
    def window(self, key: str, since: float) -> list:
        """Recent points of one series from the in-memory ring."""
        with self._lock:
            ring = self._rings.get(key)
            return [(t, v) for t, v in (ring or ()) if t > since]

    def latest(self, key: str):
        with self._lock:
            ring = self._rings.get(key)
            return ring[-1] if ring else None

    def match(self, name: str,
              labels: Mapping[str, str] | None = None) -> list:
        """Ring keys whose base name matches ``name`` and whose labels
        include every (k, v) in ``labels``."""
        want = dict(labels or {})
        with self._lock:
            out = []
            for key, (base, lbls) in self._parsed.items():
                if base != name:
                    continue
                if all(lbls.get(k) == v for k, v in want.items()):
                    out.append(key)
            return out

    def parsed(self, key: str) -> tuple:
        with self._lock:
            return self._parsed.get(key, (key, {}))

    # --------------------------------------------------------- lifecycle
    def start(self) -> "TsdbRecorder":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name="tsdb-recorder", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.scrape_s):
            self.scrape_once()

    def stop(self) -> None:
        """Stop the sampler and force a final flush so the last
        pre-shutdown window survives for the retrospective surfaces."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        try:
            self.flush()
        except Exception:  # noqa: BLE001
            log.warning("tsdb final flush failed", exc_info=True)


def _downsample(points: list, step: float) -> list:
    """Last sample per ``step``-wide stride: preserves gauges' level
    and counters' monotonic totals (any subsample of a cumulative
    series still yields exact increases at coarser resolution)."""
    out: dict[int, list] = {}
    for p in points:
        out[int(p[0] // step)] = p
    return [out[k] for k in sorted(out)]


def _hz_transitions(hz: list) -> list:
    out = []
    prev = None
    for e in hz:
        if prev is None or e[1] != prev:
            out.append(e)
            prev = e[1]
    return out


def _read_block(path: str) -> dict | None:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            d = json.load(fh)
        return d if isinstance(d, dict) else None
    except (OSError, ValueError):
        return None


class TsdbReader:
    """Cross-process read side over a ``HEATMAP_TSDB_DIR``: every
    member's retained blocks, with the same never-raise contract as
    every cross-process read (a corrupt or in-rename block is skipped,
    never fatal)."""

    def __init__(self, dir_path: str):
        self.dir = dir_path

    def members(self) -> list:
        out = []
        try:
            for name in sorted(os.listdir(self.dir)):
                if os.path.isfile(os.path.join(self.dir, name,
                                               "meta.json")):
                    out.append(name)
        except OSError:
            pass
        return out

    def meta(self, tag: str) -> dict | None:
        return _read_block(os.path.join(self.dir, tag, "meta.json"))

    def blocks(self, tag: str, since: float | None = None,
               until: float | None = None) -> list:
        mdir = os.path.join(self.dir, tag)
        paths = sorted(
            glob.glob(os.path.join(glob.escape(mdir), "tier1-*.json"))
            + glob.glob(os.path.join(glob.escape(mdir), "block-*.json")),
            key=lambda p: os.path.basename(p).split("-", 1)[1])
        out = []
        for p in paths:
            blk = _read_block(p)
            if blk is None:
                continue
            if since is not None and blk.get("t1", 0) < since:
                continue
            if until is not None and blk.get("t0", 0) > until:
                continue
            out.append(blk)
        return out

    def series(self, tag: str, names: Iterable[str] | None = None,
               since: float | None = None,
               until: float | None = None) -> dict:
        """``{series_key: [(t, v), ...]}`` merged across blocks, sorted
        by time.  ``names`` filters on the BASE family name (the part
        before any label braces)."""
        want = set(names) if names is not None else None
        merged: dict[str, list] = {}
        for blk in self.blocks(tag, since=since, until=until):
            for key, pts in (blk.get("series") or {}).items():
                if want is not None and key.split("{", 1)[0] not in want:
                    continue
                dst = merged.setdefault(key, [])
                for t, v in pts:
                    if since is not None and t <= since:
                        continue
                    if until is not None and t > until:
                        continue
                    dst.append((t, v))
        for pts in merged.values():
            pts.sort()
        return merged

    def healthz(self, tag: str, since: float | None = None) -> list:
        out = []
        for blk in self.blocks(tag, since=since):
            for e in blk.get("hz") or []:
                if len(e) >= 2 and (since is None or e[0] > since):
                    out.append((e[0], e[1],
                                list(e[2]) if len(e) > 2 else []))
        out.sort(key=lambda e: e[0])
        return out

    def events(self, tag: str, since: float | None = None) -> list:
        out = []
        for blk in self.blocks(tag, since=since):
            for ev in blk.get("events") or []:
                if isinstance(ev, dict) and (
                        since is None or ev.get("t", 0) > since):
                    out.append(ev)
        out.sort(key=lambda ev: ev.get("t", 0))
        return out


# ------------------------------------------------------------ timelines
def _flightrec_entries(flightrec_dir: str | None,
                       since: float | None) -> list:
    if not flightrec_dir:
        return []
    out = []
    for p in sorted(glob.glob(os.path.join(glob.escape(flightrec_dir),
                                           "flightrec-*.json"))):
        d = _read_block(p)
        if d is None:
            continue
        t = d.get("t_wall")
        if not isinstance(t, (int, float)):
            continue
        if since is not None and t <= since:
            continue
        out.append({"t": t, "kind": "flight_record",
                    "reason": d.get("reason"),
                    "episode": d.get("episode_id"),
                    "file": os.path.basename(p)})
    return out


def member_timeline(reader: TsdbReader, tag: str,
                    since: float | None = None,
                    flightrec_dir: str | None = None) -> list:
    """One member's ordered incident timeline, reconstructed from its
    retained blocks alone: healthz transitions, event-counter bursts
    (governor adjustments, audit mismatches, shed/lagged, retraces),
    recorded SLO alerts, and flight-recorder episodes."""
    entries = []
    prev = None
    for t, status, failing in reader.healthz(tag):
        if prev is not None and status != prev:
            if since is None or t > since:
                entries.append({
                    "t": t, "kind": "healthz", "member": tag,
                    "from": _HZ_NAMES.get(prev, str(prev)),
                    "to": _HZ_NAMES.get(status, str(status)),
                    "failing": failing})
        prev = status
    series = reader.series(tag, names=[n for n, _k in EVENT_COUNTERS],
                           since=None)
    kinds = dict(EVENT_COUNTERS)
    for key, pts in series.items():
        kind = kinds.get(key.split("{", 1)[0])
        if kind is None:
            continue
        for t, d in counter_increases(pts):
            if since is None or t > since:
                entries.append({"t": t, "kind": kind, "member": tag,
                                "series": key, "n": d})
    for ev in reader.events(tag, since=since):
        e = dict(ev)
        e.setdefault("kind", "event")
        e.setdefault("member", tag)
        entries.append(e)
    entries.extend(_flightrec_entries(flightrec_dir, since))
    entries.sort(key=lambda e: e.get("t", 0))
    return entries


def fleet_timeline(reader: TsdbReader, since: float | None = None,
                   flightrec_dir: str | None = None) -> dict:
    """Every member's timeline stitched into one, naming which member
    degraded FIRST (the earliest healthz transition away from ok —
    usable even after that member was SIGKILLed, because it reads the
    victim's retained blocks, not its sockets)."""
    members = reader.members()
    entries = []
    for tag in members:
        entries.extend(member_timeline(reader, tag, since=since))
    entries.extend(_flightrec_entries(flightrec_dir, since))
    entries.sort(key=lambda e: e.get("t", 0))
    first = None
    for e in entries:
        if e.get("kind") == "healthz" and e.get("to") != "ok":
            first = {"member": e.get("member"), "t": e.get("t"),
                     "to": e.get("to"), "failing": e.get("failing")}
            break
    return {"members": members, "entries": entries,
            "first_degraded": first}
