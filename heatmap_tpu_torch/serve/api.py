"""WSGI application: tiles/positions GeoJSON + query tier + metrics + UI.

A copy of ``heatmap_tpu/serve/api.py`` for both serve cores (the thread
core, wsgiref with a thread per request and per SSE subscriber, and the
``HEATMAP_SERVE_CORE=epoll`` event loop, serve/evloop.py) over the
materialized tile view, a writer-fed one or a replica following a
replication feed (``HEATMAP_REPL_FEED``):

- GET /api/tiles/latest  → FeatureCollection of Polygon features for the
  newest windowStart, properties {cellId, count, avgSpeedKmh, windowStart,
  windowEnd} (+ p95SpeedKmh, stddevSpeedKmh, windowMinutes, vxKmh, vyKmh
  when present).  ``?grid=`` selects a pyramid grid; ``?res=`` serves the
  incremental zoom-out rollup (query.pyramid); ``?fmt=bin`` / ``Accept``
  negotiates the binary tile frame (serve/wire.py).  Strong ``ETag`` +
  ``If-None-Match`` → 304 whenever the materialized view is available.
- GET /api/positions/latest → FeatureCollection of Point features,
  properties {provider, vehicleId, ts}, with the same ETag/304 handling
  keyed on the store write-version, and the binary positions frame.
- GET /api/tiles/delta?since=<seq> → changed cells only since view seq
  ``since`` + the next seq (mode "delta" | "full").
- GET /api/tiles/stream?since=&grid= → the same delta payloads pushed as
  Server-Sent Events (``event: tiles`` / ``tiles-bin``).
- GET /api/tiles/topk?k=&grid=&res=&bbox= → top-k tiles of the latest
  window by count.
- GET /api/tiles/forecast?h=&res= → the Kalman reducer's short-horizon
  occupancy forecast (``InferenceEngine.forecast_cells``); 503 without
  the engine in this process.
- POST/GET/DELETE /api/queries, GET /api/queries/stream → continuous
  spatial queries (query.continuous).
- GET /api/tiles/range?grid&t0&t1[&res][&fmt=bin], /api/tiles/at?seq=,
  /api/tiles/diff?t0&t1 → the space-time history tier
  (query/history.py, ``HEATMAP_HIST_DIR``; a replica following an http
  feed reads the writer's /api/hist/* re-export); /api/hist/index |
  /api/hist/chunk?name= → the chunk store re-exported for remote
  replicas.
- GET /api/repl/meta | /snapshot?epoch= | /feed?epoch=&since=&max= →
  the view-replication feed (query/repl.py, ``HEATMAP_REPL_DIR``) over
  HTTP, what a replica's ``HEATMAP_REPL_FEED=http://writer:port``
  follower polls.
- GET / → the embedded Leaflet UI; /metrics.json, /metrics, /healthz,
  /debug/view, /debug/requests.
- GET /trace/recent[?n=&fields=] (the runtime's batch trace records),
  /debug/freshness[?n=] (its closed lineage records and event-age
  summary), /debug/stacks[?n=] (the stack sampler, started on first
  read); POST /debug/profile[?batches=&skip=&dir=] arms the runtime's
  profiler window (405 on another method, 409 while a window is pending
  or active, ``dir=`` only under ``HEATMAP_PROFILE_DIR`` or the temp
  directory).

- GET /debug/timeline[?since=] and /fleet/timeline[?since=] (the
  retrospective incident timeline of this member, and of every member
  under ``HEATMAP_TSDB_DIR``, rebuilt from the telemetry history's
  retained blocks; 503 without ``HEATMAP_TSDB=1`` and a directory),
  /debug/quality (the runtime's quality observatory; 503 without
  ``HEATMAP_QUALITY=1`` and the kalman reducer).  Under
  ``HEATMAP_TSDB=1`` a serve-only app runs its own recorder and SLO
  engine (``app.tsdb``, ``app.slo_engine``), tagged ``HEATMAP_FLEET_TAG``
  or ``serve<pid>``, stopped by ``app.close()``; the SLO and quality
  checks join ``/healthz``, and each ``/api/tiles/forecast`` horizon
  registers a scorecard after its body is built.

Fleet observatory (obs.fleet; served by ANY process holding the
supervisor channel path ``HEATMAP_SUPERVISOR_CHANNEL`` — 503 without
one):

- GET /fleet/metrics → the federation exposition: every member
  snapshot's series re-emitted with a ``proc="<tag>"`` label, fleet
  rollups (counters summed, watermark gauges maxed, additive gauges
  summed as ``heatmap_fleet_<name>``), fleet-level interpolated
  quantiles over the merged histograms, per-member freshness and
  delivered-age gauges, and the legacy ``heatmap_child_*`` gauges.
- GET /fleet/healthz → the aggregate SLO verdict: any member degraded
  degrades the fleet, any member down (or a supervisor that gave up)
  downs it (HTTP 503), and a stale / corrupt / clock-skewed / vanished
  member degrades the fleet NAMING the member.
- GET /fleet/freshness[?n=] → the cross-process event-age
  decomposition, member lineage contributions stitched by lineage id.
- GET /fleet/delivery → the members' delivery blocks rolled up, the
  worst replica named (HTTP 503 while a member is stale or vanished).
- GET /fleet/audit → member ledgers summed and re-checked against the
  conservation identities, and every (grid, windowStart)'s per-shard
  digests XOR-combined against the merged-view digest.
- GET /fleet/quality → the members' quality blocks stitched.

A serve-only worker publishes its own member snapshot there
(``ServeFleetMember``, tag ``serve<pid>``, started by ``serve_forever``),
with a fleet-mode SLO watchdog; a runtime-attached process publishes from
the runtime's loop.  Under ``HEATMAP_AUDIT=1`` GET /debug/audit serves this
process's conservation ledger and digest verification state (a serve-only
worker builds its own ``AuditState`` and view digest table, and verifies
every applied feed record's ``"dg"``; 503 with auditing off) and its checks
join /healthz.  GET /debug/delivery[?n=] serves this process's delivery
lineage (the telescoping delivered-age decomposition, recent samples and
every subscriber's write-stall state): the follower installs each applied
record's writer stamps, the SSE pumps stamp each frame's encode, and both
serve cores complete a sample when a subscriber's socket write returns;
a replica with samples adds ``delivered_age_p50_ms`` to /healthz
(``HEATMAP_SLO_DELIVERED_P50_MS``, default 2000).  With
``HEATMAP_FLIGHTREC_DIR`` the app arms a flight recorder with its delivery
and request sources, dumped on the first slow request.

No request path touches the device: the view holds host dicts only, the
runtime's metrics come from the snapshot its step thread publishes at each
batch end (``metrics_snapshot``) and from its registry's families.

Unlike the reference, ``serve_port=0`` binds an ephemeral port
(``start_background`` returns the one bound).
"""

from __future__ import annotations

import collections
import datetime as dt
import functools
import gzip
import json
import logging
import os
import threading
import time
from wsgiref.simple_server import WSGIServer, WSGIRequestHandler, make_server
from socketserver import ThreadingMixIn

from heatmap_tpu_torch import hexgrid
from heatmap_tpu_torch.config import Config
from heatmap_tpu_torch.serve.ui import render_index
from heatmap_tpu_torch.sink.base import Store

log = logging.getLogger(__name__)

# Routes of the reference the port does not serve: none is left
UNPORTED_ROUTES: tuple = ()


@functools.lru_cache(maxsize=65536)
def cell_ring(cell_id: str) -> tuple:
    """Closed GeoJSON ring [[lng, lat], ...] for a hex cell, from the host
    oracle's boundary (hexgrid.host)."""
    verts = hexgrid.cell_to_boundary(cell_id)
    coords = [[lng, lat] for (lat, lng) in verts]
    if coords and coords[0] != coords[-1]:
        coords.append(coords[0])
    return tuple(tuple(c) for c in coords)


def _iso(v) -> str:
    if isinstance(v, dt.datetime):
        return v.isoformat()
    return str(v)


def _tile_props(doc: dict) -> dict:
    """One tile feature's properties — the SINGLE definition both the
    dict spec and the string-assembled hot path render, so they cannot
    drift apart (their byte identity is the wire contract)."""
    props = {
        "cellId": doc["cellId"],
        "count": int(doc.get("count", 0)),
        "avgSpeedKmh": float(doc.get("avgSpeedKmh", 0.0)),
        "windowStart": _iso(doc["windowStart"]),
        "windowEnd": _iso(doc["windowEnd"]),
    }
    for extra in ("p95SpeedKmh", "stddevSpeedKmh", "windowMinutes",
                  "vxKmh", "vyKmh"):
        if extra in doc:
            props[extra] = doc[extra]
    return props


def tiles_feature_collection(store: Store, grid: str | None = None) -> dict:
    start = store.latest_window_start(grid)
    if start is None:
        return {"type": "FeatureCollection", "features": []}
    features = []
    for doc in store.tiles_in_window(start, grid):
        props = _tile_props(doc)
        features.append({
            "type": "Feature",
            "geometry": {
                "type": "Polygon",
                "coordinates": [[list(c) for c in cell_ring(doc["cellId"])]],
            },
            "properties": props,
        })
    return {"type": "FeatureCollection", "features": features}


@functools.lru_cache(maxsize=65536)
def _cell_geometry_json(cell_id: str) -> str:
    """The feature's geometry object pre-serialized — it is a pure
    function of the cell id and ~80% of a feature's bytes, so caching
    the STRING (not just the ring) removes most of both the dict-build
    and json.dumps cost of a cold tile render."""
    return json.dumps({
        "type": "Polygon",
        "coordinates": [[list(c) for c in cell_ring(cell_id)]],
    })


def _feature_json(doc: dict) -> str:
    """One tile Feature, pre-serialized — byte-identical to
    ``json.dumps`` of the dict-spec feature (differential-pinned).
    Shared by the full render, the delta endpoint, SSE pushes, and
    topk, so every surface emits the same bytes for the same tile."""
    return ('{"type": "Feature", "geometry": '
            + _cell_geometry_json(doc["cellId"])
            + ', "properties": '
            + json.dumps(_tile_props(doc)) + '}')


def _features_collection_json(docs) -> str:
    return ('{"type": "FeatureCollection", "features": ['
            + ", ".join(_feature_json(d) for d in docs) + ']}')


def tiles_feature_collection_json(store: Store,
                                  grid: str | None = None) -> str:
    """``json.dumps(tiles_feature_collection(store, grid))``, byte for
    byte, assembled from cached geometry fragments (differential-pinned).
    The dict-returning sibling stays the readable spec; this is the
    serving hot path."""
    start = store.latest_window_start(grid)
    if start is None:
        return '{"type": "FeatureCollection", "features": []}'
    return _features_collection_json(store.tiles_in_window(start, grid))


def _qs_params(qs: str) -> dict:
    """Query string -> {name: last value}, URL-decoded (a client that
    urlencodes ``fields=a,b`` to ``a%2Cb`` must not 400)."""
    from urllib.parse import parse_qs

    try:
        return {k: v[-1]
                for k, v in parse_qs(qs, keep_blank_values=True).items()}
    except ValueError:
        return {}


def _qs_int(params: dict, name: str, default: int, cap: int) -> int:
    """Bounded non-negative int param; the default on absence/garbage."""
    try:
        return max(0, min(int(params[name]), cap))
    except (KeyError, TypeError, ValueError):
        return default


def _qs_epoch_s(params: dict, name: str) -> tuple[float | None, bool]:
    """Epoch-seconds param: (value, ok).  Absent -> (None, True);
    garbage -> (None, False) so the caller can answer 400 instead of
    silently substituting a time the client did not ask for."""
    raw = params.get(name)
    if raw is None:
        return None, True
    try:
        v = float(raw)
    except (TypeError, ValueError):
        return None, False
    if not -1e12 < v < 1e12:
        return None, False
    return v, True


_GRID_RE = None  # compiled lazily (re import stays off the hot path)


def _parse_grid(params: dict, default: str | None) -> tuple:
    """Validated ``grid=`` value (or the default): grid labels are
    embedded in response HEADERS (the ETag), so a raw URL-decoded value
    would be a response-splitting vector (CR/LF or quote injection).
    Returns (grid, None) or (None, error)."""
    raw = params.get("grid")
    if raw is None:
        return default, None
    global _GRID_RE
    if _GRID_RE is None:
        import re

        _GRID_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,64}$")
    if not _GRID_RE.match(raw):
        return None, "grid= must be 1-64 chars of [A-Za-z0-9_.:-]"
    return raw, None


def _parse_res(params: dict) -> tuple[int | None, str | None]:
    """Optional ``res=`` zoom-out resolution: (res, None) or (None, err)."""
    raw = params.get("res")
    if raw is None:
        return None, None
    try:
        res = int(raw)
    except (TypeError, ValueError):
        return None, f"res= must be an integer, got {raw[:32]!r}"
    if not 0 <= res <= 15:
        return None, f"res= must be in 0..15, got {res}"
    return res, None


def _hist_res_err(grid: str | None, res: int | None) -> str | None:
    """Validate a history rollup resolution against the grid's base:
    history rollups compute on the fly (no pyramid-levels limit), so
    any resolution AT or COARSER than the base is fine; finer is not."""
    from heatmap_tpu_torch.query.matview import _grid_base_res

    base = _grid_base_res(grid)
    if res is not None and res != base and (base is None or res > base):
        return (f"res={res} must be at or coarser than the grid's "
                f"base resolution")
    return None


def _parse_bbox(params: dict) -> tuple[tuple | None, str | None]:
    """Optional ``bbox=minLon,minLat,maxLon,maxLat``: (bbox, None) or
    (None, err)."""
    raw = params.get("bbox")
    if raw is None:
        return None, None
    parts = raw.split(",")
    if len(parts) != 4:
        return None, "bbox= needs minLon,minLat,maxLon,maxLat"
    try:
        lo_lon, lo_lat, hi_lon, hi_lat = (float(p) for p in parts)
    except ValueError:
        return None, "bbox= values must be numbers"
    if lo_lon > hi_lon or lo_lat > hi_lat:
        return None, "bbox= min exceeds max"
    return (lo_lon, lo_lat, hi_lon, hi_lat), None


def _negotiate_fmt(environ: dict, params: dict,
                   ctype: str | None = None) -> tuple:
    """Negotiated binary wire format: ``?fmt=bin|json`` wins, else an
    ``Accept`` header naming THIS endpoint's binary media type
    (``ctype``; default the tile frame — a positions Accept must not
    negotiate a tile frame it cannot decode, and vice versa), else the
    default JSON path (kept byte-identical — negotiation must never
    perturb a legacy client).  Returns (fmt, None) or (None, error)."""
    from heatmap_tpu_torch.serve import wire

    raw = params.get("fmt")
    if raw is not None:
        if raw in ("bin", "binary"):
            return "bin", None
        if raw == "json":
            return "json", None
        return None, f"fmt= must be bin or json, got {raw[:32]!r}"
    if (ctype or wire.CONTENT_TYPE) in environ.get("HTTP_ACCEPT", ""):
        return "bin", None
    return "json", None


def _inm_match(environ: dict, etag: str) -> bool:
    """If-None-Match vs a strong ETag (RFC 9110 §13.1.2: weak
    comparison is allowed for If-None-Match, so W/-prefixed client
    copies still match; ``*`` matches any representation)."""
    inm = environ.get("HTTP_IF_NONE_MATCH")
    if not inm or not etag:
        return False
    for cand in inm.split(","):
        cand = cand.strip()
        if cand == "*":
            return True
        if cand.startswith("W/"):
            cand = cand[2:]
        if cand == etag:
            return True
    return False


def _sample_serve_freshness(runtime) -> None:
    """Ingest->serve freshness, sampled at a tiles render: render wall
    clock minus the newest sink-committed event timestamp (the lineage
    watermark), clamped at 0.  A runtime-shaped object without a lineage
    (a view slot without a fold) samples nothing."""
    lin = getattr(runtime, "lineage", None)
    g = getattr(runtime, "_g_serve_fresh", None)
    if lin is None or g is None:
        return
    ts = lin.newest_committed_ts
    if ts is not None:
        g.set(max(0.0, time.time() - ts))


_FIELD_RE = None  # compiled lazily


def _parse_fields(raw: str) -> tuple[list, str | None]:
    """Validate a /trace/recent ``fields=`` projection: up to 16
    comma-separated identifier-shaped names.  Returns (names, None) or
    ([], error): the caller answers 400 on error."""
    global _FIELD_RE
    if _FIELD_RE is None:
        import re

        _FIELD_RE = re.compile(r"^[A-Za-z0-9_]{1,64}$")
    names = [f for f in raw.split(",") if f]
    if not names:
        return [], "fields= needs at least one name"
    if len(names) > 16:
        return [], "fields= accepts at most 16 names"
    for f in names:
        if not _FIELD_RE.match(f):
            return [], f"invalid field name: {f[:80]!r}"
    return names, None


def positions_feature_collection(store: Store) -> dict:
    features = []
    for doc in store.all_positions():
        lon, lat = doc["loc"]["coordinates"]
        features.append({
            "type": "Feature",
            "geometry": {"type": "Point", "coordinates": [lon, lat]},
            "properties": {
                "provider": doc.get("provider"),
                "vehicleId": doc.get("vehicleId"),
                "ts": _iso(doc.get("ts")),
            },
        })
    return {"type": "FeatureCollection", "features": features}


def _forecast_body(cells: dict, h_s: int, res: int, blk: dict) -> bytes:
    """The /api/tiles/forecast body: one Feature a forecast cell, in
    cell order.  ``baseTs`` is the newest folded event timestamp — the
    forecast predicts baseTs + h."""
    feats = []
    for ci in sorted(cells):
        cid = format(ci, "x")
        props = {"cellId": cid, "count": cells[ci]}
        feats.append(
            '{"type": "Feature", "geometry": '
            + _cell_geometry_json(cid)
            + ', "properties": ' + json.dumps(props) + '}')
    head = json.dumps({"h": h_s, "res": res,
                       "baseTs": blk["max_event_ts"],
                       "entities": blk["entities"]})
    return (head[:-1] + ', "features": ['
            + ", ".join(feats) + ']}').encode("utf-8")


def _policy_values(runtime) -> dict:
    """The engine policies this run resolved — one place feeding both
    /metrics.json keys and the /metrics info series.  The port has no
    banked merge winner (the reference's hwbank), so
    ``policy_merge_banked`` is None, as the reference's is unbanked."""
    return {
        "policy_snap_impl": runtime.snap_impl,
        "policy_emit_pull": "prefix" if runtime._prefix_pull else "full",
        "policy_merge_banked": None,
    }


def _metrics_json(runtime) -> dict:
    """The /metrics.json body: the runtime's snapshot (its step thread
    publishes it at each batch end), the writer's and the source's
    counters and the policy values, under the reference's keys, and the
    supervisor channel's fields when one is attached (cross-process state,
    so they report on a serve-only process too)."""
    from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL, SupervisorChannel

    m: dict = {}
    chan = SupervisorChannel.metrics_from(os.environ.get(ENV_CHANNEL))
    if chan:
        m["supervisor"] = chan
    if runtime is None:
        return m
    m.update(runtime.metrics_snapshot())
    m.update(runtime.writer.counters)
    m.update(getattr(runtime.source, "counters", None) or {})
    m.update(_policy_values(runtime))
    return m


def _metrics_text(runtime, serve_registry) -> str:
    """Prometheus text exposition for /metrics.  On a serve-only process
    (runtime=None) the app's own registry (serve-tier counters, the view
    families) is the body; with a runtime attached those families live in
    the runtime's registry already, which renders with its counters, the
    writer's and the source's as flat series and the policy info
    series.  With a supervisor channel, its ``heatmap_supervisor_*``
    series and the per-child ``heatmap_child_*`` freshness gauges join
    either body."""
    from heatmap_tpu_torch.obs.fleet import child_freshness_lines
    from heatmap_tpu_torch.obs.registry import _escape_label
    from heatmap_tpu_torch.obs.xproc import (ENV_CHANNEL, SupervisorChannel,
                                             supervisor_metrics_lines)

    chan_path = os.environ.get(ENV_CHANNEL)
    lines = supervisor_metrics_lines(
        SupervisorChannel.metrics_from(chan_path))
    lines.extend(child_freshness_lines(chan_path))
    if runtime is None:
        return serve_registry.expose_text(extra=lines)
    pol = _policy_values(runtime)
    labels = ",".join(
        f'{k.removeprefix("policy_")}="{_escape_label(str(v))}"'
        for k, v in pol.items())
    lines.append("# TYPE heatmap_policy_info gauge")
    lines.append("heatmap_policy_info{%s} 1" % labels)
    extra = dict(runtime.writer.counters)
    # the retries are a registry series already (heatmap_sink_retries_
    # total): a flat copy would emit the series twice
    extra.pop("sink_retries", None)
    extra.update(getattr(runtime.source, "counters", None) or {})
    return runtime.telemetry.expose_text(extra_counters=extra,
                                         extra_lines=lines)


# ---- /healthz SLO evaluation -----------------------------------------
# Env knobs (read per request):
#   HEATMAP_SLO_BATCH_P50_MS      recent p50 batch latency budget (500,
#                                 the paper's headline bound)
#   HEATMAP_SLO_FRESHNESS_P50_S   recent p50 emit freshness budget (60)
#   HEATMAP_SLO_FRESHNESS_P50_MS  recent p50 end-to-end event age budget
#                                 (10000 ms): event ts -> sink commit ack
#   HEATMAP_SLO_RESTARTS_PER_H    supervisor failures tolerated in the
#                                 trailing hour before degraded (4)
# plus the runtime-introspection checks (obs.runtimeinfo):
#   HEATMAP_SLO_RETRACES, HEATMAP_SLO_RETRACE_WINDOW_S,
#   HEATMAP_SLO_MEM_BYTES.
def _slo(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        log.warning("%s=%r is not a number; using %s", name,
                    os.environ.get(name), default)
        return float(default)


def healthz_payload(runtime, extra_checks=None) -> tuple[dict, bool]:
    """(payload, down): SLO checks against the recent-window histogram
    quantiles of the runtime's registry and the supervisor channel.  ok ->
    degraded on a budget breach; down (serve 503) only when the pipeline
    cannot make progress — a poisoned sink or a supervisor that gave up.

    ``extra_checks`` (a callable returning (checks_dict, degraded)) is
    the serve tier's contribution: the view's state and the store
    refresher's catch-up on a serve-only worker, the continuous-query
    evaluation lag."""
    checks: dict = {}
    degraded = down = False
    if extra_checks is not None:
        try:
            ec, ec_degraded = extra_checks()
            checks.update(ec)
            degraded |= ec_degraded
        except Exception:  # noqa: BLE001 - a probe bug must not 500 /healthz
            log.exception("serve-tier healthz checks failed")
    # the SLO burn-rate engine (obs.slo, HEATMAP_TSDB=1): a firing alert
    # degrades as "error budget burning fast"; a bad latest sample without
    # a tripped rule is a warn ("momentary blip")
    slo_eng = getattr(runtime, "slo_engine", None)
    if slo_eng is not None:
        try:
            for name, check in slo_eng.healthz_checks().items():
                checks[name] = check
                degraded |= not check.get("ok", True)
        except Exception:  # noqa: BLE001 - never 500 /healthz
            log.exception("slo engine healthz checks failed")
    if runtime is not None:
        from heatmap_tpu_torch.obs.runtimeinfo import healthz_checks

        m = runtime.telemetry
        if m.batch_latency.count:
            p50_ms = m.batch_latency.quantile(0.5) * 1e3
            budget = _slo("HEATMAP_SLO_BATCH_P50_MS", 500.0)
            ok = p50_ms <= budget
            checks["batch_p50_ms"] = {"value": round(p50_ms, 3),
                                      "budget": budget, "ok": ok}
            degraded |= not ok
        if m.freshness.count:
            f50 = m.freshness.quantile(0.5)
            budget = _slo("HEATMAP_SLO_FRESHNESS_P50_S", 60.0)
            ok = f50 <= budget
            checks["freshness_p50_s"] = {"value": round(f50, 3),
                                         "budget": budget, "ok": ok}
            degraded |= not ok
        ea = m.event_age.labels(bound="mean")
        if ea.count:
            p50_ms = ea.quantile(0.5) * 1e3
            budget = _slo("HEATMAP_SLO_FRESHNESS_P50_MS", 10000.0)
            ok = p50_ms <= budget
            checks["event_age_p50_ms"] = {"value": round(p50_ms, 3),
                                          "budget": budget, "ok": ok}
            degraded |= not ok
        # the reference's fastpath_pinned warning: the one-device port
        # pins no fast-path knob down
        gov = getattr(runtime, "governor", None)
        if gov is not None:
            # the governor's guardrail (stream/govern.py): a frozen
            # governor degrades, naming the latched bucket (its knobs are
            # pinned; the pipeline keeps running)
            ok = not gov.frozen
            checks["govern_frozen"] = {
                "value": (f"frozen: {gov.frozen_why} "
                          f"(bucket {gov.latched_bucket} latched)"
                          if gov.frozen else "active"),
                "ok": ok}
            degraded |= not ok
        audit = getattr(runtime, "audit", None)
        if audit is not None:
            # the integrity observatory (obs.audit, HEATMAP_AUDIT=1): a
            # ledger residual that stopped draining degrades NAMING the
            # leaking boundary; any digest mismatch degrades naming the
            # (grid, window, seq)
            try:
                ac, a_deg = audit.healthz_checks()
                checks.update(ac)
                degraded |= a_deg
            except Exception:  # noqa: BLE001 - observe-only, never 500
                log.exception("audit healthz checks failed")

        quality = getattr(runtime, "quality", None)
        if quality is not None:
            # the quality observatory (obs.quality, HEATMAP_QUALITY=1): NIS
            # coverage outside the band or the worst live skill below the
            # floor degrades naming (grid, reducer, shard); a broken
            # scorecard identity degrades with the counts
            try:
                qc, q_deg = quality.healthz_checks()
                checks.update(qc)
                degraded |= q_deg
            except Exception:  # noqa: BLE001 - observe-only, never 500
                log.exception("quality healthz checks failed")
        if runtime.writer.poisoned:
            checks["sink"] = {"value": "poisoned", "ok": False}
            down = True
        ri_checks, ri_degraded = healthz_checks(runtime)
        checks.update(ri_checks)
        degraded |= ri_degraded
    from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL, SupervisorChannel

    chan = SupervisorChannel.metrics_from(os.environ.get(ENV_CHANNEL))
    if chan:
        budget = _slo("HEATMAP_SLO_RESTARTS_PER_H", 4.0)
        n = chan.get("recent_failures", 0)
        ok = n <= budget
        checks["supervisor_restarts_1h"] = {"value": n, "budget": budget,
                                            "ok": ok}
        degraded |= not ok
        if chan.get("gave_up"):
            checks["supervisor"] = {"value": "gave_up", "ok": False}
            down = True
    status = "down" if down else ("degraded" if degraded else "ok")
    return {"ok": not down, "status": status, "checks": checks}, down


class _ServeStats:
    """Serve-tier telemetry, registered in the runtime's registry when one
    is attached, else in the app's own registry; /metrics exposes it."""

    def __init__(self, reg):
        self.http_304 = reg.counter(
            "heatmap_serve_304_total",
            "requests answered 304 Not Modified from the ETag check "
            "(no render, no body), per endpoint", labels=("endpoint",))
        self.renders = reg.counter(
            "heatmap_serve_renders_total",
            "full JSON body renders per endpoint (cache and ETag "
            "misses only)", labels=("endpoint",))
        self.rendered_bytes = reg.counter(
            "heatmap_serve_rendered_bytes_total",
            "bytes of JSON rendered per endpoint, before gzip — the "
            "cost the view/ETag/delta tier exists to avoid",
            labels=("endpoint",))
        self.sent_bytes = reg.counter(
            "heatmap_serve_sent_bytes_total",
            "response body bytes sent on the wire per endpoint (after "
            "gzip; 0 for a 304)", labels=("endpoint",))
        self.delta_cells = reg.histogram(
            "heatmap_serve_delta_cells",
            "changed cells per /api/tiles/delta response or SSE push",
            buckets=(1, 4, 16, 64, 256, 1024, 4096, 16384))
        self.sse_clients = reg.gauge(
            "heatmap_serve_sse_clients",
            "open /api/tiles/stream SSE connections")
        self.wire_format = reg.counter(
            "heatmap_serve_wire_format_total",
            "responses per negotiated wire format (?fmt=/Accept): the "
            "compact binary tile frame vs the default GeoJSON path",
            labels=("endpoint", "fmt"))
        self.shed = reg.counter(
            "heatmap_serve_shed_total",
            "requests answered 503 + Retry-After by admission control "
            "(HEATMAP_SERVE_MAX_INFLIGHT in-flight renders exceeded) — "
            "overload degrading predictably instead of collapsing p99",
            labels=("endpoint",))
        self.inflight = reg.gauge(
            "heatmap_serve_inflight",
            "render/encode requests currently in flight on the "
            "admission-controlled endpoints (the queue depth admission "
            "control bounds)")
        self.sse_encodes = reg.counter(
            "heatmap_sse_encodes_total",
            "coalesced SSE frame encodes — one per view seq advance "
            "per (grid, format) CHANNEL, fanned to every subscriber, "
            "so the count is O(grids x formats), never O(clients)",
            labels=("fmt",))
        self.sse_lagged = reg.counter(
            "heatmap_sse_lagged_total",
            "SSE subscribers shed with `event: lagged` because their "
            "bounded send queue (HEATMAP_SSE_QUEUE) overflowed — a "
            "slow reader disconnected cleanly instead of wedging the "
            "shared fan-out")
        self.sse_queue_hw = reg.gauge(
            "heatmap_sse_queue_highwater",
            "high-water mark of any SSE subscriber's bounded send "
            "queue (frames) since boot — how close the slowest healthy "
            "reader has come to being shed")
        self.slow_requests = reg.counter(
            "heatmap_serve_slow_requests_total",
            "requests whose total handling time crossed "
            "HEATMAP_SLOWREQ_MS and were captured (full per-stage "
            "span) into the slow-request ring at /debug/requests",
            labels=("endpoint",))
        self.core = reg.gauge(
            "heatmap_serve_core",
            "which HTTP core hosts this serve process "
            "(HEATMAP_SERVE_CORE) — 1 on the active core's label, "
            "thread = wsgiref, epoll = the selectors event loop",
            labels=("core",))
        self.open_connections = reg.gauge(
            "heatmap_serve_open_connections",
            "TCP connections currently open on the epoll serve core "
            "(parsing, handling, draining, or streaming SSE)")
        self.write_backlog = reg.gauge(
            "heatmap_serve_write_backlog",
            "epoll-core connections currently holding write interest "
            "— bytes staged but not yet accepted by the socket; the "
            "slow-client pressure gauge")
        self.loop_iter = reg.histogram(
            "heatmap_serve_loop_iteration_seconds",
            "busy time of one epoll event-loop iteration (dispatch + "
            "writes + ticks, excluding the idle select() wait) — the "
            "loop's own latency floor under fan-out load",
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0))


class _SSEBody:
    """SSE response body: iterates the event generator, and releases the
    admission slot exactly once from ``close()`` — which WSGI servers
    call even when iteration never starts or dies on a client
    disconnect (a generator's own finally offers no such guarantee)."""

    def __init__(self, gen, on_close):
        self._gen = gen
        self._on_close = on_close
        self._closed = False

    def __iter__(self):
        return self._gen

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._gen.close()
        finally:
            self._on_close()


class _Span:
    """One request's per-stage timing: ``mark(stage)`` accrues the time
    since the previous mark, so the stage sum telescopes to the total
    by construction — the same conservation rule as the lineage tiers.
    Stages on the data plane: admission (semaphore wait), parse
    (routing + query-string handling), lookup (view/store/history data
    production), encode (serialize + gzip + headers), write (the WSGI
    server draining the body to the socket, stamped by _SpanBody)."""

    __slots__ = ("endpoint", "status", "bytes_in", "bytes_out",
                 "view_seq", "stages", "scan", "t_unix", "_t0", "_last")

    def __init__(self, endpoint: str = "?"):
        self.endpoint = endpoint
        self.status = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.view_seq = None
        self.stages: dict = {}
        self.scan = None
        self.t_unix = time.time()
        self._t0 = self._last = time.perf_counter()

    def mark(self, stage: str) -> None:
        now = time.perf_counter()
        self.stages[stage] = (self.stages.get(stage, 0.0)
                              + (now - self._last))
        self._last = now

    def total_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def to_dict(self) -> dict:
        d = {"endpoint": self.endpoint, "status": self.status,
             "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
             "total_ms": round(self.total_ms(), 3),
             "stages_ms": {k: round(v * 1e3, 3)
                           for k, v in self.stages.items()},
             "t": round(self.t_unix, 3)}
        if self.view_seq is not None:
            d["view_seq"] = self.view_seq
        if self.scan:
            d["scan"] = self.scan
        return d


class _RequestRing:
    """Bounded newest-first span ring with optional JSONL persistence
    (the slow-request capture): append-only, flushed per record,
    dead-latched on the first write error so a bad path degrades to
    in-memory-only instead of failing requests."""

    def __init__(self, capacity: int = 256,
                 jsonl_path: str | None = None):
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._jsonl_path = jsonl_path
        self._jsonl_fh = None
        self._jsonl_dead = False

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)
            if self._jsonl_path is None or self._jsonl_dead:
                return
            try:
                if self._jsonl_fh is None:
                    self._jsonl_fh = open(self._jsonl_path, "a",
                                          encoding="utf-8")
                self._jsonl_fh.write(
                    json.dumps(rec, separators=(",", ":")) + "\n")
                self._jsonl_fh.flush()
            except (OSError, TypeError, ValueError) as e:
                self._jsonl_dead = True
                log.warning("slow-request JSONL write failed "
                            "(capture disabled): %s", e)

    def recent(self, n: int = 50) -> list:
        with self._lock:
            items = list(self._ring)
        return items[::-1][: max(0, int(n))]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class _SpanBody:
    """Response-body wrapper that closes the request span when the WSGI
    server has DRAINED the body — the write stage is the real socket
    drain, not the handler's return.  ``commit`` runs exactly once
    (wsgiref calls close() even on client disconnect)."""

    def __init__(self, chunks, span, commit):
        self._chunks = chunks
        self._span = span
        self._commit = commit
        self._done = False

    def __iter__(self):
        for c in self._chunks:
            yield c

    def close(self):
        if self._done:
            return
        self._done = True
        self._span.mark("write")
        try:
            self._commit(self._span)
        except Exception:  # noqa: BLE001 - span accounting must not 500
            log.exception("request-span commit failed")


def _delta_body(d: dict, grid: str) -> str:
    """Delta payload JSON: header via json.dumps, features embedded as
    the SAME pre-rendered strings /api/tiles/latest emits."""
    ws = d["window_start"]
    head = json.dumps({"mode": d["mode"], "seq": d["seq"], "grid": grid,
                       "windowStart": _iso(ws) if ws is not None else None})
    return (head[:-1] + ', "features": ['
            + ", ".join(_feature_json(doc) for doc in d["docs"]) + ']}')


# endpoints under admission control (HEATMAP_SERVE_MAX_INFLIGHT): the
# data-plane render/encode paths whose concurrency must stay bounded;
# the operator surface is deliberately absent
_ADMIT_PATHS = {
    "/api/tiles/latest": "tiles",
    "/api/tiles/delta": "delta",
    "/api/tiles/topk": "topk",
    "/api/positions/latest": "positions",
    "/api/tiles/range": "range",
    "/api/tiles/at": "at",
    "/api/tiles/diff": "diff",
    "/api/tiles/forecast": "forecast",
}


def make_wsgi_app(store: Store, cfg: Config, runtime=None):
    refresh_ms = cfg.refresh_ms
    resolutions = cfg.resolutions
    # default grid for bare /api/tiles/latest: one grid per response (the
    # reference contract) that actually EXISTS in the configured pyramid
    # (Config.default_grid matches the runtime's tagging rule, pair_grid)
    default_grid = cfg.default_grid()
    # ---- query tier ---------------------------------------------------
    # The materialized tile view (query.matview) serving /latest renders,
    # ETags, deltas, SSE, and topk without touching the Store:
    # - runtime attached: the runtime's writer-fed view (durable rows
    #   only; absent under HEATMAP_QUERY_VIEW=0).
    # - serve-only: an app-local view rebuilt from Store scans by
    #   version polling + the HEATMAP_VIEW_POLL_MS TTL, or, with
    #   HEATMAP_REPL_FEED, a replica view following the writer's feed.
    from heatmap_tpu_torch.obs.registry import Registry

    serve_reg = runtime.registry if runtime is not None else Registry()
    stats = _ServeStats(serve_reg)
    # ---- the delivery lineage (obs.delivery) ---------------------------
    # Read-path lineage to the subscriber socket: the follower installs
    # each applied record's writer stamps + local receipt/apply, the SSE
    # pumps stamp encode, and the subscriber generators complete
    # end-to-end delivered samples (/debug/delivery, /fleet/delivery,
    # heatmap_delivered_age_seconds{bound=}).
    from heatmap_tpu_torch.obs.delivery import (DeliveryTracker,
                                                ENV_SLO_DELIVERED_P50_MS)

    delivery = DeliveryTracker(registry=serve_reg)
    view = getattr(runtime, "matview", None) if runtime is not None else None
    refresher = None
    follower = None
    repl_dir = cfg.repl_dir
    repl_feed = cfg.repl_feed
    # ---- space-time history tier (query/history.py) -------------------
    # A local HEATMAP_HIST_DIR serves range/at/diff straight off the
    # chunk store (and re-exports it at /api/hist/* for remote
    # replicas); a replica following an http feed reads the writer's
    # re-export over the same transport.  The source also feeds the
    # follower's cold-start backfill below.
    hist_dir = cfg.hist_dir
    # scan accounting: the history endpoints reset the thread-local
    # tally before each query and attach it to the span
    from heatmap_tpu_torch.query import history as histmod

    hist_src = None
    if hist_dir:
        hist_src = histmod.FileHistorySource(hist_dir)
    elif repl_feed.startswith("http://") \
            or repl_feed.startswith("https://"):
        hist_src = histmod.HttpHistorySource(repl_feed)
    # the integrity observatory (obs.audit, HEATMAP_AUDIT=1): with a
    # runtime attached its AuditState is reused (same registry); a
    # serve-only worker builds its own — the replica half that verifies
    # every applied record's published window digest against its own
    # recomputed state and serves /debug/audit
    serve_audit = (getattr(runtime, "audit", None)
                   if runtime is not None else None)
    if runtime is None and cfg.audit:
        from heatmap_tpu_torch.obs.audit import AuditState

        serve_audit = AuditState(serve_reg, tag=f"serve{os.getpid()}",
                                 settle_s=cfg.audit_settle_s)
    if view is None and cfg.query_view:
        from heatmap_tpu_torch.query import StoreViewRefresher, TileMatView

        view_audit = None
        if cfg.audit and runtime is None:
            from heatmap_tpu_torch.obs.audit import DigestTable

            view_audit = DigestTable()
        view = TileMatView(delta_log=cfg.delta_log,
                           pyramid_levels=cfg.pyramid_levels,
                           registry=serve_reg,
                           replica=bool(repl_feed),
                           audit=view_audit)
        refresher = StoreViewRefresher(store, view,
                                       poll_s=cfg.view_poll_ms / 1e3,
                                       registry=serve_reg)
        if repl_feed:
            # replicated serve fleet (query.repl): the view follows the
            # writer's delta-log feed — zero steady-state store reads.
            # The StoreViewRefresher above is DEMOTED to a counted,
            # healthz-warning fallback: it runs only while the follower
            # is unsynced, and every request that takes that path bumps
            # heatmap_repl_fallback_total.
            from heatmap_tpu_torch.query.repl import (ReplicaViewFollower,
                                                      feed_source)

            follower = ReplicaViewFollower(
                view, feed_source(repl_feed),
                poll_s=cfg.repl_poll_ms / 1e3,
                registry=serve_reg,
                audit=serve_audit,
                hist_source=hist_src if cfg.hist_backfill else None,
                delivery=delivery)
            follower.start()
    # Continuous spatial query engine (query.continuous): standing
    # bbox/polygon/topk/geofence/threshold/anomaly subscriptions over
    # the view's mutation stream.  Created wherever the view exists so
    # the metric families register and the endpoints answer, but it
    # attaches its view watcher (and starts its drain thread) only on
    # the FIRST registration — a worker nobody registered queries on
    # does zero per-mutation work.
    cq_engine = None
    if view is not None and cfg.cq:
        from heatmap_tpu_torch.query.continuous import ContinuousQueryEngine

        cq_engine = ContinuousQueryEngine(
            view, registry=serve_reg,
            max_queries=cfg.cq_max_queries,
            events_per_query=cfg.cq_events,
            max_cells=cfg.cq_max_cells,
            default_ttl_s=cfg.cq_ttl_s)
    hist_reader = None
    if hist_src is not None:
        hist_reader = histmod.HistoryReader(hist_src, view=view,
                                            registry=serve_reg)
    # view-at-seq replays are full log reconstructions: memoize the
    # rendered bodies of the last few (epoch-keyed — a writer restart
    # invalidates naturally because the epoch changes).  A serve-only
    # app never PUBLISHES to repl_dir: only the writer process's runtime
    # creates the publisher; HEATMAP_REPL_DIR on a serve process only
    # re-exposes the feed at /api/repl/*.
    hist_at_cache: dict = {}
    if serve_audit is not None and runtime is None:
        serve_audit.attach(view=view, follower=follower)
    sse_max = cfg.sse_max_clients
    sse_heartbeat = cfg.sse_heartbeat_s
    sse_admit_lock = threading.Lock()
    # ---- serve-tier wire path -----------------------------------------
    # Binary tile/delta frames (serve/wire.py) negotiated via ?fmt=/
    # Accept, encoded through the native column writer (built with g++
    # here; a build failure raises, there is no fallback); coalesced SSE
    # fan-out (one encode per view seq advance per (grid, format)
    # channel, fanned to bounded per-client queues); bounded in-flight
    # render admission.
    from heatmap_tpu_torch.native import NativeWireOps
    from heatmap_tpu_torch.serve import evloop as evloopmod
    from heatmap_tpu_torch.serve import wire as wiremod

    wire_ops = NativeWireOps()
    sse_queue = cfg.sse_queue
    sse_send_timeout = cfg.sse_send_timeout_s
    fanout = wiremod.FanoutHub(depth=sse_queue,
                               on_lagged=stats.sse_lagged.inc,
                               hw_gauge=stats.sse_queue_hw)
    serve_reg.gauge(
        "heatmap_sse_write_stall_seconds",
        "age of the oldest in-flight (un-returned) SSE socket write "
        "across all subscribers — a wedged client shows here for the "
        "whole send-timeout window BEFORE it is shed as lagged",
        fn=fanout.max_write_stall_s)
    # the O(channels) invariant, observable: total frames retained in
    # the shared per-channel rings — flat in subscriber count, because
    # an event-loop subscriber holds only a (cursor, offset) pair into
    # the ring, never copies of frames
    serve_reg.gauge(
        "heatmap_sse_fanout_retained_frames",
        "frames currently retained across all SSE fan-out channel "
        "rings (the epoll core's entire fan-out buffer memory) — "
        "bounded by channels x HEATMAP_SSE_QUEUE regardless of "
        "subscriber count",
        fn=fanout.retained_frames)
    # ---- serve request spans ------------------------------------------
    # Every admission-controlled request carries a _Span; completed
    # spans land in a bounded ring at /debug/requests, and spans slower
    # than HEATMAP_SLOWREQ_MS are captured to a second ring persisted
    # as JSONL (HEATMAP_SLOWREQ_JSONL).
    span_ring = _RequestRing(capacity=256)
    slowreq_ms = _slo("HEATMAP_SLOWREQ_MS", 0.0)
    slow_ring = _RequestRing(
        capacity=64,
        jsonl_path=os.environ.get("HEATMAP_SLOWREQ_JSONL") or None)
    # one flight-record dump on the FIRST slow request per process (the
    # recorder's once-only dump bounds the cost), with the delivery
    # lineage and the request ring as sources; the serve-only SLO engine
    # dumps through it too
    from heatmap_tpu_torch.obs import flightrec as flightrec_mod

    flightrec = flightrec_mod.from_env()
    if flightrec is not None:
        flightrec.add_source("delivery", delivery.snapshot)
        flightrec.add_source("requests",
                             lambda: span_ring.recent(64))

    def _commit_span(span: _Span) -> None:
        rec = span.to_dict()
        span_ring.record(rec)
        if slowreq_ms > 0 and rec["total_ms"] >= slowreq_ms:
            stats.slow_requests.labels(endpoint=span.endpoint).inc()
            slow_ring.record(rec)
            if flightrec is not None:
                flightrec.dump(f"slow request {span.endpoint} "
                               f"{rec['total_ms']:.0f}ms")
    max_inflight = cfg.serve_max_inflight
    admit_sem = (threading.BoundedSemaphore(max_inflight)
                 if max_inflight > 0 else None)
    # Render cache for the store-rendered bodies: a hit requires BOTH an
    # unchanged store write-version (any local upsert bumps it) AND a
    # 1 s TTL (the bound that protects deployments where OTHER processes
    # also write the backing store, which a local counter cannot see).
    # HEATMAP_SERVE_CACHE_MS=0 disables caching entirely.  Keyed per
    # (path, grid); stores the ENCODED body and its gzip twin.
    # View-backed tile renders use a separate ETag-keyed cache below:
    # the ETag is exact, so no TTL is needed.
    try:
        cache_ttl_s = float(os.environ.get("HEATMAP_SERVE_CACHE_MS",
                                           "1000")) / 1e3
    except ValueError:
        log.warning("HEATMAP_SERVE_CACHE_MS=%r is not a number; "
                    "render cache disabled",
                    os.environ.get("HEATMAP_SERVE_CACHE_MS"))
        cache_ttl_s = 0.0
    render_cache: dict = {}
    view_cache: dict = {}

    def _account_render(endpoint: str, data: bytes) -> None:
        stats.renders.labels(endpoint=endpoint).inc()
        stats.rendered_bytes.labels(endpoint=endpoint).inc(len(data))

    def _cached_json(key, build, endpoint):
        # builders return pre-serialized JSON strings (or bytes — the
        # binary positions frame rides the same cache, keyed by format)
        if cache_ttl_s <= 0:
            data = build()
            if not isinstance(data, bytes):
                data = data.encode("utf-8")
            _account_render(endpoint, data)
            return data, None
        now = time.monotonic()
        ver = store.version()
        hit = render_cache.get(key)
        if hit is not None and hit[0] == ver and hit[1] > now:
            return hit[2], hit[3]
        data = build()
        if not isinstance(data, bytes):
            data = data.encode("utf-8")
        _account_render(endpoint, data)
        gz = gzip.compress(data, compresslevel=1) if len(data) >= 1024 \
            else None
        if len(render_cache) >= 64:
            # bounded against client-controlled ?grid= values — evict
            # ONE arbitrary entry, not everything
            render_cache.pop(next(iter(render_cache)))
        render_cache[key] = (ver, now + cache_ttl_s, data, gz)
        return data, gz

    def _view_cached(key, etag, build, endpoint):
        """ETag-keyed render cache for view-backed bodies: exact (the
        ETag changes with the view), so entries need no TTL.  Builders
        may return str (JSON) or bytes (binary wire frames) — the key
        carries the format, so one ETag never caches two
        representations."""
        hit = view_cache.get(key)
        if hit is not None and hit[0] == etag:
            return hit[1], hit[2]
        data = build()
        if not isinstance(data, bytes):
            data = data.encode("utf-8")
        _account_render(endpoint, data)
        gz = gzip.compress(data, compresslevel=1) if len(data) >= 1024 \
            else None
        if len(view_cache) >= 64:
            view_cache.pop(next(iter(view_cache)))
        view_cache[key] = (etag, data, gz)
        return data, gz

    # per-app boot nonce for version-derived ETags: version counters are
    # process-local and restart at 0, so without it a post-restart ETag
    # could equal a pre-restart one while naming different content
    import uuid

    boot_nonce = uuid.uuid4().hex[:8]
    seeded: set = set()
    # the fleet aggregator (obs.fleet), built lazily against the current
    # channel path: it is stateful (it remembers the member tags it has
    # seen, so a VANISHED member degrades /fleet/healthz), so one instance
    # an app, rebuilt only when the channel path itself changes
    fleet_state: dict = {}

    def _fleet_agg():
        from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL

        chan_path = os.environ.get(ENV_CHANNEL)
        if not chan_path:
            return None
        if fleet_state.get("path") != chan_path:
            from heatmap_tpu_torch.obs.fleet import FleetAggregator

            fleet_state["path"] = chan_path
            fleet_state["agg"] = FleetAggregator(chan_path)
        return fleet_state["agg"]

    # compaction_status is a chunk/log directory scan; /healthz probes
    # must not each pay it — one short memo serves them
    _hist_memo: dict = {}

    def _hist_status() -> dict:
        now = time.monotonic()
        if not _hist_memo or now - _hist_memo.get("t", 0.0) >= 2.0:
            _hist_memo["st"] = histmod.compaction_status(hist_dir)
            _hist_memo["t"] = now
        return _hist_memo["st"]

    def _serve_checks() -> tuple[dict, bool]:
        """The serve tier's /healthz contribution: the view's state,
        replication sync/lag/staleness on a replica, store catch-up on a
        serve-only worker, the history tier's compaction lag, the
        continuous-query evaluation lag."""
        checks: dict = {}
        degraded = False
        if view is not None and view.poisoned:
            checks["query_view"] = {"value": "poisoned", "ok": False}
            degraded = True
        if follower is not None:
            fc, f_degraded = follower.healthz_checks(
                _slo("HEATMAP_SLO_REPL_LAG_S", 10.0))
            checks.update(fc)
            degraded |= f_degraded
        elif refresher is not None:
            h = refresher.health()
            checks["view_catchup"] = h
            degraded |= not h["ok"]
        if serve_audit is not None and runtime is None:
            # serve-only audit verdicts (a runtime-attached process merges
            # its AuditState inside healthz_payload)
            ac, a_degraded = serve_audit.healthz_checks()
            checks.update(ac)
            degraded |= a_degraded
        if hist_dir:
            # compaction-lag SLO: rotated segments must keep turning
            # into chunks; a stalled compactor silently narrows the
            # durable history even though serving looks healthy.  Any
            # digest mismatch degrades too (and freezes pruning).
            st = _hist_status()
            budget = _slo("HEATMAP_SLO_HIST_LAG_S", 120.0)
            ok = st["lag_s"] <= budget
            checks["hist_compaction_lag_s"] = {
                "value": round(st["lag_s"], 3), "budget": budget,
                "ok": ok, "chunks": st["chunks"],
                "pending_segments": st["pending_segments"]}
            degraded |= not ok
            mm = st.get("mismatches", 0)
            if mm:
                checks["hist_digest"] = {
                    "value": f"{mm} compaction digest mismatch(es)",
                    "ok": False}
                degraded = True
        if cq_engine is not None and cq_engine.registered:
            # continuous-query eval lag: standing subscribers being
            # pushed stale matches is an SLO breach; a query-less
            # engine has no lag to evaluate and stays silent
            cc, c_degraded = cq_engine.healthz_checks(
                _slo("HEATMAP_SLO_CQ_LAG_S", 5.0))
            checks.update(cc)
            degraded |= c_degraded
        if serve_slo is not None and runtime is None:
            # a serve-only process's burn-rate checks (an attached
            # runtime's engine is merged inside healthz_payload): a firing
            # alert degrades, a blip only warns
            for name, check in serve_slo.healthz_checks().items():
                checks[name] = check
                degraded |= not check.get("ok", True)
        if follower is not None:
            # the delivered-freshness SLO: the age a subscriber socket
            # actually receives, evaluated only where samples exist (a
            # replica without SSE subscribers has none to breach)
            dsum = delivery.summary()
            if dsum.get("count"):
                budget_ms = _slo(ENV_SLO_DELIVERED_P50_MS, 2000.0)
                p50_ms = dsum["age_p50_s"] * 1e3
                ok = p50_ms <= budget_ms
                checks["delivered_age_p50_ms"] = {
                    "value": round(p50_ms, 1), "budget": budget_ms,
                    "ok": ok,
                    "worst_stage": dsum.get("worst_stage")}
                degraded |= not ok
        return checks, degraded

    healthz = functools.partial(healthz_payload, runtime,
                                extra_checks=_serve_checks)

    # ---- the telemetry time machine (obs.tsdb / obs.slo) ---------------
    # An attached app rides the runtime's recorder; a serve-only process
    # under HEATMAP_TSDB=1 runs its own (scraping the text /metrics
    # serves, tagged HEATMAP_FLEET_TAG or serve<pid>), so it leaves
    # retained series and SLO state behind too.  The timeline routes need
    # only the directory: they answer from retained blocks, even for
    # members that are gone.
    from heatmap_tpu_torch.obs import tsdb as tsdbmod

    tsdb_on, tsdb_dir = cfg.tsdb, cfg.tsdb_dir
    serve_tsdb = serve_slo = None
    if tsdb_on and runtime is None:
        from heatmap_tpu_torch.obs.slo import SloEngine
        from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL, ENV_FLEET_TAG

        _tsdb_tag = os.environ.get(ENV_FLEET_TAG) or f"serve{os.getpid()}"
        serve_tsdb = tsdbmod.TsdbRecorder(
            lambda: _metrics_text(None, serve_reg), tag=_tsdb_tag,
            dir_path=tsdb_dir or None,
            healthz_fn=lambda: healthz()[0], registry=serve_reg,
            scrape_s=cfg.tsdb_scrape_s, retain_s=cfg.tsdb_retain_s,
            hot_s=cfg.tsdb_hot_s, flush_s=cfg.tsdb_flush_s)
        serve_slo = SloEngine(
            serve_tsdb, registry=serve_reg, tag=_tsdb_tag,
            budget_frac=cfg.slo_budget_frac,
            budget_window_s=cfg.slo_budget_window_s,
            channel_path=os.environ.get(ENV_CHANNEL),
            flightrec=flightrec)
        serve_tsdb.start()
    elif runtime is not None:
        serve_tsdb = getattr(runtime, "tsdb", None)
        serve_slo = getattr(runtime, "slo_engine", None)

    def _tiles_view(grid: str | None):
        """The view to serve tile reads from, refreshed for serve-only
        processes; None -> fall back to direct Store renders.  A
        writer-fed view that has never seen ``grid`` (process restarted
        against a durable store) is seeded ONCE from a store scan —
        upsert-only, so racing the writer thread cannot un-expose a
        durable row.  On a REPLICA the follower feeds the view and the
        store-scan refresher runs only while the follower has never
        synced — counted, so 'zero store reads in steady state' is a
        number, not a claim."""
        if view is None or view.poisoned:
            return None
        if follower is not None:
            if not follower.synced:
                # demoted fallback: store content beats serving nothing
                # — but ONLY while the replica has never synced.  Once
                # a snapshot applied, a stale feed keeps serving the
                # last replicated state: a store scan here would WIPE
                # the feed-fed view (replicas run with empty stores in
                # the zero-store-read topology) and fork the seq
                # stream.  Every pass through here is an incident
                # signal (/healthz is degraded right now too).
                if follower.c_fallback is not None:
                    follower.c_fallback.inc()
                refresher.refresh(grid)
            return view
        if refresher is not None:
            refresher.refresh(grid)
        elif grid not in seeded:
            try:
                if not view.known_grid(grid):
                    ws = store.latest_window_start(grid)
                    if ws is not None:
                        view.seed_grid(grid,
                                       store.tiles_in_window(ws, grid))
            except Exception:
                # NOT marked seeded: a transient store error must be
                # retried on the next request, or a populated grid
                # would serve empty for the process lifetime
                log.warning("view seed scan failed for grid %r; will "
                            "retry", grid, exc_info=True)
            else:
                if len(seeded) >= 256:
                    # bounded against client-controlled ?grid= values,
                    # like the refresher's per-grid map
                    seeded.pop()
                seeded.add(grid)
        return view

    def _store_poll_tick(grid) -> bool:
        """One store-fed refresh tick shared by the fan-out pumps: True
        when this worker is store-polling (nothing else advances the
        view), with the demoted-fallback accounting the replica
        topology requires."""
        store_polling = (refresher is not None
                         and (follower is None or not follower.synced))
        if store_polling:
            if follower is not None \
                    and follower.c_fallback is not None:
                follower.c_fallback.inc()
            refresher.refresh(grid)
        return store_polling

    def _sse_tiles_frame(d: dict, grid: str, fmt: str) -> bytes:
        """One encoded SSE frame for a delta payload — the shared
        buffer the fan-out writes to every subscriber socket.  Binary
        frames ride base64 under ``event: tiles-bin`` (SSE is a text
        protocol); docs the compact layout cannot represent exactly
        fall back to the JSON event, which clients listening on both
        event names handle transparently."""
        if fmt == "bin":
            import base64

            try:
                frame = wiremod.encode(d["mode"], d["seq"], grid,
                                       d["window_start"], d["docs"],
                                       native=wire_ops)
            except ValueError:
                log.warning("binary SSE frame unrepresentable; "
                            "falling back to JSON", exc_info=True)
            else:
                return (b"event: tiles-bin\ndata: "
                        + base64.b64encode(frame) + b"\n\n")
        body = _delta_body(d, grid)
        return (f"event: tiles\ndata: {body}\n\n").encode("utf-8")

    def _tiles_pump(grid: str, fmt: str, start_seq: int):
        """The coalesced broadcaster for one (grid, format) channel:
        encodes each view seq advance EXACTLY ONCE and fans the bytes
        to every subscriber queue.  ``start_seq`` is captured in the
        REQUEST thread before the subscribe: reading view.seq here
        instead would let an advance landing between the first
        subscriber's catch-up and this thread's first instruction go
        broadcast to nobody."""
        def pump(chan):
            last = start_seq
            while True:
                if chan.try_retire():
                    return
                store_polling = _store_poll_tick(grid)
                if view.poisoned:
                    chan.finish(b"event: gone\ndata: {}\n\n")
                    return
                if view.changed_since(grid, last):
                    d = view.delta(grid, last)
                    stats.delta_cells.observe(len(d["docs"]))
                    frame = _sse_tiles_frame(d, grid, fmt)
                    stats.sse_encodes.labels(fmt=fmt).inc()
                    last = d["seq"]
                    # the delivery lineage: one encode stamp a (channel,
                    # seq), None when no upstream stamps cover the seq
                    # (knob off, or a writer-fed view), and then the
                    # frame goes out untagged, byte-identical
                    meta = delivery.encoded(d["seq"])
                    chan.broadcast(frame, meta=meta)
                    continue
                # store-polling pumps must keep POLLING (nothing else
                # advances the view), so their wait slices shorter;
                # writer-fed pumps wait event-driven on the view condvar.
                # The 1 s ceiling also bounds how long a subscriber-less
                # pump lingers.
                wait_s = (min(1.0, sse_heartbeat) if store_polling
                          else 1.0)
                view.wait_changed(grid, last, timeout=wait_s)
        return pump

    def _sse_generator(sub, first_frames):
        """One subscriber's generator: drains its bounded queue,
        heartbeats through quiet periods, and turns the LAGGED
        sentinel into ``event: lagged`` + a clean end-of-stream."""
        def events():
            yield b"retry: 3000\n\n"
            for f in first_frames:
                yield f
            last_beat = time.monotonic()
            while True:
                item = sub.pop(timeout=max(0.05,
                                           min(1.0, sse_heartbeat)))
                if item is None:
                    if time.monotonic() - last_beat >= sse_heartbeat:
                        yield b": hb\n\n"
                        last_beat = time.monotonic()
                    continue
                if item is wiremod.LAGGED:
                    # the bounded send queue overflowed: this reader
                    # is too slow for the stream — shed it cleanly
                    # rather than let its back-pressure wedge the
                    # shared fan-out (it reconnects and resyncs)
                    yield b"event: lagged\ndata: {}\n\n"
                    return
                if item is wiremod.CLOSED:
                    return
                # the delivery lineage: a Tagged frame carries the encode
                # stamp sidecar — yield the SAME bytes object (wire
                # unchanged) and bracket the blocking socket write so
                # the sample completes at the subscriber boundary.  The
                # stall stamps (monotonic, on the sub) make a wedged
                # client visible the whole time the yield below is
                # parked in send()
                meta = None
                if isinstance(item, wiremod.Tagged):
                    meta = item.meta
                    item = item.data
                wb = delivery.clock()
                with sub.cond:
                    sub.write_begin_mono = time.monotonic()
                yield item
                with sub.cond:
                    sub.write_begin_mono = None
                    sub.last_write_mono = time.monotonic()
                    sub.writes += 1
                if meta is not None:
                    delivery.delivered(meta, wb, delivery.clock())
                last_beat = time.monotonic()
        return events()

    def _arm_sse_socket(environ) -> None:
        """Bound the time a blocking SSE write may stall on a client
        that stopped reading (HEATMAP_SSE_SEND_TIMEOUT_S): the lag
        sentinel sheds a slow-but-draining reader, but a reader that
        stops draining the SOCKET parks the writer thread in send() —
        the timeout unsticks it so the admission slot is released."""
        sock = environ.get("heatmap.socket")
        if sock is not None and sse_send_timeout > 0:
            try:
                sock.settimeout(sse_send_timeout)
            except OSError:
                pass

    def _sse_response(environ, start_response):
        params = _qs_params(environ.get("QUERY_STRING", ""))
        grid, err = _parse_grid(params, default_grid)
        if err is None:
            fmt, err = _negotiate_fmt(environ, params)
        if err:
            start_response("400 Bad Request",
                           [("Content-Type", "application/json")])
            return [json.dumps({"error": err}).encode()]
        since = _qs_int(params, "since", 0, 1 << 62)
        v = _tiles_view(grid)
        if v is None:
            start_response("503 Service Unavailable",
                           [("Content-Type", "application/json")])
            return [b'{"error": "query view unavailable"}']
        # admission is check-then-claim under one lock: the gauge must
        # move BEFORE the response body is first iterated, or N
        # concurrent connects would all pass the check and exceed the
        # thread cap the limit exists to enforce
        with sse_admit_lock:
            if stats.sse_clients.value >= sse_max:
                start_response("503 Service Unavailable",
                               [("Content-Type", "application/json")])
                return [b'{"error": "sse client limit reached"}']
            stats.sse_clients.inc(1)
        _arm_sse_socket(environ)
        start_response("200 OK", [
            ("Content-Type", "text/event-stream"),
            ("Cache-Control", "no-cache"),
            ("X-Accel-Buffering", "no"),
        ])
        stats.wire_format.labels(endpoint="stream", fmt=fmt).inc()
        # anchor a would-be-new channel BEFORE subscribing, subscribe,
        # THEN build the per-client catch-up frame: broadcasts cover
        # (start_seq, ...], the catch-up covers (since, now>=start_seq]
        # — overlap is idempotent (delta upserts), a gap is not, and
        # this order can never gap
        start_seq = view.seq
        pump = _tiles_pump(grid, fmt, start_seq)
        key = ("tiles", grid, fmt)
        # event-loop core: same pump, same channel key, but the
        # subscriber is a (cursor, offset) pair into the channel's
        # shared frame ring (no per-subscriber queue, no writer
        # thread) and the loop drains it — wire bytes identical
        evloop = bool(environ.get("heatmap.evloop"))
        if evloop:
            chan, sub = fanout.subscribe_ev(key, pump)
        else:
            chan, sub = fanout.subscribe(key, pump)
        d = view.delta(grid, since)
        stats.delta_cells.observe(len(d["docs"]))
        first = [_sse_tiles_frame(d, grid, fmt)]

        def on_close():
            fanout.unsubscribe(chan, sub)
            stats.sse_clients.inc(-1)

        if evloop:
            return evloopmod.EvloopStream(
                chan, sub, [b"retry: 3000\n\n"] + first, on_close,
                sse_heartbeat, sse_send_timeout, delivery)
        # the admission slot is released in _SSEBody.close(), which the
        # WSGI server guarantees to call — a bare generator's finally
        # would never run if iteration never starts
        return _SSEBody(_sse_generator(sub, first), on_close)

    def _cq_sse_response(environ, start_response):
        """/api/queries/stream?id=&since= — one standing query's
        match/alert records as SSE.  Shares the tiles-stream admission
        cap + slot-release hardening, and heartbeats through
        match-quiet periods so an idle geofence subscriber's proxy
        never reaps the connection."""
        params = _qs_params(environ.get("QUERY_STRING", ""))
        qid = params.get("id", "")
        if cq_engine is None:
            start_response("503 Service Unavailable",
                           [("Content-Type", "application/json")])
            return [b'{"error": "continuous queries need the query '
                    b'view (HEATMAP_CQ=1)"}']
        q = cq_engine.get(qid)
        if q is None:
            start_response("404 Not Found",
                           [("Content-Type", "application/json")])
            return [b'{"error": "no such query id"}']
        since = _qs_int(params, "since", 0, 1 << 62)
        grid = q.grid
        with sse_admit_lock:
            if stats.sse_clients.value >= sse_max:
                start_response("503 Service Unavailable",
                               [("Content-Type", "application/json")])
                return [b'{"error": "sse client limit reached"}']
            stats.sse_clients.inc(1)
        _arm_sse_socket(environ)
        start_response("200 OK", [
            ("Content-Type", "text/event-stream"),
            ("Cache-Control", "no-cache"),
            ("X-Accel-Buffering", "no"),
        ])

        def _cq_frames(evs) -> bytes:
            return b"".join(
                (f"id: {ev['id']}\nevent: match\n"
                 f"data: {json.dumps(ev)}\n\n").encode("utf-8")
                for ev in evs)

        # anchor the would-be-new channel's cursor in THIS thread (the
        # same no-gap ordering as the tiles stream): events after
        # start_id broadcast, the per-client resume frame covers up to
        # at-least start_id
        _evs0 = cq_engine.events_since(qid, 0)
        start_id = _evs0[-1]["id"] if _evs0 else 0

        def pump(chan):
            # N subscribers on one standing query share ONE encode per
            # new match batch instead of N json.dumps passes
            last = start_id
            while True:
                if chan.try_retire():
                    return
                store_polling = _store_poll_tick(grid)
                if store_polling:
                    cq_engine.drain()
                evs = cq_engine.events_since(qid, last)
                if evs:
                    frame = _cq_frames(evs)
                    stats.sse_encodes.labels(fmt="cq").inc()
                    last = evs[-1]["id"]
                    # match pushes ride the tile frames' delivery stamps:
                    # the newest match's view seq anchors the lineage, so
                    # alert delivery lag is measured too
                    seqs = [ev.get("seq") for ev in evs
                            if isinstance(ev.get("seq"), int)]
                    meta = delivery.encoded(max(seqs)) if seqs else None
                    chan.broadcast(frame, meta=meta)
                    continue
                if cq_engine.get(qid) is None:
                    # expired (TTL) or deleted: tell the client not to
                    # reconnect into a 404 loop
                    chan.finish(b"event: gone\ndata: {}\n\n")
                    return
                wait_s = (min(1.0, sse_heartbeat) if store_polling
                          else 1.0)
                cq_engine.wait_events(qid, last, timeout=wait_s)

        # subscribe first, then the per-client resume frame (same
        # no-gap ordering as the tiles stream; `id:` lines make the
        # possible overlap visible to resuming clients)
        evloop = bool(environ.get("heatmap.evloop"))
        if evloop:
            chan, sub = fanout.subscribe_ev(("cq", qid), pump)
        else:
            chan, sub = fanout.subscribe(("cq", qid), pump)
        first = []
        evs = cq_engine.events_since(qid, since)
        if evs:
            first.append(_cq_frames(evs))

        def on_close():
            fanout.unsubscribe(chan, sub)
            stats.sse_clients.inc(-1)

        if evloop:
            return evloopmod.EvloopStream(
                chan, sub, [b"retry: 3000\n\n"] + first, on_close,
                sse_heartbeat, sse_send_timeout, delivery)
        return _SSEBody(_sse_generator(sub, first), on_close)

    def _handle(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        pre_gz = None
        data = None
        status = "200 OK"
        endpoint = None          # sent-bytes accounting label
        extra_headers: list = []
        # request span: installed by app() on the admitted data
        # endpoints; marks accrue time since the previous mark, so the
        # stages telescope to the total
        span = environ.get("heatmap.span")

        def _mk(stage):
            if span is not None:
                span.mark(stage)

        def _bad_request(msg):
            start_response("400 Bad Request",
                           [("Content-Type", "application/json")])
            return [json.dumps({"error": msg}).encode()]

        def _unavailable(msg):
            start_response("503 Service Unavailable",
                           [("Content-Type", "application/json")])
            return [json.dumps({"error": msg}).encode()]

        def _not_modified(etag, ep, vary_accept=False):
            stats.http_304.labels(endpoint=ep).inc()
            if ep in ("tiles", "delta") and runtime is not None:
                # what the client sees is still the current view
                _sample_serve_freshness(runtime)
            vary = ("Accept-Encoding, Accept" if vary_accept
                    else "Accept-Encoding")
            start_response("304 Not Modified",
                           [("ETag", etag), ("Vary", vary)])
            return []

        try:
            if path == "/api/tiles/latest":
                endpoint = "tiles"
                params = _qs_params(environ.get("QUERY_STRING", ""))
                # bare requests get the default grid: a multi-res
                # pyramid would otherwise mix overlapping hexes in a
                # single FeatureCollection
                grid, err = _parse_grid(params, default_grid)
                if err:
                    return _bad_request(err)
                res, err = _parse_res(params)
                if err:
                    return _bad_request(err)
                fmt, err = _negotiate_fmt(environ, params)
                if err:
                    return _bad_request(err)
                # the representation depends on Accept (binary
                # negotiation), so EVERY response — JSON 200s and 304s
                # included — must say so, or a shared cache could
                # replay the wrong representation (RFC 9110 §12.5.5)
                extra_headers.append(("Vary", "Accept"))
                ctype = "application/json"
                _mk("parse")
                v = _tiles_view(grid)
                if v is not None:
                    # etag + docs + seq captured atomically: a writer
                    # apply landing between them would label newer
                    # content with a stale strong ETag (or stamp a
                    # foreign seq into the binary frame)
                    try:
                        etag0, _ws, docs, vseq = v.snapshot_seq(grid,
                                                                res)
                    except KeyError:
                        return _bad_request(
                            f"res={res} is not maintained for grid "
                            f"{grid!r} (HEATMAP_PYRAMID_LEVELS)")
                    # format-keyed strong ETag: the binary and JSON
                    # representations of one view state must never
                    # share an ETag
                    etag = wiremod.format_etag(etag0, fmt)
                    if _inm_match(environ, etag):
                        stats.wire_format.labels(endpoint=endpoint,
                                                 fmt=fmt).inc()
                        return _not_modified(etag, endpoint,
                                             vary_accept=True)
                    if fmt == "bin":
                        try:
                            data, pre_gz = _view_cached(
                                (grid, res, "bin"), etag,
                                lambda: wiremod.encode(
                                    "full", vseq, grid, _ws, docs,
                                    native=wire_ops),
                                endpoint)
                            ctype = wiremod.CONTENT_TYPE
                        except ValueError:
                            # a doc the compact layout cannot encode
                            # exactly: serve the JSON representation
                            # (with ITS ETag) rather than bytes that
                            # would decode differently
                            log.warning("binary tiles frame "
                                        "unrepresentable; serving "
                                        "JSON", exc_info=True)
                            fmt = "json"
                            etag = etag0
                    if fmt == "json":
                        data, pre_gz = _view_cached(
                            (grid, res), etag,
                            lambda: _features_collection_json(docs),
                            endpoint)
                    extra_headers.append(("ETag", etag))
                else:
                    if res is not None:
                        return _unavailable(
                            "res= rollups need the query view "
                            "(HEATMAP_QUERY_VIEW=1)")
                    if fmt == "bin":
                        return _unavailable(
                            "binary tiles need the query view "
                            "(HEATMAP_QUERY_VIEW=1)")
                    data, pre_gz = _cached_json(
                        ("tiles", grid),
                        lambda: tiles_feature_collection_json(store, grid),
                        endpoint)
                stats.wire_format.labels(endpoint=endpoint,
                                         fmt=fmt).inc()
                _mk("lookup")
                if runtime is not None:
                    _sample_serve_freshness(runtime)
            elif path == "/api/tiles/delta":
                endpoint = "delta"
                params = _qs_params(environ.get("QUERY_STRING", ""))
                grid, err = _parse_grid(params, default_grid)
                if err:
                    return _bad_request(err)
                fmt, err = _negotiate_fmt(environ, params)
                if err:
                    return _bad_request(err)
                since = _qs_int(params, "since", 0, 1 << 62)
                extra_headers.append(("Vary", "Accept"))
                _mk("parse")
                v = _tiles_view(grid)
                if v is None:
                    return _unavailable(
                        "delta needs the query view (HEATMAP_QUERY_VIEW=1)")
                d = v.delta(grid, since)
                stats.delta_cells.observe(len(d["docs"]))
                ctype = "application/json"
                if fmt == "bin":
                    try:
                        data = wiremod.encode(d["mode"], d["seq"],
                                              grid, d["window_start"],
                                              d["docs"],
                                              native=wire_ops)
                        ctype = wiremod.CONTENT_TYPE
                    except ValueError:
                        log.warning("binary delta frame "
                                    "unrepresentable; serving JSON",
                                    exc_info=True)
                        fmt = "json"
                if fmt == "json":
                    body = _delta_body(d, grid)
                    data = body.encode("utf-8")
                _account_render(endpoint, data)
                stats.wire_format.labels(endpoint=endpoint,
                                         fmt=fmt).inc()
                _mk("lookup")
                if runtime is not None:
                    # the delta-polling UI samples the freshness too
                    _sample_serve_freshness(runtime)
            elif path == "/api/tiles/topk":
                endpoint = "topk"
                params = _qs_params(environ.get("QUERY_STRING", ""))
                grid, err = _parse_grid(params, default_grid)
                if err:
                    return _bad_request(err)
                k = _qs_int(params, "k", 20, 1000)
                res, err = _parse_res(params)
                if err:
                    return _bad_request(err)
                bbox, err = _parse_bbox(params)
                if err:
                    return _bad_request(err)
                _mk("parse")
                v = _tiles_view(grid)
                if v is None:
                    return _unavailable(
                        "topk needs the query view (HEATMAP_QUERY_VIEW=1)")
                try:
                    docs = v.topk(grid, k, res=res, bbox=bbox)
                except KeyError:
                    return _bad_request(
                        f"res={res} is not maintained for grid {grid!r} "
                        f"(HEATMAP_PYRAMID_LEVELS)")
                body = _features_collection_json(docs)
                data = body.encode("utf-8")
                _account_render(endpoint, data)
                _mk("lookup")
                ctype = "application/json"
            elif path == "/api/queries":
                endpoint = "queries"
                if cq_engine is None:
                    return _unavailable(
                        "continuous queries need the query view "
                        "(HEATMAP_CQ=1 + HEATMAP_QUERY_VIEW=1)")
                method = environ.get("REQUEST_METHOD", "GET")
                params = _qs_params(environ.get("QUERY_STRING", ""))
                if method == "POST":
                    try:
                        n = int(environ.get("CONTENT_LENGTH") or 0)
                    except ValueError:
                        n = 0
                    if not 0 < n <= 1 << 20:
                        return _bad_request(
                            "POST body must be 1..1MB of JSON")
                    try:
                        spec = json.loads(
                            environ["wsgi.input"].read(n)
                            .decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        return _bad_request("body is not valid JSON")
                    grid = (spec.get("grid") if isinstance(spec, dict)
                            else None) or default_grid
                    # make sure the grid's view is warm BEFORE the
                    # engine seeds the query's edge state (store-fed
                    # workers only materialize on access)
                    _tiles_view(grid)
                    try:
                        desc = cq_engine.register(spec, default_grid)
                    except ValueError as e:
                        return _bad_request(str(e))
                    body = json.dumps(desc)
                elif method == "DELETE":
                    qid = params.get("id")
                    if not qid:
                        return _bad_request("DELETE needs ?id=")
                    if not cq_engine.remove(qid):
                        start_response("404 Not Found",
                                       [("Content-Type",
                                         "application/json")])
                        return [b'{"error": "no such query id"}']
                    body = json.dumps({"id": qid, "removed": True})
                elif method == "GET":
                    qid = params.get("id")
                    if qid:
                        desc = cq_engine.describe(qid)
                        if desc is None:
                            start_response("404 Not Found",
                                           [("Content-Type",
                                             "application/json")])
                            return [b'{"error": "no such query id"}']
                        desc["eval"] = cq_engine.evaluate(qid)
                        body = json.dumps(desc)
                    else:
                        n = _qs_int(params, "n", 100, 1000)
                        body = json.dumps(cq_engine.list(n))
                else:
                    start_response("405 Method Not Allowed",
                                   [("Allow", "GET, POST, DELETE"),
                                    ("Content-Type",
                                     "application/json")])
                    return [b'{"error": "GET, POST or DELETE"}']
                ctype = "application/json"
            elif path == "/api/tiles/range":
                # space-time history (query/history.py): per-window
                # series + cross-range aggregate over [t0, t1), served
                # from the compacted chunk store with the live view's
                # windows overlaid (latest / not-yet-compacted windows
                # serve without waiting for the compactor)
                endpoint = "range"
                params = _qs_params(environ.get("QUERY_STRING", ""))
                grid, err = _parse_grid(params, default_grid)
                if err:
                    return _bad_request(err)
                res, err = _parse_res(params)
                if err:
                    return _bad_request(err)
                fmt, err = _negotiate_fmt(environ, params)
                if err:
                    return _bad_request(err)
                if hist_reader is None:
                    return _unavailable(
                        "the space-time history tier needs "
                        "HEATMAP_HIST_DIR (or an http replication "
                        "feed whose writer exposes /api/hist/*)")
                t0, ok0 = _qs_epoch_s(params, "t0")
                t1, ok1 = _qs_epoch_s(params, "t1")
                if not ok0 or not ok1 or t0 is None:
                    return _bad_request(
                        "range needs t0= (epoch seconds; t1= defaults "
                        "to now)")
                if t1 is None:
                    t1 = time.time()
                if t0 >= t1:
                    return _bad_request("t0 must be before t1")
                from heatmap_tpu_torch.query.matview import _grid_base_res

                err = _hist_res_err(grid, res)
                if err:
                    return _bad_request(err)
                base = _grid_base_res(grid)
                extra_headers.append(("Vary", "Accept"))
                _mk("parse")
                histmod.scan_reset()
                per_window = hist_reader.windows_in_range(grid, t0, t1)
                win_out = []
                for ws in sorted(per_window):
                    docs = per_window[ws]["docs"]
                    if not docs:
                        continue
                    ws_dt = docs[0].get("windowStart")
                    we_dt = docs[0].get("windowEnd")
                    if res is not None and res != base:
                        docs = sorted(
                            histmod.rollup_window(docs, res, base, ws_dt,
                                          we_dt),
                            key=lambda d: d["cellId"])
                    win_out.append((ws, ws_dt, we_dt, docs))
                ctype = "application/json"
                if fmt == "bin":
                    # the window series as length-prefixed tile wire
                    # frames (one per window, seq = windowStart epoch
                    # seconds); the cross-range aggregate is JSON-only
                    try:
                        body_b = bytearray()
                        for ws, ws_dt, _we, docs in win_out:
                            frame = wiremod.encode("full", ws, grid,
                                                   ws_dt, docs,
                                                   native=wire_ops)
                            body_b += len(frame).to_bytes(4, "little")
                            body_b += frame
                        data = bytes(body_b)
                        ctype = wiremod.CONTENT_TYPE
                    except ValueError:
                        log.warning("binary range frame "
                                    "unrepresentable; serving JSON",
                                    exc_info=True)
                        fmt = "json"
                if fmt == "json":
                    t0_dt = dt.datetime.fromtimestamp(t0, dt.timezone.utc)
                    t1_dt = dt.datetime.fromtimestamp(t1, dt.timezone.utc)
                    agg = histmod.aggregate_range(
                        {ws: {"docs": docs}
                         for ws, _w, _e, docs in win_out},
                        t0_dt, t1_dt)
                    parts = []
                    for ws, ws_dt, we_dt, docs in win_out:
                        head_w = json.dumps({
                            "windowStart": _iso(ws_dt)
                            if ws_dt is not None else None,
                            "windowEnd": _iso(we_dt)
                            if we_dt is not None else None})
                        parts.append(
                            head_w[:-1] + ', "features": ['
                            + ", ".join(_feature_json(d) for d in docs)
                            + ']}')
                    head = json.dumps({"grid": grid, "t0": t0,
                                       "t1": t1, "res": res,
                                       "windows": len(win_out)})
                    data = (head[:-1] + ', "series": ['
                            + ", ".join(parts)
                            + '], "aggregate": {"features": ['
                            + ", ".join(_feature_json(d) for d in agg)
                            + ']}}').encode("utf-8")
                _account_render(endpoint, data)
                stats.wire_format.labels(endpoint=endpoint,
                                         fmt=fmt).inc()
                _mk("lookup")
                if span is not None:
                    span.scan = histmod.last_scan()
                import hashlib

                etag = f'"hr.{hashlib.md5(data).hexdigest()[:16]}"'
                if _inm_match(environ, etag):
                    return _not_modified(etag, endpoint,
                                         vary_accept=True)
                extra_headers.append(("ETag", etag))
            elif path == "/api/tiles/at":
                # view-at-seq replay (query/history.py view_at_seq):
                # the materialized view reconstructed from an adopted
                # snapshot + the sealed log at one historical seq —
                # incident forensics next to the flight recorder's
                # episode dumps
                endpoint = "at"
                params = _qs_params(environ.get("QUERY_STRING", ""))
                grid, err = _parse_grid(params, default_grid)
                if err:
                    return _bad_request(err)
                if not hist_dir:
                    return _unavailable(
                        "view-at-seq replay needs a local "
                        "HEATMAP_HIST_DIR (the sealed log lives "
                        "there)")
                seq = _qs_int(params, "seq", 0, 1 << 62)
                if seq <= 0:
                    return _bad_request("at needs seq= > 0")
                _mk("parse")
                from heatmap_tpu_torch.query.repl import read_meta

                feed = repl_dir or (
                    repl_feed if repl_feed
                    and not repl_feed.startswith("http") else None)
                epoch = params.get("epoch") or (
                    read_meta(feed).get("epoch") if feed else None)
                key = (epoch, seq, grid)
                data = (hist_at_cache.get(key)
                        if epoch is not None else None)
                if data is None:
                    try:
                        v_at = histmod.view_at_seq(hist_dir, seq,
                                           feed_dir=feed, epoch=epoch)
                    except ValueError as e:
                        start_response("404 Not Found",
                                       [("Content-Type",
                                         "application/json")])
                        return [json.dumps({"error": str(e)}).encode()]
                    ws_dt, docs = v_at.latest_docs(grid)
                    head = json.dumps({
                        "seq": seq, "grid": grid,
                        "windowStart": _iso(ws_dt)
                        if ws_dt is not None else None})
                    data = (head[:-1] + ', "features": ['
                            + ", ".join(_feature_json(d) for d in docs)
                            + ']}').encode("utf-8")
                    if epoch is not None:
                        if len(hist_at_cache) >= 8:
                            hist_at_cache.pop(
                                next(iter(hist_at_cache)))
                        hist_at_cache[key] = data
                _account_render(endpoint, data)
                _mk("lookup")
                ctype = "application/json"
            elif path == "/api/tiles/diff":
                # day-over-day diff: the window states anchored at t0
                # and t1 compared per cell (delta = count@t1 -
                # count@t0; cells present on only one side count 0 on
                # the other)
                endpoint = "diff"
                params = _qs_params(environ.get("QUERY_STRING", ""))
                grid, err = _parse_grid(params, default_grid)
                if err:
                    return _bad_request(err)
                res, err = _parse_res(params)
                if err:
                    return _bad_request(err)
                if hist_reader is None:
                    return _unavailable(
                        "the space-time history tier needs "
                        "HEATMAP_HIST_DIR (or an http replication "
                        "feed whose writer exposes /api/hist/*)")
                t0, ok0 = _qs_epoch_s(params, "t0")
                t1, ok1 = _qs_epoch_s(params, "t1")
                if not ok0 or not ok1 or t0 is None or t1 is None:
                    return _bad_request(
                        "diff needs t0= and t1= (epoch seconds)")
                from heatmap_tpu_torch.query.matview import _grid_base_res

                err = _hist_res_err(grid, res)
                if err:
                    return _bad_request(err)
                base = _grid_base_res(grid)
                _mk("parse")
                histmod.scan_reset()
                sides = []
                for t in (t0, t1):
                    got = hist_reader.window_at(grid, t)
                    docs = got[1] if got else []
                    if docs and res is not None and res != base:
                        docs = histmod.rollup_window(
                            docs, res, base,
                            docs[0].get("windowStart"),
                            docs[0].get("windowEnd"))
                    sides.append((got[0] if got else None,
                                  {d["cellId"]: d for d in docs}))
                (ws0, m0), (ws1, m1) = sides
                feats = []
                for cid in sorted(set(m0) | set(m1)):
                    c0 = int((m0.get(cid) or {}).get("count", 0))
                    c1 = int((m1.get(cid) or {}).get("count", 0))
                    props = {"cellId": cid, "count": c1,
                             "prevCount": c0, "delta": c1 - c0}
                    side = m1.get(cid) or m0.get(cid)
                    if side is not None and "avgSpeedKmh" in side:
                        props["avgSpeedKmh"] = float(
                            side["avgSpeedKmh"])
                    feats.append(
                        '{"type": "Feature", "geometry": '
                        + _cell_geometry_json(cid)
                        + ', "properties": ' + json.dumps(props) + '}')
                head = json.dumps({"grid": grid, "t0": t0, "t1": t1,
                                   "res": res, "window0": ws0,
                                   "window1": ws1})
                body = (head[:-1] + ', "features": ['
                        + ", ".join(feats) + ']}')
                data = body.encode("utf-8")
                _account_render(endpoint, data)
                _mk("lookup")
                if span is not None:
                    span.scan = histmod.last_scan()
                ctype = "application/json"
            elif path == "/api/tiles/forecast":
                # short-horizon occupancy forecast (infer.engine): every
                # tracked entity advected along its filtered velocity
                # for h seconds, snapped, counted — answered straight
                # off the entity table (host arrays), so it needs the
                # runtime's inference engine (HEATMAP_REDUCERS=
                # count,kalman) in THIS process
                endpoint = "forecast"
                infer_eng = (getattr(runtime, "infer", None)
                             if runtime is not None else None)
                if infer_eng is None:
                    return _unavailable(
                        "occupancy forecasts need the streaming "
                        "inference engine (HEATMAP_REDUCERS="
                        "count,kalman) in the serving process")
                params = _qs_params(environ.get("QUERY_STRING", ""))
                h_s = _qs_int(params, "h", 60, 3600)
                if h_s <= 0:
                    return _bad_request("h= must be in 1..3600 seconds")
                res, err = _parse_res(params)
                if err:
                    return _bad_request(err)
                if res is None:
                    res = infer_eng.base_res
                _mk("parse")
                cells = infer_eng.forecast_cells(float(h_s), res)
                blk = infer_eng.member_block()
                data = _forecast_body(cells, h_s, res, blk)
                _account_render(endpoint, data)
                # the quality observatory (HEATMAP_QUALITY=1): every
                # served horizon becomes a pending scorecard, AFTER the
                # body is built and guarded, so registration never
                # changes the response bytes or fails the request
                quality = getattr(runtime, "quality", None)
                if quality is not None:
                    try:
                        quality.register_forecast(
                            res, float(h_s), blk["max_event_ts"] or None,
                            cells)
                    except Exception:  # noqa: BLE001 - observe-only
                        log.warning("scorecard registration failed",
                                    exc_info=True)
                _mk("lookup")
                ctype = "application/json"
            elif path.startswith("/api/hist/"):
                # the chunk store re-exported over HTTP: what a remote
                # replica's cold-start backfill (and range reader)
                # consumes via HttpHistorySource
                if not hist_dir:
                    return _unavailable(
                        "the history re-export needs HEATMAP_HIST_DIR")
                params = _qs_params(environ.get("QUERY_STRING", ""))
                if path == "/api/hist/index":
                    body = json.dumps({
                        "chunks": hist_src.index(),
                        "bucket_s": cfg.hist_bucket_s,
                        "parent_res": cfg.hist_parent_res,
                        "retention_s": cfg.hist_retention_s,
                    })
                    ctype = "application/json"
                elif path == "/api/hist/chunk":
                    name = params.get("name") or ""
                    if not histmod.chunk_name_ok(name):
                        return _bad_request(
                            "name= is not a chunk name")
                    buf = hist_src.chunk_bytes(name)
                    if buf is None:
                        start_response("404 Not Found",
                                       [("Content-Type",
                                         "application/json")])
                        return [b'{"error": "no such chunk"}']
                    data = buf
                    ctype = "application/octet-stream"
                else:
                    start_response("404 Not Found",
                                   [("Content-Type", "text/plain")])
                    return [b"not found"]
            elif path == "/api/positions/latest":
                endpoint = "positions"
                params = _qs_params(environ.get("QUERY_STRING", ""))
                fmt, err = _negotiate_fmt(
                    environ, params, ctype=wiremod.CONTENT_TYPE_POSITIONS)
                if err:
                    return _bad_request(err)
                # the representation depends on Accept (binary
                # negotiation): every response must say so or a shared
                # cache could replay the wrong representation
                extra_headers.append(("Vary", "Accept"))
                _mk("parse")
                ver = store.version()
                etag = None
                if ver is not None and runtime is not None:
                    # only the writer process may trust the version
                    # counter as a change signal (MongoStore's counter
                    # sees ONLY this process's writes — a serve-only
                    # deployment over a shared store would 304 forever
                    # while positions change underneath).  Format-keyed:
                    # the binary and JSON representations of one store
                    # version must never share an ETag.
                    etag = wiremod.format_etag(
                        f'"p.{boot_nonce}.{ver}"', fmt)
                    if _inm_match(environ, etag):
                        stats.wire_format.labels(endpoint=endpoint,
                                                 fmt=fmt).inc()
                        return _not_modified(etag, endpoint,
                                             vary_accept=True)
                ctype = "application/json"
                if fmt == "bin":
                    try:
                        data, pre_gz = _cached_json(
                            ("positions", "bin"),
                            lambda: wiremod.encode_positions(
                                store.all_positions()),
                            endpoint)
                        ctype = wiremod.CONTENT_TYPE_POSITIONS
                    except ValueError:
                        # a doc the compact layout cannot represent
                        # exactly: serve the JSON representation (with
                        # ITS ETag) rather than bytes that would
                        # decode differently
                        log.warning("binary positions frame "
                                    "unrepresentable; serving JSON",
                                    exc_info=True)
                        fmt = "json"
                        etag = (f'"p.{boot_nonce}.{ver}"'
                                if etag is not None else None)
                if fmt == "json":
                    data, pre_gz = _cached_json(
                        ("positions",),
                        lambda: json.dumps(
                            positions_feature_collection(store)),
                        endpoint)
                if etag is not None and store.version() != ver:
                    # a write landed between the version read and the
                    # render: the body may be newer than the version
                    # ETag claims — fall through to the content hash
                    etag = None
                if etag is None:
                    # serve-only: a content-derived strong ETag — the
                    # render still runs (the cache absorbs repeats) but
                    # a 304 saves the wire bytes and is never wrong.
                    # The hash covers the encoded representation, so
                    # it is format-keyed by construction.
                    import hashlib

                    etag = f'"p.h.{hashlib.md5(data).hexdigest()[:16]}"'
                    if _inm_match(environ, etag):
                        stats.wire_format.labels(endpoint=endpoint,
                                                 fmt=fmt).inc()
                        return _not_modified(etag, endpoint,
                                             vary_accept=True)
                extra_headers.append(("ETag", etag))
                stats.wire_format.labels(endpoint=endpoint,
                                         fmt=fmt).inc()
                _mk("lookup")
            elif path.startswith("/api/repl/"):
                # the replication feed over HTTP (query.repl): any
                # process holding the feed directory re-exposes its
                # three artifacts, so remote replicas follow over plain
                # TCP with the same snapshot-then-tail protocol the
                # same-host file transport uses
                if not repl_dir:
                    return _unavailable(
                        "replication feed endpoints need "
                        "HEATMAP_REPL_DIR")
                from heatmap_tpu_torch.query import repl as replmod

                params = _qs_params(environ.get("QUERY_STRING", ""))
                if path == "/api/repl/meta":
                    body = json.dumps(replmod.read_meta(repl_dir))
                elif path == "/api/repl/snapshot":
                    epoch = params.get("epoch") or \
                        replmod.read_meta(repl_dir).get("epoch") or ""
                    snap = replmod.read_snapshot(repl_dir, epoch)
                    if snap is None:
                        start_response("404 Not Found",
                                       [("Content-Type",
                                         "application/json")])
                        return [b'{"error": "no snapshot for that '
                                b'epoch"}']
                    body = replmod.dumps(snap)
                elif path == "/api/repl/feed":
                    epoch = params.get("epoch") or ""
                    since = _qs_int(params, "since", 0, 1 << 62)
                    max_n = _qs_int(params, "max", 512, 4096)
                    meta = replmod.read_meta(repl_dir)
                    recs = (replmod.read_records(repl_dir, epoch, since,
                                                 max_n or 512)
                            if epoch == meta.get("epoch") else [])
                    body = replmod.dumps({
                        "epoch": meta.get("epoch"),
                        "last_seq": meta.get("last_seq", 0),
                        "min_seq": meta.get("min_seq", 1),
                        "records": recs,
                    })
                else:
                    start_response("404 Not Found",
                                   [("Content-Type", "text/plain")])
                    return [b"not found"]
                ctype = "application/json"
            elif path == "/metrics":
                body = _metrics_text(runtime, serve_reg)
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(_metrics_json(runtime))
                ctype = "application/json"
            elif path == "/trace/recent":
                params = _qs_params(environ.get("QUERY_STRING", ""))
                n = _qs_int(params, "n", 50, 1024)
                fields = params.get("fields")
                ring = getattr(runtime, "tracering", None)
                traces = ring.recent(n) if ring is not None else []
                if fields is not None:
                    # a bounded, validated key projection (missing keys
                    # drop out)
                    names, err = _parse_fields(fields)
                    if err:
                        return _bad_request(err)
                    traces = [{k: r[k] for k in names if k in r}
                              for r in traces]
                body = json.dumps({"traces": traces})
                ctype = "application/json"
            elif path == "/debug/freshness":
                from heatmap_tpu_torch.obs.lineage import STAGES

                params = _qs_params(environ.get("QUERY_STRING", ""))
                n = _qs_int(params, "n", 32, 256)
                lin = getattr(runtime, "lineage", None)
                tel = getattr(runtime, "telemetry", None)
                body = json.dumps({
                    "records": lin.tail(n) if lin is not None else [],
                    "summary": (tel.freshness_summary()
                                if tel is not None else {}),
                    "stage_order": list(STAGES),
                })
                ctype = "application/json"
            elif path == "/debug/profile":
                # POST arms the runtime's profiler window; method-gated,
                # so a crawler's GET never arms a capture
                if environ.get("REQUEST_METHOD", "GET") != "POST":
                    start_response("405 Method Not Allowed",
                                   [("Allow", "POST"),
                                    ("Content-Type", "application/json")])
                    return [b'{"error": "POST required"}']
                tracer = getattr(runtime, "tracer", None)
                if tracer is None:
                    return _unavailable(
                        "profiler capture needs an attached stream "
                        "runtime")
                import tempfile

                params = _qs_params(environ.get("QUERY_STRING", ""))
                batches = _qs_int(params, "batches", 16, 4096)
                skip = _qs_int(params, "skip", 0, 4096)
                prof_dir = params.get("dir") or ""
                if prof_dir:
                    # the endpoint is auth-free: captures go under the
                    # operator's HEATMAP_PROFILE_DIR (or the temp
                    # directory) only
                    base = (os.environ.get("HEATMAP_PROFILE_DIR")
                            or tempfile.gettempdir())
                    root = os.path.realpath(base).rstrip(os.sep)
                    rp = os.path.realpath(prof_dir)
                    if rp != root and not rp.startswith(root + os.sep):
                        return _bad_request(
                            f"dir= must be under {base} (set "
                            f"HEATMAP_PROFILE_DIR to change the base)")
                made_dir = False
                if not prof_dir:
                    prof_dir = tempfile.mkdtemp(prefix="heatmap-profile-")
                    made_dir = True
                epoch = int(runtime.epoch)
                if not tracer.arm(prof_dir, batches=max(1, batches),
                                  skip=skip, base_epoch=epoch):
                    if made_dir:
                        # a refusal leaks no tempdir
                        try:
                            os.rmdir(prof_dir)
                        except OSError:
                            pass
                    start_response("409 Conflict",
                                   [("Content-Type", "application/json")])
                    return [b'{"error": "a profiler capture is already '
                            b'pending or active"}']
                body = json.dumps({
                    "armed": True, "dir": prof_dir,
                    "batches": max(1, batches), "skip": skip,
                    "from_epoch": epoch + skip,
                })
                ctype = "application/json"
            elif path == "/debug/stacks":
                # the sampling stack profiler, started on first read and
                # left running; GET-only
                if environ.get("REQUEST_METHOD", "GET") != "GET":
                    start_response("405 Method Not Allowed",
                                   [("Allow", "GET"),
                                    ("Content-Type", "application/json")])
                    return [b'{"error": "GET required"}']
                from heatmap_tpu_torch.obs.prof import get_sampler

                sampler = get_sampler()
                enabled = sampler.ensure_started()
                params = _qs_params(environ.get("QUERY_STRING", ""))
                n = _qs_int(params, "n", 40, 512)
                payload = sampler.snapshot(n)
                payload["enabled"] = enabled
                body = json.dumps(payload)
                ctype = "application/json"
            elif path == "/debug/requests":
                # per-worker request spans: recent completed spans
                # (per-stage timings, bytes, view seq) and the
                # slow-request capture ring
                params = _qs_params(environ.get("QUERY_STRING", ""))
                n = _qs_int(params, "n", 50, 256)
                body = json.dumps({
                    "count": len(span_ring),
                    "slowreq_ms": slowreq_ms,
                    "slow_count": len(slow_ring),
                    "recent": span_ring.recent(n),
                    "slow": slow_ring.recent(min(n, 64)),
                })
                ctype = "application/json"
            elif path == "/debug/view":
                try:
                    store_grids = store.grids()
                except Exception:
                    store_grids = []
                payload = {
                    "enabled": view is not None,
                    "pid": os.getpid(),
                    "mode": (None if view is None else
                             "replica" if follower is not None else
                             "writer-fed" if refresher is None else
                             "store-fed"),
                    "poisoned": view.poisoned if view is not None else None,
                    "seq": view.seq if view is not None else None,
                    "cells": (view.cells_live()
                              if view is not None else None),
                    "sse_clients": int(stats.sse_clients.value),
                    "store_grids": store_grids,
                }
                if follower is not None:
                    payload["repl"] = {
                        "synced": follower.synced,
                        "epoch": follower.epoch,
                        "applied_seq": follower.applied,
                        "seq_lag": follower.seq_lag(),
                        "healthy": follower.healthy(),
                    }
                body = json.dumps(payload)
                ctype = "application/json"
            elif path == "/healthz":
                payload, down = healthz()
                if down:
                    status = "503 Service Unavailable"
                body = json.dumps(payload)
                ctype = "application/json"
            elif path == "/":
                body = render_index(refresh_ms, resolutions)
                ctype = "text/html; charset=utf-8"
            elif path == "/debug/quality":
                # this process's quality observatory: the scorecard
                # identity, rolling live skill per (grid, horizon), NIS
                # calibration, the pending-card tail (obs.quality)
                q_obs = getattr(runtime, "quality", None)
                if q_obs is None:
                    return _unavailable(
                        "the quality observatory needs "
                        "HEATMAP_QUALITY=1 and the kalman reducer in "
                        "the serving process")
                body = json.dumps(q_obs.snapshot())
                ctype = "application/json"
            elif path == "/debug/timeline":
                # the retrospective incident timeline (obs.tsdb): healthz
                # transitions, SLO alerts, shed/lagged bursts, retraces
                # and flight records in time order, rebuilt from this
                # member's retained blocks
                if not (tsdb_on and tsdb_dir):
                    return _unavailable(
                        "the telemetry time machine needs "
                        "HEATMAP_TSDB=1 and HEATMAP_TSDB_DIR")
                params = _qs_params(environ.get("QUERY_STRING", ""))
                since_s = _qs_int(params, "since", 3600, 7 * 86400)
                now = time.time()
                tag = serve_tsdb.tag if serve_tsdb is not None else None
                reader = tsdbmod.TsdbReader(tsdb_dir)
                if tag is None or tag not in reader.members():
                    members = reader.members()
                    tag = members[0] if members else None
                entries = (tsdbmod.member_timeline(
                    reader, tag, since=now - since_s,
                    flightrec_dir=cfg.flightrec_dir or None)
                    if tag is not None else [])
                body = json.dumps({"member": tag, "since_s": since_s,
                                   "entries": entries})
                ctype = "application/json"
            elif path == "/fleet/timeline":
                # every member's timeline stitched, naming which member
                # degraded FIRST — from retained blocks, so it rebuilds
                # incidents for members that are already gone
                if not (tsdb_on and tsdb_dir):
                    return _unavailable(
                        "the telemetry time machine needs "
                        "HEATMAP_TSDB=1 and HEATMAP_TSDB_DIR")
                params = _qs_params(environ.get("QUERY_STRING", ""))
                since_s = _qs_int(params, "since", 3600, 7 * 86400)
                payload = tsdbmod.fleet_timeline(
                    tsdbmod.TsdbReader(tsdb_dir),
                    since=time.time() - since_s,
                    flightrec_dir=cfg.flightrec_dir or None)
                payload["since_s"] = since_s
                body = json.dumps(payload)
                ctype = "application/json"
            elif path.startswith("/fleet/") and path[7:] in (
                    "metrics", "healthz", "freshness", "delivery", "audit",
                    "quality"):
                # the fleet observatory (obs.fleet) over the member
                # snapshots beside the supervisor channel
                agg = _fleet_agg()
                if agg is None:
                    return _unavailable(
                        "fleet surfaces need a supervisor channel "
                        "(HEATMAP_SUPERVISOR_CHANNEL)")
                name = path[7:]
                ctype = "application/json"
                if name == "metrics":
                    body = agg.metrics_text()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif name in ("healthz", "delivery"):
                    # a down fleet, or a delivery fleet with a stale or
                    # vanished member, answers 503
                    payload, down = getattr(agg, name)()
                    if down:
                        status = "503 Service Unavailable"
                    body = json.dumps(payload)
                elif name == "freshness":
                    params = _qs_params(environ.get("QUERY_STRING", ""))
                    body = json.dumps(
                        agg.freshness(_qs_int(params, "n", 32, 256)))
                else:
                    # audit: member ledgers summed and re-checked, and the
                    # per-shard digests XOR-combined against the merged
                    # view's; quality: the scorecard ledgers summed, the
                    # worst shard named
                    body = json.dumps(getattr(agg, name)())
            elif path == "/debug/audit":
                # this process's integrity observatory: per-stage ledger
                # counts, boundary residuals (worst and leaking named),
                # digest verification state (obs.audit)
                if serve_audit is None:
                    return _unavailable(
                        "the integrity observatory needs "
                        "HEATMAP_AUDIT=1")
                body = json.dumps(serve_audit.snapshot())
                ctype = "application/json"
            elif path == "/debug/delivery":
                # this replica's delivery lineage: the telescoping
                # delivered-age decomposition (stage order, cross-host
                # legs flagged), recent end-to-end samples, the
                # stalled-feed estimate, and every subscriber's
                # write-stall state from the fan-out hub
                params = _qs_params(environ.get("QUERY_STRING", ""))
                n = _qs_int(params, "n", 32, 256)
                payload = delivery.snapshot(n)
                payload["subscribers"] = fanout.sub_stats()
                body = json.dumps(payload)
                ctype = "application/json"
            else:
                start_response("404 Not Found",
                               [("Content-Type", "text/plain")])
                return [b"not found"]
        except Exception:
            log.exception("request failed: %s", path)
            start_response("500 Internal Server Error",
                           [("Content-Type", "application/json")])
            return [b'{"error": "internal"}']
        if data is None:
            data = body.encode("utf-8")
        headers = [("Content-Type", ctype)] + extra_headers
        # tile FeatureCollections run to hundreds of KB and the UI polls
        # every few seconds; GeoJSON gzips ~5-10x
        if _accepts_gzip(environ.get("HTTP_ACCEPT_ENCODING", "")):
            if pre_gz is not None:
                data = pre_gz
                headers.append(("Content-Encoding", "gzip"))
            elif len(data) >= 1024:
                data = gzip.compress(data, compresslevel=1)
                headers.append(("Content-Encoding", "gzip"))
        headers.append(("Vary", "Accept-Encoding"))
        headers.append(("Content-Length", str(len(data))))
        if endpoint is not None:
            stats.sent_bytes.labels(endpoint=endpoint).inc(len(data))
        if span is not None:
            span.mark("encode")
            span.bytes_out = len(data)
            if view is not None and not view.poisoned:
                span.view_seq = view.seq
        start_response(status, headers)
        return [data]

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        if path in ("/api/tiles/stream", "/api/queries/stream"):
            try:
                if path == "/api/queries/stream":
                    return _cq_sse_response(environ, start_response)
                return _sse_response(environ, start_response)
            except Exception:
                log.exception("request failed: %s", path)
                start_response("500 Internal Server Error",
                               [("Content-Type", "application/json")])
                return [b'{"error": "internal"}']
        # admission control (HEATMAP_SERVE_MAX_INFLIGHT): bound the
        # render/encode concurrency on the data endpoints so overload
        # sheds predictably (503 + Retry-After, counted per endpoint)
        # instead of stacking threads until p99 collapses.  SSE has
        # its own cap; the operator surface (/metrics, /healthz) is
        # never shed — you must be able to observe an overloaded
        # worker.
        ep = _ADMIT_PATHS.get(path)
        if ep is None:
            return _handle(environ, start_response)
        # request span: stamped per stage through _handle, closed by
        # _SpanBody when the server has drained the body — every
        # admitted request lands in /debug/requests
        span = _Span(ep)
        try:
            span.bytes_in = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            pass
        environ["heatmap.span"] = span

        def _sr(status_line, headers, exc_info=None):
            try:
                span.status = int(status_line[:3])
            except ValueError:
                pass
            # pass exc_info through only when set: PEP 3333 callables
            # may bind start_response(status, headers) positionally
            if exc_info is None:
                return start_response(status_line, headers)
            return start_response(status_line, headers, exc_info)

        if admit_sem is None:
            return _SpanBody(_handle(environ, _sr), span, _commit_span)
        if not admit_sem.acquire(blocking=False):
            stats.shed.labels(endpoint=ep).inc()
            span.mark("admission")
            span.status = 503
            start_response("503 Service Unavailable",
                           [("Content-Type", "application/json"),
                            ("Retry-After", "1")])
            return _SpanBody([b'{"error": "overloaded; retry '
                              b'shortly"}'], span, _commit_span)
        span.mark("admission")
        stats.inflight.inc(1)
        try:
            return _SpanBody(_handle(environ, _sr), span, _commit_span)
        finally:
            stats.inflight.inc(-1)
            admit_sem.release()

    # the serve-only fleet member (ServeFleetMember) snapshots this
    # registry (the runtime's own when one is attached) with this healthz
    # verdict, so /fleet/healthz degrades on a lagging replica without
    # scraping it, and these blocks on the same publish cadence: audit
    # (ledger and digest state, for /fleet/audit), cq (standing queries,
    # matches, eval lag), hist and delivery (the delivered-age summary
    # and worst stage, for /fleet/delivery)
    app.serve_registry = serve_reg
    app.healthz_fn = healthz
    app.repl_follower = follower
    app.audit_fn = (serve_audit.member_block
                    if serve_audit is not None else None)
    app.serve_audit = serve_audit
    app.cq_fn = (cq_engine.member_block
                 if cq_engine is not None else None)
    app.cq_engine = cq_engine
    app.delivery_fn = delivery.member_block
    app.delivery = delivery

    # the history block: chunks, covered span, compaction lag,
    # backfills; serve workers derive it from the store's files since
    # they run no compactor
    def _hist_block():
        out: dict = {}
        if hist_dir:
            out = dict(_hist_status())
        if follower is not None and follower.c_backfill is not None:
            out["backfills"] = int(follower.c_backfill.value)
        return out or None

    app.hist_fn = (_hist_block if hist_dir or follower is not None
                   else None)
    app.hist_reader = hist_reader
    app.span_ring = span_ring
    # the event-loop core reads these (loop metrics + fan-out wake)
    app.fanout = fanout
    app.serve_stats = stats
    app.view = view
    app.refresher = refresher
    # the recorder and the SLO engine this app runs (serve-only) or rides
    # (the runtime's)
    app.tsdb = serve_tsdb
    app.slo_engine = serve_slo

    def close():
        if cq_engine is not None:
            cq_engine.close()
        if follower is not None:
            follower.stop()
        if serve_tsdb is not None and runtime is None:
            # a serve-only recorder: the sampler joined, then a final
            # scrape and flush, so the last window reaches the retained
            # blocks (an attached runtime's recorder stops in the
            # runtime's close)
            serve_tsdb.stop()
            try:
                serve_tsdb.scrape_once()
                serve_tsdb.flush()
            except Exception:  # noqa: BLE001
                pass

    app.close = close
    return app


def _accepts_gzip(accept_encoding: str) -> bool:
    """True when the client lists gzip with a nonzero qvalue (a bare
    substring match would gzip at 'gzip;q=0')."""
    for part in accept_encoding.split(","):
        token, _, params = part.strip().partition(";")
        if token.strip().lower() != "gzip":
            continue
        q = 1.0
        for p in params.split(";"):
            k, _, v = p.strip().partition("=")
            if k.strip().lower() == "q":
                try:
                    q = float(v)
                except ValueError:
                    q = 0.0
        return q > 0.0
    return False


class _ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    daemon_threads = True
    # wsgiref's default listen backlog is 5: under a polling fleet
    # that opens a connection per request, an accept burst overflows
    # it and the dropped SYNs come back 1s/3s later (kernel
    # retransmit) — a latency cliff that reads as a server tail but is
    # really queue overflow at the socket.  128 rides the kernel's
    # somaxconn clamp.
    request_queue_size = 128


class _ReusePortWSGIServer(_ThreadingWSGIServer):
    """SO_REUSEPORT bind: the multi-process serve fleet's workers each
    bind the SAME port and the kernel balances incoming connections
    across their accept queues.  Unlike the reference, a socket that
    cannot take the option raises instead of binding exclusively."""

    def server_bind(self):
        from heatmap_tpu_torch.utils.netio import set_reuseport

        set_reuseport(self.socket)
        super().server_bind()


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):  # route access logs through logging
        log.debug("%s %s", self.address_string(), fmt % args)

    def get_environ(self):
        # expose the connection socket so the SSE path can arm a send
        # timeout (HEATMAP_SSE_SEND_TIMEOUT_S): a subscriber that stops
        # reading the SOCKET parks the writer thread in send() forever
        # otherwise, leaking its admission slot
        env = super().get_environ()
        env["heatmap.socket"] = self.connection
        return env


def _make_http_server(store, cfg, runtime, host, port,
                      reuse_port: bool = False):
    """The server of the core ``cfg.serve_core`` names.  Port 0 (the
    config's ``serve_port`` or the argument) binds an ephemeral port,
    unlike the reference, which turns it into 5000."""
    host = host or cfg.serve_host
    if port is None:
        port = cfg.serve_port
    app = make_wsgi_app(store, cfg, runtime)
    core = cfg.serve_core
    try:
        if core == "epoll":
            from heatmap_tpu_torch.serve.evloop import EventLoopServer

            srv = EventLoopServer(host, port, app, reuse_port=reuse_port,
                                  handlers=cfg.serve_loop_handlers)
        else:
            srv = make_server(host, port, app,
                              server_class=(_ReusePortWSGIServer
                                            if reuse_port
                                            else _ThreadingWSGIServer),
                              handler_class=_QuietHandler)
    except BaseException:
        app.close()
        raise
    app.serve_stats.core.labels(core=core).set(1)
    return srv


class ServeFleetMember:
    """A serve-only worker's fleet membership (obs.fleet): a daemon
    thread that publishes this process's member snapshot —
    ``role="serve"``, the app registry's exposition text, the channel
    /healthz verdict — next to the supervisor channel every
    ``HEATMAP_FLEET_PUBLISH_S``, plus an :class:`SloWatchdog` in fleet
    mode so the worker follows episode broadcasts with a correlated
    flight-recorder dump even though it has no runtime.  The
    runtime-attached process publishes itself (stream/runtime.py) —
    start this only when ``runtime is None``."""

    def __init__(self, serve_registry, channel_path: str,
                 tag: str | None = None, healthz_fn=None,
                 audit_fn=None, cq_fn=None, hist_fn=None,
                 delivery_fn=None):
        from heatmap_tpu_torch.obs.xproc import ENV_FLEET_TAG

        self.registry = serve_registry
        self.channel_path = channel_path
        # the app's healthz closure carries the serve-tier checks
        # (replication sync/lag) the bare payload can't see
        self.healthz_fn = healthz_fn or (lambda: healthz_payload(None))
        # the app's audit closure (obs.audit member block) when
        # HEATMAP_AUDIT=1 — /fleet/audit stitches it
        self.audit_fn = audit_fn
        # the app's continuous-query closure (standing queries /
        # matches / eval lag) — obs_top --fleet renders it
        self.cq_fn = cq_fn
        # the app's space-time history closure (chunks / span /
        # compaction lag / backfills) — obs_top --fleet renders it
        self.hist_fn = hist_fn
        # the app's delivery-lineage closure (obs.delivery member
        # block: delivered-age quantiles, per-stage p50s, worst stage)
        # — /fleet/delivery names the worst replica from these
        self.delivery_fn = delivery_fn
        # HEATMAP_FLEET_TAG names the RUNTIME member (stream/runtime.py
        # adopts it verbatim when single-process), so a serve worker
        # composes with it rather than adopting it — otherwise a serve
        # worker and a runtime sharing the channel and env would
        # overwrite each other's member file
        env_tag = os.environ.get(ENV_FLEET_TAG)
        self.tag = tag or (f"{env_tag}-serve{os.getpid()}" if env_tag
                           else f"serve{os.getpid()}")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.watchdog = None

    @classmethod
    def from_env(cls, app) -> "ServeFleetMember | None":
        """Build-and-start against the app's registry; None without a
        channel or with publishing disabled (HEATMAP_FLEET_PUBLISH_S=0)."""
        from heatmap_tpu_torch.obs import ENV_CHANNEL
        from heatmap_tpu_torch.obs.xproc import fleet_publish_s

        chan_path = os.environ.get(ENV_CHANNEL)
        reg = getattr(app, "serve_registry", None)
        if not chan_path or reg is None or fleet_publish_s() <= 0:
            return None
        member = cls(reg, chan_path,
                     healthz_fn=getattr(app, "healthz_fn", None),
                     audit_fn=getattr(app, "audit_fn", None),
                     cq_fn=getattr(app, "cq_fn", None),
                     hist_fn=getattr(app, "hist_fn", None),
                     delivery_fn=getattr(app, "delivery_fn", None))
        member.start()
        return member

    def start(self) -> None:
        from heatmap_tpu_torch.obs.flightrec import from_env as flightrec_env
        from heatmap_tpu_torch.obs.runtimeinfo import SloWatchdog

        self.publish()  # join the fleet now, not a cadence later
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-fleet-member")
        self._thread.start()
        self.watchdog = SloWatchdog(None, channel_path=self.channel_path,
                                    tag=self.tag,
                                    flightrec=flightrec_env())
        self.watchdog.start()

    def publish(self, left: bool = False) -> None:
        from heatmap_tpu_torch.obs.xproc import publish_member_snapshot

        try:
            payload, _down = self.healthz_fn()
            publish_member_snapshot(
                self.channel_path, self.tag, role="serve",
                metrics_text=self.registry.expose_text(),
                healthz=payload,
                audit=self.audit_fn() if self.audit_fn else None,
                cq=self.cq_fn() if self.cq_fn else None,
                hist=self.hist_fn() if self.hist_fn else None,
                delivery=self.delivery_fn() if self.delivery_fn else None,
                left=left)
        except Exception:  # noqa: BLE001 - telemetry never kills serving
            log.warning("serve fleet snapshot publish failed",
                        exc_info=True)

    def _run(self) -> None:
        from heatmap_tpu_torch.obs.xproc import fleet_publish_s

        while not self._stop.wait(max(0.05, fleet_publish_s())):
            self.publish()

    def stop(self) -> None:
        self._stop.set()
        if self.watchdog is not None:
            self.watchdog.stop()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # departure tombstone: a worker taken out of the fleet on
        # purpose must not degrade /fleet/healthz as "stale"
        self.publish(left=True)


def serve_forever(store: Store, cfg: Config, runtime=None,
                  host: str | None = None, port: int | None = None,
                  reuse_port: bool = False):
    httpd = _make_http_server(store, cfg, runtime, host, port,
                              reuse_port=reuse_port)
    # serve-only workers join the fleet observatory themselves; a
    # runtime-attached process already publishes on its step loop
    member = (ServeFleetMember.from_env(httpd.get_app())
              if runtime is None else None)
    log.info("serving on http://%s:%d/", *httpd.server_address)
    try:
        httpd.serve_forever()
    finally:
        if member is not None:
            member.stop()
        httpd.get_app().close()
        httpd.server_close()


def start_background(store: Store, cfg: Config, runtime=None,
                     host: str | None = None, port: int | None = None):
    """Start the server on a daemon thread; returns (server, thread,
    port), the port the server bound.  Stop it with ``stop_background``."""
    httpd = _make_http_server(store, cfg, runtime, host, port)
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="serve-http")
    t.start()
    return httpd, t, httpd.server_address[1]


def stop_background(httpd, thread, timeout: float = 10.0) -> None:
    """Stop a ``start_background`` server: end its accept loop, close its
    socket and the app's query engine, and join its thread."""
    httpd.shutdown()
    httpd.server_close()
    httpd.get_app().close()
    thread.join(timeout=timeout)
