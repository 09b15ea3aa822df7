"""The port's serve app against the JAX package's, on the CPU.

- Both packages' ``make_wsgi_app`` over stores holding the same docs,
  called in process through WSGI environs (no socket): byte-equal bodies
  for ``/``, ``/api/tiles/latest`` (JSON, ``?fmt=bin``, gzip, ``?grid=``,
  ``?res=``), ``/api/positions/latest`` (JSON and binary),
  ``/api/tiles/delta`` from 0 and from a mid seq, ``/api/tiles/topk`` with
  and without a bbox, ``/debug/view``'s seq and cell fields, and the
  ETags equal but for each process's nonce; If-None-Match answers 304.
- ``HEATMAP_QUERY_VIEW=0``: store renders, byte-equal to the reference's;
  the runtime keeps no view then.
- The routes of subsystems not ported: the pinned list, 503 with the
  reference's own body where it has one, else 501 naming the ROADMAP item.
- One socket test: ``serve_port=0`` binds an ephemeral port (not 5000),
  and an SSE subscriber gets its first frame and is closed.
- Both runtimes under ``HEATMAP_H3_IMPL=native`` on the CPU with the view
  on: their views hold the same docs (ints exact, floats under
  ``test_torch_stream.py``'s bars), the port's app renders the JAX view's
  docs byte-equal to the JAX app's body, and the port's writer-fed app
  serves the runtime's metrics snapshot, healthz and exposition.
"""

import datetime as dt
import gzip
import io
import json
import re
import socket
import time

import numpy as np
import pytest
import torch

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import SyntheticSource as JaxSyntheticSource
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.serve import start_background, stop_background
from heatmap_tpu_torch.serve import wire as twire
from heatmap_tpu_torch.sink.base import PositionDoc
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
from test_torch_query import (BBOX, WIN_S, city_cells, etag_shape,
                              tile_docs)
from test_torch_stream import AXES, N_EVENTS, _pin_reference

UTC = dt.timezone.utc


def call(app, path, qs="", headers=None, method="GET", body=b""):
    """One request through a WSGI app, in process: (status, headers,
    body); the body iterable is closed as a server would."""
    environ = {"PATH_INFO": path, "QUERY_STRING": qs,
               "REQUEST_METHOD": method, "wsgi.input": io.BytesIO(body),
               "CONTENT_LENGTH": str(len(body))}
    for k, v in (headers or {}).items():
        environ["HTTP_" + k.upper().replace("-", "_")] = v
    out = {}

    def start_response(status, hdrs, exc_info=None):
        out["status"], out["headers"] = status, hdrs

    it = app(environ, start_response)
    try:
        data = b"".join(it)
    finally:
        if hasattr(it, "close"):
            it.close()
    return out["status"], dict(out["headers"]), data


def both(apps, path, qs="", headers=None):
    """The same request to the port's app and the reference's."""
    (s1, h1, b1), (s2, h2, b2) = (call(a, path, qs, headers) for a in apps)
    assert s1 == s2, (path, qs, s1, s2, b1[:200], b2[:200])
    return (h1, b1), (h2, b2)


def position_docs(n, now):
    rng = np.random.default_rng(21)
    return [PositionDoc("mbta", f"v{i}",
                        dt.datetime.fromtimestamp(now - int(rng.integers(
                            0, 600)), UTC),
                        float(rng.uniform(42.2, 42.5)),
                        float(rng.uniform(-71.2, -70.9)))
            for i in range(n)]


@pytest.fixture
def served():
    """Both packages' serve-only apps over stores holding the same tile
    docs (two grids, two windows) and positions."""
    now = int(time.time()) // WIN_S * WIN_S
    rng = np.random.default_rng(20)
    cells = city_cells(200, 8, 20)
    store, jstore = MemoryStore(), JaxMemoryStore()
    for docs in (tile_docs(cells[:120], now - WIN_S, rng),
                 tile_docs(cells[60:180], now, rng),
                 tile_docs(cells[:50], now, rng, grid="h3r8m15"),
                 position_docs(300, now)):
        for s in (store, jstore):
            if "loc" in docs[0]:
                s.upsert_positions(docs)
            else:
                s.upsert_tiles(docs)
    apps = (tapi.make_wsgi_app(store, load_config({})),
            japi.make_wsgi_app(jstore, jax_load_config({})))
    yield apps, (store, jstore), (cells, rng, now)
    apps[0].close()
    apps[1].close_repl()


def test_data_routes_byte_equal_to_jax(served):
    apps, stores, (cells, rng, now) = served
    (h, b), (jh, jb) = both(apps, "/")
    assert b == jb and h["Content-Type"] == jh["Content-Type"]
    for qs in ("", "grid=h3r8m15", "res=6", "res=7", "fmt=bin",
               "fmt=bin&res=6", "grid=h3r8m15&fmt=bin", "fmt=json"):
        (h, b), (jh, jb) = both(apps, "/api/tiles/latest", qs)
        assert b == jb, qs
        assert etag_shape(h["ETag"]) == etag_shape(jh["ETag"])
        assert h["Content-Type"] == jh["Content-Type"]
    (h, b), (jh, jb) = both(apps, "/api/tiles/latest", "",
                            {"Accept-Encoding": "gzip"})
    assert h["Content-Encoding"] == jh["Content-Encoding"] == "gzip"
    assert gzip.decompress(b) == gzip.decompress(jb)
    (h, b), (jh, jb) = both(apps, "/api/tiles/latest", "",
                            {"Accept": twire.CONTENT_TYPE})
    assert b == jb and h["Content-Type"] == twire.CONTENT_TYPE
    for qs in ("", "fmt=bin"):
        (h, b), (jh, jb) = both(apps, "/api/positions/latest", qs)
        assert b == jb and h["ETag"] == jh["ETag"], qs
    for qs in ("since=0", "since=0&fmt=bin", "k=5", "k=5&bbox=%s,%s,%s,%s"
               % BBOX, "k=9&res=6"):
        path = "/api/tiles/topk" if "k=" in qs else "/api/tiles/delta"
        (_, b), (_, jb) = both(apps, path, qs)
        assert b == jb, (path, qs)
    # a mid seq: the same change written to both stores, then deltas
    (_, b0), _ = both(apps, "/api/tiles/delta", "since=0")
    seq0 = json.loads(b0)["seq"]
    docs = tile_docs(cells[150:200], now, rng)
    for s in stores:
        s.upsert_tiles(docs)
    for qs in (f"since={seq0}", f"since={seq0}&fmt=bin", "since=0"):
        (_, b), (_, jb) = both(apps, "/api/tiles/delta", qs)
        assert b == jb, qs
    assert json.loads(b)["seq"] == seq0 + 1
    (_, b), (_, jb) = both(apps, "/debug/view")
    v, jv = json.loads(b), json.loads(jb)
    for f in ("enabled", "mode", "poisoned", "seq", "cells", "store_grids"):
        assert v[f] == jv[f], f
    for qs in ("res=16", "grid=a%0db", "bbox=1,2,3", "fmt=xml"):
        path = "/api/tiles/topk" if "bbox" in qs else "/api/tiles/latest"
        (_, b), (_, jb) = both(apps, path, qs)
        assert b == jb, qs


def test_dict_and_string_renderers_byte_equal_to_jax(served):
    """The readable dict spec through ``json.dumps`` and the
    string-assembled hot path give the same bytes, in both packages."""
    _, (store, jstore), _ = served
    for grid in ("h3r8", "h3r8m15", "h3r9"):
        body = tapi.tiles_feature_collection_json(store, grid)
        assert body == json.dumps(tapi.tiles_feature_collection(store, grid))
        assert body == japi.tiles_feature_collection_json(jstore, grid)
    assert (json.dumps(tapi.positions_feature_collection(store))
            == json.dumps(japi.positions_feature_collection(jstore)))
    cell = next(iter(store.tiles_in_window(
        store.latest_window_start("h3r8"), "h3r8")))["cellId"]
    assert tapi.cell_ring(cell) == japi.cell_ring(cell)


def test_etag_answers_304(served):
    app = served[0][0]
    for path, qs in (("/api/tiles/latest", ""),
                     ("/api/tiles/latest", "fmt=bin"),
                     ("/api/positions/latest", "")):
        s, h, _ = call(app, path, qs)
        assert s.startswith("200")
        s, h2, b = call(app, path, qs, {"If-None-Match": h["ETag"]})
        assert s.startswith("304") and b == b"" and h2["ETag"] == h["ETag"]
    # a JSON ETag never answers a binary request
    _, h, _ = call(app, "/api/tiles/latest")
    s, _, _ = call(app, "/api/tiles/latest", "fmt=bin",
                   {"If-None-Match": h["ETag"]})
    assert s.startswith("200")


def test_query_view_off_renders_from_the_store(served):
    _, (store, jstore), _ = served
    apps = (tapi.make_wsgi_app(store, load_config(
                {"HEATMAP_QUERY_VIEW": "0"})),
            japi.make_wsgi_app(jstore, jax_load_config(
                {"HEATMAP_QUERY_VIEW": "0"})))
    for path, qs in (("/api/tiles/latest", ""),
                     ("/api/tiles/latest", "grid=h3r8m15"),
                     ("/api/tiles/latest", "fmt=bin"),
                     ("/api/tiles/latest", "res=6"),
                     ("/api/tiles/delta", ""), ("/api/tiles/topk", ""),
                     ("/api/queries", ""), ("/debug/view", "")):
        (h, b), (_, jb) = both(apps, path, qs)
        if path == "/debug/view":
            b, jb = (json.loads(x) for x in (b, jb))
            b.pop("pid"), jb.pop("pid")
        assert b == jb, (path, qs)
    assert "ETag" not in call(apps[0], "/api/tiles/latest")[1]


def test_runtime_keeps_no_view_with_the_knob_off(tmp_path):
    cfg = load_config({"HEATMAP_QUERY_VIEW": "0"},
                      checkpoint_dir=str(tmp_path), **AXES)
    rt = MicroBatchRuntime(cfg, SyntheticSource(n_events=8), MemoryStore(),
                           device="cpu")
    assert rt.matview is None and rt.writer.view is None
    rt.close()


# the routes the port once answered 503/501 for (the integrity, delivery
# and fleet surfaces): all served now
_FORMERLY_UNPORTED = (
    "/debug/audit", "/debug/delivery", "/fleet/audit", "/fleet/delivery",
    "/fleet/freshness", "/fleet/healthz", "/fleet/metrics", "/fleet/quality")


def _shape(v):
    """A JSON value's shape: dict keys (recursively), list element shapes,
    scalar types."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(x) for x in v]
    return type(v).__name__


def test_unported_routes_are_pinned(served):
    """The table of unported routes is empty.  Each route it used to hold
    answers as the reference's does without its knob or channel (503 with
    the same body, or the same body shape), and so do the history,
    replication, timeline and quality routes without their directories
    or knobs."""
    apps = served[0]
    assert tapi.UNPORTED_ROUTES == ()
    probes = list(_FORMERLY_UNPORTED) + [
        "/api/tiles/range", "/api/tiles/at", "/api/tiles/diff",
        "/api/hist/index", "/api/hist/chunk", "/api/repl/meta",
        "/api/repl/feed", "/debug/quality", "/debug/timeline",
        "/fleet/timeline"]
    for path in probes:
        s, _, b = call(apps[0], path, "t0=1&t1=2&seq=1")
        js, _, jb = call(apps[1], path, "t0=1&t1=2&seq=1")
        assert s == js, (path, s, js)
        if s.startswith("503"):
            assert b == jb, path
        else:
            assert s.startswith("200"), path
            assert _shape(json.loads(b)) == _shape(json.loads(jb)), path
    s, _, _ = call(apps[0], "/no/such/route")
    assert s.startswith("404")


def _read_until(sock, marker, limit=1 << 20):
    buf = b""
    while marker not in buf and len(buf) < limit:
        chunk = sock.recv(65536)
        if not chunk:
            break
        buf += chunk
    return buf


def test_port_zero_binds_an_ephemeral_port_and_streams(served):
    _, (store, _), _ = served
    cfg = load_config({"SERVE_PORT": "0", "HEATMAP_SSE_HEARTBEAT_S": "0.2"})
    httpd, thread, port = start_background(store, cfg)
    try:
        assert port not in (0, 5000)
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(b"GET /healthz HTTP/1.0\r\n\r\n")
            head = _read_until(s, b"}")
        assert b"200 OK" in head and b'"status": "ok"' in head
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall(b"GET /api/tiles/stream?since=0 HTTP/1.0\r\n\r\n")
            got = _read_until(s, b"event: tiles\ndata: ")
            got += _read_until(s, b"\n\n")
        assert b"text/event-stream" in got and b'"mode": "full"' in got
    finally:
        stop_background(httpd, thread)
    assert not thread.is_alive()


# --- both runtimes with the view on --------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's runtime over the same synthetic stream under
    ``HEATMAP_H3_IMPL=native``, with the view on; its stream starts 30
    minutes ago, so no window is stale yet."""
    mp = pytest.MonkeyPatch()
    _pin_reference(mp, {})
    mp.setenv("HEATMAP_H3_IMPL", "native")
    t0 = int(time.time()) - 1800
    src = dict(n_events=N_EVENTS, n_vehicles=300, events_per_second=8,
               t0=t0)
    try:
        jstore, store = JaxMemoryStore(), MemoryStore()
        jcfg = jax_load_config(
            None, checkpoint_dir=str(tmp_path_factory.mktemp("jax")),
            store="memory", state_max_log2=AXES["state_capacity_log2"],
            **AXES)
        jrt = JaxRuntime(jcfg, JaxSyntheticSource(**src), jstore)
        jrt.run()
        cfg = load_config(
            None, checkpoint_dir=str(tmp_path_factory.mktemp("port")),
            **AXES)
        rt = MicroBatchRuntime(cfg, SyntheticSource(**src), store,
                               device="cpu")
        rt.run()
    finally:
        mp.undo()
    return (rt, store, cfg), (jrt, jstore, jcfg)


def test_runtime_views_hold_the_same_docs(runs):
    (rt, _, cfg), (jrt, _, _) = runs
    assert rt.snap_impl == "native" and rt.matview is rt.writer.view
    state, jstate = rt.matview.export_state(), jrt.matview.export_state()
    grid = cfg.default_grid()
    assert state["grids"].keys() == jstate["grids"].keys() == {grid}
    wins = state["grids"][grid]["windows"]
    jwins = jstate["grids"][grid]["windows"]
    assert wins.keys() == jwins.keys() and len(wins) >= 5
    total = 0
    for ws, cells in wins.items():
        ref = jwins[ws]
        assert cells.keys() == ref.keys(), ws
        for cid, d in cells.items():
            r = ref[cid]
            assert d["_id"] == r["_id"] and d["count"] == r["count"]
            assert d["windowEnd"] == r["windowEnd"]
            assert d["staleAt"] == r["staleAt"]
            for f in ("avgSpeedKmh", "stddevSpeedKmh", "p95SpeedKmh"):
                assert d[f] == pytest.approx(r[f], rel=1e-6, abs=1e-9)
            for a, b in zip(d["centroid"]["coordinates"],
                            r["centroid"]["coordinates"]):
                assert abs(a - b) <= 1e-5
            total += d["count"]
    assert total == N_EVENTS
    assert rt.writer.last_view_seq == rt.matview.seq > 0


def test_port_app_renders_the_jax_view_byte_equal(runs):
    (_, _, cfg), (jrt, jstore, jcfg) = runs
    japp = japi.make_wsgi_app(jstore, jcfg, jrt)
    grid = cfg.default_grid()
    store = MemoryStore()
    for ws, cells in sorted(jrt.matview.export_state()["grids"][grid]
                            ["windows"].items()):
        store.upsert_tiles(list(cells.values()))
    app = tapi.make_wsgi_app(store, cfg)
    try:
        for qs in ("", "res=7", "fmt=bin"):
            (_, b), (_, jb) = both((app, japp), "/api/tiles/latest", qs)
            if qs == "fmt=bin":
                # the frame stamps each view's own seq
                b, jb = twire.decode(b), twire.decode(jb)
                b.pop("seq"), jb.pop("seq")
            assert b == jb, qs
        _, docs = jrt.matview.latest_docs(grid)
        assert (tapi._features_collection_json(docs).encode()
                == call(japp, "/api/tiles/latest")[2])
    finally:
        app.close()
        japp.close_repl()


def test_writer_fed_app_serves_the_runtime(runs, monkeypatch):
    (rt, store, cfg), (jrt, jstore, jcfg) = runs
    app = tapi.make_wsgi_app(store, cfg, rt)
    japp = japi.make_wsgi_app(jstore, jcfg, jrt)
    try:
        m = json.loads(call(app, "/metrics.json")[2])
        jm = json.loads(call(japp, "/metrics.json")[2])
        for k in ("events_valid", "tiles_emitted",
                  "positions_emitted", "tiles_written", "positions_written",
                  "policy_snap_impl", "policy_emit_pull"):
            assert m[k] == jm[k], k
        for k in ("uptime_s", "events_per_sec", "batch_latency_p50_ms",
                  "batch_latency_p95_ms", "span_poll_p50_ms"):
            assert k in m and k in jm, k
        # the batch budget against the snapshot's p50, either way (the
        # stream is 30 minutes old: the freshness budgets are lifted)
        monkeypatch.setenv("HEATMAP_SLO_FRESHNESS_P50_S", "1e9")
        monkeypatch.setenv("HEATMAP_SLO_FRESHNESS_P50_MS", "1e9")
        monkeypatch.setenv("HEATMAP_SLO_BATCH_P50_MS", "1e9")
        h = json.loads(call(app, "/healthz")[2])
        assert h["status"] == "ok" and h["checks"]["batch_p50_ms"]["ok"]
        p50 = h["checks"]["batch_p50_ms"]["value"]
        assert p50 == rt.metrics_snapshot()["batch_latency_p50_ms"] > 0
        monkeypatch.setenv("HEATMAP_SLO_BATCH_P50_MS", str(p50 / 2))
        h = json.loads(call(app, "/healthz")[2])
        assert h["status"] == "degraded"
        assert not h["checks"]["batch_p50_ms"]["ok"]
        assert call(app, "/api/tiles/latest")[0].startswith("200")
        s, _, b = call(app, "/metrics")
        text = b.decode()
        for name in ("heatmap_view_seq", "heatmap_view_cells",
                     "heatmap_view_apply_seconds_count",
                     "heatmap_serve_renders_total",
                     "heatmap_events_valid_total", "heatmap_policy_info"):
            assert re.search(rf"^{name}\b", text, re.M), name
        _, b = call(app, "/api/tiles/delta")[1:]
        assert json.loads(b)["seq"] == rt.matview.seq
        v = json.loads(call(app, "/debug/view")[2])
        assert v["mode"] == "writer-fed" and v["cells"] > 0
        s, _, b = call(app, "/api/tiles/forecast")
        assert s.startswith("503")
        assert b == call(japp, "/api/tiles/forecast")[2]
        # no request reads the runtime's device state: its metrics
        # property (which waits on the device's fold events) and a
        # device synchronize both raise, and every route still answers
        def forbidden(*a, **k):
            raise AssertionError("a request touched the device")

        monkeypatch.setattr(type(rt), "metrics", property(forbidden))
        monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
        monkeypatch.setattr(rt, "_read_fold_events", forbidden)
        for path, qs in (("/api/tiles/latest", "fmt=bin"),
                         ("/api/tiles/delta", "since=0"),
                         ("/api/tiles/topk", "k=3"),
                         ("/api/positions/latest", ""),
                         ("/metrics.json", ""), ("/metrics", ""),
                         ("/healthz", ""), ("/debug/view", ""),
                         ("/debug/requests", ""), ("/", "")):
            assert call(app, path, qs)[0].startswith("200"), path
    finally:
        app.close()
        japp.close_repl()


def test_serve_entry_point_serves_a_store(tmp_path):
    """``python -m heatmap_tpu_torch.serve`` over HEATMAP_STORE on an
    ephemeral port answers; ``--workers`` below 1 raises (the fleet of
    more is in ``test_torch_serve_core.py``)."""
    import os
    import subprocess
    import sys
    import urllib.request

    from heatmap_tpu_torch.serve import __main__ as entry
    from test_torch_stream import REPO

    with pytest.raises(ValueError, match="--workers must be >= 1"):
        entry.main(["--workers", "0"])
    env = dict(os.environ, HEATMAP_STORE="jsonl", CHECKPOINT=str(tmp_path),
               SERVE_PORT="0")
    proc = subprocess.Popen([sys.executable, "-m", "heatmap_tpu_torch.serve"],
                            cwd=REPO, env=env, stderr=subprocess.PIPE,
                            text=True)
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)/", line)
            if m:
                port = int(m.group(1))
        assert port not in (None, 5000)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/tiles/latest", timeout=10) as r:
            assert json.loads(r.read()) == {"type": "FeatureCollection",
                                            "features": []}
    finally:
        proc.terminate()
        proc.wait(timeout=30)
