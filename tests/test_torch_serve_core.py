"""The port's epoll serve core (``serve/evloop.py``) and ``--workers``
serve fleet (``serve/__main__.py``), on the CPU.

- The thread core and ``HEATMAP_SERVE_CORE=epoll`` answer every route
  byte-identically — status, headers and body — with only the ``Date``
  header and the per-process ETag nonce taken out: on a store-fed app,
  on a replica following a feed, and on the history routes.
- SSE: the preamble, catch-up frame, pushed frames and heartbeats of the
  tiles stream (JSON and binary), and the cq stream's ``gone`` frame, are
  identical across the two cores.
- A subscriber that stops reading is shed with ``event: lagged`` on the
  port's epoll core, its write stall visible first, as on the
  reference's epoll core under the same load.
- ``python -m heatmap_tpu_torch.serve --workers 2 --port 0`` (epoll core,
  following a feed) gets both workers serving one port and the writer's
  bodies; a killed worker is restarted; SIGTERM stops the fleet.
- A host without ``SO_REUSEPORT`` raises at each place the fleet needs
  it, instead of binding exclusively.
"""

import datetime as dt
import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.serve.api import start_background as jax_start_background
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu_torch import hexgrid
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.query import repl as trepl
from heatmap_tpu_torch.serve import __main__ as entry
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.serve import evloop
from heatmap_tpu_torch.serve import start_background, stop_background
from heatmap_tpu_torch.sink.base import TileDoc
from heatmap_tpu_torch.sink.memory import MemoryStore
from test_torch_history import Run, compact
from test_torch_query import GRID, WIN_S, city_cells, tile_docs
from test_torch_stream import REPO

UTC = dt.timezone.utc
# the per-app boot nonce inside each ETag is process-random by design
_NONCE = re.compile(r'(?<=["."])[0-9a-f]{8}(?=\.)')


def _mk_store(n=40, store=None, ws=None):
    store = store or MemoryStore()
    rng = np.random.default_rng(50)
    if ws is None:
        ws = int(time.time()) // WIN_S * WIN_S - WIN_S
    store.upsert_tiles(tile_docs(city_cells(n, 8, 51), ws, rng))
    return store


def _get(port, path, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=15)
    try:
        c.request("GET", path, headers=headers or {})
        r = c.getresponse()
        return r.status, r.getheaders(), r.read()
    finally:
        c.close()


def _norm(hdrs):
    return [(k, _NONCE.sub("NONCE", v) if k.lower() == "etag" else v)
            for k, v in hdrs if k.lower() != "date"]


class Pair:
    """A thread-core server and an epoll-core one over one store."""

    def __init__(self, store, env=None, **cfg_over):
        self.servers = []
        for core in ("thread", "epoll"):
            e = dict(env or {}, HEATMAP_SERVE_CORE=core)
            cfg = load_config(e, serve_port=0, **cfg_over)
            self.servers.append(start_background(store, cfg))
        self.ports = [p for _h, _t, p in self.servers]
        assert 5000 not in self.ports and 0 not in self.ports

    def app(self, i):
        return self.servers[i][0].get_app()

    def same(self, path, headers=None):
        (s1, h1, b1), (s2, h2, b2) = (_get(p, path, headers)
                                      for p in self.ports)
        assert s1 == s2, (path, s1, s2)
        assert _norm(h1) == _norm(h2), (path, _norm(h1), _norm(h2))
        assert b1 == b2, path
        return s1, h1, b1

    def close(self):
        for httpd, thread, _port in self.servers:
            stop_background(httpd, thread)
            assert not thread.is_alive()


ROUTES = ["/", "/api/tiles/latest", "/api/tiles/latest?fmt=bin",
          "/api/tiles/latest?res=7", "/api/tiles/delta?since=0",
          "/api/tiles/delta?since=0&fmt=bin", "/api/tiles/topk?k=5",
          "/api/positions/latest", "/api/tiles/forecast", "/debug/nosuch",
          "/api/queries", "/fleet/healthz", "/trace/recent",
          "/api/tiles/latest?grid=bad%0d"]


def test_cores_answer_byte_identical_store_fed():
    store = _mk_store()
    pair = Pair(store)
    try:
        for path in ROUTES:
            pair.same(path)
        s, h, b = pair.same("/api/tiles/latest",
                            {"Accept-Encoding": "gzip"})
        assert dict(h)["Content-Encoding"] == "gzip"
        etag = dict(h)["ETag"]
        # each server answers its own ETag with 304
        for i, port in enumerate(pair.ports):
            e = dict(_get(port, "/api/tiles/latest")[1])["ETag"]
            assert _get(port, "/api/tiles/latest",
                        {"If-None-Match": e})[0] == 304
        assert etag
        text = _get(pair.ports[1], "/metrics")[2].decode()
        assert 'heatmap_serve_core{core="epoll"} 1' in text
        for name in ("heatmap_serve_open_connections",
                     "heatmap_serve_write_backlog",
                     "heatmap_serve_loop_iteration_seconds_count",
                     "heatmap_sse_fanout_retained_frames"):
            assert re.search(rf"^{name}\b", text, re.M), name
    finally:
        pair.close()


def test_cores_answer_byte_identical_on_a_replica_and_history(tmp_path):
    run = Run(tmp_path, "port")
    run.drive()
    compact(run.hmod, run.hist, run.feed, run.clock)
    pair = Pair(MemoryStore(), repl_feed=run.feed, hist_dir=run.hist,
                repl_poll_ms=20)
    try:
        deadline = time.monotonic() + 30
        while not all(pair.app(i).repl_follower.applied == run.view.seq
                      for i in (0, 1)):
            assert time.monotonic() < deadline, "replicas never caught up"
            time.sleep(0.02)
        t = run.clock["t"]
        for path in ROUTES[1:7] + [
                f"/api/tiles/range?t0={t - 5 * 3600}&t1={t}",
                f"/api/tiles/range?t0={t - 5 * 3600}&t1={t}&fmt=bin",
                f"/api/tiles/range?t0={t - 5 * 3600}&t1={t}&res=6",
                f"/api/tiles/at?seq={run.view.seq // 2}",
                f"/api/tiles/diff?t0={t - WIN_S}&t1={t}",
                "/api/hist/index", "/api/repl/meta"]:
            pair.same(path)
    finally:
        pair.close()
        run.close()


def _sse_connect(port, path="/api/tiles/stream?since=0"):
    sk = socket.create_connection(("127.0.0.1", port), timeout=15)
    sk.sendall(f"GET {path} HTTP/1.0\r\n\r\n".encode())
    return sk


def _read_until(sk, pred, timeout=15):
    buf = b""
    deadline = time.monotonic() + timeout
    while not pred(buf):
        assert time.monotonic() < deadline, f"timeout; got {buf[-300:]!r}"
        chunk = sk.recv(65536)
        if not chunk:
            return buf
        buf += chunk
    return buf


def test_sse_streams_identical_across_cores():
    store = _mk_store(8)
    pair = Pair(store, env={"HEATMAP_VIEW_POLL_MS": "30",
                            "HEATMAP_SSE_HEARTBEAT_S": "0.3"})
    socks = []
    try:
        streams = {}
        for fmt in ("", "&fmt=bin"):
            got = []
            for port in pair.ports:
                sk = _sse_connect(port, f"/api/tiles/stream?since=0{fmt}")
                socks.append(sk)
                buf = _read_until(sk, lambda b: b.count(b"\n\n") >= 3)
                head, _, rest = buf.partition(b"\r\n\r\n")
                got.append(([x for x in head.split(b"\r\n")
                             if not x.startswith(b"Date:")], rest))
                streams[(port, fmt)] = sk
            assert got[0][0] == got[1][0]
            assert got[0][1].startswith(b"retry: 3000\n\n")
            assert got[0][1] == got[1][1]
        # one store mutation: one pushed frame, the same bytes
        ws = int(time.time()) // WIN_S * WIN_S - WIN_S
        store.upsert_tiles(tile_docs(city_cells(3, 8, 52), ws,
                                     np.random.default_rng(53)))
        pushed = []
        for port in pair.ports:
            buf = _read_until(streams[(port, "")],
                              lambda b: b"event: tiles" in b)
            pushed.append([f for f in buf.split(b"\n\n")
                           if f.startswith(b"event: tiles")][0])
        assert pushed[0] == pushed[1] and b'"mode": "delta"' in pushed[0]
        for port in pair.ports:
            assert b": hb\n\n" in _read_until(streams[(port, "")],
                                              lambda b: b": hb\n\n" in b)
        # the cq stream: a removed query ends with the same gone frame
        lat, lon = hexgrid.cell_to_latlng(hexgrid.latlng_to_cell(
            42.36, -71.06, 8))
        tails = []
        for i, port in enumerate(pair.ports):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/queries",
                data=json.dumps({"type": "geofence", "bbox": [
                    lon - 5e-3, lat - 5e-3, lon + 5e-3,
                    lat + 5e-3]}).encode(), method="POST",
                headers={"Content-Type": "application/json"})
            qid = json.loads(urllib.request.urlopen(req, timeout=10)
                             .read())["id"]
            sk = _sse_connect(port, f"/api/queries/stream?id={qid}")
            socks.append(sk)
            _read_until(sk, lambda b: b"retry: 3000" in b)
            pair.app(i).cq_engine.remove(qid)
            buf = _read_until(sk, lambda b: b"event: gone" in b)
            tails.append([f for f in buf.split(b"\n\n") if f][-1])
        assert tails[0] == tails[1] == b"event: gone\ndata: {}"
    finally:
        for sk in socks:
            sk.close()
        pair.close()


def _fam(app, name):
    for fam in app.serve_registry._families.values():
        if fam.name == name:
            return fam
    raise AssertionError(f"no family {name}")


def _shed_slow_reader(start, store, cells, ws):
    """Wedge one subscriber of an epoll server while another reads on,
    upserting into window ``ws``; returns (lagged count, the worst write
    stall seen, the wedged stream's tail)."""
    env = {"HEATMAP_SERVE_CORE": "epoll", "HEATMAP_VIEW_POLL_MS": "30",
           "HEATMAP_SSE_QUEUE": "2", "HEATMAP_SSE_HEARTBEAT_S": "5",
           "HEATMAP_SSE_SEND_TIMEOUT_S": "60"}
    httpd, thread, port = start(store, env)
    app = httpd.get_app()
    lagged = _fam(app, "heatmap_sse_lagged_total")
    slow = socket.socket()
    slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    slow.settimeout(15)
    slow.connect(("127.0.0.1", port))
    slow.sendall(b"GET /api/tiles/stream?since=0 HTTP/1.0\r\n\r\n")
    good = _sse_connect(port)
    try:
        _read_until(slow, lambda b: b"event: tiles" in b)
        _read_until(good, lambda b: b"event: tiles" in b)
        stall = 0.0
        for m in range(30):
            store.upsert_tiles([
                TileDoc("bos", 8, format(c, "x"),
                        dt.datetime.fromtimestamp(ws, UTC),
                        dt.datetime.fromtimestamp(ws + WIN_S, UTC),
                        count=m * 1000 + j + 1, avg_speed_kmh=9.0,
                        avg_lat=42.36, avg_lon=-71.06, ttl_minutes=45)
                for j, c in enumerate(cells)])
            _read_until(good, lambda b: b"event: tiles" in b)
            stall = max(stall, app.fanout.max_write_stall_s())
            if lagged.value >= 1 and stall > 0:
                break
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and lagged.value < 1:
            stall = max(stall, app.fanout.max_write_stall_s())
            time.sleep(0.05)
        tail = b""
        while True:
            chunk = slow.recv(65536)
            if not chunk:
                break
            tail += chunk
        return lagged.value, stall, tail.rstrip()[-40:]
    finally:
        slow.close()
        good.close()
        httpd.shutdown()
        thread.join(timeout=30)


def test_lagged_shed_as_in_the_reference():
    cells = city_cells(400, 8, 54)

    def port_start(store, env):
        return start_background(store, load_config(env, serve_port=0))

    def jax_start(store, env):
        return jax_start_background(store, jax_load_config(env),
                                    port=_free_port())

    # one window for both servers, so a run that straddles a window
    # boundary of the wall clock compares like with like
    ws = int(time.time()) // WIN_S * WIN_S - WIN_S
    got = [_shed_slow_reader(port_start, _mk_store(ws=ws), cells, ws),
           _shed_slow_reader(jax_start, _mk_store(store=JaxMemoryStore(),
                                                  ws=ws), cells, ws)]
    for lagged, stall, tail in got:
        assert lagged >= 1 and stall > 0.0
        assert tail.endswith(b"event: lagged\ndata: {}")
    assert got[0][2] == got[1][2]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_missing_reuseport_raises(monkeypatch):
    real = socket.socket.setsockopt

    def setsockopt(self, level, opt, *a):
        if opt == getattr(socket, "SO_REUSEPORT", object()):
            raise OSError(92, "Protocol not available")
        return real(self, level, opt, *a)

    monkeypatch.setattr(socket.socket, "setsockopt", setsockopt)
    with pytest.raises(OSError, match="SO_REUSEPORT"):
        entry._hold_port("127.0.0.1")
    with pytest.raises(OSError, match="SO_REUSEPORT"):
        evloop.EventLoopServer("127.0.0.1", 0, lambda e, s: [],
                               reuse_port=True)
    for core in ("thread", "epoll"):
        with pytest.raises(OSError, match="SO_REUSEPORT"):
            tapi._make_http_server(MemoryStore(), load_config(
                {"HEATMAP_SERVE_CORE": core}), None, "127.0.0.1", 0,
                reuse_port=True)


def _pid_of(port):
    return json.loads(_get(port, "/debug/view")[2])["pid"]


def _pids(port, want, timeout=60):
    seen = set()
    deadline = time.monotonic() + timeout
    while not want <= seen or len(seen) < 2:
        assert time.monotonic() < deadline, f"saw only {seen}"
        try:
            seen.add(_pid_of(port))
        except OSError:
            time.sleep(0.05)
    return seen


def test_workers_fleet_shares_one_port_restarts_and_stops(tmp_path):
    feed = str(tmp_path / "feed")
    view = TileMatView()
    pub = trepl.DeltaLogPublisher(view, feed)
    ws = int(time.time()) // WIN_S * WIN_S - WIN_S
    view.apply_docs(tile_docs(city_cells(30, 8, 55), ws,
                              np.random.default_rng(56)))
    env = dict(os.environ, HEATMAP_SERVE_CORE="epoll", HEATMAP_STORE="memory",
               HEATMAP_REPL_FEED=feed, HEATMAP_REPL_POLL_MS="20")
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "heatmap_tpu_torch.serve", "--workers", "2",
         "--port", "0"], cwd=REPO, env=env, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            assert line, "the supervisor exited"
            m = re.search(r"serve fleet: 2 workers on "
                          r"http://127\.0\.0\.1:(\d+)/ \(SO_REUSEPORT, "
                          r"epoll core\)", line)
            if m:
                port = int(m.group(1))
        assert port not in (None, 0, 5000)
        pids = _pids(port, set())
        assert len(pids) == 2
        want = tapi._features_collection_json(view.latest_docs(GRID)[1])
        for _ in range(8):
            s, _h, b = _get(port, "/api/tiles/latest")
            assert s == 200 and b.decode() == want
        # a killed worker is restarted
        victim = sorted(pids)[0]
        os.kill(victim, signal.SIGKILL)
        after = _pids(port, set(), timeout=90)
        assert victim not in after and len(after) == 2
        # SIGTERM stops the fleet
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        for pid in after:
            with pytest.raises(ProcessLookupError):
                for _ in range(100):
                    os.kill(pid, 0)
                    time.sleep(0.1)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
        pub.close()
