"""The port's view replication (``query/repl.py``) against the JAX
package's, on the CPU.

- A port ``DeltaLogPublisher`` and a JAX one, each over its own package's
  ``TileMatView``, fed the same mutations (new windows, a late doc into an
  older window, a same-window update, a store-fed resync, and evictions
  of older and of the latest window under a shared fake clock) write the
  same feed: the segment lines byte-equal once each record's publish time
  ``"t"`` is taken out, the snapshots equal but for the epoch nonce, the
  meta's seqs equal.
- Across packages and transports: a JAX replica app follows the port
  writer's feed and a port replica app follows the JAX writer's, over the
  feed directory and over HTTP (each writer's feed re-exported by its own
  package's app on an ephemeral port).  ``/api/tiles/latest`` (JSON and
  ``?fmt=bin``) and ``/api/tiles/delta`` from 0 and from mid seqs are
  byte-equal to the writers' bodies, at a mid point and after the
  evictions; nothing is taken out.
- A follower that lags past ``repl_segments`` rotations re-bootstraps from
  the snapshot; a writer restart (a new epoch) makes the follower discard
  its tail; both directions across packages.
- ``/healthz`` is degraded until the first snapshot applies, then ok, as
  the reference's is.
- ``/api/repl/{meta,snapshot,feed}`` bodies are byte-equal between the two
  packages' apps over one feed directory.
- The reference's continuous-query replay test, run with the port's view,
  feed, follower and engine: standing queries on a replica stay equal to
  the reference's one-shot evaluation at every seq, a writer restart
  included.
"""

import datetime as dt
import glob
import json
import os
import re
import threading
import time
import types
from wsgiref.simple_server import make_server

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu.query import TileMatView as JaxView
from heatmap_tpu.query import repl as jrepl
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.query import repl as trepl
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.serve import start_background, stop_background
from heatmap_tpu_torch.sink.memory import MemoryStore
from test_torch_query import GRID, WIN_S, city_cells, tile_docs
from test_torch_serve import call

DEADLINE_S = 30.0


def wait_for(pred, what, timeout=DEADLINE_S):
    t_end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < t_end, f"timed out waiting for {what}"
        time.sleep(0.02)


class Writers:
    """A port writer view + publisher and a JAX one, fed the same
    mutations under one fake clock."""

    def __init__(self, tmp_path, **pub_kw):
        self.clock = {"t": float(int(time.time()) // WIN_S * WIN_S)}
        now = lambda: self.clock["t"]  # noqa: E731
        self.tdir, self.jdir = str(tmp_path / "port"), str(tmp_path / "jax")
        self.tview = TileMatView(now_fn=now)
        self.jview = JaxView(now_fn=now)
        self.tpub = trepl.DeltaLogPublisher(self.tview, self.tdir,
                                            start=False, **pub_kw)
        self.jpub = jrepl.DeltaLogPublisher(self.jview, self.jdir,
                                            start=False, **pub_kw)
        self.rng = np.random.default_rng(30)
        self.cells = city_cells(200, 8, 31)
        # (follower, its view) pairs stepped after every mutation, their
        # views read as the writers' are (a replica evicts its older
        # stale windows locally, on a read, as the writer does)
        self.followers = []

    def both(self, fn):
        out = (fn(self.tview), fn(self.jview))
        self.tpub.flush()
        self.jpub.flush()
        for fol, view in self.followers:
            while fol.step():
                pass
            self.read_all(view)
        return out

    def apply(self, lo, hi, ws):
        docs = tile_docs(self.cells[lo:hi], ws, self.rng)
        return self.both(lambda v: v.apply_docs(docs))

    def first_half(self):
        t = self.clock["t"]
        self.apply(0, 60, t - 2 * WIN_S)
        self.apply(40, 120, t - WIN_S)
        self.apply(0, 10, t - 2 * WIN_S)       # late docs, older window
        self.apply(100, 120, t - WIN_S)        # same-window update
        # a store-fed rebuild of a second grid: a resync record
        seed = tile_docs(self.cells[:30], t - WIN_S, self.rng,
                         grid="h3r8m15")
        self.both(lambda v: v.replace_grid("h3r8m15", seed))

    def second_half(self, evict=True):
        t = self.clock["t"]
        self.apply(120, 170, t)
        if evict:
            # the two older windows go stale (evicted on the next read,
            # locally: no record) ...
            self.clock["t"] += 46 * 60
            self.both(self.read_all)
        self.apply(150, 200, t)
        if evict:
            # ... then the latest one: the writer's evict record
            self.clock["t"] += 10 * 60
            self.both(self.read_all)

    @staticmethod
    def read_all(view):
        """A read of every grid: the lazy eviction of stale windows."""
        for grid in (GRID, "h3r8m15"):
            view.etag(grid)

    def close(self):
        self.tpub.close()
        self.jpub.close()


def feed_lines(feed_dir):
    """The feed's record lines in seq order, each with its publish time
    ``"t"`` (the last key of every record) taken out."""
    out = []
    for p in sorted(glob.glob(os.path.join(feed_dir, "seg-*.jsonl")),
                    key=trepl._seg_start):
        with open(p, encoding="utf-8") as fh:
            for line in fh.read().splitlines():
                stripped = re.sub(r',"t":[0-9.e+-]+\}$', "}", line)
                assert stripped != line, line[-80:]
                out.append(stripped)
    return out


def _render(view, grid=GRID):
    return tapi._features_collection_json(view.latest_docs(grid)[1])


def test_publishers_write_the_same_records(tmp_path):
    """Both feeds, and followers of each package on the other's feed
    under the writers' fake clock: renders and deltas from every seq
    equal the writers' at both checkpoints (evictions included)."""
    w = Writers(tmp_path)
    now = lambda: w.clock["t"]  # noqa: E731
    trep, jrep = TileMatView(replica=True, now_fn=now), JaxView(
        replica=True, now_fn=now)
    w.followers = [
        (trepl.ReplicaViewFollower(trep, trepl.FileFeedSource(w.jdir)),
         trep),
        (jrepl.ReplicaViewFollower(jrep, jrepl.FileFeedSource(w.tdir)),
         jrep)]
    try:
        for half in (w.first_half, w.second_half):
            half()
            for v in (trep, jrep, w.jview):
                assert v.seq == w.tview.seq
                for grid in (GRID, "h3r8m15"):
                    assert _render(v, grid) == _render(w.tview, grid)
                    for since in range(w.tview.seq + 2):
                        assert (json.dumps(v.delta(grid, since),
                                           default=str)
                                == json.dumps(w.tview.delta(grid, since),
                                              default=str)), (grid, since)
        assert w.tview.latest_docs(GRID)[1] == []
        assert w.tview.seq == w.jview.seq == 9
        lines = feed_lines(w.tdir)
        assert lines == feed_lines(w.jdir)
        assert len(lines) == w.tview.seq
        kinds = [json.loads(x)["kind"] for x in lines]
        assert {"apply", "resync", "evict"} <= set(kinds), kinds
        snaps = []
        for d, pub in ((w.tdir, w.tpub), (w.jdir, w.jpub)):
            snap = trepl.read_snapshot(d, pub.epoch)
            assert snap.pop("epoch") == pub.epoch
            snaps.append(snap)
        assert snaps[0] == snaps[1]
        # the codec round-trips the feed exactly, in both directions
        assert trepl.loads(lines[0]) == jrepl.loads(lines[0])
        rec = trepl.loads(lines[0])
        assert trepl.dumps(rec) == jrepl.dumps(rec) == lines[0]
    finally:
        w.close()
    metas = [trepl.read_meta(d) for d in (w.tdir, w.jdir)]
    for m in metas:
        m.pop("epoch"), m.pop("updated_unix")
    assert metas[0] == metas[1] and metas[0]["closed"] is True


def _writer_app(pkg, view, cfg):
    """A package's app over a writer-fed view (the runtime's view slot
    without a runtime's fold)."""
    if pkg == "port":
        rt = types.SimpleNamespace(matview=view, registry=Registry())
        return tapi.make_wsgi_app(MemoryStore(), cfg, rt)
    rt = types.SimpleNamespace(matview=view, metrics=types.SimpleNamespace(
        registry=JaxRegistry()))
    return japi.make_wsgi_app(JaxMemoryStore(), cfg, rt)


def _close(app):
    (getattr(app, "close_repl", None) or app.close)()


class _JaxFeedServer:
    """The JAX package's app re-exporting a feed directory, hosted by a
    stdlib server on an ephemeral port (never the reference's 5000)."""

    def __init__(self, feed_dir):
        self.app = japi.make_wsgi_app(
            JaxMemoryStore(), jax_load_config({}, repl_dir=feed_dir))
        self.httpd = make_server("127.0.0.1", 0, self.app)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()
        _close(self.app)


def _bodies(app, seqs):
    out = {}
    for qs in ("", "fmt=bin", "res=7"):
        s, h, b = call(app, "/api/tiles/latest", qs)
        assert s.startswith("200"), (qs, s)
        out[("latest", qs)] = b
    for since in seqs:
        for fmt in ("", "&fmt=bin"):
            s, _, b = call(app, "/api/tiles/delta", f"since={since}{fmt}")
            assert s.startswith("200")
            out[("delta", since, fmt)] = b
    return out


@pytest.mark.parametrize("transport", ["file", "http"])
def test_replicas_across_packages_serve_the_writers_bodies(tmp_path,
                                                           transport):
    w = Writers(tmp_path)
    servers, apps = [], []
    try:
        if transport == "file":
            port_feed, jax_feed = w.tdir, w.jdir
        else:
            httpd, thread, port = start_background(
                MemoryStore(), load_config({}, repl_dir=w.tdir,
                                           serve_port=0))
            servers.append(lambda: stop_background(httpd, thread))
            assert port != 5000
            port_feed = f"http://127.0.0.1:{port}"
            jsrv = _JaxFeedServer(w.jdir)
            servers.append(jsrv.close)
            jax_feed = jsrv.url
        # a JAX replica of the port writer, a port replica of the JAX one
        jrep = japi.make_wsgi_app(JaxMemoryStore(), jax_load_config(
            {}, repl_feed=port_feed, repl_poll_ms=20, hist_backfill=False))
        apps.append(jrep)
        trep = tapi.make_wsgi_app(MemoryStore(), load_config(
            {}, repl_feed=jax_feed, repl_poll_ms=20, hist_backfill=False))
        apps.append(trep)
        twriter = _writer_app("port", w.tview, load_config({}))
        jwriter = _writer_app("jax", w.jview, jax_load_config({}))
        apps += [twriter, jwriter]
        # the replica apps evict on the real clock, the writers on the
        # fake one: this test leaves the clock alone (the one above
        # replicates the evictions)
        for half in (w.first_half,
                     lambda: w.second_half(evict=False)):
            half()
            seq = w.tview.seq
            wait_for(lambda: jrep.repl_follower.applied == seq
                     and trep.repl_follower.applied == seq,
                     "both replicas at the writers' seq")
            seqs = sorted({0, 1, seq // 2, seq - 1, seq})
            ref = _bodies(twriter, seqs)
            assert _bodies(jwriter, seqs) == ref
            # the JAX replica serves the port writer's bodies and the
            # port replica the JAX writer's, byte for byte
            assert _bodies(jrep, seqs) == ref
            assert _bodies(trep, seqs) == ref
        assert trep.repl_follower.synced and trep.repl_follower.healthy()
        assert int(trep.repl_follower.c_fallback.value) == 0
        v = json.loads(call(trep, "/debug/view")[2])
        assert v["mode"] == "replica" and v["repl"]["seq_lag"] == 0
    finally:
        for app in apps:
            _close(app)
        for stop in servers:
            stop()
        w.close()


PKGS = {"port": (TileMatView, trepl), "jax": (JaxView, jrepl)}


@pytest.mark.parametrize("writer,follower", [("port", "jax"),
                                             ("jax", "port")])
def test_lagging_follower_rebootstraps_after_rotation(tmp_path, writer,
                                                      follower):
    wview_cls, wmod = PKGS[writer]
    fview_cls, fmod = PKGS[follower]
    w = wview_cls()
    pub = wmod.DeltaLogPublisher(w, str(tmp_path), seg_bytes=4096,
                                 segments=2, start=False)
    rng = np.random.default_rng(32)
    cells = city_cells(80, 8, 33)
    ws = int(time.time()) // WIN_S * WIN_S - WIN_S
    w.apply_docs(tile_docs(cells[:1], ws, rng))
    pub.flush()
    r = fview_cls(replica=True)
    fol = fmod.ReplicaViewFollower(r, fmod.FileFeedSource(str(tmp_path)))
    fol.step()
    assert r.seq == 1
    # the follower stalls while the writer rotates the log past it
    for i in range(60):
        w.apply_docs(tile_docs(cells[i + 1:i + 2], ws, rng))
        pub.flush()
    assert fmod.read_meta(str(tmp_path))["min_seq"] > 2
    with pytest.raises(OSError, match="horizon"):
        fol.step()
    fol.step()
    assert r.seq == w.seq == 61
    assert (tapi._features_collection_json(r.latest_docs(GRID)[1])
            == tapi._features_collection_json(w.latest_docs(GRID)[1]))
    pub.close()


@pytest.mark.parametrize("writer,follower", [("port", "jax"),
                                             ("jax", "port")])
def test_writer_restart_discards_the_followers_tail(tmp_path, writer,
                                                    follower):
    wview_cls, wmod = PKGS[writer]
    fview_cls, fmod = PKGS[follower]
    rng = np.random.default_rng(34)
    cells = city_cells(3, 8, 35)
    ws = int(time.time()) // WIN_S * WIN_S - WIN_S
    w1 = wview_cls()
    pub1 = wmod.DeltaLogPublisher(w1, str(tmp_path), start=False)
    w1.apply_docs(tile_docs(cells[:2], ws, rng))
    pub1.flush()
    r = fview_cls(replica=True)
    fol = fmod.ReplicaViewFollower(r, fmod.FileFeedSource(str(tmp_path)))
    fol.step()
    assert r.seq == 1 and fol.epoch == pub1.epoch
    pub1.close()
    # the restart: different content under the same seq numbers
    w2 = wview_cls()
    pub2 = wmod.DeltaLogPublisher(w2, str(tmp_path), start=False)
    w2.apply_docs(tile_docs(cells[2:], ws, rng))
    pub2.flush()
    assert not [p for p in glob.glob(str(tmp_path / "seg-*"))
                if pub1.epoch in p]
    fol.step()
    assert fol.epoch == pub2.epoch and r.seq == w2.seq == 1
    assert (tapi._features_collection_json(r.latest_docs(GRID)[1])
            == tapi._features_collection_json(w2.latest_docs(GRID)[1]))
    pub2.close()


def _health(app):
    s, _, b = call(app, "/healthz")
    h = json.loads(b)
    return s, h["status"], h["checks"]["repl_synced"]


def test_healthz_degraded_until_the_first_snapshot(tmp_path):
    feed = str(tmp_path / "feed")
    os.makedirs(feed)
    apps = [tapi.make_wsgi_app(MemoryStore(), load_config(
                {}, repl_feed=feed, repl_poll_ms=20)),
            japi.make_wsgi_app(JaxMemoryStore(), jax_load_config(
                {}, repl_feed=feed, repl_poll_ms=20))]
    pub = None
    try:
        got = [_health(a) for a in apps]
        assert got[0] == got[1] == (
            "200 OK", "degraded", {"value": False, "ok": False})
        view = TileMatView()
        pub = trepl.DeltaLogPublisher(view, feed)
        # the followers back off while the feed is missing (at most 5 s)
        wait_for(lambda: all(a.repl_follower.synced for a in apps),
                 "both followers synced")
        got = [_health(a) for a in apps]
        assert got[0] == got[1] == (
            "200 OK", "ok", {"value": True, "ok": True})
    finally:
        for a in apps:
            _close(a)
        if pub is not None:
            pub.close()


def test_repl_routes_equal_between_apps(tmp_path):
    w = Writers(tmp_path)
    w.first_half()
    w.tpub.flush()
    apps = (tapi.make_wsgi_app(MemoryStore(), load_config(
                {}, repl_dir=w.tdir)),
            japi.make_wsgi_app(JaxMemoryStore(), jax_load_config(
                {}, repl_dir=w.tdir)))
    try:
        epoch = w.tpub.epoch
        for path, qs in (("/api/repl/meta", ""),
                         ("/api/repl/snapshot", ""),
                         ("/api/repl/snapshot", f"epoch={epoch}"),
                         ("/api/repl/snapshot", "epoch=nosuch"),
                         ("/api/repl/feed", f"epoch={epoch}&since=0"),
                         ("/api/repl/feed", f"epoch={epoch}&since=3&max=2"),
                         ("/api/repl/feed", "epoch=nosuch&since=0"),
                         ("/api/repl/nosuch", "")):
            (s, h, b), (js, jh, jb) = (call(a, path, qs) for a in apps)
            assert (s, b) == (js, jb), (path, qs)
            assert h["Content-Type"] == jh["Content-Type"]
        recs = json.loads(call(apps[0], "/api/repl/feed",
                               f"epoch={epoch}&since=0")[2])["records"]
        assert [r["seq"] for r in recs] == list(range(1, w.tview.seq + 1))
    finally:
        for a in apps:
            _close(a)
        w.close()


def test_reference_cq_replay_invariant_holds_on_a_port_replica(
        tmp_path, monkeypatch):
    """The reference's own replay test (``tests/test_cq.py``) with the
    port's view, publisher, follower and query engine in place of its
    own: a replica fed one record at a time keeps every standing query's
    incremental state equal to the reference's one-shot evaluation at
    every seq, across window advance, eviction, a writer restart (the
    view's ``reset``: no phantom transitions) and a pruned-horizon
    resync."""
    import test_cq
    from heatmap_tpu.query.continuous import ContinuousQueryEngine as JaxCQ
    from heatmap_tpu_torch.query.continuous import ContinuousQueryEngine

    class PortEngine(ContinuousQueryEngine):
        oneshot = staticmethod(JaxCQ.oneshot)

    monkeypatch.setattr(test_cq, "TileMatView", TileMatView)
    monkeypatch.setattr(test_cq, "ContinuousQueryEngine", PortEngine)
    for name in ("DeltaLogPublisher", "FileFeedSource",
                 "ReplicaViewFollower"):
        monkeypatch.setattr(jrepl, name, getattr(trepl, name))
    test_cq.test_differential_replay_invariant(tmp_path)
