"""The delivery lineage of the port (heatmap_tpu_torch/obs/delivery.py,
the feed's ``pt`` stamps in query/repl.py, the SSE brackets of both serve
cores) against the JAX package's, on the CPU.

The stamps are host floats from injected clocks, so every comparison is
exact (no tolerance): the telescoping residual is identically 0.

- each package's ``DeliveryTracker`` over one seeded script of stamps,
  the replica's clock minutes ahead of the writer's: the same samples,
  summaries and member blocks, every residual exactly 0, the skew in
  ``feed_transit`` alone;
- with ``HEATMAP_AUDIT=1`` and ``HEATMAP_DELIVERY=1`` the port's feed
  records are byte-equal to the JAX package's, ``"dg"`` and ``"pt"``
  included, under one injected clock; a replica of each package
  following the other's feed installs the stamps bit for bit and
  completes samples with residual 0;
- with both knobs off the feed carries neither field and its bytes equal
  the JAX package's (as the port's did before the lineage), the hook
  being the bare append;
- a replica-fed serve app on each core with one SSE subscriber: with the
  knob on, delivered samples complete with residual 0 and
  ``/debug/delivery`` serves them; the SSE frames are byte-identical
  with the knob on, with it off, and to the JAX app's over the same feed.
"""

import datetime as dt
import glob
import json
import os
import socket
import time

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.obs import audit as jaudit
from heatmap_tpu.obs import delivery as jdelivery
from heatmap_tpu.query import TileMatView as JaxTileMatView
from heatmap_tpu.query import repl as jrepl
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs import audit as taudit
from heatmap_tpu_torch.obs import delivery as tdelivery
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.query import repl as trepl
from heatmap_tpu_torch.serve import start_background, stop_background
from heatmap_tpu_torch.sink.base import UTC
from heatmap_tpu_torch.sink.memory import MemoryStore
from test_torch_audit import seeded_docs

PKGS = {"jax": (jdelivery, JaxTileMatView, jrepl, jaudit),
        "port": (tdelivery, TileMatView, trepl, taudit)}


class FakeClock:
    def __init__(self, t: float):
        self.t = t

    def advance(self, dt_s: float) -> None:
        self.t += dt_s

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------ tracker
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tracker_telescopes_exactly_as_jax_under_skew(seed):
    """Stamps in multiples of 1/64 s (binary-exact), the replica's clock
    300 s ahead of the writer's: both trackers give the same snapshot, and
    every sample's residual is exactly 0 with the skew in feed_transit."""
    rng = np.random.default_rng(seed)
    clocks = {p: FakeClock(100300.0) for p in PKGS}
    trackers = {p: m[0].DeliveryTracker(clock=clocks[p], capacity=64)
                for p, m in PKGS.items()}
    steps = rng.integers(1, 64, size=(40, 6)) / 64.0
    w = 100000.0
    for i, st in enumerate(steps):
        eq, pub, ea = w, w + st[0], float(st[1])
        w += st[2]
        for p, tr in trackers.items():
            clk = clocks[p]
            rx = clk()
            clk.advance(st[3])
            tr.record_applied(i + 1, [eq, pub, ea], rx, clk())
            meta = tr.encoded(i + 1)
            clk.advance(st[4])
            wb = clk()
            clk.advance(st[5])
            tr.delivered(meta, wb, clk())
    snaps = {p: tr.snapshot(64) for p, tr in trackers.items()}
    assert snaps["port"] == snaps["jax"]
    assert (trackers["port"].member_block()
            == trackers["jax"].member_block())
    for s in snaps["port"]["recent"]:
        assert s["residual_s"] == 0.0
        assert s["age_s"] == sum(s["stages"].values())
        assert s["stages"]["feed_transit"] > 250.0
    summ = snaps["port"]["summary"]
    assert summ["count"] == 40 and summ["max_abs_residual_s"] == 0.0
    assert summ["worst_stage"] == "feed_transit"
    assert snaps["port"]["cross_host"] == ["feed_transit"]
    # a coalesced frame ages as the newest stamped record at or below it
    assert trackers["port"].encoded(99)["rec"]["seq"] == 40
    assert trackers["port"].encoded(0) is None


def test_stalled_feed_shows_in_the_member_block():
    for m in PKGS.values():
        clk = FakeClock(100300.0)
        tr = m[0].DeliveryTracker(clock=clk)
        tr.record_applied(1, [100000.0, 100000.5, 0.0], clk(), clk())
        clk.advance(30.0)
        assert tr.member_block() == {"count": 0,
                                     "feed_transit_current_s": 329.5,
                                     "since_last_receipt_s": 30.0}


# --------------------------------------------------------------- feed
def _feed_lines(pkg, d, audit: bool, delivery: bool):
    """The feed one package's writer publishes for three seeded rounds of
    docs, its segment clock (``t``) and publish clock injected, and
    whether its view hook is the bare append."""
    _, view_cls, repl, audit_mod = PKGS[pkg]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(repl.time, "time", lambda: 1234.5)
        if delivery:
            mp.setenv("HEATMAP_DELIVERY", "1")
        else:
            mp.delenv("HEATMAP_DELIVERY", raising=False)
        clk = FakeClock(2000.0)
        view = view_cls(audit=audit_mod.DigestTable() if audit else None)
        pub = repl.DeltaLogPublisher(view, str(d), start=False, clock=clk,
                                     event_age_fn=lambda: 1.5)
        bare = view._hook == pub._q.append
        ws0 = dt.datetime.fromtimestamp(1_900_000_000, UTC)
        for rnd in range(3):
            view.apply_docs(seeded_docs(rnd, n_cells=8, ws0=ws0, pkg=pkg))
            clk.advance(0.25)
            pub.flush()
            clk.advance(0.5)
        pub.close()
    lines = []
    for p in sorted(glob.glob(os.path.join(str(d), "seg-*.jsonl"))):
        with open(p, encoding="utf-8") as fh:
            lines += fh.readlines()
    return lines, bare


def test_feed_records_byte_equal_with_audit_and_delivery(tmp_path):
    (lines, bare), (jlines, _) = (
        _feed_lines(pkg, tmp_path / pkg, audit=True, delivery=True)
        for pkg in ("port", "jax"))
    assert lines == jlines and not bare
    recs = [trepl.loads(ln) for ln in lines]
    assert recs and all("dg" in r and "pt" in r for r in recs)
    assert recs[0]["pt"] == [2000.0, 2000.25, 1.5]


def test_knobs_off_feed_carries_neither_and_equals_jax(tmp_path):
    (lines, bare), (jlines, jbare) = (
        _feed_lines(pkg, tmp_path / pkg, audit=False, delivery=False)
        for pkg in ("port", "jax"))
    assert lines == jlines and lines
    assert bare and jbare
    assert all('"pt"' not in ln and '"dg"' not in ln
               and '"_eq"' not in ln for ln in lines)
    # the audit table alone adds "dg" and nothing else
    dg_lines, _ = _feed_lines("port", tmp_path / "dg", audit=True,
                              delivery=False)
    for on, off in zip(dg_lines, lines):
        rec = trepl.loads(on)
        assert isinstance(rec.pop("dg"), dict)
        assert trepl.dumps(rec) == off.rstrip("\n")


@pytest.mark.parametrize("writer,replica", [("jax", "port"),
                                            ("port", "jax")])
def test_replica_installs_the_other_packages_stamps(tmp_path, monkeypatch,
                                                   writer, replica):
    """The writer stamps on one clock, the replica (the other package)
    applies and delivers on another 300 s ahead: the stamps arrive bit for
    bit and every completed sample telescopes with residual 0."""
    monkeypatch.setenv("HEATMAP_DELIVERY", "1")
    feed = str(tmp_path / "feed")
    _, wview_cls, wrepl, waudit = PKGS[writer]
    wclk = FakeClock(100000.0)
    wview = wview_cls(audit=waudit.DigestTable())
    pub = wrepl.DeltaLogPublisher(wview, feed, start=False, clock=wclk,
                                  event_age_fn=lambda: 2.0)
    ws0 = dt.datetime.now(UTC).replace(microsecond=0) - \
        dt.timedelta(minutes=7)
    for rnd in range(3):
        wview.apply_docs(seeded_docs(rnd, n_cells=6, n_windows=2, ws0=ws0,
                                     pkg=writer))
        wclk.advance(0.5)
        pub.flush()
        wclk.advance(0.25)
    pub.close()
    dmod, rview_cls, rrepl, raudit = PKGS[replica]
    rclk = FakeClock(100300.0)
    tr = dmod.DeliveryTracker(clock=rclk)
    aud = raudit.AuditState(tag="r")
    rview = rview_cls(replica=True, audit=raudit.DigestTable())
    fol = rrepl.ReplicaViewFollower(rview, rrepl.FileFeedSource(feed),
                                    clock=rclk, delivery=tr, audit=aud)
    aud.attach(view=rview, follower=fol)
    while fol.step():
        rclk.advance(0.25)
    assert fol.synced and rview.seq == wview.seq
    assert aud.verified >= 3 and aud.mismatches == 0
    assert sorted(tr._recs) == list(range(1, wview.seq + 1))
    for seq, rec in tr._recs.items():
        assert (rec["ea"], rec["pub"] - rec["eq"]) == (2.0, 0.5)
        meta = tr.encoded(seq)
        rclk.advance(0.125)
        wb = rclk()
        rclk.advance(0.5)
        tr.delivered(meta, wb, rclk())
    summ = tr.summary()
    assert summ["count"] == wview.seq and summ["max_abs_residual_s"] == 0.0
    assert summ["worst_stage"] == "feed_transit"


# ---------------------------------------------------------------- SSE
def _subscribe(port):
    sk = socket.create_connection(("127.0.0.1", port), timeout=20)
    sk.sendall(b"GET /api/tiles/stream?since=0&grid=h3r8 HTTP/1.0\r\n\r\n")
    return sk


def _read_frames(sk, n):
    buf = b""
    deadline = time.monotonic() + 30
    while buf.count(b"event: tiles") < n and time.monotonic() < deadline:
        chunk = sk.recv(65536)
        if not chunk:
            break
        buf += chunk
    return buf


def _sse_run(tmp_path, tag, monkeypatch, knob, core, pkg="port"):
    """A writer view publishing a feed, a replica-fed serve app of
    ``pkg`` on ``core`` with one SSE subscriber, a mutation after the
    subscribe: (the tile frames, the delivery summary, /debug/delivery)."""
    if knob:
        monkeypatch.setenv("HEATMAP_DELIVERY", "1")
    else:
        monkeypatch.delenv("HEATMAP_DELIVERY", raising=False)
    feed = str(tmp_path / f"feed-{tag}")
    ws0 = dt.datetime.now(UTC).replace(second=0, microsecond=0)
    view = TileMatView()
    pub = trepl.DeltaLogPublisher(view, feed, flush_s=0.02)
    view.apply_docs(seeded_docs(1, n_cells=6, n_windows=1, ws0=ws0))
    env = {"HEATMAP_REPL_FEED": feed, "HEATMAP_REPL_POLL_MS": "20",
           "HEATMAP_SERVE_CORE": core, "SERVE_PORT": "0"}
    if pkg == "port":
        httpd, thread, port = start_background(MemoryStore(),
                                               load_config(env))
    else:
        # the JAX server turns port 0 into 5000: host its app on an
        # ephemeral port here
        import threading
        from wsgiref.simple_server import make_server

        from heatmap_tpu.serve import api as japi

        app = japi.make_wsgi_app(JaxMemoryStore(),
                                 jax_load_config(env, store="memory"))
        httpd = make_server("127.0.0.1", 0, app,
                            server_class=japi._ThreadingWSGIServer,
                            handler_class=japi._QuietHandler)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        port = httpd.server_address[1]
    app = httpd.get_app()
    try:
        fol = app.repl_follower
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                fol.synced and fol.view.seq >= 1 and fol.seq_lag() == 0):
            time.sleep(0.02)
        sk = _subscribe(port)
        buf = _read_frames(sk, 1)
        view.apply_docs(seeded_docs(2, n_cells=6, n_windows=1, ws0=ws0))
        buf += _read_frames(sk, 2 - buf.count(b"event: tiles"))
        if knob:
            deadline = time.monotonic() + 15
            while (time.monotonic() < deadline
                   and not app.delivery.summary().get("count")):
                time.sleep(0.02)
        summ = app.delivery.summary()
        debug = None
        if pkg == "port":
            from test_torch_serve import call

            debug = json.loads(call(app, "/debug/delivery")[2])
        sk.close()
        frames = [f for f in buf.split(b"\n\n") if b"event: tiles" in f]
        return frames, summ, debug
    finally:
        if pkg == "port":
            stop_background(httpd, thread)
        else:
            httpd.shutdown()
            httpd.server_close()
            app.close_repl()
        pub.close()


@pytest.mark.parametrize("core", ["thread", "epoll"])
def test_sse_delivered_end_to_end_and_frames_unchanged(tmp_path,
                                                      monkeypatch, core):
    on_frames, on_summ, on_debug = _sse_run(tmp_path, "on", monkeypatch,
                                            True, core)
    assert len(on_frames) == 2
    assert on_summ["count"] >= 1 and on_summ["max_abs_residual_s"] == 0.0
    assert set(on_summ["stages_p50_s"]) == set(tdelivery.DELIVERY_STAGES)
    assert on_debug["summary"]["count"] >= 1
    assert on_debug["cross_host"] == ["feed_transit"]
    assert on_debug["subscribers"]
    off_frames, off_summ, _ = _sse_run(tmp_path, "off", monkeypatch,
                                       False, core)
    assert not off_summ.get("count")
    assert off_frames == on_frames
    if core == "thread":
        jax_frames, jax_summ, _ = _sse_run(tmp_path, "jax", monkeypatch,
                                           True, core, pkg="jax")
        assert jax_frames == on_frames and jax_summ["count"] >= 1
