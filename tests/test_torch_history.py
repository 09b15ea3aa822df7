"""The port's space-time history tier (``query/history.py``) against the
JAX package's, on the CPU.

A writer (one package's ``TileMatView`` + ``DeltaLogPublisher`` with a
``HistoryLog``, segments small enough to rotate many times) drives three
windows of churn, then the latest window's eviction under a fake clock;
each test runs both directions (the port writer's feed and the JAX
writer's).  Bars, all exact: nothing is taken out of any chunk (its meta
header holds no wall time: ``stale`` is the docs' own ``staleAt``, the
epoch is the feed's), bodies are compared byte for byte.

- Both compactors over one feed (two copies of its history directory)
  write the same chunk files, byte for byte, and the same
  ``hist-state.json``; ``encode_chunk`` on the same windows gives the same
  bytes and each package's ``decode_chunk`` reads the other's.
- Each package's ``HistoryReader`` over the other's chunks returns the
  windows the writer served live, rendered byte-equal.
- ``/api/tiles/range`` (JSON, ``fmt=bin``, ``res`` rollups),
  ``/api/tiles/at?seq=`` and ``/api/tiles/diff`` from both packages' apps
  over one history directory: equal bodies; the range's aggregate
  conserves every event pushed, and every seq's at-body holds the live
  view's features at that seq.
- A compactor that dies between its chunk write and its state write
  re-ingests on restart to the chunks an uninterrupted JAX compactor
  writes, with nothing counted twice.
- A replica of each package cold-start backfills a restarted writer's
  pre-snapshot windows from the other package's chunks.
- ``python -m heatmap_tpu_torch.query.history --once`` prints what the
  reference's CLI prints over a copy of the same directory.
"""

import datetime as dt
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.query import TileMatView as JaxView
from heatmap_tpu.query import history as jhist
from heatmap_tpu.query import repl as jrepl
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs import audit as taudit
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.query import history as thist
from heatmap_tpu_torch.query import repl as trepl
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.serve import wire as twire
from heatmap_tpu_torch.sink.memory import MemoryStore
from test_torch_query import GRID, WIN_S, city_cells, tile_docs
from test_torch_serve import call
from test_torch_stream import REPO

PKGS = {"port": (TileMatView, trepl, thist),
        "jax": (JaxView, jrepl, jhist)}
BOTH = pytest.mark.parametrize("writer", ["port", "jax"])


def render(docs):
    return tapi._features_collection_json(
        sorted(docs, key=lambda d: d["cellId"]))


class Run:
    """One package's writer over a feed + history directory, driven
    through three windows of churn and the latest window's eviction;
    ``per_seq`` holds the live ``/latest`` render after every seq,
    ``final`` each window's docs after its last mutation."""

    def __init__(self, tmp_path, writer, tag="a"):
        view_cls, rmod, hmod = PKGS[writer]
        self.rmod, self.hmod = rmod, hmod
        self.clock = {"t": float(int(time.time()) // WIN_S * WIN_S)}
        self.feed = str(tmp_path / f"feed-{tag}")
        self.hist = str(tmp_path / f"hist-{tag}")
        self.view = view_cls(now_fn=lambda: self.clock["t"])
        self.pub = rmod.DeltaLogPublisher(
            self.view, self.feed, seg_bytes=8192, segments=2, start=False,
            hist=hmod.HistoryLog(self.hist))
        self.per_seq = {}
        self.final = {}
        self.events = 0

    def apply(self, docs):
        self.view.apply_docs(docs)
        self.pub.flush()
        self.per_seq[self.view.seq] = tapi._features_collection_json(
            self.view.latest_docs(GRID)[1])

    def drive(self, seed=40):
        rng = np.random.default_rng(seed)
        cells = city_cells(150, 8, seed + 1)
        t = self.clock["t"]
        for wi, ws in enumerate((t - 2 * WIN_S, t - WIN_S, t)):
            cur = {}
            for k in range(6):
                docs = tile_docs(cells[20 * k + wi:20 * k + wi + 30], ws,
                                 rng)
                for d in docs:
                    cur[d["cellId"]] = d
                self.apply(docs)
            self.final[int(ws)] = list(cur.values())
            self.events += sum(d["count"] for d in cur.values())
        # every window ages out: the latest's eviction is a feed record
        self.clock["t"] += 2 * 3600
        self.view.etag(GRID)
        self.pub.flush()
        self.per_seq[self.view.seq] = tapi._features_collection_json(
            self.view.latest_docs(GRID)[1])
        return self

    def close(self):
        self.pub.close()
        return self


def chunk_files(hist_dir):
    out = {}
    for p in sorted(glob.glob(os.path.join(hist_dir, "chunks", "*.hst"))):
        with open(p, "rb") as fh:
            out[os.path.basename(p)] = fh.read()
    return out


def compact(hmod, hist, feed, clock):
    comp = hmod.HistoryCompactor(hist, feed_dir=feed,
                                 clock=lambda: clock["t"])
    comp.step()
    return comp


@BOTH
def test_compactors_write_the_same_chunks(tmp_path, writer):
    run = Run(tmp_path, writer).drive().close()
    assert len(glob.glob(os.path.join(run.hist, "log", "seg-*"))) >= 4
    jcopy = str(tmp_path / "hist-jax-compactor")
    shutil.copytree(run.hist, jcopy)
    tcomp = compact(thist, run.hist, run.feed, run.clock)
    jcomp = compact(jhist, jcopy, run.feed, run.clock)
    chunks = chunk_files(run.hist)
    assert chunks and chunks == chunk_files(jcopy)
    with open(os.path.join(run.hist, thist.STATE)) as a, \
            open(os.path.join(jcopy, jhist.STATE)) as b:
        assert json.load(a) == json.load(b)
    assert tcomp.member_block() == jcomp.member_block()
    assert tcomp.records_ingested == run.view.seq
    # without an audited feed nothing verifies and nothing mismatches
    assert tcomp.verified == tcomp.mismatches == 0
    now = run.clock["t"]
    assert (thist.compaction_status(run.hist, now=now)
            == jhist.compaction_status(jcopy, now=now))
    # each package decodes the other's chunks to the same windows
    for buf in chunks.values():
        tm, tw = thist.decode_chunk(buf)
        jm, jw = jhist.decode_chunk(buf)
        assert tm == jm and tw == jw
        # and re-encodes them to the same bytes
        windows = {ws: dict(part, **{k: v for k, v in
                                     tm["windows"][str(ws)].items()
                                     if k not in ("digest", "docs")},
                            digest=int(tm["windows"][str(ws)]["digest"],
                                       16))
                   for ws, part in tw.items()}
        args = (tm["grid"], int(tm["parent"], 16), tm["bucket"],
                tm["bucket_s"], tm["parent_res"], windows)
        assert thist.encode_chunk(*args) == jhist.encode_chunk(*args) \
            == buf


def test_doc_hash_and_digests_match_jax():
    from heatmap_tpu.obs import audit as jaudit

    rng = np.random.default_rng(41)
    docs = tile_docs(city_cells(50, 8, 42), 1_700_000_100, rng)
    hashes = [taudit.doc_hash(d) for d in docs]
    assert hashes == [jaudit.doc_hash(d) for d in docs]
    assert len(set(hashes)) == len(hashes)
    assert (taudit.combine_digests(hashes)
            == jaudit.combine_digests(hashes) != 0)
    assert taudit.combine_digests([]) == 0


@BOTH
def test_readers_read_the_other_packages_chunks(tmp_path, writer):
    run = Run(tmp_path, writer).drive().close()
    compact(PKGS[writer][2], run.hist, run.feed, run.clock)
    reader_mod = thist if writer == "jax" else jhist
    reader = reader_mod.HistoryReader(reader_mod.FileHistorySource(
        run.hist))
    t = run.clock["t"]
    got = reader.windows_in_range(GRID, t - 5 * 3600, t)
    assert sorted(got) == sorted(run.final)
    for ws, part in got.items():
        assert render(part["docs"]) == render(run.final[ws])
    # the newest window at or before each window start
    for ws in run.final:
        w, docs = reader.window_at(GRID, ws + 1)
        assert w == ws and render(docs) == render(run.final[ws])


def _apps(run):
    return (tapi.make_wsgi_app(MemoryStore(), load_config(
                {}, repl_dir=run.feed, hist_dir=run.hist)),
            japi.make_wsgi_app(JaxMemoryStore(), jax_load_config(
                {}, repl_dir=run.feed, hist_dir=run.hist)))


def _close(apps):
    apps[0].close()
    apps[1].close_repl()


def _same(apps, path, qs):
    (s, h, b), (js, jh, jb) = (call(a, path, qs) for a in apps)
    assert (s, b) == (js, jb), (path, qs, s, js, b[:300], jb[:300])
    assert h.get("Content-Type") == jh.get("Content-Type")
    assert h.get("ETag") == jh.get("ETag")
    return s, b


@BOTH
def test_history_routes_equal_and_conserve(tmp_path, writer):
    run = Run(tmp_path, writer).drive().close()
    compact(PKGS[writer][2], run.hist, run.feed, run.clock)
    apps = _apps(run)
    try:
        t = run.clock["t"]
        t0, t1 = t - 5 * 3600, t
        span = f"t0={t0}&t1={t1}"
        s, b = _same(apps, "/api/tiles/range", span)
        body = json.loads(b)
        assert s.startswith("200") and body["windows"] == 3
        agg = body["aggregate"]["features"]
        assert sum(f["properties"]["count"] for f in agg) == run.events
        for res in (7, 6, 5):
            s, b = _same(apps, "/api/tiles/range", f"{span}&res={res}")
            body = json.loads(b)
            assert sum(f["properties"]["count"]
                       for w in body["series"] for f in w["features"]) \
                == run.events
        for qs in (f"{span}&fmt=bin", f"{span}&fmt=bin&res=7"):
            s, b = _same(apps, "/api/tiles/range", qs)
            frames, pos = [], 0
            while pos < len(b):
                n = int.from_bytes(b[pos:pos + 4], "little")
                frames.append(twire.decode(b[pos + 4:pos + 4 + n]))
                pos += 4 + n
            assert len(frames) == 3
            assert sum(d["count"] for f in frames for d in f["docs"]) \
                == run.events
        # view-at-seq: every seq's replay holds the live view's features
        for seq, want in run.per_seq.items():
            s, b = _same(apps, "/api/tiles/at", f"seq={seq}")
            assert s.startswith("200"), (seq, b[:200])
            feats = json.loads(b)["features"]
            assert feats == json.loads(want)["features"], seq
        s, _ = _same(apps, "/api/tiles/at", f"seq={run.view.seq + 5}")
        assert s.startswith("404")
        for a, b_ in ((t - 2 * WIN_S + 1, t + 1), (t - WIN_S + 1, t + 1),
                      (t0, t1)):
            for res in ("", "&res=7"):
                s, b = _same(apps, "/api/tiles/diff",
                             f"t0={a}&t1={b_}{res}")
                assert s.startswith("200") and json.loads(b)["features"]
        # the chunk re-export, and the bad requests
        s, b = _same(apps, "/api/hist/index", "")
        names = [c["name"] for c in json.loads(b)["chunks"]]
        assert names
        s, b = _same(apps, "/api/hist/chunk", f"name={names[0]}")
        assert b == chunk_files(run.hist)[names[0]]
        for path, qs in (("/api/hist/chunk", "name=../x"),
                         ("/api/hist/chunk",
                          "name=chunk-h3r8-0000000000000000-1.hst"),
                         ("/api/tiles/range", "t1=5"),
                         ("/api/tiles/range", "t0=9&t1=5"),
                         ("/api/tiles/range", "t0=1&res=12"),
                         ("/api/tiles/diff", "t0=1"),
                         ("/api/tiles/at", "seq=0")):
            s, _ = _same(apps, path, qs)
            assert s[:3] in ("400", "404"), (path, qs, s)
        # the compaction lag is a wall-clock age: its value is taken out
        h, jh = (json.loads(call(a, "/healthz")[2]) for a in apps)
        for x in (h, jh):
            assert x["checks"]["hist_compaction_lag_s"].pop("value") < 60
        assert h == jh and h["checks"]["hist_compaction_lag_s"]["ok"]
        text = call(apps[0], "/metrics")[2].decode()
        for name in ("heatmap_hist_scan_chunks_total",
                     "heatmap_hist_scan_rows_total"):
            assert name in text, name
        blocks = [a.hist_fn() for a in apps]
        for b_ in blocks:
            assert b_.pop("lag_s") < 60
        assert blocks[0] == blocks[1] and blocks[0]["chunks"] > 0
    finally:
        _close(apps)


def test_history_routes_503_without_the_tier():
    apps = (tapi.make_wsgi_app(MemoryStore(), load_config({})),
            japi.make_wsgi_app(JaxMemoryStore(), jax_load_config({})))
    try:
        for path, qs in (("/api/tiles/range", "t0=1"),
                         ("/api/tiles/at", "seq=1"),
                         ("/api/tiles/diff", "t0=1&t1=2"),
                         ("/api/hist/index", ""),
                         ("/api/repl/meta", "")):
            s, _ = _same(apps, path, qs)
            assert s.startswith("503"), path
    finally:
        _close(apps)


@BOTH
def test_crash_between_chunk_write_and_state_write(tmp_path, writer):
    run = Run(tmp_path, writer).drive().close()
    ref = str(tmp_path / "hist-uninterrupted")
    shutil.copytree(run.hist, ref)
    compact(jhist, ref, run.feed, run.clock)

    class Crash(Exception):
        pass

    comp = thist.HistoryCompactor(run.hist, feed_dir=run.feed,
                                  clock=lambda: run.clock["t"])

    def crash():
        raise Crash

    comp._save_state = crash
    with pytest.raises(Crash):
        comp.step()
    assert chunk_files(run.hist)
    assert not os.path.exists(os.path.join(run.hist, thist.STATE))
    comp2 = compact(thist, run.hist, run.feed, run.clock)
    assert comp2.records_ingested == run.view.seq
    assert chunk_files(run.hist) == chunk_files(ref)
    reader = thist.HistoryReader(thist.FileHistorySource(run.hist))
    t = run.clock["t"]
    got = reader.windows_in_range(GRID, t - 5 * 3600, t)
    assert sum(d["count"] for p in got.values() for d in p["docs"]) \
        == run.events
    assert comp2.step() == 0
    assert chunk_files(run.hist) == chunk_files(ref)


@pytest.mark.parametrize("writer,replica", [("jax", "port"),
                                            ("port", "jax")])
def test_replica_backfills_pre_snapshot_windows(tmp_path, writer, replica):
    """A writer restart shrinks the snapshot to the new epoch's windows;
    the replica restores the older ones from the other package's
    chunks, without touching its seq or /latest."""
    view_cls, wrepl, whist = PKGS[writer]
    rview_cls, rrepl, rhist = PKGS[replica]
    rng = np.random.default_rng(43)
    cells = city_cells(20, 8, 44)
    t = float(int(time.time()) // WIN_S * WIN_S)
    feed, hist = str(tmp_path / "feed"), str(tmp_path / "hist")
    w = view_cls()
    pub = wrepl.DeltaLogPublisher(w, feed, start=False,
                                  hist=whist.HistoryLog(hist))
    old = tile_docs(cells[:8], t - 4 * WIN_S, rng)
    w.apply_docs(old)
    pub.flush()
    pub.close()
    whist.HistoryCompactor(hist, feed_dir=feed).step()
    w2 = view_cls()
    pub2 = wrepl.DeltaLogPublisher(w2, feed, start=False,
                                   hist=whist.HistoryLog(hist))
    w2.apply_docs(tile_docs(cells[8:], t - WIN_S, rng))
    pub2.flush()
    reg = Registry() if replica == "port" else None
    r = rview_cls(replica=True)
    kw = {"registry": reg} if reg is not None else {}
    fol = rrepl.ReplicaViewFollower(r, rrepl.FileFeedSource(feed),
                                    hist_source=rhist.FileHistorySource(
                                        hist), **kw)
    while fol.step():
        pass
    wd = r.window_docs(GRID)
    assert sorted(wd) == [int(t - 4 * WIN_S), int(t - WIN_S)]
    assert render(wd[int(t - 4 * WIN_S)][2]) == render(old)
    assert r.seq == w2.seq
    assert (tapi._features_collection_json(r.latest_docs(GRID)[1])
            == tapi._features_collection_json(w2.latest_docs(GRID)[1]))
    if reg is not None:
        assert "heatmap_hist_backfill_total 1" in reg.expose_text()
    pub2.close()


def test_cli_once_prints_what_the_reference_prints(tmp_path):
    run = Run(tmp_path, "port").drive().close()
    jcopy = str(tmp_path / "hist-jax-cli")
    shutil.copytree(run.hist, jcopy)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    outs = []
    for mod, hist in (("heatmap_tpu_torch.query.history", run.hist),
                      ("heatmap_tpu.query.history", jcopy)):
        p = subprocess.run(
            [sys.executable, "-m", mod, "--hist", hist, "--feed", run.feed,
             "--once"], cwd=REPO, env=env, capture_output=True, text=True,
            timeout=120)
        assert p.returncode == 0, p.stderr
        outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1] and outs[0]["chunks"] > 0
    assert chunk_files(run.hist) == chunk_files(jcopy)
