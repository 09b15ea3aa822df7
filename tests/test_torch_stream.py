"""The port's streaming runtime against the JAX package's, and the port's
independence from JAX.

Both runtimes fold the same small ``SyntheticSource`` stream (timestamps
over several 5-minute windows, so windows close and evict) into a
``MemoryStore``, twice: pinned (HEATMAP_MERGE_IMPL=sort, HEATMAP_FASTPATH=0,
HEATMAP_EMIT_FLUSH_K=1, which both packages read), and each with its own
defaults (auto, the fast path on, an emit ring 8 batches deep).  The
reference's snap is pinned to HEATMAP_H3_IMPL=xla; the port has one snap
route (the fused snap kernel's plain version on the CPU: the geometry,
then the table stage).

The two snaps are not bit-identical on the CPU: the face search differs in
its expression tree (an unrolled compare against a matmul plus argmax), and
the reference's cos/sin come from the C library, PyTorch's from its vector
math library, so a point within ~1e-3 grid units of a cell edge may land in
the neighbouring cell (tests/test_torch_hexgrid.py measures the share).
The bars:

- at most 0.2% of the events may snap differently (the reference's own bar
  between its two snaps), counted event by event;
- the docs of every (cell, window) that no such event touches: the same
  set on both sides, counts exact, average and stddev of speed and p95
  within 1e-6 relative (their sums match bit for bit, see
  test_torch_engine.py), centroid within 1e-5 degrees (the per-event
  half-ulp of the fused multiply-add noted in test_torch_engine.py);
- the counts summed over all docs equal on both sides (conservation).
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.engine import step as jstep
from heatmap_tpu.hexgrid import device as jdev
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import SyntheticSource as JaxSyntheticSource
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.engine import step as tstep
from heatmap_tpu_torch.hexgrid import snap_kernel
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.events import columns_from_arrays
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import Source, SyntheticSource

REPO = Path(__file__).resolve().parents[1]
RES = 9
BATCH = 1 << 12
CAP_LOG2 = 14
# 3.5 batches at 8 events/s of sim time: ~30 minutes of event time
N_EVENTS = 3 * BATCH + BATCH // 2
SOURCE_ARGS = dict(n_events=N_EVENTS, n_vehicles=300,
                   events_per_second=8, t0=1_700_000_000)
AXES = dict(city="bos", h3_res=RES, resolutions=(RES,), windows_minutes=(5,),
            tile_minutes=5, batch_size=BATCH, state_capacity_log2=CAP_LOG2,
            speed_hist_bins=64)


KNOBS = ("HEATMAP_MERGE_IMPL", "HEATMAP_FASTPATH", "HEATMAP_EMIT_FLUSH_K",
         "HEATMAP_EMIT_PULL")


def _pin_reference(monkeypatch, pinned: dict):
    monkeypatch.setenv("HEATMAP_H3_IMPL", "xla")
    for k in KNOBS:
        if k in pinned:
            monkeypatch.setenv(k, pinned[k])
        else:
            monkeypatch.delenv(k, raising=False)
    # the JAX runtime pins these module slots at init; restore them after
    for slot in ("SNAP_IMPL", "MERGE_IMPL", "FASTPATH", "MERGE_BANK_PIN"):
        monkeypatch.setattr(jstep, slot, getattr(jstep, slot))
    monkeypatch.setattr(tstep, "MERGE_IMPL", None)
    monkeypatch.setattr(tstep, "FASTPATH", None)


@pytest.fixture
def reference_env(monkeypatch):
    _pin_reference(monkeypatch, {"HEATMAP_MERGE_IMPL": "sort",
                                 "HEATMAP_FASTPATH": "0",
                                 "HEATMAP_EMIT_FLUSH_K": "1"})


@pytest.fixture
def default_env(monkeypatch):
    _pin_reference(monkeypatch, {})


def run_jax(tmp_path):
    cfg = jax_load_config(None, checkpoint_dir=str(tmp_path / "ckpt"),
                          store="memory", state_max_log2=CAP_LOG2, **AXES)
    store = JaxMemoryStore()
    rt = JaxRuntime(cfg, JaxSyntheticSource(**SOURCE_ARGS), store,
                    checkpoint_every=0)
    rt.run()
    return store._tiles, cfg


def run_port(ckpt, source_args=SOURCE_ARGS, axes=AXES, **over):
    """The port's runtime over the stream, committing to its own fresh
    checkpoint directory ``ckpt``."""
    cfg = load_config(None, checkpoint_dir=str(ckpt), **axes, **over)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, SyntheticSource(**source_args), store,
                           device="cpu")
    rt.run()
    return store._tiles, rt


def snap_disagreements():
    """(cell id, window start) pairs touched by events that the port's snap
    (the runtime's own route) and the reference's XLA snap place
    differently, and the share of such events."""
    cols = SyntheticSource(**SOURCE_ARGS).poll(N_EVENTS)
    hi, lo = jdev.latlng_to_cell_vec(cols.lat_rad, cols.lng_rad, RES)
    ref = jdev.cells_to_uint64(hi, lo)
    th, tl = snap_kernel.latlng_to_cell_kernel(
        torch.from_numpy(cols.lat_rad), torch.from_numpy(cols.lng_rad), RES)
    mine = jdev.cells_to_uint64(th.numpy().view(np.uint32),
                                tl.numpy().view(np.uint32))
    bad = np.nonzero(ref != mine)[0]
    ws = (cols.ts_s // 300) * 300
    touched = set()
    for i in bad:
        for cell in (ref[i], mine[i]):
            touched.add((format(int(cell), "x"), int(ws[i])))
    return touched, len(bad) / N_EVENTS


def assert_docs_match(ref_docs, docs, metrics):
    """The module docstring's bars."""
    touched, bad_share = snap_disagreements()
    assert bad_share <= 0.002, bad_share

    key = lambda d: (d["cellId"], int(d["windowStart"].timestamp()))
    ref = {key(d): d for d in ref_docs.values()}
    mine = {key(d): d for d in docs.values()}
    # several windows, and nothing lost on either side
    assert len({k[1] for k in mine}) >= 5
    assert sum(d["count"] for d in mine.values()) == N_EVENTS
    assert sum(d["count"] for d in ref.values()) == N_EVENTS
    assert metrics["events_valid"] == N_EVENTS
    assert metrics["state_overflow"] == 0

    clean_ref = {k: d for k, d in ref.items() if k not in touched}
    clean = {k: d for k, d in mine.items() if k not in touched}
    assert clean.keys() == clean_ref.keys()
    assert len(clean) >= len(ref) - 2 * len(touched)
    for k, d in clean.items():
        r = clean_ref[k]
        assert d["_id"] == r["_id"] and d["count"] == r["count"], k
        for f in ("avgSpeedKmh", "stddevSpeedKmh", "p95SpeedKmh"):
            assert d[f] == pytest.approx(r[f], rel=1e-6, abs=1e-9), (k, f)
        for a, b in zip(d["centroid"]["coordinates"],
                        r["centroid"]["coordinates"]):
            assert abs(a - b) <= 1e-5, (k, a, b)
        assert d["windowEnd"] == r["windowEnd"]
        assert d["staleAt"] == r["staleAt"]


def test_runtime_matches_jax_runtime(tmp_path, reference_env):
    ref_docs, ref_cfg = run_jax(tmp_path)
    docs, rt = run_port(tmp_path / "port")
    assert ref_cfg.emit_flush_k == rt.cfg.emit_flush_k == 1
    assert rt.pulls["flushes"] == rt.counters["batches"]
    assert_docs_match(ref_docs, docs, rt.metrics)


def test_runtime_defaults_match_jax_defaults(tmp_path, default_env):
    """Each runtime with its own defaults: the fast path over auto (rank
    here: the slab holds 4x the batch), an emit ring 8 batches deep.  The
    JAX side pins its growth ceiling (``run_jax``); at this ratio neither
    slab grows.  Growth on, at synthetic_backfill's 1:2 ratio, is
    tests/test_torch_growth.py::test_growth_defaults_match_jax."""
    ref_docs, ref_cfg = run_jax(tmp_path)
    tiers = dict(tstep._merge_fastpath.tiers)
    docs, rt = run_port(tmp_path / "port")
    assert ref_cfg.emit_flush_k == rt.cfg.emit_flush_k == 8
    assert rt.cfg.emit_pull == "auto" and not rt._prefix_pull
    taken = {t: n - tiers[t] for t, n in tstep._merge_fastpath.tiers.items()}
    assert sum(taken.values()) == rt.counters["batches"]
    assert rt.pulls["batches"] == rt.counters["batches"]
    assert rt.pulls["flushes"] < rt.counters["batches"]
    assert_docs_match(ref_docs, docs, rt.metrics)


# one 5-minute window, 10 batches: no window closes, so no watermark flush
ONE_WINDOW = dict(n_events=10 * 1024, n_vehicles=300,
                  events_per_second=1024, t0=1_700_000_000 - 200)
SMALL_AXES = dict(AXES, batch_size=1024, state_capacity_log2=13)


# two resolutions x two window lengths: four pairs share each pull
PAIRS_AXES = dict(AXES, resolutions=(8, 9), windows_minutes=(1, 5))


@pytest.mark.parametrize("source_args,axes", [
    (ONE_WINDOW, SMALL_AXES), (SOURCE_ARGS, AXES), (SOURCE_ARGS, PAIRS_AXES)],
    ids=["one_window", "windows", "four_pairs"])
def test_flush_depth_does_not_change_results(tmp_path, default_env,
                                             source_args, axes):
    """K=1 (full pulls) and K=8 (prefix pulls) give the same docs and the
    same counters; only the pulls differ."""
    docs1, rt1 = run_port(tmp_path / "k1", source_args, axes, emit_flush_k=1,
                          emit_pull="full")
    docs8, rt8 = run_port(tmp_path / "k8", source_args, axes, emit_flush_k=8,
                          emit_pull="prefix")
    assert rt8._prefix_pull and not rt1._prefix_pull
    assert docs8 == docs1
    assert rt8.counters == rt1.counters
    assert rt8.max_event_ts == rt1.max_event_ts
    batches = rt1.counters["batches"]
    assert rt1.pulls["flushes"] == rt1.pulls["batches"] == batches
    assert rt8.pulls["batches"] == batches
    assert rt8.pulls["bytes"] < rt1.pulls["bytes"]
    if source_args is ONE_WINDOW:
        # flushes before the 7th batch, under growth pressure (the live
        # groups plus the worst-case minting of 6 parked batches and the
        # next two pass the 2^13-row slab: runtime._grow_margin), before
        # the ring is full, and on the idle poll that finds the source
        # exhausted
        assert rt8.pulls == dict(rt8.pulls, flushes=2, full=0, grow=1,
                                 idle=1, watermark=0, close=0)
        assert rt8.counters["state_grown"] == 0
    else:
        # the stream crosses windows: closing windows flush early
        assert rt8.pulls["watermark"] > 0


class _ListSource(Source):
    """Serves the given batches in order, an empty poll for each None."""

    def __init__(self, batches):
        self._batches = list(batches)

    def poll(self, max_events):
        b = self._batches.pop(0) if self._batches else None
        return b if b is not None else columns_from_arrays([], [], [], [])

    @property
    def exhausted(self):
        return not self._batches


def test_idle_poll_flushes(tmp_path, default_env):
    cols = SyntheticSource(**ONE_WINDOW).poll(1024)
    store = MemoryStore()
    rt = MicroBatchRuntime(load_config(None, checkpoint_dir=str(tmp_path),
                                       **SMALL_AXES),
                           _ListSource([cols, None, None, cols]), store,
                           device="cpu")
    assert rt.step_once()
    # the prefetch refill after the dispatch polled the first None: a
    # refill's empty poll flushes nothing, the step's own poll does
    assert len(rt._ring) == 1 and store.n_tiles == 0
    assert not rt.step_once()                # idle: the parked batch lands
    assert len(rt._ring) == 0 and rt.pulls["idle"] == 1
    rt.writer.drain()                        # its docs land on the writer
    assert store.n_tiles > 0
    assert rt.step_once()
    rt.close()
    assert rt.pulls == dict(rt.pulls, flushes=2, idle=1, close=1,
                            batches=2)
    assert rt.counters["events_valid"] == 2 * len(cols)


def test_flush_knobs_validated():
    with pytest.raises(ValueError, match="HEATMAP_EMIT_FLUSH_K"):
        load_config({"HEATMAP_EMIT_FLUSH_K": "0"})
    with pytest.raises(ValueError, match="HEATMAP_EMIT_PULL"):
        load_config({"HEATMAP_EMIT_PULL": "some"})
    cfg = load_config({"HEATMAP_EMIT_FLUSH_K": "4",
                       "HEATMAP_EMIT_PULL": "prefix"})
    assert cfg.emit_flush_k == 4 and cfg.emit_pull == "prefix"
    cfg = load_config({})
    assert cfg.emit_flush_k == 8 and cfg.emit_pull == "auto"


def test_ops_per_batch_counts_the_dispatched_ops(tmp_path, monkeypatch):
    """``profile_fold.ops_per_batch`` counts every PyTorch op of one batch
    and the port's own kernel launches, which the CPU makes none of: so on
    the CPU it covers at least the plain snap that runs inside the fold
    (the in-program snap, HEATMAP_H3_IMPL=xla: ``auto`` keys the fold with
    the host snap on the CPU)."""
    from heatmap_tpu_torch.profile_fold import _CountOps, ops_per_batch

    monkeypatch.setenv("HEATMAP_H3_IMPL", "xla")
    rt = MicroBatchRuntime(load_config(None, checkpoint_dir=str(tmp_path),
                                       **AXES),
                           SyntheticSource(**SOURCE_ARGS), MemoryStore(),
                           device="cpu")
    assert rt.step_once()
    got = ops_per_batch(rt)
    x = torch.zeros(BATCH)
    with _CountOps() as snap:
        snap_kernel.latlng_to_cell_reference(x, x, RES)
    assert got["kernel_launches"] == 0
    assert got["ops"] == got["torch_ops"] > snap.n > 1000, (got, snap.n)


def test_entry_point_needs_a_card_or_cpu(monkeypatch):
    """No CUDA device and no --device cpu: the entry point raises."""
    from heatmap_tpu_torch.stream import __main__ as entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["synthetic_backfill", "--max-batches", "1"])


_ISOLATION = r"""
import shutil
import sys
import tempfile
import torch
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
import heatmap_tpu_torch.stream.__main__
import heatmap_tpu_torch._build
import heatmap_tpu_torch.hexgrid.snap_kernel
import heatmap_tpu_torch.profile_fold
import heatmap_tpu_torch.models.bench_pipelines
import heatmap_tpu_torch.models.demo
import heatmap_tpu_torch.serve.__main__
import heatmap_tpu_torch.query.continuous
import heatmap_tpu_torch.query.geom
import heatmap_tpu_torch.query.history
import heatmap_tpu_torch.query.repl
import heatmap_tpu_torch.serve.evloop
from heatmap_tpu_torch.serve import make_wsgi_app
from heatmap_tpu_torch.kafka import KafkaClient, Record
from heatmap_tpu_torch.models.pipelines import PIPELINES
from heatmap_tpu_torch.stream.source import KafkaSource, MemorySource
from heatmap_tpu_torch.testing.mock_kafka import MockKafkaBroker
from heatmap_tpu_torch.utils.netio import recv_exact
import heatmap_tpu_torch.native
from heatmap_tpu_torch.sink import AsyncWriter, JsonlStore, make_store
from heatmap_tpu_torch.sink.mongo import MongoStore
from heatmap_tpu_torch.testing.mock_mongod import MockMongod

# the Kafka ingress over a mock broker, the wire client, the registry
with MockKafkaBroker() as bootstrap:
    src = KafkaSource(bootstrap, "mobility.positions.v1")
    c = KafkaClient(bootstrap)
    c.produce("mobility.positions.v1", 1, [Record(0, 0, b"k", (
        b'{"provider": "p", "vehicleId": "v", "lat": 42.3, "lon": -71.0, '
        b'"ts": 1700000000}'))])
    c.close()
    assert len(src.poll(10)) == 1
    assert src.counters["values_decoded_native"] == 1
    src.close()
assert len(PIPELINES) == 5 and len(MemorySource([{}]).poll(5)) == 1

ckpt = tempfile.mkdtemp()
# the integrity and delivery knobs and the fleet's channel, on
import os
os.environ["HEATMAP_SUPERVISOR_CHANNEL"] = ckpt + "/channel.json"
os.environ["HEATMAP_DELIVERY"] = "1"
cfg = load_config({}, city="bos", h3_res=9, resolutions=(9,),
                  batch_size=1024, state_capacity_log2=12,
                  checkpoint_dir=ckpt, repl_dir=ckpt + "/feed",
                  hist_dir=ckpt + "/hist", reducers=("count", "kalman"),
                  tsdb=True, tsdb_dir=ckpt + "/tsdb", tsdb_scrape_s=600.0,
                  quality=True, audit=True)
store = MemoryStore()
rt = MicroBatchRuntime(cfg, SyntheticSource(n_events=2048), store,
                       device="cpu")
assert rt.tsdb is not None and rt.quality is not None
assert rt.audit is not None
rt.run()
assert not any(rt.audit.residuals().values()), rt.audit.residuals()
assert store.n_tiles > 0 and store.n_positions > 0
# the read path over the run's writer-fed view, in process
app = make_wsgi_app(store, cfg, rt)
for path in ("/api/tiles/latest", "/api/tiles/delta", "/metrics",
             "/api/tiles/range", "/api/repl/meta", "/api/hist/index",
             "/api/tiles/forecast", "/debug/quality", "/debug/timeline",
             "/fleet/timeline", "/debug/audit", "/debug/delivery",
             "/fleet/metrics", "/fleet/healthz", "/fleet/freshness",
             "/fleet/delivery", "/fleet/audit", "/fleet/quality"):
    out = []
    body = b"".join(app({"PATH_INFO": path, "QUERY_STRING": "t0=0",
                         "REQUEST_METHOD": "GET"},
                        lambda st, h, e=None: out.append(st)))
    assert out[0].startswith("200") and body, (path, out)
app.close()
shutil.rmtree(cfg.checkpoint_dir)
del os.environ["HEATMAP_SUPERVISOR_CHANNEL"], os.environ["HEATMAP_DELIVERY"]

# the same run through the writer into Mongo over the wire client and the
# C++ encoders, and into the JSONL store
with MockMongod() as uri:
    for kind in ("mongo", "jsonl"):
        cfg = load_config({"HEATMAP_STORE": kind, "MONGO_URI": uri},
                          city="bos", h3_res=9, resolutions=(9,),
                          batch_size=1024, state_capacity_log2=12,
                          checkpoint_dir=tempfile.mkdtemp())
        store = make_store(cfg)
        rt = MicroBatchRuntime(cfg, SyntheticSource(n_events=2048), store,
                               device="cpu")
        rt.run()
        store.close()
        m = rt.metrics
        assert m["tiles_written"] > 0 and m["positions_written"] > 0, m
        shutil.rmtree(cfg.checkpoint_dir)

# the shard fleet, the governor, the heartbeat and the supervisor
import heatmap_tpu_torch.stream.govern
import heatmap_tpu_torch.stream.shardmap
import heatmap_tpu_torch.stream.supervisor
import heatmap_tpu_torch.testing.faults
from heatmap_tpu_torch.stream.source import RampSource
ckpt = tempfile.mkdtemp()
os.environ["HEATMAP_HEARTBEAT_FILE"] = ckpt + "/hb"
os.environ["HEATMAP_SUPERVISOR_CHANNEL"] = ckpt + "/channel.json"
store = MemoryStore()
for i in range(2):
    cfg = load_config({}, city="bos", h3_res=9, resolutions=(9,),
                      batch_size=1024, state_capacity_log2=12, shards=2,
                      shard_index=i, govern=True, govern_min_batch=256,
                      store="jsonl", checkpoint_dir=ckpt)
    shard_store = make_store(cfg)
    rt = MicroBatchRuntime(cfg, SyntheticSource(n_events=4096),
                           shard_store, device="cpu")
    rt.run()
    shard_store.close()
    assert rt.governor is not None and rt.counters["events_out_of_shard"]
assert os.path.exists(ckpt + "/hb")
assert make_store(load_config({"HEATMAP_SHARDS": "2"}, store="jsonl",
                              checkpoint_dir=ckpt), writer=False).n_tiles
assert RampSource([(10.0, 1.0)]).schedule
shutil.rmtree(ckpt)
del os.environ["HEATMAP_HEARTBEAT_FILE"], os.environ["HEATMAP_SUPERVISOR_CHANNEL"]
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "heatmap_tpu" or m.startswith("heatmap_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    p = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "LEAKED []" in p.stdout


def test_port_sources_name_no_jax_import():
    """No file of the port imports jax or heatmap_tpu (source scan)."""
    import ast

    offenders = []
    for path in sorted((REPO / "heatmap_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "heatmap_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders


# --- the entry point's default and the knobs (ROADMAP queue C, C1 and C2) ----

class _ParserSeen(Exception):
    pass


def _entry_parser(main, monkeypatch):
    """The argparse parser ``main`` builds, caught at its parse."""
    import argparse

    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["parser"] = self
        raise _ParserSeen

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_ParserSeen):
        main([])
    return {a.dest: a for a in seen["parser"]._actions}


def test_entry_point_default_pipeline_matches_jax(monkeypatch):
    """C1: both entry points default to the same pipeline
    (``mbta_default``) over the same choices."""
    from heatmap_tpu.stream import __main__ as jentry
    from heatmap_tpu_torch.stream import __main__ as tentry

    mine = _entry_parser(tentry.main, monkeypatch)["pipeline"]
    ref = _entry_parser(jentry.main, monkeypatch)["pipeline"]
    assert mine.default == ref.default == "mbta_default"
    assert list(mine.choices) == list(ref.choices)


# the knobs still refused name their exact slice, the mesh (A8); the
# sharded runtime's, the governor's and the supervisor's (A7b) load as in
# the reference since their slice
_KNOB_ITEMS = {"HEATMAP_SHARDS": None, "HEATMAP_SHARD_INDEX": None,
               "HEATMAP_GOVERN": None, "HEATMAP_HEARTBEAT_FILE": None,
               "HEATMAP_COORDINATOR": "A8,", "NUM_SHARDS": "A8,"}
_A7B_FIELDS = ("shards", "shard_index", "shard_res", "shard_oversample",
               "govern", "govern_interval_s", "govern_min_batch",
               "govern_max_flush_k", "govern_max_prefetch",
               "govern_healthy_frac")


@pytest.mark.parametrize("knob,on,off", [
    ("HEATMAP_SHARDS", "2", "1"),
    ("HEATMAP_SHARD_INDEX", "1", "0"),
    ("HEATMAP_GOVERN", "1", "0"),
    ("HEATMAP_HEARTBEAT_FILE", "heartbeat", ""),
    ("HEATMAP_COORDINATOR", "127.0.0.1:1234", ""),
    ("NUM_SHARDS", "2", "1"),
    ("NUM_SHARDS", "4", "0"),
])
def test_unported_knob_raises_by_name(knob, on, off):
    """C2: a knob that turns on a subsystem the port lacks raises, naming
    itself and the ROADMAP item that ports it; a knob of a ported slice
    (A7b) loads as the reference loads it, its fields equal; the "off"
    value loads in both packages."""
    item = _KNOB_ITEMS[knob]
    if item is None:
        # a shard index needs a fleet it lies in
        env = {knob: on, **({"HEATMAP_SHARDS": "2"}
                            if knob == "HEATMAP_SHARD_INDEX" else {})}
        mine, ref = load_config(env), jax_load_config(env)
        for f in _A7B_FIELDS:
            assert getattr(mine, f) == getattr(ref, f), (knob, f)
        assert (mine.shards, mine.shard_index, mine.govern) != (1, 0, False) \
            or knob == "HEATMAP_HEARTBEAT_FILE"
    else:
        with pytest.raises(NotImplementedError, match=knob) as e:
            load_config({knob: on})
        assert f"ROADMAP {item}" in str(e.value)
    load_config({knob: off})
    jax_load_config({knob: off})


# the telemetry time machine and the quality observatory (ROADMAP A6b,
# A5), integrity and delivery (A6c) and the fleet's channel (A7a): the
# knobs the port used to refuse load as in the reference
_A6B_A5_FIELDS = ("tsdb", "tsdb_dir", "tsdb_scrape_s", "tsdb_retain_s",
                  "tsdb_hot_s", "tsdb_flush_s", "slo_budget_frac",
                  "slo_budget_window_s", "quality", "quality_window_s",
                  "quality_lookback_s", "quality_mature_s", "quality_ttl_s",
                  "reducers", "audit", "audit_settle_s")


@pytest.mark.parametrize("env", [
    {"HEATMAP_TSDB": "1"},
    {"HEATMAP_TSDB": "0"},
    {"HEATMAP_TSDB": "true", "HEATMAP_TSDB_DIR": "tsdb",
     "HEATMAP_TSDB_SCRAPE_S": "0.5", "HEATMAP_TSDB_RETAIN_S": "7200",
     "HEATMAP_TSDB_HOT_S": "600", "HEATMAP_TSDB_FLUSH_S": "0",
     "HEATMAP_SLO_BUDGET_FRAC": "0.05",
     "HEATMAP_SLO_BUDGET_WINDOW_S": "3600"},
    {"HEATMAP_QUALITY": "1"},
    {"HEATMAP_QUALITY": "", "HEATMAP_REDUCERS": "count,kalman"},
    {"HEATMAP_QUALITY": "1", "HEATMAP_REDUCERS": "count,kalman",
     "HEATMAP_QUALITY_WINDOW_S": "60", "HEATMAP_QUALITY_LOOKBACK_S": "30",
     "HEATMAP_QUALITY_MATURE_S": "0", "HEATMAP_QUALITY_TTL_S": "0"},
    {"HEATMAP_TSDB": "1", "HEATMAP_QUALITY": "yes",
     "HEATMAP_REDUCERS": "kalman,count"},
    {"HEATMAP_AUDIT": "true"},
    {"HEATMAP_AUDIT": "false", "HEATMAP_AUDIT_SETTLE_S": "2.5"},
    {"HEATMAP_DELIVERY": " On"},
    {"HEATMAP_DELIVERY": "no"},
    {"HEATMAP_SUPERVISOR_CHANNEL": "channel.json"},
])
def test_observability_knob_loads_as_the_reference(env):
    """HEATMAP_TSDB, HEATMAP_QUALITY, HEATMAP_AUDIT (and their knobs),
    HEATMAP_DELIVERY and HEATMAP_SUPERVISOR_CHANNEL no longer raise: each
    loads the same config fields as the reference's load_config, and the
    delivery knob reads the same in both packages."""
    from heatmap_tpu.obs.delivery import delivery_enabled as jdelivery
    from heatmap_tpu_torch.obs.delivery import delivery_enabled

    cfg, ref = load_config(env), jax_load_config(env)
    assert ({f: getattr(cfg, f) for f in _A6B_A5_FIELDS}
            == {f: getattr(ref, f) for f in _A6B_A5_FIELDS})
    assert delivery_enabled(env) == jdelivery(env)


@pytest.mark.parametrize("env", [
    {"HEATMAP_TSDB_SCRAPE_S": "0"}, {"HEATMAP_TSDB_FLUSH_S": "-1"},
    {"HEATMAP_TSDB_RETAIN_S": "60"}, {"HEATMAP_SLO_BUDGET_FRAC": "0"},
    {"HEATMAP_SLO_BUDGET_FRAC": "1.5"},
    {"HEATMAP_SLO_BUDGET_WINDOW_S": "0"}, {"HEATMAP_QUALITY_WINDOW_S": "0"},
    {"HEATMAP_QUALITY_LOOKBACK_S": "-1"}, {"HEATMAP_QUALITY_MATURE_S": "-1"},
    {"HEATMAP_QUALITY_MATURE_S": "120", "HEATMAP_QUALITY_TTL_S": "60"},
    {"HEATMAP_AUDIT_SETTLE_S": "0"}])
def test_observability_knobs_validated_as_in_jax(env):
    with pytest.raises(ValueError) as ref:
        jax_load_config(env)
    with pytest.raises(ValueError) as mine:
        load_config(env)
    assert str(mine.value) == str(ref.value)


# the serve tier's second slice (ROADMAP A4b): the knobs the port used
# to refuse load as in the reference, from the env or as overrides
_A4B_FIELDS = ("serve_workers", "serve_core", "serve_loop_handlers",
               "repl_dir", "repl_feed", "repl_seg_bytes", "repl_segments",
               "repl_poll_ms", "hist_dir", "hist_retention_s",
               "hist_bucket_s", "hist_parent_res", "hist_compact_s",
               "hist_backfill")


def _a4b(cfg):
    return {f: getattr(cfg, f) for f in _A4B_FIELDS}


@pytest.mark.parametrize("env", [
    {},
    {"HEATMAP_REPL_DIR": "repl-feed"},
    {"HEATMAP_HIST_DIR": "history"},
    {"HEATMAP_REPL_FEED": "http://127.0.0.1:1"},
    {"HEATMAP_SERVE_CORE": "epoll"},
    {"HEATMAP_SERVE_WORKERS": "2"},
    {"HEATMAP_SERVE_LOOP_HANDLERS": "3", "HEATMAP_REPL_SEG_BYTES": "4096",
     "HEATMAP_REPL_SEGMENTS": "1", "HEATMAP_REPL_POLL_MS": "10",
     "HEATMAP_HIST_RETENTION_S": "60.5", "HEATMAP_HIST_BUCKET_S": "60",
     "HEATMAP_HIST_PARENT_RES": "0", "HEATMAP_HIST_COMPACT_S": "0.25",
     "HEATMAP_HIST_BACKFILL": "false"},
])
def test_serve_tier_knobs_load_as_in_jax(env):
    """The replication, history, epoll and fleet knobs load to the
    reference's values (they no longer raise)."""
    assert _a4b(load_config(env)) == _a4b(jax_load_config(env))


@pytest.mark.parametrize("field,value", [
    ("serve_core", "epoll"), ("serve_workers", 4), ("repl_dir", "feed"),
    ("hist_dir", "hist"), ("repl_feed", "feed")])
def test_serve_tier_fields_honoured_past_the_env(field, value):
    """Overrides and dataclasses.replace take the serve tier's values."""
    assert getattr(load_config({}, **{field: value}), field) == value
    assert getattr(dataclasses.replace(load_config({}), **{field: value}),
                   field) == value


@pytest.mark.parametrize("env", [
    {"HEATMAP_SERVE_WORKERS": "0"}, {"HEATMAP_SERVE_CORE": "uring"},
    {"HEATMAP_SERVE_LOOP_HANDLERS": "0"},
    {"HEATMAP_REPL_SEG_BYTES": "4095"}, {"HEATMAP_REPL_SEGMENTS": "0"},
    {"HEATMAP_REPL_POLL_MS": "9"}, {"HEATMAP_HIST_RETENTION_S": "0"},
    {"HEATMAP_HIST_BUCKET_S": "59"}, {"HEATMAP_HIST_PARENT_RES": "16"},
    {"HEATMAP_HIST_COMPACT_S": "0"}])
def test_serve_tier_knobs_validated_as_in_jax(env):
    with pytest.raises(ValueError) as ref:
        jax_load_config(env)
    with pytest.raises(ValueError) as mine:
        load_config(env)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("spec", ["count", "count,kalman", "kalman,count",
                                  " count , kalman , count "])
def test_reducers_knob_is_honoured(spec):
    """HEATMAP_REDUCERS loads in both packages to the same reducer set
    (inference is ported, so the knob no longer raises)."""
    want = jax_load_config({"HEATMAP_REDUCERS": spec}).reducers
    assert load_config({"HEATMAP_REDUCERS": spec}).reducers == want
    assert want[0] == "count"


class _Clock:
    """The time module, with ``sleep`` recorded instead of slept and
    ``monotonic`` a fake clock that moves 1 ms a read: the trigger interval
    is then measured on the loop's own reads, not on the wall time a busy
    machine spends compiling a runtime's first step (past 60 s, under a
    loaded parallel run, that step's sleep was skipped)."""

    def __init__(self):
        import time

        self._time, self.sleeps = time, []
        self._mono = time.monotonic()

    def sleep(self, s):
        self.sleeps.append(s)

    def monotonic(self):
        self._mono += 1e-3
        return self._mono

    def __getattr__(self, name):
        return getattr(self._time, name)


def test_trigger_ms_paces_as_in_jax(tmp_path, monkeypatch, default_env):
    """C2: with TRIGGER_MS each batch that progressed is followed by a
    sleep for what is left of the interval, and nothing else sleeps, as
    in the reference's ``run``."""
    from heatmap_tpu.stream import runtime as jruntime
    from heatmap_tpu_torch.stream import runtime as truntime

    env = {"TRIGGER_MS": "60000"}
    src = dict(n_events=3 * 512, n_vehicles=50, events_per_second=64)
    axes = dict(AXES, batch_size=512, state_capacity_log2=12)
    sleeps = {}
    for pkg, mod in (("port", truntime), ("jax", jruntime)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        if pkg == "port":
            cfg = load_config(env, checkpoint_dir=str(tmp_path / pkg), **axes)
            rt = MicroBatchRuntime(cfg, SyntheticSource(**src), MemoryStore(),
                                   device="cpu", checkpoint_every=0)
        else:
            cfg = jax_load_config(env, checkpoint_dir=str(tmp_path / pkg),
                                  store="memory", **axes)
            rt = JaxRuntime(cfg, JaxSyntheticSource(**src), JaxMemoryStore(),
                            checkpoint_every=0)
        assert cfg.trigger_ms == 60_000
        rt.run()
        sleeps[pkg] = clock.sleeps
    for got in sleeps.values():
        assert len(got) == 3 and all(0.0 < s <= 60.0 for s in got), got
    # and TRIGGER_MS=0 (the default) never sleeps after a batch
    clock = _Clock()
    monkeypatch.setattr(truntime, "time", clock)
    MicroBatchRuntime(load_config({}, checkpoint_dir=str(tmp_path / "zero"),
                                  **axes), SyntheticSource(**src),
                      MemoryStore(), device="cpu", checkpoint_every=0).run()
    assert clock.sleeps == []


# --- the serve tier's second slice: both runtimes publishing ------------------

def _feed_records(hmod, dirs):
    """Every record the run published, in seq order: the segments it
    retired into its history log and those its feed still holds."""
    recs = {}
    for d in (os.path.join(dirs["hist_dir"], "log"), dirs["repl_dir"]):
        for p in glob.glob(os.path.join(d, "seg-*.jsonl")):
            for rec in hmod._read_segment(p):
                recs[rec["seq"]] = rec
    return [recs[k] for k in sorted(recs)]


def _chunks(hmod, hist_dir):
    out = {}
    for p in sorted(glob.glob(os.path.join(hist_dir, "chunks", "*.hst"))):
        with open(p, "rb") as fh:
            meta, windows = hmod.decode_chunk(fh.read())
        out[os.path.basename(p)] = (meta, windows)
    return out


def _docs_close(mine, ref):
    """Ints and strings exact; floats under the module docstring's bars."""
    assert [d["cellId"] for d in mine] == [d["cellId"] for d in ref]
    for d, r in zip(mine, ref):
        assert d.keys() == r.keys(), d["cellId"]
        for k, v in d.items():
            if k == "centroid":
                for a, b in zip(v["coordinates"],
                                r[k]["coordinates"]):
                    assert abs(a - b) <= 1e-5, (d["cellId"], a, b)
            elif isinstance(v, float):
                assert v == pytest.approx(r[k], rel=1e-6, abs=1e-9), k
            else:
                assert v == r[k], (d["cellId"], k)


def test_runtimes_publish_equal_feeds_and_chunks(tmp_path, monkeypatch):
    """Both runtimes with HEATMAP_REPL_DIR and HEATMAP_HIST_DIR over the
    same stream (HEATMAP_H3_IMPL=native, shared host keys): the same
    feed records (kinds, seqs, cells, counts exact; floats under the
    bars), the same chunk files holding the same windows, and a range
    over the run's span that conserves every event in both apps."""
    from heatmap_tpu.query import history as jhist
    from heatmap_tpu.serve import api as japi
    from heatmap_tpu_torch.query import history as thist
    from heatmap_tpu_torch.serve import api as tapi
    from test_torch_serve import call

    _pin_reference(monkeypatch, {})
    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    t0 = int(time.time()) - 1800
    src = dict(SOURCE_ARGS, t0=t0)
    dirs = {pkg: dict(repl_dir=str(tmp_path / pkg / "feed"),
                      hist_dir=str(tmp_path / pkg / "hist"))
            for pkg in ("port", "jax")}
    jcfg = jax_load_config(None, checkpoint_dir=str(tmp_path / "jck"),
                           store="memory", state_max_log2=CAP_LOG2,
                           **dirs["jax"], **AXES)
    jrt = JaxRuntime(jcfg, JaxSyntheticSource(**src), JaxMemoryStore(),
                     checkpoint_every=0)
    jrt.run()
    cfg = load_config(None, checkpoint_dir=str(tmp_path / "tck"),
                      **dirs["port"], **AXES)
    rt = MicroBatchRuntime(cfg, SyntheticSource(**src), MemoryStore(),
                           device="cpu", checkpoint_every=0)
    rt.run()
    assert rt.repl_pub is not None and rt.hist_compactor is not None
    recs = _feed_records(thist, dirs["port"])
    jrecs = _feed_records(jhist, dirs["jax"])
    assert len(recs) == len(jrecs) == rt.matview.seq == jrt.matview.seq
    assert [r["seq"] for r in recs] == list(range(1, len(recs) + 1))
    for r, j in zip(recs, jrecs):
        assert (r["kind"], r["seq"]) == (j["kind"], j["seq"])
        _docs_close(r.get("docs") or [], j.get("docs") or [])
    chunks = _chunks(thist, dirs["port"]["hist_dir"])
    jchunks = _chunks(jhist, dirs["jax"]["hist_dir"])
    assert chunks.keys() == jchunks.keys() and chunks
    for name, (meta, windows) in chunks.items():
        jmeta, jwindows = jchunks[name]
        for m in (meta, jmeta):
            for wm in m["windows"].values():
                wm.pop("digest"), wm.pop("epoch")
        assert meta == jmeta, name
        assert windows.keys() == jwindows.keys()
        for ws in windows:
            _docs_close(windows[ws]["docs"], jwindows[ws]["docs"])
    # conservation through the history routes, both packages
    qs = f"t0={t0 - 3600}&t1={t0 + 7200}"
    for app, close in ((tapi.make_wsgi_app(rt.store, cfg, rt),
                        "close"),
                       (japi.make_wsgi_app(jrt.store, jcfg, jrt),
                        "close_repl")):
        try:
            s, _, b = call(app, "/api/tiles/range", qs)
            agg = json.loads(b)["aggregate"]["features"]
            assert sum(f["properties"]["count"] for f in agg) == N_EVENTS
        finally:
            getattr(app, close)()
