"""The port's multi-pair runtime against the JAX package's, under the axes
of BASELINE configs #4 (``hex_pyramid``: res 7/8/9 x 5 min) and #5
(``multi_window``: res 8 x 1/5/15 min).

Both runtimes fold one small ``SyntheticSource`` stream (12 batches of
1024 events, 3000 vehicles, over ~25 minutes of event time for the
pyramid and ~13 for the windows, whose 1-minute pair then holds enough
groups to grow the slab: 1-, 5- and 15-minute windows close and evict, and
the shared 2^13-row slab grows) into a ``MemoryStore``, once with each
package's defaults (growth on, an emit ring 8 batches deep, the fast path
over auto) and once pinned
(HEATMAP_MERGE_IMPL=sort, HEATMAP_FASTPATH=0, HEATMAP_EMIT_FLUSH_K=1,
which both packages read).  The reference's snap is pinned to
HEATMAP_H3_IMPL=xla.

Bars, per (res, window) pair (those of ``test_torch_stream.py``'s
``assert_docs_match``, at each pair's own res and window):

- at most 0.2% of the events may snap differently at that res, counted
  event by event;
- the docs of every (cell, window) that no such event touches: the same
  set on both sides, ``_id`` and counts exact, average and stddev of
  speed and p95 within 1e-6 relative, centroid within 1e-5 degrees;
- the counts summed over the pair's docs equal the events on both sides;
- the run's counters (events valid and late, overflow), its growths, its
  slab capacity and its flushes by trigger are equal.

A 3-pair commit of either package resumes in the other to the
uninterrupted run's docs, under the same bars.  This file holds the
multi-window's tests; ``test_torch_pyramid.py`` runs the same checks under
the pyramid's axes.

The registry and the entry point: each preset's config equals the JAX
package's under the same environment, and ``python -m
heatmap_tpu_torch.stream`` runs each live pipeline on the CPU, over the
reference's synthetic fallback or a live mock-broker topic.
"""

import copy
import functools
import json
import shutil
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.hexgrid import device as jdev
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import SyntheticSource as JaxSyntheticSource
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.hexgrid import snap_kernel
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
from test_torch_stream import REPO, _pin_reference

STREAM = dict(n_events=12 * 1024, n_vehicles=3000, events_per_second=8,
              t0=1_700_000_000)
STREAMS = {"pyramid": STREAM, "windows": dict(STREAM, events_per_second=16)}
N_EVENTS = STREAM["n_events"]
SMALL = dict(city="bos", h3_res=8, tile_minutes=5, batch_size=1024,
             state_capacity_log2=13, speed_hist_bins=64)
AXES = {"pyramid": dict(SMALL, resolutions=(7, 8, 9), windows_minutes=(5,)),
        "windows": dict(SMALL, resolutions=(8,), windows_minutes=(1, 5, 15))}
PINNED = {"HEATMAP_MERGE_IMPL": "sort", "HEATMAP_FASTPATH": "0",
          "HEATMAP_EMIT_FLUSH_K": "1"}
TRIGGERS = ("full", "watermark", "grow", "checkpoint", "idle", "close")


# --- the bars ----------------------------------------------------------------

def snap_touched(lat_rad, lng_rad, ts_s, res, win_s):
    """(cell id, window start) pairs touched by events that the port's
    snap (the runtime's own route) and the reference's XLA snap place
    differently at ``res``, and the share of such events."""
    hi, lo = jdev.latlng_to_cell_vec(lat_rad, lng_rad, res)
    ref = jdev.cells_to_uint64(hi, lo)
    th, tl = snap_kernel.latlng_to_cell_kernel(
        torch.from_numpy(lat_rad), torch.from_numpy(lng_rad), res)
    mine = jdev.cells_to_uint64(th.numpy().view(np.uint32),
                                tl.numpy().view(np.uint32))
    bad = np.nonzero(ref != mine)[0]
    ws = (ts_s.astype(np.int64) // win_s) * win_s
    touched = set()
    for i in bad:
        for cell in (ref[i], mine[i]):
            touched.add((format(int(cell), "x"), int(ws[i])))
    return touched, len(bad) / max(len(lat_rad), 1)


@functools.lru_cache(maxsize=None)
def _stream_touched(name, res, win_s):
    cols = SyntheticSource(**STREAMS[name]).poll(N_EVENTS)
    return snap_touched(cols.lat_rad, cols.lng_rad, cols.ts_s, res, win_s)


def touched_fn(name):
    return functools.partial(_stream_touched, name)


def assert_pair_docs_match(ref_docs, docs, cfg, n_events, touched_fn,
                           min_windows=2):
    """The module docstring's bars, pair by pair; ``touched_fn(res,
    win_s)`` gives the pair's snap-disagreement set and share."""
    for res in cfg.resolutions:
        for wmin in cfg.windows_minutes:
            grid = cfg.pair_grid(res, wmin)
            touched, bad_share = touched_fn(res, wmin * 60)
            assert bad_share <= 0.002, (grid, bad_share)
            key = lambda d: (d["cellId"], int(d["windowStart"].timestamp()))
            ref = {key(d): d for d in ref_docs.values() if d["grid"] == grid}
            mine = {key(d): d for d in docs.values() if d["grid"] == grid}
            assert len({k[1] for k in mine}) >= min_windows, grid
            assert sum(d["count"] for d in mine.values()) == n_events, grid
            assert sum(d["count"] for d in ref.values()) == n_events, grid
            clean_ref = {k: d for k, d in ref.items() if k not in touched}
            clean = {k: d for k, d in mine.items() if k not in touched}
            assert clean.keys() == clean_ref.keys(), grid
            assert len(clean) >= len(ref) - 2 * len(touched), grid
            for k, d in clean.items():
                r = clean_ref[k]
                assert d["_id"] == r["_id"] and d["count"] == r["count"], k
                for f in ("avgSpeedKmh", "stddevSpeedKmh", "p95SpeedKmh"):
                    assert d[f] == pytest.approx(r[f], rel=1e-6, abs=1e-9), \
                        (k, f)
                for a, b in zip(d["centroid"]["coordinates"],
                                r["centroid"]["coordinates"]):
                    assert abs(a - b) <= 1e-5, (k, a, b)
                for f in ("windowEnd", "staleAt", "windowMinutes"):
                    assert d.get(f) == r.get(f), (k, f)


# --- the runs ----------------------------------------------------------------

def count_jax_flushes(jrt) -> Counter:
    """The JAX runtime's flushes by trigger, named as the port's ``pulls``
    names them.  The JAX runtime counts flushes but not why; its
    ``flush_pending`` is wrapped on this instance, and each call that
    finds batches parked is classified by its caller: the step loop's
    idle poll (no entry), its pressure test (ring full, then watermark,
    then growth, in the loop's order), the checkpoint or close."""
    reasons = Counter()
    orig = jrt.flush_pending

    def flush_pending():
        if len(jrt._ring):
            caller = sys._getframe(1)
            name = caller.f_code.co_name
            if name == "_step_once_inner":
                name = ("idle" if caller.f_locals.get("entry") is None
                        else "full" if jrt._ring.full
                        else "watermark" if jrt._wm_flush_due()
                        else "grow")
            elif name == "_checkpoint":
                name = "checkpoint"
            reasons[name] += 1
        return orig()

    jrt.flush_pending = flush_pending
    return reasons


def jax_runtime(ckpt, name, store, every=20):
    cfg = jax_load_config(None, checkpoint_dir=str(ckpt), store="memory",
                          **AXES[name])
    jrt = JaxRuntime(cfg, JaxSyntheticSource(**STREAMS[name]), store,
                     checkpoint_every=every)
    return jrt, count_jax_flushes(jrt)


def port_runtime(ckpt, name, store, every=20, **axes):
    cfg = load_config(None, checkpoint_dir=str(ckpt),
                      **dict(AXES[name], **axes))
    return MicroBatchRuntime(cfg, SyntheticSource(**STREAMS[name]), store,
                             device="cpu", checkpoint_every=every)


_JAX_RUNS: dict = {}


def jax_run(tmp_path_factory, name, pinned):
    """The JAX runtime's uninterrupted run (cached for the module):
    (docs, counters, flushes by trigger, slab rows, max_event_ts)."""
    key = (name, pinned)
    if key not in _JAX_RUNS:
        store = JaxMemoryStore()
        jrt, reasons = jax_runtime(tmp_path_factory.mktemp("jax"), name,
                                   store)
        jrt.run()
        _JAX_RUNS[key] = (store._tiles, dict(jrt.metrics.counters),
                          {t: reasons[t] for t in TRIGGERS},
                          jrt._multi.capacity_per_shard, jrt.max_event_ts)
    return _JAX_RUNS[key]


def port_flushes(rt) -> dict:
    return {t: rt.pulls[t] for t in TRIGGERS}


# The checks, one set per axes: the windows' tests are below, the
# pyramid's in test_torch_pyramid.py (the two files' JAX compiles run on
# separate test workers).

def check_runtime_matches_jax(tmp_path, tmp_path_factory, monkeypatch,
                              name, pinned):
    _pin_reference(monkeypatch, PINNED if pinned else {})
    ref_docs, jc, jflushes, jcap, jmax = jax_run(tmp_path_factory, name,
                                                 pinned)
    store = MemoryStore()
    rt = port_runtime(tmp_path / "port", name, store)
    rt.run()
    assert rt.cfg.emit_flush_k == (1 if pinned else 8)
    assert_pair_docs_match(ref_docs, store._tiles, rt.cfg, N_EVENTS,
                           touched_fn(name))
    c = rt.counters
    assert c["events_valid"] == jc["events_valid"] == N_EVENTS
    assert c["events_late"] == jc.get("events_late", 0)
    assert c["state_overflow"] == jc.get("state_overflow_groups", 0) == 0
    # growth on the capacity the pairs share, and the flushes by trigger
    assert c["state_grown"] == jc.get("state_grown", 0) >= 1
    assert rt.multi.capacity_per_shard == jcap == 1 << 14
    assert port_flushes(rt) == jflushes
    assert rt.pulls["flushes"] == jc["emit_pulls"]
    assert rt.pulls["batches"] == jc["emit_pull_batches"]
    # K=1: the ring is full at every step, which the loop tests first
    assert (rt.pulls["full"] if pinned else rt.pulls["watermark"]) > 0
    assert rt.max_event_ts == jmax
    assert c["checkpoints"] == jc["checkpoints"]


def check_each_pair_equals_its_one_pair_run(tmp_path, monkeypatch, name):
    """Each pair's docs of a 3-pair run equal, exactly, those of a run of
    that one pair over the same stream (``chip_smoke.py`` holds the
    presets to the same on the card)."""
    _pin_reference(monkeypatch, {})
    store = MemoryStore()
    rt = port_runtime(tmp_path / name, name, store)
    rt.run()
    for res, win_s in rt.pairs:
        one = MemoryStore()
        port_runtime(tmp_path / f"{name}-{res}-{win_s}", name, one,
                     resolutions=(res,),
                     windows_minutes=(win_s // 60,)).run()
        grid = rt.cfg.pair_grid(res, win_s // 60)
        mine = {k: d for k, d in store._tiles.items() if d["grid"] == grid}
        assert mine and mine == one._tiles, (name, grid)


def _killed_after_commit(rt, batches=6):
    """``batches`` batches (a commit every 4), the commit joined, the
    runtime abandoned."""
    for _ in range(batches):
        assert rt.step_once()
    rt._ckpt_join()


def check_jax_commit_resumed_by_the_port(tmp_path, tmp_path_factory,
                                         monkeypatch, name):
    _pin_reference(monkeypatch, {})
    ref_docs = jax_run(tmp_path_factory, name, False)[0]
    batch = AXES[name]["batch_size"]
    jstore = JaxMemoryStore()
    jrt, _ = jax_runtime(tmp_path / "a", name, jstore, every=4)
    _killed_after_commit(jrt)
    jrt.writer.drain()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    # the port resumes the JAX commit on the surviving docs ...
    store = MemoryStore()
    store.upsert_tiles(copy.deepcopy(list(jstore._tiles.values())))
    rt = port_runtime(tmp_path / "a", name, store, every=0)
    assert rt.epoch == 4 and rt.source.offset() == 4 * batch
    assert len(rt.pairs) == 3
    rt.run()
    assert rt.counters["events_valid"] == N_EVENTS - 4 * batch
    assert_pair_docs_match(ref_docs, store._tiles, rt.cfg, N_EVENTS,
                           touched_fn(name))
    # ... and grows and flushes as the JAX runtime does resuming it
    jstore2 = JaxMemoryStore()
    jstore2.upsert_tiles(copy.deepcopy(list(jstore._tiles.values())))
    jrt2, reasons = jax_runtime(tmp_path / "b", name, jstore2, every=0)
    jrt2.run()
    assert port_flushes(rt) == {t: reasons[t] for t in TRIGGERS}
    assert rt.multi.capacity_per_shard == jrt2._multi.capacity_per_shard
    assert rt.max_event_ts == jrt2.max_event_ts


def check_port_commit_resumed_by_jax(tmp_path, tmp_path_factory,
                                     monkeypatch, name):
    _pin_reference(monkeypatch, {})
    ref_docs = jax_run(tmp_path_factory, name, False)[0]
    batch = AXES[name]["batch_size"]
    store = MemoryStore()
    rt = port_runtime(tmp_path / "a", name, store, every=4)
    _killed_after_commit(rt)
    meta = rt.ckpt.load_meta()
    assert meta["epoch"] == 4 and meta["snap_impl"] == "pallas"
    assert len(rt.ckpt.load_state(*rt.pairs[0]).key_hi) == \
        rt.multi.capacity_per_shard
    jstore = JaxMemoryStore()
    jstore.upsert_tiles(copy.deepcopy(list(store._tiles.values())))
    jrt, _ = jax_runtime(tmp_path / "a", name, jstore, every=0)
    assert jrt.epoch == 4 and jrt.source.offset() == 4 * batch
    jrt.run()
    assert_pair_docs_match(ref_docs, jstore._tiles, rt.cfg, N_EVENTS,
                           touched_fn(name))
    assert jrt.metrics.counters.get("state_overflow_groups", 0) == 0


@pytest.mark.parametrize("pinned", [False, True], ids=["defaults", "pinned"])
def test_multi_window_runtime_matches_jax(tmp_path, tmp_path_factory,
                                          monkeypatch, pinned):
    check_runtime_matches_jax(tmp_path, tmp_path_factory, monkeypatch,
                              "windows", pinned)


def test_multi_window_pairs_equal_their_one_pair_runs(tmp_path,
                                                      monkeypatch):
    check_each_pair_equals_its_one_pair_run(tmp_path, monkeypatch,
                                            "windows")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_multi_window_commit_resumes_across_packages(
        tmp_path, tmp_path_factory, monkeypatch, writer):
    check = (check_jax_commit_resumed_by_the_port if writer == "jax"
             else check_port_commit_resumed_by_jax)
    check(tmp_path, tmp_path_factory, monkeypatch, "windows")


# --- the pipeline registry and the entry point ------------------------------

PRESET_ENVS = {
    "bare": {},
    "env": {"H3_RES": "9", "TILE_MINUTES": "1", "BATCH_SIZE": "2048",
            "STATE_CAPACITY_LOG2": "12", "SPEED_HIST_BINS": "32",
            "KAFKA_BOOTSTRAP": "broker-a:9093,broker-b",
            "KAFKA_TOPIC": "positions.test", "CITY": "ath",
            "WATERMARK_MINUTES": "3"},
}


@pytest.fixture
def rebuilt_pipelines(monkeypatch):
    """Both packages' pipeline registries rebuilt under a given env (they
    read it at import, as the reference's do), and rebuilt again under the
    test's own env afterwards."""
    import importlib

    from heatmap_tpu.models import pipelines as jpipes
    from heatmap_tpu_torch.models import pipelines as tpipes

    def build(env):
        for k in ("H3_RES", "TILE_MINUTES", "BATCH_SIZE",
                  "STATE_CAPACITY_LOG2", "SPEED_HIST_BINS", "H3_RESOLUTIONS",
                  "WINDOW_MINUTES", "KAFKA_BOOTSTRAP", "KAFKA_TOPIC", "CITY",
                  "WATERMARK_MINUTES"):
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("CHECKPOINT", "/nonexistent/ckpt")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        return importlib.reload(jpipes), importlib.reload(tpipes)

    yield build
    monkeypatch.undo()
    importlib.reload(jpipes)
    importlib.reload(tpipes)


@pytest.mark.parametrize("env", sorted(PRESET_ENVS))
@pytest.mark.parametrize("name", ["mbta_default", "opensky_global",
                                  "synthetic_backfill", "hex_pyramid",
                                  "multi_window"])
def test_presets_match_jax_presets(rebuilt_pipelines, name, env):
    """Each preset's config equals the JAX package's, field by field, for
    every field the port has, under the same environment."""
    import dataclasses

    jpipes, tpipes = rebuilt_pipelines(PRESET_ENVS[env])
    assert sorted(tpipes.PIPELINES) == sorted(jpipes.PIPELINES)
    mine = tpipes.get_pipeline(name)
    ref = jpipes.get_pipeline(name)
    assert mine.description == ref.description
    for f in dataclasses.fields(mine.config):
        assert getattr(mine.config, f.name) == getattr(ref.config, f.name), \
            f.name
    if name == "mbta_default":
        # nothing pinned but the city: the axes follow the env
        assert mine.config.city == "bos"
        assert mine.config.resolutions == (mine.config.h3_res,)
        assert mine.config.windows_minutes == (mine.config.tile_minutes,)


def _entry_env(tmp_path, **extra):
    import os

    env = {k: v for k, v in os.environ.items() if k not in (
        "PYTHONSTARTUP", "HEATMAP_FEEDER", "HEATMAP_EVENT_FORMAT",
        "HEATMAP_KAFKA_IMPL")}
    # the live presets take their batch and slab from the env (a small
    # batch here); opensky_global pins its own 2^19-row slab.  The store
    # is named: HEATMAP_STORE=auto would try a Mongo server on 27017
    env.update({"BATCH_SIZE": "1024", "STATE_CAPACITY_LOG2": "12",
                "CHECKPOINT": str(tmp_path / "ckpt"), "JAX_PLATFORMS": "cpu",
                "HEATMAP_STORE": "memory", **extra})
    return env


def _run_entry(env, name, timeout=300):
    """``python -m heatmap_tpu_torch.stream [name] --device cpu
    --max-batches 2``; no name takes the entry point's default."""
    import subprocess

    p = subprocess.run(
        [sys.executable, "-m", "heatmap_tpu_torch.stream",
         *([name] if name else []), "--device", "cpu", "--max-batches", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p.stderr


@pytest.mark.parametrize("name", ["mbta_default", "opensky_global",
                                  "hex_pyramid", "multi_window"])
def test_entry_point_runs_each_live_pipeline_on_the_cpu(tmp_path, name):
    """``python -m heatmap_tpu_torch.stream <name> --device cpu
    --max-batches 2`` with no broker: the reference's synthetic fallback,
    two batches stepped and the one prefetched behind them folded at
    close (as the reference's close does: a bounded run loses nothing it
    polled), the metrics line printed."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    closed = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    out, err = _run_entry(_entry_env(tmp_path, KAFKA_BOOTSTRAP=closed), name)
    assert "kafka unreachable" in err and "using synthetic source" in err
    assert out["pipeline"] == name and out["device"] == "cpu"
    assert out["source"] == "SyntheticSource"
    assert out["batches"] == 3 and out["events_valid"] == 3 * 1024
    assert out["tiles"] > 0 and out["state_overflow"] == 0
    assert out["checkpoints"] == 1


def test_entry_point_defaults_to_mbta_default_into_the_jsonl_store(
        tmp_path):
    """No pipeline named: ``mbta_default`` (here on its synthetic
    fallback), with HEATMAP_STORE=jsonl writing ``<CHECKPOINT>/
    store.jsonl``, which reloads to the docs the run reports."""
    import socket

    from heatmap_tpu_torch.sink import JsonlStore

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    closed = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    out, _ = _run_entry(_entry_env(tmp_path, KAFKA_BOOTSTRAP=closed,
                                   HEATMAP_STORE="jsonl"), None)
    assert out["pipeline"] == "mbta_default" and out["store"] == "JsonlStore"
    assert out["tiles"] > 0 and out["positions"] > 0
    assert out["tiles_written"] >= out["tiles"]
    assert out["positions_written"] == out["positions_emitted"] > 0
    store = JsonlStore(str(tmp_path / "ckpt"))
    assert (store.n_tiles, store.n_positions) == (out["tiles"],
                                                  out["positions"])
    store.close()


def test_entry_point_reads_a_live_kafka_topic(tmp_path):
    """The same entry point against a broker that a producer feeds while
    it runs: the source starts at LATEST, folds two batches (and the one
    prefetched, if any) of what arrives after it started, and prints the
    source's counters."""
    import threading

    from heatmap_tpu_torch.kafka import KafkaClient, Record
    from heatmap_tpu_torch.testing.mock_kafka import MockKafkaBroker

    stop = threading.Event()
    with MockKafkaBroker() as bootstrap:
        def produce():
            c = KafkaClient(bootstrap)
            i = 0
            while not stop.is_set():
                recs = [Record(0, 0, None, json.dumps({
                    "provider": "mbta", "vehicleId": f"v{j % 40}",
                    "lat": 42.35 + (j % 50) * 1e-3, "lon": -71.06,
                    "speedKmh": 30.0, "ts": 1_700_000_000 + j}).encode())
                    for j in range(i, i + 100)]
                c.produce("mobility.positions.v1", i // 100 % 3, recs)
                i += 100
                stop.wait(0.05)
            c.close()

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            out, _ = _run_entry(_entry_env(tmp_path,
                                           KAFKA_BOOTSTRAP=bootstrap),
                                "mbta_default")
        finally:
            stop.set()
            t.join()
    assert out["source"] == "KafkaSource" and out["batches"] in (2, 3)
    assert 0 < out["events_valid"] <= 3 * 1024
    assert out["kafka_fetch_errors"] == out["kafka_offset_resets"] == 0
    assert out["kafka_discover_errors"] == 0
    assert out["p50_span_ms"]["fetch"] > 0
