"""Checkpoints and resume: the port's ``CheckpointManager`` and runtime
against the JAX package's, and against themselves.

- The on-disk format both ways: a commit either package writes reads in
  the other with identical arrays, dtypes and meta keys; a torn ``.tmp``
  is ignored, commits prune to two, an older layout refuses.
- Counterparts of ``tests/test_stream.py`` and ``tests/test_emit_ring.py``
  for the port's runtime: resume, resume across a capacity change, a
  refused shard-count change, a crash between poll and dispatch with the
  prefetch on, the background commit and its errors, the flush forced
  before a commit, replay equivalence after a restore mid-interval.
- A process killed after a commit and a few batches, resumed by a new
  runtime on the surviving store: exactly the uninterrupted run's docs
  and slab.
- Cross-package resume, both ways: a JAX commit resumed by the port and a
  port commit resumed by the JAX runtime, against an uninterrupted JAX
  run under the bars of ``tests/test_torch_stream.py::assert_docs_match``;
  resumed from the same commit, both runtimes flush the same number of
  times (the watermark-pressure tracker restarts from nothing after a
  resume in both).
"""

import copy
import json
import os
import pickle
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import SyntheticSource as JaxSyntheticSource
from heatmap_tpu.stream.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.engine import state as tstate
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream import checkpoint as tckpt
from heatmap_tpu_torch.stream.checkpoint import CheckpointManager
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
from test_torch_stream import (AXES, SOURCE_ARGS, _pin_reference,
                               assert_docs_match)

REPO = Path(__file__).resolve().parents[1]
PAIR = (9, 300)


def mk_cfg(tmp_path, **over):
    """The reference tests' small config (tests/test_stream.py::mk_cfg)."""
    base = dict(city="bos", h3_res=9, resolutions=(9,), batch_size=512,
                state_capacity_log2=13, speed_hist_bins=8,
                checkpoint_dir=str(tmp_path / "ckpt"))
    base.update(over)
    return load_config({}, **base)


def folded_slab(tmp_path):
    """A real host slab (reference layout) after two batches."""
    rt = MicroBatchRuntime(mk_cfg(tmp_path, checkpoint_dir=str(
        tmp_path / "slab")), SyntheticSource(n_events=1024, n_vehicles=60),
        MemoryStore(), device="cpu", checkpoint_every=0)
    rt.step_once()
    rt.step_once()
    return rt.aggs[PAIR].snapshot()


def assert_states_identical(a, b):
    for name, x, y in zip(tstate.TileState._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


def assert_slabs_equal(rt_a, rt_b):
    for pair in rt_a.pairs:
        for x, y in zip(rt_a.aggs[pair].state, rt_b.aggs[pair].state):
            assert torch.equal(x, y)


# --- the on-disk format ------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_format_both_ways(tmp_path, writer):
    """A commit written by one package reads in the other: identical
    arrays and dtypes (key words uint32), identical meta."""
    st = folded_slab(tmp_path)
    assert st.key_hi.dtype == np.uint32
    d = str(tmp_path / "c")
    meta_in = dict(offset=1024, max_event_ts=1_700_000_123, epoch=7,
                   shards=1, snap_impl="torch")
    if writer == "port":
        CheckpointManager(d).commit(
            meta_in["offset"], meta_in["max_event_ts"], meta_in["epoch"],
            {PAIR: st}, shards=1, snap_impl="torch")
    else:
        JaxCheckpointManager(d).commit(
            meta_in["offset"], meta_in["max_event_ts"], meta_in["epoch"],
            {PAIR: st}, shards=1, snap_impl="torch")
    for mgr in (CheckpointManager(d), JaxCheckpointManager(d)):
        assert mgr.load_meta() == meta_in
        assert mgr.available_epochs() == [7]
        assert_states_identical(mgr.load_state(*PAIR), st)
        assert mgr.load_state(8, 300) is None
    names = sorted(os.listdir(os.path.join(d, "commit-000000000007")))
    assert names == ["meta.json", "state-9-300.npz"]


def test_jax_extras_read_by_the_port(tmp_path):
    d = str(tmp_path / "c")
    extra = {"ids": np.arange(5, dtype=np.int64),
             "x": np.linspace(0, 1, 5).astype(np.float32)}
    JaxCheckpointManager(d).commit(1, 2, 3, {}, shards=1,
                                   extras={"infer": extra})
    got = CheckpointManager(d).load_extra("infer")
    assert got.keys() == extra.keys()
    for k in extra:
        assert got[k].dtype == extra[k].dtype
        np.testing.assert_array_equal(got[k], extra[k])
    assert CheckpointManager(d).load_extra("quality") is None


def test_torn_commit_is_ignored_and_commits_prune_to_two(tmp_path):
    st = folded_slab(tmp_path)
    d = str(tmp_path / "c")
    mgr = CheckpointManager(d)
    assert mgr.load_meta() is None and mgr.load_state(*PAIR) is None
    for epoch in (1, 2, 3):
        mgr.commit(epoch * 512, 100 + epoch, epoch, {PAIR: st}, shards=1)
    assert mgr.available_epochs() == [2, 3]
    assert tckpt.KEEP_COMMITS == 2
    # a crash mid-commit leaves a torn .tmp dir: LATEST still names 3
    torn = os.path.join(d, "commit-000000000004.tmp")
    os.makedirs(torn)
    with open(os.path.join(torn, "meta.json"), "w") as fh:
        fh.write("{")
    for m in (CheckpointManager(d), JaxCheckpointManager(d)):
        assert m.load_meta()["epoch"] == 3
        assert m.available_epochs() == [2, 3]
    assert mgr.load_meta(epoch=2)["offset"] == 1024
    # the next commit of that epoch replaces the torn dir
    mgr.commit(4 * 512, 104, 4, {PAIR: st}, shards=1)
    assert mgr.available_epochs() == [3, 4]
    assert not os.path.exists(torn)


def test_old_layout_refused(tmp_path):
    st = folded_slab(tmp_path)
    d = str(tmp_path / "c")
    CheckpointManager(d).commit(0, 0, 1, {PAIR: st}, shards=1)
    path = os.path.join(d, "commit-000000000001", "state-9-300.npz")
    # a layout without the per-group anchors
    np.savez(path, **{k: v for k, v in st._asdict().items()
                      if not k.startswith("anchor_")})
    with pytest.raises(ValueError, match="older state layout"):
        CheckpointManager(d).load_state(*PAIR)


# --- the runtime: counterparts of tests/test_stream.py -------------------------

def test_checkpoint_resume(tmp_path):
    cfg = mk_cfg(tmp_path)
    src = SyntheticSource(n_events=2048, n_vehicles=50, events_per_second=512)
    rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                           checkpoint_every=1)
    for _ in range(2):
        rt.step_once()
    rt._checkpoint()
    rt._ckpt_join()
    # the prefetch polled batch 3; the commit covers the dispatched two
    assert src.offset() == 1536
    assert rt._offsets_dispatched == 1024
    assert rt.ckpt.load_meta() == {"offset": 1024, "epoch": 2, "shards": 1,
                                   "snap_impl": "native",
                                   "max_event_ts": rt.max_event_ts}

    src2 = SyntheticSource(n_events=2048, n_vehicles=50,
                           events_per_second=512)
    rt2 = MicroBatchRuntime(cfg, src2, MemoryStore(), device="cpu",
                            checkpoint_every=0)
    assert src2.offset() == 1024
    assert rt2.epoch == rt.epoch == 2
    assert rt2.max_event_ts == rt.max_event_ts
    rt2.run()
    assert src2.exhausted

    cfg3 = mk_cfg(tmp_path, checkpoint_dir=str(tmp_path / "ckpt3"))
    rt3 = MicroBatchRuntime(cfg3, SyntheticSource(
        n_events=2048, n_vehicles=50, events_per_second=512), MemoryStore(),
        device="cpu", checkpoint_every=0)
    rt3.run()
    assert_slabs_equal(rt2, rt3)


def test_resume_across_capacity_change(tmp_path):
    """A grown run's commit restores into a smaller configuration (the
    slab grows to match) and into a larger one (padded up)."""
    cfg = mk_cfg(tmp_path, state_capacity_log2=6, state_max_log2=12,
                 batch_size=128)
    src = lambda: SyntheticSource(n_events=1024, n_vehicles=400,
                                  events_per_second=128)
    rt = MicroBatchRuntime(cfg, src(), MemoryStore(), device="cpu",
                           checkpoint_every=1)
    for _ in range(4):
        rt.step_once()
    rt._checkpoint()
    rt._ckpt_join()
    grown_cap = rt.multi.capacity_per_shard
    assert grown_cap > 256          # past the startup floor
    rt.close()
    assert rt.multi.capacity_per_shard == grown_cap

    rt2 = MicroBatchRuntime(cfg, src(), MemoryStore(), device="cpu",
                            checkpoint_every=0)
    assert rt2.multi.capacity_per_shard == grown_cap
    committed = rt2.ckpt.load_state(*rt2.pairs[0])
    assert_states_identical(rt2.aggs[rt2.pairs[0]].snapshot(), committed)
    rt2.run()
    assert rt2.source.exhausted

    cfg3 = mk_cfg(tmp_path, state_capacity_log2=11, state_max_log2=12,
                  batch_size=128)
    committed = CheckpointManager(cfg3.checkpoint_dir).load_state(
        *rt2.pairs[0])
    assert committed.key_hi.shape[0] < 2048
    rt3 = MicroBatchRuntime(cfg3, src(), MemoryStore(), device="cpu",
                            checkpoint_every=0)
    assert rt3.multi.capacity_per_shard == 2048
    padded = rt3.aggs[rt3.pairs[0]].snapshot()
    assert_states_identical(tstate.resize_state(committed, 2048), padded)
    rt3.run()


def test_resume_refuses_shard_count_change(tmp_path):
    cfg = mk_cfg(tmp_path)
    src = lambda: SyntheticSource(n_events=1024, n_vehicles=50,
                                  events_per_second=512)
    rt = MicroBatchRuntime(cfg, src(), MemoryStore(), device="cpu",
                           checkpoint_every=1)
    rt.step_once()
    rt._ckpt_join()
    rt.close()
    cdir = rt.ckpt._commit_dir()
    mp = os.path.join(cdir, "meta.json")
    with open(mp) as fh:
        meta = json.load(fh)
    assert meta["shards"] == 1
    meta["shards"] = 8
    with open(mp, "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(RuntimeError, match="shard"):
        MicroBatchRuntime(cfg, src(), MemoryStore(), device="cpu")


def test_crash_between_poll_and_dispatch_replays_polled_batch(
        tmp_path, monkeypatch):
    """The prefetch polled batch 2 ahead of a dispatch that dies: the
    exit commit covers batch 1 only, so batch 2 replays on resume."""
    cfg = mk_cfg(tmp_path)
    src = SyntheticSource(n_events=1024, n_vehicles=50,
                          events_per_second=512)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, src, store, device="cpu",
                           checkpoint_every=0)
    assert cfg.prefetch_batches == 1
    rt.step_once()
    assert src.offset() == 1024          # the prefetch consumed batch 2
    assert rt._offsets_dispatched == 512

    def dying(*a, **k):
        raise RuntimeError("device died mid-step")

    monkeypatch.setattr(rt.multi, "step_packed_all", dying)
    with pytest.raises(RuntimeError, match="device died"):
        rt.close()                       # the drain dispatches and dies
    assert rt.ckpt.load_meta()["offset"] == 512

    src2 = SyntheticSource(n_events=1024, n_vehicles=50,
                           events_per_second=512)
    rt2 = MicroBatchRuntime(cfg, src2, store, device="cpu",
                            checkpoint_every=0)
    assert src2.offset() == 512
    rt2.run()
    assert sum(d["count"] for d in store._tiles.values()) == 1024


class _FailingStore(MemoryStore):
    """A store whose packed upserts raise on the calls in ``fail``."""

    def __init__(self, fail):
        super().__init__()
        self.calls, self.fail = 0, set(fail)

    def upsert_tiles_packed(self, body, meta):
        self.calls += 1
        if self.calls in self.fail:
            raise OSError("sink write failed")
        return super().upsert_tiles_packed(body, meta)


def _sink_run(tmp_path, store):
    cfg = mk_cfg(tmp_path, emit_flush_k=8)
    src = lambda: SyntheticSource(n_events=8 * 512, n_vehicles=60,
                                  events_per_second=2048)
    rt = MicroBatchRuntime(cfg, src(), store, device="cpu",
                           checkpoint_every=3)
    rt.writer.backoff_s = 0.001        # the retries' backoff, shortened
    return cfg, src, rt


def test_failed_sink_write_commits_nothing_past_it(tmp_path):
    """A flush hands its batches to the writer thread and empties the
    ring; a write that fails past the writer's retries poisons it, and
    the commit that drains the writer fails: no commit may record offsets
    past batches whose docs never landed.  The last good commit stays,
    and a resume on the same store replays to the uninterrupted run's
    docs."""
    # batch 4, the second flush's first write, fails on every attempt
    # (1 + 3 retries)
    store = _FailingStore(fail=range(4, 8))
    cfg, src, rt = _sink_run(tmp_path, store)
    for _ in range(6):
        assert rt.step_once()          # epoch 6's checkpoint flushes 4-6
    rt.writer._q.join()                # the writer has given up on batch 4
    with pytest.raises(RuntimeError, match="async sink write failed") as e:
        rt.close()                     # nothing folds or commits
    assert isinstance(e.value.__cause__, OSError)
    meta = rt.ckpt.load_meta()
    assert meta["epoch"] == 3 and meta["offset"] == 3 * 512
    assert rt.writer.poisoned and rt.epoch == 6
    assert rt.counters["checkpoints"] == 1
    with pytest.raises(RuntimeError, match="earlier flush lost"):
        rt.flush_pending()             # nothing flushes or commits again

    rt2 = MicroBatchRuntime(cfg, src(), store, device="cpu",
                            checkpoint_every=3)
    assert rt2.epoch == 3
    rt2.run()
    ref_store = MemoryStore()
    ref = MicroBatchRuntime(mk_cfg(tmp_path, emit_flush_k=8, checkpoint_dir=
                                   str(tmp_path / "ref")), src(), ref_store,
                            device="cpu", checkpoint_every=3)
    ref.run()
    assert_slabs_equal(rt2, ref)
    assert store._tiles == ref_store._tiles


def test_transient_sink_write_is_retried(tmp_path):
    """A write that fails once lands on its retry: one retry counted, the
    run commits as usual, and the docs and slab equal an uninterrupted
    run's."""
    store = _FailingStore(fail={4})
    _, src, rt = _sink_run(tmp_path, store)
    rt.run()
    assert rt.metrics["sink_retries"] == 1 and not rt.writer.poisoned
    assert rt.ckpt.load_meta()["epoch"] == 8
    assert rt.counters["checkpoints"] == 3
    ref_store = MemoryStore()
    ref = MicroBatchRuntime(mk_cfg(tmp_path, emit_flush_k=8, checkpoint_dir=
                                   str(tmp_path / "ref")), src(), ref_store,
                            device="cpu", checkpoint_every=3)
    ref.run()
    assert_slabs_equal(rt, ref)
    assert store._tiles == ref_store._tiles
    assert store._positions == ref_store._positions


def test_checkpoint_commit_is_async(tmp_path, monkeypatch):
    """The step loop does not wait for the copy to the host and the disk:
    the commit runs on a background thread off device copies, and lands
    with the epoch it captured."""
    cfg = mk_cfg(tmp_path)
    rt = MicroBatchRuntime(cfg, SyntheticSource(
        n_events=1500, n_vehicles=50, events_per_second=512), MemoryStore(),
        device="cpu", checkpoint_every=2)
    gate = threading.Event()
    commit = rt.ckpt.commit

    def gated(*a, **k):
        assert gate.wait(10.0)
        commit(*a, **k)

    monkeypatch.setattr(rt.ckpt, "commit", gated)
    assert rt.step_once()              # epoch 1: no checkpoint
    t0 = time.monotonic()
    assert rt.step_once()              # epoch 2: the checkpoint fires
    assert time.monotonic() - t0 < 3.0  # not blocked behind the gate
    assert rt.ckpt.load_meta() is None
    assert rt.commits[-1]["epoch"] == 2 and "bytes" not in rt.commits[-1]
    gate.set()
    rt._ckpt_join()
    assert rt.ckpt.load_meta()["epoch"] == 2
    assert rt.commits[-1]["bytes"] > 0
    rt.step_once()
    rt.close()                         # the exit commit lands
    assert rt.ckpt.load_meta()["epoch"] == 3
    assert rt.counters["checkpoints"] == 2


def test_async_checkpoint_errors_surface(tmp_path, monkeypatch):
    cfg = mk_cfg(tmp_path)
    rt = MicroBatchRuntime(cfg, SyntheticSource(
        n_events=1500, n_vehicles=50, events_per_second=512), MemoryStore(),
        device="cpu", checkpoint_every=2)

    def bad_commit(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(rt.ckpt, "commit", bad_commit)
    rt.step_once()
    rt.step_once()                     # epoch 2: the commit fails
    with pytest.raises(RuntimeError, match="async checkpoint commit"):
        rt._ckpt_join()
    # a close commits again and raises the same way
    with pytest.raises(RuntimeError, match="async checkpoint commit"):
        rt.close()
    assert rt.counters["checkpoints"] == 0


def test_flush_forced_before_checkpoint_commit(tmp_path):
    """Counterpart of tests/test_emit_ring.py: the capture flushes the
    ring first, so the commit covers every batch its offset covers."""
    cfg = mk_cfg(tmp_path, emit_flush_k=8)
    rt = MicroBatchRuntime(cfg, SyntheticSource(
        n_events=4 * 512, n_vehicles=50, events_per_second=2048),
        MemoryStore(), device="cpu", checkpoint_every=2)
    rt.step_once()
    assert len(rt._ring) == 1
    rt.step_once()                     # epoch 2: the checkpoint fires
    assert len(rt._ring) == 0
    assert rt.pulls == dict(rt.pulls, flushes=1, checkpoint=1, batches=2)
    rt._ckpt_join()
    meta = rt.ckpt.load_meta()
    assert meta["epoch"] == 2 and meta["offset"] == 1024
    assert meta["max_event_ts"] == rt.max_event_ts
    rt.close()


def test_replay_equivalence_after_restore_mid_interval(tmp_path):
    """Counterpart of tests/test_emit_ring.py: a crash with batches
    parked in the ring, a resume from the last commit and a replay give
    the continuous run's slab, docs and watermark exactly."""
    cfg = mk_cfg(tmp_path, emit_flush_k=3)
    n = 8 * 512
    src = lambda: SyntheticSource(n_events=n, n_vehicles=60,
                                  events_per_second=2048)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, src(), store, device="cpu",
                           checkpoint_every=2)
    for _ in range(5):
        rt.step_once()
    rt._ckpt_join()
    assert len(rt._ring) >= 1          # abandoned with emits parked

    src2 = src()
    rt2 = MicroBatchRuntime(cfg, src2, store, device="cpu",
                            checkpoint_every=2)
    assert rt2.epoch == 4
    assert src2.offset() == 4 * 512
    rt2.run()

    cfg3 = mk_cfg(tmp_path, emit_flush_k=3,
                  checkpoint_dir=str(tmp_path / "ckpt3"))
    store3 = MemoryStore()
    rt3 = MicroBatchRuntime(cfg3, src(), store3, device="cpu",
                            checkpoint_every=2)
    rt3.run()
    assert_slabs_equal(rt2, rt3)
    assert store._tiles == store3._tiles
    assert rt2.max_event_ts == rt3.max_event_ts


def test_resume_restarts_the_watermark_tracker(tmp_path):
    """After a resume only max_event_ts is restored and the pressure
    tracker starts from nothing, as in the reference: the first batch
    that finds one parked flushes under watermark pressure."""
    cfg = mk_cfg(tmp_path)
    src = lambda: SyntheticSource(n_events=6 * 512, n_vehicles=50,
                                  events_per_second=512)
    rt = MicroBatchRuntime(cfg, src(), MemoryStore(), device="cpu",
                           checkpoint_every=2)
    for _ in range(2):
        rt.step_once()
    rt._ckpt_join()
    rt2 = MicroBatchRuntime(cfg, src(), MemoryStore(), device="cpu",
                            checkpoint_every=0)
    assert rt2.max_event_ts == rt.ckpt.load_meta()["max_event_ts"]
    rt2.step_once()
    assert rt2.pulls["flushes"] == 0
    rt2.step_once()
    assert rt2.pulls == dict(rt2.pulls, flushes=1, watermark=1)
    rt2.close()


# --- a real process killed after a commit -------------------------------------

# 8 batches of 1024 over ~17 minutes of event time: windows close, the
# 1:2 slab grows twice (once before the commit, once after), checkpoint
# every 3 batches
KILL_SOURCE = dict(n_events=8 * 1024 + 300, n_vehicles=300,
                   events_per_second=8, t0=1_700_000_000)
KILL_AXES = dict(city="bos", h3_res=9, resolutions=(9,), windows_minutes=(5,),
                 tile_minutes=5, batch_size=1024, state_capacity_log2=11,
                 speed_hist_bins=64)

_KILLED = r"""
import os, pickle, sys
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
ckpt, out, source, axes = sys.argv[1], sys.argv[2], eval(sys.argv[3]), \
    eval(sys.argv[4])
store = MemoryStore()
rt = MicroBatchRuntime(load_config({}, checkpoint_dir=ckpt, **axes),
                       SyntheticSource(**source), store, device="cpu",
                       checkpoint_every=3)
for _ in range(5):              # a commit at epoch 3, then 2 more batches
    assert rt.step_once()
rt._ckpt_join()
with open(out, "wb") as fh:     # the store outlives the process
    pickle.dump(store._tiles, fh)
os._exit(0)                     # killed: no close, no exit commit
"""


def test_killed_process_resumes_to_the_uninterrupted_run(tmp_path):
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "store.pkl")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    p = subprocess.run([sys.executable, "-c", _KILLED, ckpt, out,
                        repr(KILL_SOURCE), repr(KILL_AXES)], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    meta = CheckpointManager(ckpt).load_meta()
    assert meta["epoch"] == 3 and meta["offset"] == 3 * 1024
    store = MemoryStore()
    with open(out, "rb") as fh:
        store.upsert_tiles(list(pickle.load(fh).values()))
    rt = MicroBatchRuntime(load_config({}, checkpoint_dir=ckpt, **KILL_AXES),
                           SyntheticSource(**KILL_SOURCE), store,
                           device="cpu", checkpoint_every=3)
    assert rt.multi.capacity_per_shard == 1 << 12      # grown, restored
    rt.run()

    ref_store = MemoryStore()
    ref = MicroBatchRuntime(load_config(
        {}, checkpoint_dir=str(tmp_path / "ref"), **KILL_AXES),
        SyntheticSource(**KILL_SOURCE), ref_store, device="cpu",
        checkpoint_every=3)
    ref.run()
    assert ref.counters["state_grown"] == 2             # 2^11 -> 2^13
    assert rt.multi.capacity_per_shard == ref.multi.capacity_per_shard
    assert ref.pulls["watermark"] > 0
    assert_slabs_equal(rt, ref)
    assert store._tiles == ref_store._tiles
    assert rt.max_event_ts == ref.max_event_ts
    assert rt.epoch == ref.epoch == 9


# --- cross-package resume ---------------------------------------------------

def _jax_runtime(ckpt, store, every):
    cfg = jax_load_config(None, checkpoint_dir=str(ckpt), store="memory",
                          **AXES)
    return JaxRuntime(cfg, JaxSyntheticSource(**SOURCE_ARGS), store,
                      checkpoint_every=every)


def _port_runtime(ckpt, store, every):
    cfg = load_config(None, checkpoint_dir=str(ckpt), **AXES)
    return MicroBatchRuntime(cfg, SyntheticSource(**SOURCE_ARGS), store,
                             device="cpu", checkpoint_every=every)


def _killed_after_commit(rt):
    """Two batches, the commit at epoch 2 joined, the runtime abandoned."""
    for _ in range(2):
        assert rt.step_once()
    rt._ckpt_join()


def _uninterrupted_jax(tmp_path):
    store = JaxMemoryStore()
    _jax_runtime(tmp_path / "ref", store, 0).run()
    return store._tiles


def test_jax_commit_resumed_by_the_port(tmp_path, monkeypatch):
    _pin_reference(monkeypatch, {})
    ref_docs = _uninterrupted_jax(tmp_path)
    jstore = JaxMemoryStore()
    jrt = _jax_runtime(tmp_path / "a", jstore, 2)
    _killed_after_commit(jrt)
    jrt.writer.drain()
    first_valid = jrt.metrics.counters["events_valid"]
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    # the port resumes the JAX commit on the surviving docs ...
    store = MemoryStore()
    store.upsert_tiles(copy.deepcopy(list(jstore._tiles.values())))
    rt = _port_runtime(tmp_path / "a", store, 0)
    assert rt.epoch == 2 and rt.source.offset() == 2 * AXES["batch_size"]
    rt.run()
    assert_docs_match(ref_docs, store._tiles, {
        "events_valid": first_valid + rt.counters["events_valid"],
        "state_overflow": rt.counters["state_overflow"]})
    # ... and flushes as the JAX runtime does resuming the same commit
    jstore2 = JaxMemoryStore()
    jstore2.upsert_tiles(copy.deepcopy(list(jstore._tiles.values())))
    jrt2 = _jax_runtime(tmp_path / "b", jstore2, 0)
    jrt2.run()
    assert rt.pulls["flushes"] == jrt2.metrics.counters["emit_pulls"]
    assert rt.pulls["watermark"] >= 1
    assert rt.max_event_ts == jrt2.max_event_ts


def test_port_commit_resumed_by_jax(tmp_path, monkeypatch):
    _pin_reference(monkeypatch, {})
    ref_docs = _uninterrupted_jax(tmp_path)
    store = MemoryStore()
    rt = _port_runtime(tmp_path / "a", store, 2)
    _killed_after_commit(rt)
    assert rt.ckpt.load_meta()["snap_impl"] == "pallas"
    jstore = JaxMemoryStore()
    jstore.upsert_tiles(copy.deepcopy(list(store._tiles.values())))
    jrt = _jax_runtime(tmp_path / "a", jstore, 0)
    assert jrt.epoch == 2 and jrt.source.offset() == 2 * AXES["batch_size"]
    jrt.run()
    jc = jrt.metrics.counters
    assert_docs_match(ref_docs, jstore._tiles, {
        "events_valid": rt.counters["events_valid"] + jc["events_valid"],
        "state_overflow": jc.get("state_overflow_groups", 0)})
