"""``HEATMAP_H3_IMPL`` in the port's runtime against the JAX package's
(``heatmap_tpu/stream/runtime.py:747-757``, ``_pin_snap_impl`` :1138-1210).

- Both runtimes under ``HEATMAP_H3_IMPL=native`` on the CPU (the f64 host
  snap keys the fold as ``prekeys`` in both): the docs' cell keys,
  windows and counts exactly equal, average, stddev and p95 of speed
  within 1e-6 relative and centroids within 1e-5 degrees (the bars of
  ``test_torch_stream.py``), and the committed slabs' keys, window starts,
  counts and histograms exactly equal, group by group.
- The route is recorded in every commit under the reference's names
  (``native`` | ``pallas``) and pinned on resume: a JAX commit written
  under ``native`` resumes in the port with the knob unset (also where
  ``auto`` would take the in-program snap, as on the card) and keeps
  ``native``, and the reverse; an in-program commit (JAX's ``xla``, the
  port's former ``torch``) resumed with the knob unset on the CPU keeps
  the in-program snap; an explicit knob is honoured over the commit, as in
  the reference.  Each resumed run ends with the uninterrupted run's docs.
- ``native`` with a host snap that cannot build raises, with the build's
  error, at construction and at a resume's pin.
"""

import copy
import logging
import shutil

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import SyntheticSource as JaxSyntheticSource
from heatmap_tpu.stream.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from heatmap_tpu_torch import _build
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.hexgrid import native_snap
from heatmap_tpu_torch.hexgrid import snap_kernel
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream import runtime as truntime
from heatmap_tpu_torch.stream.checkpoint import CheckpointManager
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
from test_torch_stream import (AXES, N_EVENTS, SOURCE_ARGS, _pin_reference,
                               assert_docs_match)

PAIR = (AXES["h3_res"], 300)


@pytest.fixture
def knob(monkeypatch):
    """The reference's pins for everything but the snap, which each test
    sets; ``knob(value)`` sets HEATMAP_H3_IMPL (None unsets it)."""
    _pin_reference(monkeypatch, {})

    def set_knob(value):
        if value is None:
            monkeypatch.delenv("HEATMAP_H3_IMPL", raising=False)
        else:
            monkeypatch.setenv("HEATMAP_H3_IMPL", value)
    return set_knob


def _jax_runtime(ckpt, store, every):
    cfg = jax_load_config(None, checkpoint_dir=str(ckpt), store="memory",
                          state_max_log2=AXES["state_capacity_log2"], **AXES)
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
    rt.writer.drain()


def assert_docs_equal(ref_docs, docs):
    """Cell keys, windows and counts exact; floats under the bars."""
    key = lambda d: (d["cellId"], int(d["windowStart"].timestamp()))
    ref = {key(d): d for d in ref_docs.values()}
    mine = {key(d): d for d in docs.values()}
    assert mine.keys() == ref.keys()
    assert len({k[1] for k in mine}) >= 5
    assert sum(d["count"] for d in mine.values()) == N_EVENTS
    for k, d in mine.items():
        r = ref[k]
        assert d["_id"] == r["_id"] and d["count"] == r["count"], k
        assert d["windowEnd"] == r["windowEnd"]
        for f in ("avgSpeedKmh", "stddevSpeedKmh", "p95SpeedKmh"):
            assert d[f] == pytest.approx(r[f], rel=1e-6, abs=1e-9), (k, f)
        for a, b in zip(d["centroid"]["coordinates"],
                        r["centroid"]["coordinates"]):
            assert abs(a - b) <= 1e-5, (k, a, b)


def _groups(st):
    """Live groups of a host slab: (key_hi, key_lo, ws) -> (count, hist)."""
    count = np.asarray(st.count)
    live = np.flatnonzero(count > 0)
    hi, lo, ws = (np.asarray(x).view(np.uint32 if i < 2 else np.int32)
                  for i, x in enumerate((st.key_hi, st.key_lo, st.key_ws)))
    hist = np.asarray(st.hist)
    return {(int(hi[i]), int(lo[i]), int(ws[i])):
            (int(count[i]), hist[i].tobytes()) for i in live}


def test_both_runtimes_under_native_fold_the_same_groups(tmp_path, knob):
    knob("native")
    jstore = JaxMemoryStore()
    jrt = _jax_runtime(tmp_path / "jax", jstore, 0)
    assert jrt._snap_impl_name == "native"
    jrt.run()
    store = MemoryStore()
    rt = _port_runtime(tmp_path / "port", store, 0)
    assert rt.snap_impl == "native"
    launches = snap_kernel.latlng_to_cell_kernel.launches
    rt.run()
    assert snap_kernel.latlng_to_cell_kernel.launches == launches
    assert rt.metrics["p50_span_ms"]["snap"] > 0
    assert_docs_equal(jstore._tiles, store._tiles)
    jmeta = JaxCheckpointManager(str(tmp_path / "jax")).load_meta()
    meta = CheckpointManager(str(tmp_path / "port")).load_meta()
    assert jmeta["snap_impl"] == meta["snap_impl"] == "native"
    jst = JaxCheckpointManager(str(tmp_path / "jax")).load_state(*PAIR)
    st = CheckpointManager(str(tmp_path / "port")).load_state(*PAIR)
    assert _groups(st) == _groups(jst)


@pytest.mark.parametrize("auto_means", ["native", "pallas"],
                         ids=["auto_on_cpu", "auto_as_on_the_card"])
def test_jax_native_commit_pins_native_in_the_port(tmp_path, knob,
                                                   monkeypatch, auto_means):
    """A JAX commit written under native, resumed in the port with the knob
    unset: the port keeps the host snap, also where ``auto`` would pick the
    in-program snap (the card's resolution, patched in here), and ends
    with the uninterrupted run's docs."""
    knob("native")
    ref = JaxMemoryStore()
    _jax_runtime(tmp_path / "ref", ref, 0).run()
    jstore = JaxMemoryStore()
    jrt = _jax_runtime(tmp_path / "a", jstore, 2)
    _killed_after_commit(jrt)
    assert JaxCheckpointManager(str(tmp_path / "a")).load_meta()[
        "snap_impl"] == "native"
    knob(None)
    monkeypatch.setattr(truntime, "resolve_snap_route",
                        lambda *a: auto_means)
    store = MemoryStore()
    store.upsert_tiles(copy.deepcopy(list(jstore._tiles.values())))
    rt = _port_runtime(tmp_path / "a", store, 0)
    assert rt.epoch == 2 and rt.snap_impl == "native"
    rt.run()
    assert CheckpointManager(str(tmp_path / "a")).load_meta()[
        "snap_impl"] == "native"
    assert_docs_equal(ref._tiles, store._tiles)


def test_port_native_commit_pins_native_in_jax(tmp_path, knob):
    knob("native")
    ref = JaxMemoryStore()
    _jax_runtime(tmp_path / "ref", ref, 0).run()
    store = MemoryStore()
    rt = _port_runtime(tmp_path / "a", store, 2)
    _killed_after_commit(rt)
    assert rt.ckpt.load_meta()["snap_impl"] == "native"
    knob(None)
    jstore = JaxMemoryStore()
    jstore.upsert_tiles(copy.deepcopy(list(store._tiles.values())))
    jrt = _jax_runtime(tmp_path / "a", jstore, 0)
    assert jrt.epoch == 2 and jrt._snap_impl_name == "native"
    jrt.run()
    assert_docs_equal(ref._tiles, jstore._tiles)


@pytest.mark.parametrize("written", ["xla", "torch"])
def test_in_program_commit_pins_the_in_program_snap(tmp_path, knob,
                                                    written):
    """A commit keyed by the in-program snap (JAX's ``xla``, or the port's
    former name ``torch``) resumed with the knob unset on the CPU, where
    ``auto`` would take the host snap: the port keeps the in-program snap
    and ends with the uninterrupted in-program run's docs."""
    knob("xla")
    store = MemoryStore()
    if written == "xla":
        ref = JaxMemoryStore()
        _jax_runtime(tmp_path / "ref", ref, 0).run()
        jstore = JaxMemoryStore()
        jrt = _jax_runtime(tmp_path / "a", jstore, 2)
        _killed_after_commit(jrt)
        first_valid = jrt.metrics.counters["events_valid"]
        store.upsert_tiles(copy.deepcopy(list(jstore._tiles.values())))
    else:
        ref = MemoryStore()
        _port_runtime(tmp_path / "ref", ref, 0).run()
        _killed_after_commit(_port_runtime(tmp_path / "a", store, 2))
        mgr = CheckpointManager(str(tmp_path / "a"))
        meta = mgr.load_meta()
        meta["snap_impl"] = "torch"
        mgr.commit(meta["offset"], meta["max_event_ts"], meta["epoch"],
                   {PAIR: mgr.load_state(*PAIR)}, shards=meta["shards"],
                   snap_impl="torch")
    assert CheckpointManager(str(tmp_path / "a")).load_meta()[
        "snap_impl"] == written
    knob(None)
    rt = _port_runtime(tmp_path / "a", store, 0)
    assert rt.epoch == 2 and rt.snap_impl == "pallas"
    rt.run()
    assert CheckpointManager(str(tmp_path / "a")).load_meta()[
        "snap_impl"] == "pallas"
    if written == "xla":
        # JAX's XLA snap keyed the first batches: the bars of a JAX run
        # against the port's in-program snap
        assert_docs_match(ref._tiles, store._tiles, {
            "events_valid": first_valid + rt.counters["events_valid"],
            "state_overflow": rt.counters["state_overflow"]})
    else:
        assert_docs_equal(ref._tiles, store._tiles)


def test_an_explicit_knob_is_honoured_over_the_commit(tmp_path, knob,
                                                      caplog):
    knob("xla")
    _killed_after_commit(_port_runtime(tmp_path / "a", MemoryStore(), 2))
    knob("native")
    caplog.set_level(logging.WARNING)
    rt = _port_runtime(tmp_path / "a", MemoryStore(), 0)
    assert rt.epoch == 2 and rt.snap_impl == "native"
    assert any("HEATMAP_H3_IMPL=native forces" in r.getMessage()
               for r in caplog.records)
    rt.close()


def _failing_build(monkeypatch):
    def fail(source):
        raise _build.KernelBuildError(f"cannot build {source}: g++ failed")

    native_snap.host_snap.cache_clear()
    monkeypatch.setattr(_build, "load", fail)


def test_native_with_a_failing_build_raises(tmp_path, knob, monkeypatch):
    knob("native")
    _failing_build(monkeypatch)
    try:
        with pytest.raises(_build.KernelBuildError, match="g\\+\\+ failed"):
            _port_runtime(tmp_path / "a", MemoryStore(), 0)
    finally:
        native_snap.host_snap.cache_clear()


def test_a_native_pin_with_a_failing_build_raises(tmp_path, knob,
                                                  monkeypatch):
    knob("native")
    _killed_after_commit(_port_runtime(tmp_path / "a", MemoryStore(), 2))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    knob(None)
    monkeypatch.setattr(truntime, "resolve_snap_route",
                        lambda *a: "pallas")
    _failing_build(monkeypatch)
    try:
        with pytest.raises(_build.KernelBuildError):
            _port_runtime(tmp_path / "b", MemoryStore(), 0)
    finally:
        native_snap.host_snap.cache_clear()
