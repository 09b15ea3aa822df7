"""Slab growth and the overflow policy: the port against the JAX package.

- ``resize_state`` (host) and ``grow_state`` (device) against JAX's
  ``resize_state``: grow, shrink and a refused shrink, arrays exact.
- ``MultiAggregator.grow`` mid-stream against JAX's, on shared prekeys:
  per-batch emits and slabs under the fold differential's bars
  (``tests/test_torch_engine.py``: integer lanes, anchors and row order
  exact, speed sums within 2 ulp, coordinate sums within count x ulp).
- Both runtimes with their defaults and growth ON (no ``state_max_log2``
  pin) at synthetic_backfill's 1:2 batch:slab ratio: the same slab
  capacity, growths, flushes and commits.
- The runtime's growth and overflow policy, counterparts of
  ``tests/test_stream.py``: growth before overflow, ``grow_margin=
  observed``, loud overflow, fail mode, knob validation.
"""

import logging
import os
import tempfile

import numpy as np
import pytest
import torch

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.engine import multi as jmulti
from heatmap_tpu.engine import state as jstate
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import SyntheticSource as JaxSyntheticSource
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.engine import multi as tmulti
from heatmap_tpu_torch.engine import state as tstate
from heatmap_tpu_torch.engine import step as tstep
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.events import columns_from_arrays
from heatmap_tpu_torch.stream.runtime import (MicroBatchRuntime,
                                              StateOverflowError)
from heatmap_tpu_torch.stream.source import SyntheticSource
from test_torch_engine import jax_sort_route  # noqa: F401 (a fixture)
from test_torch_engine import (BATCH, BINS, RES, WINDOW_S,
                               assert_states_equal, make_batches, run_pair)
from test_torch_stream import (AXES, SOURCE_ARGS, _ListSource,
                               _pin_reference, assert_docs_match)


def host_slab(rng, capacity, live, bins=4):
    """A sorted host slab in the reference's layout: ``live`` rows of
    random keys at the head, EMPTY rows after."""
    hi = np.sort(rng.integers(0x08900000, 0x08A00000, live)
                 .astype(np.uint32))
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    pad = lambda a, fill: np.concatenate(
        [a, np.full((capacity - live,) + a.shape[1:], fill, a.dtype)])
    return tstate.TileState(
        key_hi=pad(hi, np.uint32(0xFFFFFFFF)),
        key_lo=pad(rng.integers(0, 2**32, live, dtype=np.uint64)
                   .astype(np.uint32), np.uint32(0xFFFFFFFF)),
        key_ws=pad(np.full(live, 1_700_000_100, np.int32), 2**31 - 1),
        count=pad(rng.integers(1, 50, live).astype(np.int32), 0),
        sum_speed=pad(f32(live), 0), sum_speed2=pad(f32(live), 0),
        sum_lat=pad(f32(live), 0), sum_lon=pad(f32(live), 0),
        hist=pad(rng.integers(0, 9, (live, bins)).astype(np.int32), 0),
        anchor_speed=pad(f32(live), 0), anchor_lat=pad(f32(live), 0),
        anchor_lon=pad(f32(live), 0), comp=pad(f32(live, 4), 0))


def assert_host_equal(a, b):
    for name, x, y in zip(tstate.TileState._fields, a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("cap,live,new", [
    (64, 40, 256), (256, 40, 64), (64, 64, 128), (128, 20, 20)],
    ids=["grow", "shrink", "grow_full", "shrink_to_live"])
def test_resize_state_matches_jax(cap, live, new):
    st = host_slab(np.random.default_rng(7), cap, live)
    got = tstate.resize_state(st, new)
    want = jstate.resize_state(jstate.TileState(*st), new)
    assert got.key_hi.shape[0] == new
    assert_host_equal(got, want)
    if new > cap:
        # the device grow gives the same slab
        dev = tstate.grow_state(tstate.from_host(st, "cpu"), new)
        assert_host_equal(tstate.to_host(dev), want)


def test_refused_shrink_matches_jax():
    st = host_slab(np.random.default_rng(3), 256, 100)
    with pytest.raises(ValueError, match="cannot shrink"):
        tstate.resize_state(st, 64)
    with pytest.raises(ValueError, match="cannot shrink"):
        jstate.resize_state(jstate.TileState(*st), 64)
    with pytest.raises(ValueError, match="cannot shrink"):
        tstate.grow_state(tstate.from_host(st, "cpu"), 128)


def test_grow_mid_stream_matches_jax(jax_sort_route):
    """Both aggregators start at 2^11 rows (emit capacity 2^11 < the
    batch), fold 2 batches, grow to 2^13 (emit capacity -> the batch),
    then fold the rest: every batch's emit and the final slab agree."""
    batches = make_batches(seed=17)
    pairs = [(RES, WINDOW_S)]
    cap = 1 << 11
    j = jmulti.MultiAggregator(pairs, cap, BATCH, emit_capacity=cap,
                               hist_bins=BINS)
    t = tmulti.MultiAggregator(pairs, cap, BATCH, emit_capacity=cap,
                               hist_bins=BINS, device="cpu")
    max_ts, seen = run_pair(j, t, batches[:2], tstep.I32_MIN)
    assert_states_equal(j.states[0], t.states[0])
    j.grow(1 << 13)
    t.grow(1 << 13)
    assert t.capacity_per_shard == j.capacity_per_shard == 1 << 13
    assert ([p.emit_capacity for p in t.params]
            == [p.emit_capacity for p in j.params] == [BATCH])
    assert_states_equal(j.states[0], t.states[0])
    _, more = run_pair(j, t, batches[2:], max_ts)
    assert_states_equal(j.states[0], t.states[0])
    seen += more
    assert sum(s.n_evicted for s in seen) > 0
    assert all(s.state_overflow == 0 for s in more)


def test_pair_view_checkpoint_roundtrip():
    """Counterpart of tests/test_multi.py::test_pair_view_checkpoint_
    roundtrip: snapshot, restore into a fresh aggregator, refuse another
    shape."""
    pairs = [(8, 300), (9, 300)]
    b = make_batches(seed=2)[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    multi = tmulti.MultiAggregator(pairs, 1 << 13, BATCH, BATCH,
                                   hist_bins=8, device="cpu")
    multi.step_packed_all(t(b["lat"]), t(b["lng"]), t(b["speed"]),
                          t(b["ts"]), t(b["valid"]), tstep.I32_MIN)
    snap = {p: multi.view(*p).snapshot() for p in pairs}
    assert snap[pairs[0]].key_hi.dtype == np.uint32
    fresh = tmulti.MultiAggregator(pairs, 1 << 13, BATCH, BATCH,
                                   hist_bins=8, device="cpu")
    for p in pairs:
        fresh.view(*p).restore(snap[p])
    for a, b2 in zip(multi.states, fresh.states):
        for x, y in zip(a, b2):
            assert torch.equal(x, y)
    small = tmulti.MultiAggregator(pairs, 1 << 12, BATCH, BATCH,
                                   hist_bins=8, device="cpu")
    with pytest.raises(ValueError, match="state shape"):
        small.view(*pairs[0]).restore(snap[pairs[0]])


# --- both runtimes with growth on ------------------------------------------

# synthetic_backfill's shape at 1/128 of its batch: one window, SyntheticSource
# defaults otherwise, 12 batches
BACKFILL = dict(n_events=12 * 4096, t0=1_700_000_000)


@pytest.mark.parametrize("source_args", [BACKFILL, SOURCE_ARGS],
                         ids=["one_window", "windows"])
def test_growth_defaults_match_jax(tmp_path, monkeypatch, source_args):
    """Both runtimes with their defaults, growth on and checkpoints to
    their own directories, slab 2x the batch as in synthetic_backfill:
    the slab grows once, and the flushes (the port's ``pulls`` against
    the JAX runtime's ``emit_pulls``) and commits are the same."""
    _pin_reference(monkeypatch, {})
    axes = dict(AXES, state_capacity_log2=13)
    jcfg = jax_load_config(None, checkpoint_dir=str(tmp_path / "jax"),
                           store="memory", **axes)
    assert jcfg.state_max_log2 == 0 and jcfg.prefetch_batches == 1
    jstore = JaxMemoryStore()
    jrt = JaxRuntime(jcfg, JaxSyntheticSource(**source_args), jstore)
    jrt.run()
    cfg = load_config(None, checkpoint_dir=str(tmp_path / "port"), **axes)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, SyntheticSource(**source_args), store,
                           device="cpu")
    rt.run()
    jc = jrt.metrics.counters
    assert rt.multi.capacity_per_shard == jrt._multi.capacity_per_shard
    assert rt.multi.capacity_per_shard == 1 << 14
    assert rt.counters["state_grown"] == jc["state_grown"] == 1
    assert rt.pulls["flushes"] == jc["emit_pulls"]
    assert rt.pulls["batches"] == jc["emit_pull_batches"]
    assert rt.pulls["grow"] >= rt.counters["batches"] // 2 - 1
    assert rt.counters["checkpoints"] == jc["checkpoints"] == 1
    assert rt.ckpt.load_meta()["epoch"] == jrt.ckpt.load_meta()["epoch"]
    if source_args is SOURCE_ARGS:
        assert rt.pulls["watermark"] > 0
        assert_docs_match(jstore._tiles, store._tiles, rt.metrics)
    else:
        total = sum(d["count"] for d in store._tiles.values())
        assert total == sum(d["count"] for d in jstore._tiles.values())
        assert total == rt.counters["events_valid"] == BACKFILL["n_events"]


# --- the runtime's growth and overflow policy --------------------------------

def small_cfg(tmp_path, **over):
    base = dict(city="bos", h3_res=RES, resolutions=(RES,),
                batch_size=512, state_capacity_log2=13, speed_hist_bins=8,
                checkpoint_dir=str(tmp_path / "ckpt"))
    base.update(over)
    return load_config({}, **base)


def many_cells(n_events):
    """A stream over ~``n_events`` distinct res-9 cells (500 vehicles
    spread over a wide box)."""
    return SyntheticSource(n_events=n_events, n_vehicles=500,
                           radius_deg=1.0, events_per_second=1000)


def test_state_grows_before_overflow(tmp_path):
    """A tiny initial slab self-heals: it starts at the floor (2x batch)
    and doubles before it can overflow; nothing is dropped."""
    cfg = small_cfg(tmp_path, state_capacity_log2=6, state_max_log2=12,
                    batch_size=128)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, many_cells(1000), store, device="cpu")
    assert rt.multi.capacity_per_shard == 256       # the startup floor
    rt.run()
    assert rt.counters["state_grown"] >= 1
    assert rt.counters["state_overflow"] == 0
    assert rt.counters["events_valid"] == 1000
    assert sum(d["count"] for d in store._tiles.values()) == 1000
    assert rt.multi.capacity_per_shard > 256


def test_state_overflow_is_loud(tmp_path, caplog):
    """Overflow past the ceiling counts on every overflowing batch and
    logs an ERROR (rate-limited)."""
    cfg = small_cfg(tmp_path, state_capacity_log2=6, state_max_log2=6)
    rt = MicroBatchRuntime(cfg, many_cells(1000), MemoryStore(),
                           device="cpu")
    with caplog.at_level(logging.ERROR,
                         logger="heatmap_tpu_torch.stream.runtime"):
        rt.run()
    assert rt.counters["state_overflow"] > 0
    assert rt.counters["state_overflow_last_epoch"] >= 1
    assert rt.multi.capacity_per_shard == 64
    assert any("STATE OVERFLOW" in r.message for r in caplog.records)


def test_state_overflow_fail_mode(tmp_path):
    """HEATMAP_ON_OVERFLOW=fail stops the run and commits nothing: the
    lost batch replays after a capacity raise."""
    cfg = small_cfg(tmp_path, state_capacity_log2=6, state_max_log2=6,
                    on_overflow="fail")
    rt = MicroBatchRuntime(cfg, many_cells(1000), MemoryStore(),
                           device="cpu")
    with pytest.raises(StateOverflowError):
        rt.run()
    assert rt._fatal
    assert not os.path.exists(rt.ckpt.latest_path)


def _points(points, ts):
    lat = np.array([p[0] for p in points], np.float32)
    lng = np.array([p[1] for p in points], np.float32)
    n = len(points)
    return columns_from_arrays(lat, lng, np.full(n, 10.0, np.float32),
                               np.full(n, ts, np.int32))


def test_grow_margin_observed(tmp_path):
    """grow_margin=observed sizes the margin from the measured per-batch
    minting: a low-cardinality stream keeps the configured slab (no
    startup floor), and a burst of new cells still grows it before it
    overflows."""
    cfg = small_cfg(tmp_path, state_capacity_log2=9, state_max_log2=13,
                    grow_margin="observed")
    few = [(42.30 + 0.001 * i, -71.05) for i in range(40)]
    rng = np.random.default_rng(3)
    burst = [(float(rng.uniform(40.0, 44.0)), float(rng.uniform(-75.0, -70.0)))
             for _ in range(400)]
    t0 = 1_700_000_000
    src = _ListSource([_points(few, t0 + k) for k in range(3)]
                      + [_points(burst, t0 + 10)])
    rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu")
    assert rt.multi.capacity_per_shard == 512
    for _ in range(3):
        assert rt.step_once()
    rt.flush_pending()
    rt._maybe_grow()
    assert rt.multi.capacity_per_shard == 512
    # a pair's first observation only seeds the baseline; the repeats
    # mint nothing
    assert rt._mint_peak == 0
    assert rt.step_once()
    rt.flush_pending()
    rt._maybe_grow()
    assert rt._mint_peak >= 390
    assert rt.multi.capacity_per_shard > 512
    assert rt.counters["state_overflow"] == 0
    rt.close()


@pytest.mark.parametrize("env,match", [
    ({"HEATMAP_ON_OVERFLOW": "FAIL"}, "HEATMAP_ON_OVERFLOW"),
    ({"HEATMAP_GROW_MARGIN": "best"}, "HEATMAP_GROW_MARGIN"),
    ({"HEATMAP_STATE_MAX_LOG2": "12", "STATE_CAPACITY_LOG2": "13"},
     "HEATMAP_STATE_MAX_LOG2"),
    ({"HEATMAP_PREFETCH_BATCHES": "-1"}, "HEATMAP_PREFETCH_BATCHES"),
    ({"HEATMAP_PREFETCH_BATCHES": "33"}, "HEATMAP_PREFETCH_BATCHES"),
])
def test_knobs_validated(env, match):
    with pytest.raises(ValueError, match=match):
        load_config(env)
    with pytest.raises(ValueError, match=match):
        jax_load_config(env)


def test_knobs_read_as_the_reference_reads_them():
    env = {"HEATMAP_ON_OVERFLOW": "fail", "HEATMAP_GROW_MARGIN": "observed",
           "HEATMAP_STATE_MAX_LOG2": "20", "HEATMAP_PREFETCH_BATCHES": "2",
           "CHECKPOINT": "/var/lib/heatmap/ckpt"}
    got, want = load_config(env), jax_load_config(env)
    for f in ("on_overflow", "grow_margin", "state_max_log2",
              "prefetch_batches", "checkpoint_dir"):
        assert getattr(got, f) == getattr(want, f), f
    d, jd = load_config({}), jax_load_config({})
    for f in ("on_overflow", "grow_margin", "state_max_log2",
              "prefetch_batches"):
        assert getattr(d, f) == getattr(jd, f), f
    # the port's default commit directory follows TMPDIR, so runs with
    # temp directories of their own never resume each other's commits
    assert d.checkpoint_dir == os.path.join(tempfile.gettempdir(),
                                            "heatmap-checkpoint")


def test_grow_refused_with_parked_emits(tmp_path):
    """The ring stacks (P, E+1, 13) matrices: growth with emits parked
    would change E mid-ring, so the grower refuses it."""
    cfg = small_cfg(tmp_path)
    rt = MicroBatchRuntime(cfg, many_cells(512), MemoryStore(),
                           device="cpu")
    assert rt.step_once()
    rt._n_active_peak = 1 << 13          # as if the slab were full
    with pytest.raises(RuntimeError, match="parked"):
        rt._maybe_grow()
    rt.flush_pending()
    rt._n_active_peak = 1 << 13
    rt._maybe_grow()
    assert rt.multi.capacity_per_shard == 1 << 14
    rt.close()
