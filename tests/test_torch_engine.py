"""The port's fold (heatmap_tpu_torch.engine) against the JAX package's.

Both sides fold the same batches, keyed by the same precomputed cell keys
(``prekeys``), so that a snap difference cannot hide a fold difference.
The JAX side runs its sort route with the fast path off
(HEATMAP_MERGE_IMPL=sort, HEATMAP_FASTPATH=0); the port runs on the CPU,
with the plain versions of its kernels.

Bars: integer lanes (keys, window starts, counts, histograms, step stats),
anchors (a segment min) and emit row order must match exactly.  The speed
sums, their Kahan ``comp`` and p95 are held to 2 ulp of float32: on the CPU
both sides add each segment's rows in event order in float32, so they come
out bit-equal, and 2 ulp leaves room for one add rounded differently.

The lat/lon residual sums get a wider bound.  The JAX side computes
``lat_rad * (180/pi) - anchor`` as one fused multiply-add on the CPU,
while the port rounds the degree value first (as the anchor itself is
rounded), so each event's residual may differ by half a float32 ulp of
its coordinate.  They are held to |diff| <= count * ulp(anchor).
"""

import numpy as np
import pytest
import torch

from heatmap_tpu.engine import multi as jmulti
from heatmap_tpu.engine import state as jstate
from heatmap_tpu.engine import step as jstep
from heatmap_tpu.hexgrid import device as jdev
from heatmap_tpu_torch.engine import multi as tmulti
from heatmap_tpu_torch.engine import state as tstate
from heatmap_tpu_torch.engine import step as tstep
from heatmap_tpu_torch.hexgrid import snap_kernel

RES = 9
WINDOW_S = 300
WATERMARK_S = 600
CAP = 1 << 14
BATCH = 1 << 12
BINS = 64
T0 = 1_700_000_000
N_BATCHES = 7
# float lanes of the packed body: sums, p95, anchors
FLOAT_COLS = (4, 5, 6, 7, 9, 10, 11, 12)


@pytest.fixture
def jax_sort_route(monkeypatch):
    monkeypatch.setattr(jstep, "MERGE_IMPL", "sort")
    monkeypatch.setattr(jstep, "FASTPATH", False)


def make_batches(seed=5):
    """N_BATCHES padded batches whose event times cross several window ends
    (eviction fires) with a share of stale events (late drops fire) and an
    invalid padded tail."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(N_BATCHES):
        n = BATCH - int(rng.integers(0, 300))
        lat_d = rng.uniform(42.30, 42.40, BATCH)
        lng_d = rng.uniform(-71.10, -71.00, BATCH)
        ts = T0 + b * 240 + rng.integers(0, 240, BATCH)
        stale = rng.random(BATCH) < 0.05
        ts = np.where(stale, ts - 1500, ts).astype(np.int32)
        speed = rng.uniform(0.0, 120.0, BATCH).astype(np.float32)
        lat = np.radians(lat_d).astype(np.float32)
        lng = np.radians(lng_d).astype(np.float32)
        valid = np.zeros(BATCH, bool)
        valid[:n] = True
        hi, lo = jdev.latlng_to_cell_vec(lat, lng, RES)
        out.append(dict(lat=lat, lng=lng, speed=speed, ts=ts, valid=valid,
                        hi=np.asarray(hi), lo=np.asarray(lo)))
    return out


def new_aggs():
    pairs = [(RES, WINDOW_S)]
    j = jmulti.MultiAggregator(pairs, CAP, BATCH, emit_capacity=BATCH,
                               hist_bins=BINS)
    t = tmulti.MultiAggregator(pairs, CAP, BATCH, emit_capacity=BATCH,
                               hist_bins=BINS, device="cpu")
    return j, t


def step_both(j, t, b, cutoff):
    jp = j.step_packed_all(b["lat"], b["lng"], b["speed"], b["ts"],
                           b["valid"], cutoff,
                           prekeys={RES: (b["hi"], b["lo"])})
    tk = (torch.from_numpy(b["hi"].view(np.int32).copy()),
          torch.from_numpy(b["lo"].view(np.int32).copy()))
    tp = t.step_packed_all(
        torch.from_numpy(b["lat"]), torch.from_numpy(b["lng"]),
        torch.from_numpy(b["speed"]), torch.from_numpy(b["ts"]),
        torch.from_numpy(b["valid"]), cutoff, prekeys={RES: tk})
    return np.asarray(jp)[0], tp.numpy().view(np.uint32)[0]


def assert_f32_close(a, b, what):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    try:
        np.testing.assert_array_max_ulp(a, b, maxulp=2)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def assert_coord_sums_close(a, b, count, anchor, what):
    """|a - b| <= count * ulp(anchor): the fused multiply-add bound of the
    module docstring."""
    bound = count.astype(np.float64) * np.spacing(
        np.abs(anchor.astype(np.float32))).astype(np.float64)
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    bad = diff > bound
    assert not bad.any(), (what, int(bad.sum()), diff[bad][:5], bound[bad][:5])


def assert_packed_equal(jp, tp):
    assert jp.shape == tp.shape and jp.dtype == tp.dtype == np.uint32
    int_cols = [c for c in range(jp.shape[1]) if c not in FLOAT_COLS]
    np.testing.assert_array_equal(tp[0], jp[0])          # head + stats
    np.testing.assert_array_equal(tp[1:, int_cols], jp[1:, int_cols])
    # anchors are a segment min: exact
    np.testing.assert_array_equal(tp[1:, 10:13], jp[1:, 10:13])
    f = lambda m, c: m[1:, c].view(np.float32)
    for c in (4, 5, 9):
        assert_f32_close(f(jp, c), f(tp, c), c)
    count = jp[1:, 3].view(np.int32)
    for c, anchor_col in ((6, 11), (7, 12)):
        assert_coord_sums_close(f(jp, c), f(tp, c), count,
                                f(jp, anchor_col), c)


def assert_states_equal(jst, tst):
    jh = jstate.to_host(jst)
    th = tstate.to_host(tst)
    for name, a, b in zip(jstate.TileState._fields, jh, th):
        assert a.dtype == b.dtype and a.shape == b.shape, name
    for name in ("key_hi", "key_lo", "key_ws", "count", "hist",
                 "anchor_speed", "anchor_lat", "anchor_lon"):
        np.testing.assert_array_equal(getattr(th, name), getattr(jh, name),
                                      err_msg=name)
    assert_f32_close(jh.sum_speed, th.sum_speed, "sum_speed")
    assert_f32_close(jh.sum_speed2, th.sum_speed2, "sum_speed2")
    assert_f32_close(jh.comp[:, :2], th.comp[:, :2], "comp speed")
    for name, col, anchor in (("sum_lat", 2, jh.anchor_lat),
                              ("sum_lon", 3, jh.anchor_lon)):
        assert_coord_sums_close(getattr(jh, name), getattr(th, name),
                                jh.count, anchor, name)
        assert_coord_sums_close(jh.comp[:, col], th.comp[:, col],
                                jh.count, anchor, f"comp {name}")


def run_pair(j, t, batches, max_ts):
    """Fold ``batches`` on both sides; the cutoff follows the runtime's rule
    from the previous batches' batch_max_ts.  Returns the new max_ts and
    the per-batch stats."""
    seen = []
    for b in batches:
        cutoff = (max_ts - WATERMARK_S if max_ts > tstep.I32_MIN
                  else tstep.I32_MIN)
        jp, tp = step_both(j, t, b, cutoff)
        assert_packed_equal(jp, tp)
        ju, tu = jstep.unpack_emit(jp), tstep.unpack_emit(tp)
        assert ju.keys() == tu.keys()
        for k in ("key_hi", "key_lo", "key_ws", "count", "valid",
                  "n_emitted", "overflowed"):
            np.testing.assert_array_equal(tu[k], ju[k], err_msg=k)
        st = tmulti.stats_from_packed(tp)
        assert st == jmulti.stats_from_packed(jp)
        seen.append(st)
        max_ts = max(max_ts, st.batch_max_ts)
    return max_ts, seen


def test_fold_matches_jax_on_shared_keys(jax_sort_route):
    batches = make_batches()
    j, t = new_aggs()
    _, seen = run_pair(j, t, batches, tstep.I32_MIN)
    # the batches must exercise every path of the prologue
    assert sum(s.n_late for s in seen) > 0
    assert sum(s.n_evicted for s in seen) > 0
    assert all(s.state_overflow == 0 for s in seen)
    assert_states_equal(j.states[0], t.states[0])


def test_from_host_carries_a_jax_slab(jax_sort_route):
    """A JAX slab after 3 batches, carried into the port with from_host,
    then 3 more batches on each side: the same emits and the same slab."""
    batches = make_batches(seed=11)
    j, t = new_aggs()
    max_ts = tstep.I32_MIN
    for b in batches[:3]:
        cutoff = (max_ts - WATERMARK_S if max_ts > tstep.I32_MIN
                  else tstep.I32_MIN)
        jp = np.asarray(j.step_packed_all(
            b["lat"], b["lng"], b["speed"], b["ts"], b["valid"], cutoff,
            prekeys={RES: (b["hi"], b["lo"])}))[0]
        max_ts = max(max_ts, jmulti.stats_from_packed(jp).batch_max_ts)
    t.states = [tstate.from_host(jstate.to_host(j.states[0]), "cpu")]
    assert_states_equal(j.states[0], t.states[0])
    run_pair(j, t, batches[3:6], max_ts)
    assert_states_equal(j.states[0], t.states[0])


def test_state_layout_round_trips():
    """to_host gives the reference's dtypes and from_host inverts it."""
    ref = jstate.to_host(jstate.init_state(64, BINS))
    mine = tstate.to_host(tstate.init_state(64, BINS, "cpu"))
    for name, a, b in zip(jstate.TileState._fields, ref, mine):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    back = tstate.to_host(tstate.from_host(mine, "cpu"))
    for a, b in zip(mine, back):
        np.testing.assert_array_equal(a, b)
    st = tstate.from_host(mine, "cpu")
    copy = tstate.device_copy(st)
    for a, b in zip(st, copy):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    with pytest.raises(TypeError):
        tstate.from_host(ref._replace(key_hi=ref.key_hi.view(np.int32)),
                         "cpu")


@pytest.mark.parametrize("counts", [
    [0, 0, 0, 0],
    [5, 0, 0, 0],
    [1, 2, 3, 4],
    [0, 0, 0, 9],
    [10, 10, 0, 1],
])
def test_p95_matches_jax(counts):
    hist = np.asarray([counts, counts[::-1]], np.int32)
    count = hist.sum(axis=1).astype(np.int32)
    want = np.asarray(jstep.p95_from_hist_device(hist, count, 256.0))
    got = tstep.p95_from_hist_device(torch.from_numpy(hist),
                                     torch.from_numpy(count), 256.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_sort_key_is_unsigned_order():
    """The int64 sort key orders (k1, lo) as unsigned words, EMPTY last."""
    rng = np.random.default_rng(3)
    k1 = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    lo = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    k1[:4] = 0xFFFFFFFF
    lo[:4] = 0xFFFFFFFF
    key = tstep._sort_key(torch.from_numpy(k1.astype(np.int64)),
                          torch.from_numpy(lo.astype(np.uint32).view(np.int32)))
    order = torch.argsort(key, stable=True).numpy()
    want = np.lexsort((lo, k1))
    np.testing.assert_array_equal(order, want)


def test_aggregate_batch_is_snap_then_merge():
    """aggregate_batch = snap_and_window + merge_batch on the degree lanes."""
    b = make_batches(seed=2)[0]
    params = tstep.AggParams(RES, WINDOW_S, emit_capacity=BATCH)
    lat, lng, speed, ts, valid = (torch.from_numpy(b[k]) for k in
                                  ("lat", "lng", "speed", "ts", "valid"))
    st = tstate.init_state(CAP, BINS, "cpu")
    _, e1, s1 = tstep.aggregate_batch(st, lat, lng, speed, ts, valid,
                                      tstep.I32_MIN, params)
    hi, lo, ws = tstep.snap_and_window(lat, lng, ts, valid, params)
    deg = tstep.RAD_TO_DEG
    _, e2, s2 = tstep.merge_batch(st, hi, lo, ws, speed, lat * deg,
                                  lng * deg, ts, valid, tstep.I32_MIN, params)
    for a, c in zip(tuple(e1) + tuple(s1), tuple(e2) + tuple(s2)):
        assert torch.equal(a, c)
    assert int(s1.n_valid) == int(valid.sum())


@pytest.mark.parametrize("impl,device,res,route", [
    ("auto", "cpu", RES, "native"), ("xla", "cpu", RES, "pallas"),
    ("pallas", "cpu", RES, "pallas"), ("native", "cpu", RES, "native"),
    ("typo", "cpu", RES, "pallas"), ("native", "cpu", 11, "pallas"),
    ("auto", "cpu", 11, "pallas"), ("auto", "cuda", RES, "pallas"),
    ("native", "cuda", RES, "native"), ("xla", "cuda", RES, "pallas")])
def test_snap_route_resolves_as_the_reference(monkeypatch, tmp_path, impl,
                                              device, res, route):
    """HEATMAP_H3_IMPL resolves as heatmap_tpu/stream/runtime.py:747-757
    does: the host snap (``native``) for ``native``, and for ``auto`` on
    the CPU; the in-program snap (``pallas``: the kernel wrapper, its plain
    version only for CPU tensors) otherwise and above res 10.  A CPU
    runtime built under the knob takes that route."""
    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.sink.memory import MemoryStore
    from heatmap_tpu_torch.stream.runtime import (MicroBatchRuntime,
                                                  resolve_snap_route)
    from heatmap_tpu_torch.stream.source import SyntheticSource

    assert resolve_snap_route(impl, torch.device(device), (res,)) == route
    assert tstep._snap_impl(RES) is snap_kernel.latlng_to_cell_kernel
    if device == "cpu":
        monkeypatch.setenv("HEATMAP_H3_IMPL", impl)
        rt = MicroBatchRuntime(
            load_config({}, h3_res=res, resolutions=(res,), batch_size=256,
                        state_capacity_log2=10,
                        checkpoint_dir=str(tmp_path)),
            SyntheticSource(n_events=0), MemoryStore(), device="cpu")
        assert rt.snap_impl == route
        assert (rt._host_snap is not None) == (route == "native")
        rt.writer.close()
