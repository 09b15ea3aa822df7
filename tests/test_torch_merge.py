"""The port's merge routes and fast-path tiers against the JAX package's.

Both sides fold the same batches at the ``merge_batch`` level: cell keys
made from a numpy seed (res-9 index words with random variable bits),
window starts, speeds and degree coordinates.  The JAX side runs on the
CPU as its own tests run it, with its ``MERGE_IMPL`` / ``FASTPATH`` slots
set through ``monkeypatch``; the port's slots are set the same way.

The stream takes every tier of the fast path: an empty slab (tier 3),
the same cells again (tier 1), a few new cells (tier 2), a miss burst over
the tier-2 budget (tier 3), a half-late batch (tier 1), a new window
(tier 2), the eviction of the first window (tier 3), two batches of fresh
cells that overflow the slab (tier 3), and the new window's cells again,
of which the overflow dropped some (tier 2).

Bars, as in tests/test_torch_engine.py: integer lanes (keys, window
starts, counts, histograms, step stats), anchors and emit row order exact;
the speed sums, their Kahan ``comp`` and p95 within 2 ulp of float32; the
lat/lon residual sums within count * ulp(anchor).  Within the port, the
six combinations of impl and fast path must be byte-identical.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from heatmap_tpu.engine import state as jstate
from heatmap_tpu.engine import step as jstep
from heatmap_tpu_torch.engine import state as tstate
from heatmap_tpu_torch.engine import step as tstep
from tests.test_torch_engine import assert_packed_equal, assert_states_equal

RES = 9
WINDOW_S = 300
WATERMARK_S = 600
CAP = 1 << 11
N = 2048
BINS = 16
T0 = 1_700_000_000 - 1_700_000_000 % WINDOW_S     # a window start
EMPTY_WS = 2**31 - 1
IMPLS = ("sort", "rank", "probe")
COMBOS = [(impl, fp) for impl in IMPLS for fp in (True, False)]
# the tier the fast path takes on each batch of ``stream()``
TIERS = [3, 1, 2, 3, 1, 2, 3, 3, 3, 2]


def cells(rng, n):
    """``n`` distinct res-9 cells as (hi, lo) uint32 words: the mode and
    resolution bits fixed (as they are at one resolution), the 20
    variable bits of hi distinct, lo random over all 32 bits."""
    var = rng.choice((1 << 20) - 1, n, replace=False).astype(np.uint32)
    hi = np.uint32(0x08900000) | var
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def batch(rng, pool, ts0, n_live=N, spread=200):
    """N events over the cells of ``pool``, the first ``n_live`` valid,
    timestamps in [ts0, ts0 + spread)."""
    idx = rng.integers(0, len(pool[0]), N)
    ts = (ts0 + rng.integers(0, spread, N)).astype(np.int32)
    valid = np.arange(N) < n_live
    return dict(
        hi=pool[0][idx], lo=pool[1][idx], ts=ts, valid=valid,
        speed=rng.uniform(0.0, 120.0, N).astype(np.float32),
        lat=rng.uniform(42.30, 42.40, N).astype(np.float32),
        lon=rng.uniform(-71.10, -71.00, N).astype(np.float32))


def splice(b, other, n, rng):
    """``b`` with ``n`` random events of ``other`` in place of its own."""
    out = {k: v.copy() for k, v in b.items()}
    idx = rng.choice(N, n, replace=False)
    for k in out:
        out[k][idx] = other[k][idx]
    return out


def stream(seed=7):
    rng = np.random.default_rng(seed)
    a, new, burst, c = (cells(rng, k) for k in (200, 50, 1500, 100))
    b0 = batch(rng, a, T0)
    b1 = batch(rng, a, T0)                          # the same cells: hits
    b2 = splice(batch(rng, a, T0), batch(rng, new, T0), 60, rng)
    b3 = batch(rng, a, T0)
    b3["hi"][:1500], b3["lo"][:1500] = burst        # 1500 fresh cells
    b4 = splice(batch(rng, a, T0), batch(rng, a, T0 - 2000), N // 2, rng)
    b5 = batch(rng, c, T0 + 900, n_live=500)        # a new window
    b6 = batch(rng, c, T0 + 900)                    # evicts the first
    b7 = batch(rng, cells(rng, N), T0 + 900)        # fresh cells ...
    b8 = batch(rng, cells(rng, N), T0 + 900)        # ... overflow
    b9 = batch(rng, c, T0 + 900)                    # some were dropped
    return [b0, b1, b2, b3, b4, b5, b6, b7, b8, b9]


def fold_args(b):
    ws = np.where(b["valid"], (b["ts"] // WINDOW_S) * WINDOW_S, EMPTY_WS)
    return (b["hi"], b["lo"], ws.astype(np.int32), b["speed"], b["lat"],
            b["lon"], b["ts"], b["valid"])


def to_torch(args):
    out = []
    for a in args:
        a = np.ascontiguousarray(a)
        out.append(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                    else a.copy()))
    return out


def run_port(batches, impl, fastpath, monkeypatch, bins=BINS):
    """Fold ``batches`` with the port; returns per batch (state, packed
    emit with its stats ridden, tier taken or None)."""
    monkeypatch.setattr(tstep, "MERGE_IMPL", impl)
    monkeypatch.setattr(tstep, "FASTPATH", fastpath)
    params = tstep.AggParams(RES, WINDOW_S, emit_capacity=N)
    st = tstate.init_state(CAP, bins, "cpu")
    max_ts, out = tstep.I32_MIN, []
    for b in batches:
        cutoff = max_ts - WATERMARK_S if max_ts > tstep.I32_MIN else max_ts
        before = dict(tstep._merge_fastpath.tiers)
        st, emit, stats = tstep.merge_batch(st, *to_torch(fold_args(b)),
                                            cutoff, params)
        tier = [t for t, n in tstep._merge_fastpath.tiers.items()
                if n != before[t]]
        packed = tstep.ride_stats(tstep.pack_emit(emit, 256.0), stats)
        out.append((st, packed, tier[0] if tier else None))
        max_ts = max(max_ts, int(stats.batch_max_ts))
    return out


def run_jax(batches, impl, fastpath, monkeypatch):
    monkeypatch.setattr(jstep, "MERGE_IMPL", impl)
    monkeypatch.setattr(jstep, "FASTPATH", fastpath)
    params = jstep.AggParams(RES, WINDOW_S, emit_capacity=N)
    st = jstate.init_state(CAP, BINS)
    max_ts, out = tstep.I32_MIN, []
    for b in batches:
        cutoff = max_ts - WATERMARK_S if max_ts > tstep.I32_MIN else max_ts
        st, emit, stats = jstep.merge_batch(st, *fold_args(b),
                                            np.int32(cutoff), params)
        packed = jstep.ride_stats(jstep.pack_emit(emit, 256.0), stats)
        out.append((st, np.asarray(packed)))
        max_ts = max(max_ts, int(stats.batch_max_ts))
    return out


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.fixture(scope="module")
def batches():
    return stream()


@pytest.mark.parametrize("impl,fastpath", COMBOS)
def test_merge_matches_jax_per_batch(batches, impl, fastpath, monkeypatch):
    ref = run_jax(batches, impl, fastpath, monkeypatch)
    mine = run_port(batches, impl, fastpath, monkeypatch)
    stats = []
    for k, ((jst, jp), (tst, tp, _)) in enumerate(zip(ref, mine)):
        try:
            assert_packed_equal(jp, tp.numpy().view(np.uint32))
            assert_states_equal(jst, tst)
        except AssertionError as e:
            raise AssertionError(f"batch {k}: {e}") from None
        stats.append(tp[0, 2:8].numpy())
    stats = np.asarray(stats)     # n_valid, n_late, n_evicted, ...
    # the stream exercises every path of the prologue and the overflow
    assert stats[:, 1].sum() > 0 and stats[:, 2].sum() > 0
    assert stats[:, 4].sum() > 0


@pytest.mark.parametrize("bins", [BINS, 0])
def test_six_routes_byte_identical(batches, bins, monkeypatch):
    runs = {c: run_port(batches, *c, monkeypatch, bins=bins)
            for c in COMBOS}
    first = runs[COMBOS[0]]
    for combo, run in runs.items():
        for k, ((st0, p0, _), (st, p, _)) in enumerate(zip(first, run)):
            assert torch.equal(p, p0), (combo, k)
            for name, a, b in zip(tstate.TileState._fields, st0, st):
                assert torch.equal(bits(a), bits(b)), (combo, k, name)


@pytest.mark.parametrize("impl", IMPLS)
def test_fastpath_takes_every_tier(batches, impl, monkeypatch):
    tiers = [t for _, _, t in run_port(batches, impl, True, monkeypatch)]
    assert tiers == TIERS
    assert set(tiers) == {1, 2, 3}
    off = [t for _, _, t in run_port(batches, impl, False, monkeypatch)]
    assert off == [None] * len(batches)


def port_state_after(b, cap=CAP, bins=0):
    params = tstep.AggParams(RES, WINDOW_S, emit_capacity=N)
    st = tstate.init_state(cap, bins, "cpu")
    st, _, _ = tstep.merge_batch(st, *to_torch(fold_args(b)), tstep.I32_MIN,
                                 params, impl="sort")
    return st, params


def test_predicate_scenarios(batches):
    """fast_ok exactly when every valid event hits an existing row and no
    window evicts (the reference's scenarios), and the port's probe gives
    the JAX probe's late mask, hits and fast_ok."""
    b0, b1, b2 = batches[:3]
    st, params = port_state_after(b0)
    jst = jstate.init_state(CAP, 0)
    jparams = jstep.AggParams(RES, WINDOW_S, emit_capacity=N)
    jst, _, _ = jstep.merge_batch(jst, *fold_args(b0), np.int32(-2**31),
                                  jparams, impl="sort")

    late_b = dict(b1, ts=(b1["ts"] - 7200).astype(np.int32))
    cases = [
        (b1, tstep.I32_MIN, True),           # the same keys again
        (b2, tstep.I32_MIN, False),          # new cells
        (b1, T0 + 600, False),               # the cutoff closes the window
        (late_b, T0 - 600, True),            # all late: vacuously all-hit
    ]
    for b, cutoff, want in cases:
        hi, lo, ws, _, _, _, _, valid = fold_args(b)
        late, ev_valid, pos, hit, ok = tstep._fastpath_probe(
            st, *to_torch((hi, lo, ws, valid)), cutoff, params)
        assert bool(ok) is want, (cutoff, want)
        jl, jv, jpos, jhit, jok = jstep._fastpath_probe(
            jst, hi, lo, ws, valid, np.int32(cutoff), jparams)
        assert bool(jok) is want
        np.testing.assert_array_equal(late.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(ev_valid.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        if cutoff < T0 + 600:       # no eviction: the slab stays sorted
            np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("cap,n,picks_rank", [(2048, 128, True),
                                              (256, 128, False)])
def test_auto_dispatch(cap, n, picks_rank, monkeypatch):
    """auto picks rank only when the slab holds at least 4x the batch,
    both as the route itself and as the fast path's tier-3 impl."""
    monkeypatch.setattr(tstep, "MERGE_IMPL", "auto")
    b = {k: v[:n] for k, v in stream()[0].items()}
    params = tstep.AggParams(RES, WINDOW_S, emit_capacity=n)
    args = (tstate.init_state(cap, 0, "cpu"), *to_torch(fold_args(b)),
            tstep.I32_MIN, params)
    monkeypatch.setattr(tstep, "FASTPATH", False)
    with mock.patch.object(tstep, "_merge_rank",
                           wraps=tstep._merge_rank) as mr, \
         mock.patch.object(tstep, "_merge_sort",
                           wraps=tstep._merge_sort) as ms:
        tstep.merge_batch(*args)
    assert mr.called == picks_rank
    assert ms.called == (not picks_rank)
    monkeypatch.setattr(tstep, "FASTPATH", True)
    with mock.patch.object(tstep, "_merge_fastpath",
                           wraps=tstep._merge_fastpath) as fp:
        tstep.merge_batch(*args)
    assert fp.call_args.args[-1] == ("rank" if picks_rank else "sort")


def test_probe_zero_rounds_falls_back(batches, monkeypatch):
    """PROBE_ROUNDS=0 places nothing: every batch takes the sort route of
    the rank rails, reads its fallback flag once, and still matches sort
    exactly."""
    ref = run_port(batches, "sort", False, monkeypatch)
    monkeypatch.setattr(tstep, "PROBE_ROUNDS", 0)
    reads = tstep._read_flags.reads
    with mock.patch.object(tstep, "_sorted_batch_uniques",
                           wraps=tstep._sorted_batch_uniques) as sbu:
        got = run_port(batches, "probe", False, monkeypatch)
    assert sbu.call_count == len(batches)
    assert tstep._read_flags.reads - reads == len(batches)
    for (st0, p0, _), (st, p, _) in zip(ref, got):
        assert torch.equal(p, p0)
        for a, b in zip(st0, st):
            assert torch.equal(bits(a), bits(b))


def test_env_read_at_call_time(monkeypatch):
    """HEATMAP_MERGE_IMPL / HEATMAP_FASTPATH set after import are honored,
    and the override slots win over them."""
    monkeypatch.setattr(tstep, "MERGE_IMPL", None)
    monkeypatch.setattr(tstep, "FASTPATH", None)
    monkeypatch.delenv("HEATMAP_MERGE_IMPL", raising=False)
    monkeypatch.delenv("HEATMAP_FASTPATH", raising=False)
    assert tstep._resolve_merge_impl() == "auto"
    assert tstep._resolve_fastpath() is True
    monkeypatch.setenv("HEATMAP_MERGE_IMPL", "rank")
    assert tstep._resolve_merge_impl() == "rank"
    monkeypatch.setenv("HEATMAP_MERGE_IMPL", "probe")
    assert tstep._resolve_merge_impl() == "probe"
    monkeypatch.setattr(tstep, "MERGE_IMPL", "sort")
    assert tstep._resolve_merge_impl() == "sort"

    b = {k: v[:256] for k, v in stream()[0].items()}
    params = tstep.AggParams(RES, WINDOW_S, emit_capacity=256)
    st = tstate.init_state(1024, 0, "cpu")
    args = (st, *to_torch(fold_args(b)), tstep.I32_MIN, params)
    monkeypatch.setenv("HEATMAP_FASTPATH", "0")
    with mock.patch.object(tstep, "_merge_fastpath",
                           wraps=tstep._merge_fastpath) as fp:
        tstep.merge_batch(*args)
    assert not fp.called
    monkeypatch.delenv("HEATMAP_FASTPATH")
    with mock.patch.object(tstep, "_merge_fastpath",
                           wraps=tstep._merge_fastpath) as fp:
        tstep.merge_batch(*args)
    assert fp.called
    monkeypatch.setattr(tstep, "FASTPATH", False)
    with mock.patch.object(tstep, "_merge_fastpath",
                           wraps=tstep._merge_fastpath) as fp:
        tstep.merge_batch(*args)
    assert not fp.called
    with pytest.raises(ValueError, match="sort\\|rank\\|probe\\|auto"):
        tstep.merge_batch(*args, impl="bogus")


def test_searchsorted_pair_matches_jax():
    """Leftmost insertion points of unsigned (k1, lo) pairs, high bits
    set on both words, against the reference's unrolled search."""
    rng = np.random.default_rng(11)
    n = 1000
    a1 = np.sort(rng.integers(2**31 - 4, 2**31 + 4, n).astype(np.uint32))
    a1[-8:] = 0xFFFFFFFF
    a2 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    order = np.lexsort((a2, a1))
    a1, a2 = a1[order], a2[order]
    q1 = np.concatenate([a1, rng.integers(2**31 - 6, 2**31 + 6, 500)
                         .astype(np.uint32), [0, 0xFFFFFFFF]]).astype(
                             np.uint32)
    q2 = np.concatenate([a2, rng.integers(0, 2**32, 500, dtype=np.uint64)
                         .astype(np.uint32), [0, 0xFFFFFFFF]]).astype(
                             np.uint32)
    # the definition: the leftmost insertion point of the u64 keys
    key = lambda x1, x2: (x1.astype(np.uint64) << np.uint64(32)) | x2
    want = np.searchsorted(key(a1, a2), key(q1, q2), side="left")
    ref = np.asarray(jstep._searchsorted_pair(a1, a2, q1, q2))
    # the reference's fixed-count search overshoots to n + 1 for a query
    # above every row (no caller sees it: each tests pos < n first)
    over = want == n
    np.testing.assert_array_equal(ref[~over], want[~over])
    assert set(ref[over]) <= {n, n + 1}
    t = lambda w: torch.from_numpy(w.view(np.int32).copy())
    got = tstep._searchsorted_pair(torch.from_numpy(a1.astype(np.int64)),
                                   t(a2), torch.from_numpy(
                                       q1.astype(np.int64)), t(q2))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (a1 >= 2**31).any() and (a2 >= 2**31).any()


def test_probe_hash_wraps_as_uint32():
    """The probe hash's products wrap as uint32 multiplies do."""
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64)
    a[:3] = [0, 0xFFFFFFFF, 0x80000000]
    for b in (0x9E3779B9, 0x85EBCA6B):
        want = (a.astype(np.uint32) * np.uint32(b)).astype(np.int64)
        got = tstep._mul_u32(torch.from_numpy(a.astype(np.int64)), b)
        np.testing.assert_array_equal(got.numpy(), want)
