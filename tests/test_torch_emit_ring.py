"""The port's device-resident emit ring and live-prefix pulls
(heatmap_tpu_torch.engine.step: EmitRing, pull_packed_stack), against the
JAX package's pulls on the same matrices.

The packed emits come from the port's own fold on the CPU.  The ring
changes when and in how many transfers emits cross to the host, never
their content: a stacked flush must equal per-batch pulls exactly, and a
prefix pull must equal the full pull on the head rows and the live rows.
"""

import numpy as np
import pytest
import torch

from heatmap_tpu.engine import step as jstep
from heatmap_tpu_torch.engine import step as tstep
from heatmap_tpu_torch.engine.multi import (MultiAggregator, MultiStats,
                                            stats_from_packed)
from heatmap_tpu_torch.engine.step import EmitRing, pull_packed_stack

T0 = 1_700_000_000


def packs(n_batches, seed=1, emit_capacity=256):
    """Packed emits of ``n_batches`` batches of 128 events folded by the
    port on the CPU: (1, E+1, 13) int32 tensors."""
    rng = np.random.default_rng(seed)
    agg = MultiAggregator([(8, 300)], 1 << 10, 128,
                          emit_capacity=emit_capacity,
                          hist_bins=8, device="cpu")
    out = []
    for k in range(n_batches):
        t = lambda a: torch.from_numpy(np.asarray(a))
        out.append(agg.step_packed_all(
            t(rng.uniform(0.73, 0.74, 128).astype(np.float32)),
            t(rng.uniform(-1.25, -1.24, 128).astype(np.float32)),
            t(rng.uniform(0, 90, 128).astype(np.float32)),
            t(np.full(128, T0 + k, np.int32)), torch.ones(128, dtype=bool),
            tstep.I32_MIN))
    return out


def zeros(rows=9):
    return torch.zeros((1, rows, 13), dtype=torch.int32)


@pytest.mark.parametrize("prefix", [False, True])
def test_stacked_flush_equals_per_batch_pull(prefix):
    ps = packs(3)
    ring = EmitRing(4)
    for i, p in enumerate(ps):
        assert not ring.append(p, tag=i)
    flushed = ring.flush_stacked(prefix)
    assert [t for _, t in flushed] == [0, 1, 2]
    assert len(ring) == 0 and ring.n_flushes == 1
    for (bufs, _tag), p in zip(flushed, ps):
        ref = pull_packed_stack(p, prefix)
        assert len(bufs) == len(ref) == 1
        assert bufs[0].dtype == np.uint32
        np.testing.assert_array_equal(bufs[0], ref[0])
        # the ridden stats decode identically through the ring
        assert stats_from_packed(bufs[0]) == stats_from_packed(ref[0])
        assert isinstance(stats_from_packed(bufs[0]), MultiStats)


def test_prefix_pull_matches_jax():
    """The port's pulls give the JAX package's on the same stacked matrix,
    and the prefix pull keeps the head rows and every live row."""
    stacked = torch.cat(packs(3), dim=0)             # (3, E+1, 13)
    as_u32 = stacked.numpy().view(np.uint32)
    n_emitted = as_u32[:, 0, 0].astype(np.int64)
    assert 0 < n_emitted.max() < 128
    for prefix in (False, True):
        got = pull_packed_stack(stacked, prefix)
        want = jstep.pull_packed_stack(as_u32, prefix)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    full = pull_packed_stack(stacked, False)
    pre = pull_packed_stack(stacked, True)
    bucket = 1 << int(n_emitted.max() - 1).bit_length()
    for f, p, n in zip(full, pre, n_emitted):
        assert p.shape == (1 + bucket, 13)
        np.testing.assert_array_equal(p, f[:1 + bucket])
        assert not f[1 + n:, 8].any()                # no live row is left
    one = tstep.pull_emit_prefix(stacked[1])
    np.testing.assert_array_equal(one, np.asarray(
        jstep.pull_emit_prefix(as_u32[1])))


def test_prefix_pull_on_overflow_takes_every_row():
    """n_emitted past the emit capacity: the bucket is the whole body."""
    p = packs(1, emit_capacity=8)[0]
    assert int(p[0, 0, 0]) > 8 and bool(p[0, 0, 1])
    got = pull_packed_stack(p, True)[0]
    np.testing.assert_array_equal(got, p[0].numpy().view(np.uint32))
    np.testing.assert_array_equal(
        got, np.asarray(jstep.pull_packed_stack(got[None], True)[0]))


def test_emitring_refuses_shape_change():
    ring = EmitRing(4)
    ring.append(zeros(9))
    with pytest.raises(ValueError, match="flush before"):
        ring.append(zeros(17))


def test_emitring_residency_accounting():
    """take() records per entry the seconds parked and the batches
    resident: the oldest entry of a K-deep flush reads K."""
    ring = EmitRing(4)
    for tag in range(3):
        ring.append(zeros(), tag)
    entries = ring.take()
    res = ring.last_flush_residency
    assert len(entries) == len(res) == 3
    assert [b for _, b in res] == [3, 2, 1]
    assert all(s >= 0.0 for s, _ in res)
    assert ring.last_flush_live == [True] * 3
    ring.append(zeros(), 9)
    ring.take()
    assert [b for _, b in ring.last_flush_residency] == [1]
    ring.take()
    assert ring.last_flush_residency == [] and ring.n_flushes == 2


def test_emitring_capacity_and_nbytes():
    ring = EmitRing(2)
    assert ring.nbytes == 0
    assert not ring.append(zeros())
    assert ring.append(zeros())          # full
    assert ring.full and len(ring) == 2
    assert ring.nbytes == 2 * 9 * 13 * 4
    assert len(ring.flush_stacked(False)) == 2
    assert not ring.full and ring.nbytes == 0
    assert ring.flush_stacked(True) == []
    assert EmitRing(0).capacity == 1


def test_emitring_idle_entries_do_not_trigger():
    """Entries appended live=False park but do not advance the flush
    trigger; past 8 x capacity parked entries the ring reads full."""
    ring = EmitRing(2)
    for i in range(15):
        assert not ring.full
        ring.append(zeros(), tag=i, live=False)
    assert len(ring) == 15 and ring.live_pending == 0
    assert ring.append(zeros(), live=False)
    assert ring.full
    assert len(ring.flush_stacked(False)) == 16 and not ring.full
    ring.append(zeros(), live=False)
    assert not ring.append(zeros(), live=True)
    assert ring.live_pending == 1 and not ring.full
    assert ring.append(zeros(), live=True)
    assert ring.full
    assert len(ring.take()) == 3
    assert ring.live_pending == 0
