"""The rounds kernel's row pitch and tiling, held on the CPU.

``heatmap_tpu_torch/infer/csrc/kalman_rounds.cu`` moves its round planes
with TMA, so on the card every (K, M) plane has its rows ``ld =
row_pitch(M)`` entities apart and the kernel gets ``[:, :M]`` views; a
block walks a tile of T entities through the rounds in chunks of R rounds,
and the tails of both are zero-filled boxes.  No card here, so these tests
hold the facts that design rests on with the plain version,
``filter_rounds_reference``:

- the plain version on pitched views equals its contiguous run bit for
  bit, and the JAX package's ``filter_rounds`` under
  ``test_torch_infer.py``'s bar (rtol 1e-5 / atol 1e-3: XLA contracts
  FMAs);
- ``row_pitch`` and ``pitched`` give ``ld >= M``, a multiple of 16, and
  strides the wrapper's ``_check`` and ``kernel_pitch`` accept; planes the
  kernel cannot take raise before any device is asked for a kernel;
- a zero-filled lane (valid = reseed = 0, dt = z = 0) leaves x and P as
  they are and writes zeros;
- K split into chunks and M into tiles, with zero-filled tails, equals the
  one-pass plain version bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from heatmap_tpu.infer import kalman as jkalman
from heatmap_tpu_torch.infer import kalman as tkalman
from test_torch_infer import KW, assert_rounds_close, rounds_corpus

CONSTS = tkalman.filter_consts(**KW)
PLANES = ("z", "dt", "valid", "reseed")


def to_tensors(args, pitch: bool):
    """The numpy round set as CPU tensors, the planes pitched or
    contiguous."""
    x, P, *planes = (torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    k, m = planes[2].shape
    if pitch:
        planes = [tkalman.pitched(k, m, t.shape[2:], t.dtype, "cpu")
                  .copy_(t) for t in planes]
    return [x, P, *planes]


@pytest.mark.parametrize("seed,k,m", [(11, 1, 1), (12, 3, 5), (13, 9, 17),
                                      (14, 27, 33), (15, 2, 20_001)])
def test_plain_version_on_pitched_views(seed, k, m):
    args = rounds_corpus(seed, k, m)
    pitched = to_tensors(args, pitch=True)
    assert pitched[4].stride(0) == tkalman.row_pitch(m) or k == 1
    got = tkalman.kalman_rounds(*pitched, CONSTS)
    flat = tkalman.kalman_rounds(*to_tensors(args, pitch=False), CONSTS)
    for a, b in zip(got, flat):
        assert torch.equal(a, b)
    assert_rounds_close(tuple(t.numpy() for t in got),
                        jkalman.filter_rounds(*args, **KW))


@pytest.mark.parametrize("m", [1, 15, 16, 17, 20_000, 20_001])
@pytest.mark.parametrize("k", [1, 3])
def test_pitch_helper_gives_what_the_kernel_takes(k, m):
    ld = tkalman.row_pitch(m)
    assert m <= ld < m + tkalman.PITCH and ld % 16 == 0
    dtypes = {"z": torch.float32, "dt": torch.float32, "valid": torch.bool,
              "reseed": torch.bool}
    planes = {name: tkalman.pitched(k, m, (2,) if name == "z" else (),
                                    dtypes[name], "cpu")
              for name in PLANES}
    assert planes["z"].stride() == (2 * ld, 2, 1)
    assert planes["valid"].stride() == (ld, 1)
    pitches = [tkalman._check(name, t, k, m, torch.device("cpu"))
               for name, t in planes.items()]
    assert pitches == [ld if k > 1 else None] * 4
    assert tkalman.kernel_pitch(planes, pitches, k, m) == ld


def _meta_rounds(k, m, pitch: bool):
    meta = torch.device("meta")
    x = torch.empty((m, 4), device=meta)
    P = torch.empty((m, 4, 4), device=meta)
    dtypes = (torch.float32, torch.float32, torch.bool, torch.bool)
    tails = ((2,), (), (), ())
    planes = [tkalman.pitched(k, m, tail, dt, meta) if pitch
              else torch.empty((k, m, *tail), dtype=dt, device=meta)
              for tail, dt in zip(tails, dtypes)]
    return x, P, *planes


@pytest.mark.parametrize("m,qualifies", [(5, False), (20_001, False),
                                         (16, True), (20_000, True)])
def test_unpitched_planes_raise_before_any_kernel(m, qualifies):
    """Off the CPU a plane whose rows TMA cannot take raises; a contiguous
    plane with M % 16 == 0, or a pitched one, gets as far as asking the
    device for a kernel (none on ``meta``)."""
    for pitch in (False, True):
        with pytest.raises(ValueError) as e:
            tkalman.kalman_rounds(*_meta_rounds(3, m, pitch), CONSTS)
        assert ("no kernel for meta" if pitch or qualifies
                else "row pitch") in str(e.value)
    mixed = list(_meta_rounds(3, 32, pitch=False))
    mixed[3] = tkalman.pitched(3, 32, (), torch.float32, "meta", ld=48)
    with pytest.raises(ValueError, match="pitches differ"):
        tkalman.kalman_rounds(*mixed, CONSTS)


@pytest.mark.parametrize("state", ["warm", "zero"])
def test_zero_lane_leaves_state_and_writes_zeros(state):
    """valid = reseed = 0, dt = z = 0 in every round: x and P come out as
    they went in (a zero-filled tail lane of the kernel: state zero too)
    and every output is zero."""
    k, m = 11, 40
    x, P = rounds_corpus(21, k, m)[:2]
    if state == "zero":
        x, P = np.zeros_like(x), np.zeros_like(P)
    zero = [np.zeros((k, m, 2), np.float32), np.zeros((k, m), np.float32),
            np.zeros((k, m), bool), np.zeros((k, m), bool)]
    out = tkalman.kalman_rounds(*to_tensors((x, P, *zero), pitch=True),
                                CONSTS)
    assert torch.equal(out[0], torch.from_numpy(x))
    assert torch.equal(out[1], torch.from_numpy(P))
    for t in out[2:]:
        assert not t.any()


def tiled_run(ins, rounds: int, tile: int):
    """The plain version run as the kernel walks the set: M cut into tiles
    of ``tile`` entities and K into chunks of ``rounds`` rounds, both
    padded with zero-filled lanes and rounds, the state carried from chunk
    to chunk, the outputs cropped."""
    x, P, z, dt, valid, reseed = ins
    k, m = valid.shape
    kp, mp = -(-k // rounds) * rounds, -(-m // tile) * tile

    def pad(t, shape):
        out = torch.zeros(shape, dtype=t.dtype)
        out[tuple(slice(0, n) for n in t.shape)] = t
        return out

    x, P = pad(x, (mp, 4)), pad(P, (mp, 4, 4))
    z, dt = pad(z, (kp, mp, 2)), pad(dt, (kp, mp))
    valid, reseed = pad(valid, (kp, mp)), pad(reseed, (kp, mp))
    planes = [torch.zeros_like(dt), torch.zeros_like(valid),
              torch.zeros_like(dt), torch.zeros_like(z)]
    for e0 in range(0, mp, tile):
        xs, ps = x[e0:e0 + tile], P[e0:e0 + tile]
        for r0 in range(0, kp, rounds):
            box = (slice(r0, r0 + rounds), slice(e0, e0 + tile))
            xs, ps, *outs = tkalman.filter_rounds_reference(
                xs, ps, z[box], dt[box], valid[box], reseed[box], CONSTS)
            for plane, o in zip(planes, outs):
                plane[box] = o
        x[e0:e0 + tile], P[e0:e0 + tile] = xs, ps
    return (x[:m], P[:m], *(p[:k, :m] for p in planes))


@pytest.mark.parametrize("k,m,rounds,tile", [
    (27, 100, 8, 64), (27, 20, 8, 16), (1, 5, 8, 16), (13, 70, 8, 32),
    (200, 17, 8, 16), (9, 33, 4, 16), (30, 50, 16, 64)])
def test_chunks_and_tiles_equal_one_pass(k, m, rounds, tile):
    ins = to_tensors(rounds_corpus(31 + k, k, m), pitch=False)
    one = tkalman.filter_rounds_reference(*ins, CONSTS)
    for a, b in zip(tiled_run(ins, rounds, tile), one):
        assert torch.equal(a, b)
    # past a few lanes the corpus reaches the gate, a re-seed and a
    # clamped dt
    assert (one[3].any() and ins[5].any() and (ins[3] < 0).any()
            or k * m < 100)
