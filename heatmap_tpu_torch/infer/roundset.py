"""A seeded round set of the rounds scan (``infer/csrc/kalman_rounds.cu``)
and the work it needs, for measuring the kernel against its bound:
``chip_smoke.py``'s ``infer`` phase builds its full-table and edge round
sets with ``round_set`` and turns ``rounds_work`` into the bound.
"""

from __future__ import annotations

import numpy as np

# f32 operations of one (round, entity) of the rounds scan, each add,
# subtract, multiply, divide and compare counted once and the hypot as one
# (selects not counted; a lower bound): the clamp 1, dt2 and dt3 3, the
# predicted covariance 42, the predicted position 4, the innovation 2,
# S and its determinant 6, its inverse 4, the NIS 9, the gain 24, the
# updated state 16, B = (I - KH) Pp 64, the Joseph covariance 90, the gate
# 1 and the speed 1
ROUND_OPS = 267


def round_set(k: int, m: int, seed: int):
    """(x, P, z, dt, valid, reseed) as numpy: warm states, a
    constant-velocity walk with GPS noise, 1% teleports, 10% empty lanes,
    1% handoff re-seeds (half of the teleport lanes among them, where the
    re-seed takes precedence over the gate), and 1% each of dt = 0 and
    dt < 0, so every branch of the filter runs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 300, (m, 4)).astype(np.float32)
    P = np.zeros((m, 4, 4), np.float32)
    P[:, [0, 1, 2, 3], [0, 1, 2, 3]] = rng.uniform(5, 50, (m, 4))
    t = np.cumsum(rng.uniform(1, 10, (k, m)), axis=0)
    z = (x[None, :, :2] + x[None, :, 2:] * t[..., None]
         + rng.normal(0, 10, (k, m, 2))).astype(np.float32)
    jump = rng.random((k, m)) < 0.01
    z[jump] += np.float32(50_000.0)
    dt = np.diff(t, axis=0, prepend=0.0).astype(np.float32)
    dt[rng.random((k, m)) < 0.01] = np.float32(0.0)
    back = rng.random((k, m)) < 0.01
    dt[back] = -dt[back]
    valid = rng.random((k, m)) < 0.9
    reseed = (rng.random((k, m)) < 0.01) | (jump & (rng.random((k, m)) < 0.5))
    return x, P, z, dt, valid, reseed


def rounds_work(valid) -> tuple[float, float]:
    """(bytes, operations) the scan needs on these inputs: per (round,
    entity) z 8, dt 4, valid 1 and reseed 1 in and nis 4, tele 1, spd 4
    and inn 8 out; per entity x and P in and out, 160 B; ROUND_OPS for each
    valid (round, entity)."""
    k, m = valid.shape
    return 31.0 * k * m + 160.0 * m, float(ROUND_OPS) * int(valid.sum())
