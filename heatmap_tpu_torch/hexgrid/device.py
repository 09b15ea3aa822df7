"""Plain PyTorch H3 snap: ``latlng_to_cell_vec`` on tensors.

The counterpart of ``heatmap_tpu/hexgrid/device.py`` (the XLA snap):
(lat, lng) radians in, the 64-bit H3 cell index out as two int32 words
``(hi, lo)`` that hold the uint32 bit patterns of the reference's words.
Torch covers few ``uint32`` ops, so the words ride as int32 bit views
(``.numpy().view(np.uint32)`` recovers the reference's arrays).

The geometry stage follows the reference op for op:
- the icosahedron face search is a (N, 3) x (3, 20) float matmul plus
  argmax.  TF32 would move the face choice at face edges, so
  ``_geo_to_hex2d_vec`` turns it off for the matmul it runs;
- the gnomonic projection is ``v / d - c`` dotted with two per-face
  tangent bases (``_projection_bases``);
- the aperture-7 digit chain is exact int32 arithmetic, packed 3 bits per
  digit for res <= 10.

Every division by a constant divides by a tensor on the same device:
on CUDA, PyTorch turns ``tensor / python_float`` into a multiply by the
reciprocal, which rounds differently from the reference's true division.

The table stage (``_apply_rotations_packed`` / ``_pack_packed``) is shared
by this snap and the fused kernel's plain version (``snap_kernel``).  Resolutions
above 10 (the reference's ``(N, res)`` digit arrays) are not ported yet.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from heatmap_tpu_torch.hexgrid import _tables
from heatmap_tpu_torch.hexgrid.constants import (
    FACE_AXES_AZ_CII,
    FACE_CENTER_XYZ,
    M_AP7_ROT_RADS,
    M_SIN60,
    M_SQRT7,
    RES0_U_GNOMONIC,
)
from heatmap_tpu_torch.hexgrid.mathlib import (
    _DOWN_AP7,
    _DOWN_AP7R,
    K_AXES_DIGIT,
    ROTATE60_CCW,
    is_class_iii,
)

MAX_PACKED_RES = 10


# ---------------------------------------------------------------------------
# Precomputed projection bases and packed tables (host-side, float64)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _projection_bases() -> tuple[np.ndarray, np.ndarray]:
    """Per-face tangent basis (U1, U2), each (20, 3) float64.

    ``x_hex = p . U1[f]``, ``y_hex = p . U2[f]`` give the Class II hex-plane
    coordinates in res-0 grid units (the 1/RES0_U_GNOMONIC scale is folded
    in)."""
    c = FACE_CENTER_XYZ  # (20, 3)
    zhat = np.array([0.0, 0.0, 1.0])
    north = zhat[None, :] - (c @ zhat)[:, None] * c
    north /= np.linalg.norm(north, axis=1, keepdims=True)
    east = np.cross(np.broadcast_to(zhat, c.shape), c)
    east /= np.linalg.norm(east, axis=1, keepdims=True)
    az0 = FACE_AXES_AZ_CII[:, None]
    u1 = np.cos(az0) * north + np.sin(az0) * east
    u2 = np.sin(az0) * north - np.cos(az0) * east
    return u1 / RES0_U_GNOMONIC, u2 / RES0_U_GNOMONIC


@functools.lru_cache(maxsize=1)
class _DeviceTables:
    """Grid lookup tables as flat int32 numpy arrays ready for gathers."""

    def __init__(self):
        self.face_ijk_bc = np.asarray(_tables.FACE_IJK_BC, np.int32).reshape(-1)   # (540,)
        self.face_ijk_rot = np.asarray(_tables.FACE_IJK_ROT, np.int32).reshape(-1)
        self.bc_pent = np.asarray(_tables.BC_PENT, np.int32)                       # (122,)
        self.pent_cw_offset = np.asarray(_tables.PENT_CW_OFFSET, np.int32).reshape(-1)  # (2440,)
        # ccw_pow[k*7 + d] = CCW^k(d): per-digit rotation by a variable
        # count in one tiny-table gather
        pow_tab = np.zeros((6, 7), np.int32)
        pow_tab[0] = np.arange(7)
        for k in range(1, 6):
            pow_tab[k] = np.asarray(ROTATE60_CCW, np.int32)[pow_tab[k - 1]]
        self.ccw_pow = pow_tab.reshape(-1)


@functools.lru_cache(maxsize=None)
def _tables_on(device: torch.device) -> dict:
    """The table stage's lookup tables as int64 tensors on ``device``
    (int64 so that they index other tensors directly)."""
    T = _DeviceTables()
    return {name: torch.as_tensor(getattr(T, name), dtype=torch.int64,
                                  device=device)
            for name in ("face_ijk_bc", "face_ijk_rot", "bc_pent",
                         "pent_cw_offset", "ccw_pow")}


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def scalar_tensor(value: float, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A 0-dim tensor of ``value`` on ``device``, made once (its host copy
    waits on the device, so the fold must not make it per batch): a
    divisor that keeps true division on CUDA (see the module docstring).
    Callers only read it."""
    return torch.tensor(value, dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _geometry_on(dtype: torch.dtype, device: torch.device):
    """Face centers and the two tangent bases as (20, 3) tensors."""
    u1, u2 = _projection_bases()
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (FACE_CENTER_XYZ, u1, u2))


# ---------------------------------------------------------------------------
# Integer hex-lattice ops (vectorized, exact)
# ---------------------------------------------------------------------------

def _floordiv(x, d: int):
    return torch.div(x, d, rounding_mode="floor")


def _ijk_normalize(i, j, k):
    # fold negative axes, then subtract the min
    neg = torch.clamp(i, max=0)
    j, k, i = j - neg, k - neg, i - neg
    neg = torch.clamp(j, max=0)
    i, k, j = i - neg, k - neg, j - neg
    neg = torch.clamp(k, max=0)
    i, j, k = i - neg, j - neg, k - neg
    m = torch.minimum(torch.minimum(i, j), k)
    return i - m, j - m, k - m


def _div7_round(x):
    """round-half-away-from-zero of x/7 for int32 x (exact; x/7 is never a
    half-integer since 7*(2m+1)/2 is not integral)."""
    return _floordiv(2 * x + 7, 14)


def _up_ap7(i, j, k):
    ii = i - k
    jj = j - k
    return _ijk_normalize(_div7_round(3 * ii - jj), _div7_round(ii + 2 * jj),
                          torch.zeros_like(i))


def _up_ap7r(i, j, k):
    ii = i - k
    jj = j - k
    return _ijk_normalize(_div7_round(2 * ii + jj), _div7_round(3 * jj - ii),
                          torch.zeros_like(i))


def _lin3(vecs, i, j, k):
    iv, jv, kv = vecs
    return _ijk_normalize(
        i * iv[0] + j * jv[0] + k * kv[0],
        i * iv[1] + j * jv[1] + k * kv[1],
        i * iv[2] + j * jv[2] + k * kv[2],
    )


def _hex2d_to_ijk(x, y):
    """Vectorized cell rounding of hex-plane coordinates (exact ints)."""
    a1 = torch.abs(x)
    a2 = torch.abs(y)
    x2 = a2 / scalar_tensor(M_SIN60, a2.dtype, a2.device)
    x1 = a1 + x2 * 0.5
    m1 = torch.floor(x1).to(torch.int32)
    m2 = torch.floor(x2).to(torch.int32)
    r1 = x1 - m1
    r2 = x2 - m2

    third = 1.0 / 3.0
    # branch tree on r1
    # r1 < 1/3
    i_a = m1
    j_a = torch.where(r2 < (1.0 + r1) * 0.5, m2, m2 + 1)
    # 1/3 <= r1 < 1/2
    j_b = torch.where(r2 < (1.0 - r1), m2, m2 + 1)
    i_b = torch.where(((1.0 - r1) <= r2) & (r2 < 2.0 * r1), m1 + 1, m1)
    # 1/2 <= r1 < 2/3
    j_c = torch.where(r2 < (1.0 - r1), m2, m2 + 1)
    i_c = torch.where(((2.0 * r1 - 1.0) < r2) & (r2 < (1.0 - r1)), m1, m1 + 1)
    # r1 >= 2/3
    i_d = m1 + 1
    j_d = torch.where(r2 < r1 * 0.5, m2, m2 + 1)

    lo = r1 < 0.5
    i = torch.where(lo, torch.where(r1 < third, i_a, i_b),
                    torch.where(r1 < 2.0 * third, i_c, i_d))
    j = torch.where(lo, torch.where(r1 < third, j_a, j_b),
                    torch.where(r1 < 2.0 * third, j_c, j_d))

    # fold across the axes for negative x / y
    j_even = (j % 2) == 0
    axisi = torch.where(j_even, _floordiv(j, 2), _floordiv(j + 1, 2))
    diff = i - axisi
    i_folded = torch.where(j_even, i - 2 * diff, i - (2 * diff + 1))
    i = torch.where(x < 0.0, i_folded, i)

    i_yneg = i - _floordiv(2 * j + 1, 2)
    i = torch.where(y < 0.0, i_yneg, i)
    j = torch.where(y < 0.0, -j, j)

    return _ijk_normalize(i, j, torch.zeros_like(i))


# ---------------------------------------------------------------------------
# Packed digit chains (res <= 10): the whole chain in one int32 per point
# ---------------------------------------------------------------------------
# Field f (bits 3f..3f+2) holds the digit for resolution (res - f): the
# coarsest digit (r=1) sits in the TOP field, so the leading-nonzero digit
# is the highest nonzero 3-bit field.

def _lead_digit_packed(p):
    """Highest nonzero 3-bit field of packed chain p (0 if p == 0).

    The reference finds it with a count-leading-zeros; torch has none, so
    this walks the ten fields from the bottom and keeps the last nonzero
    one (p < 2**30 for res <= 10)."""
    lead = torch.zeros_like(p)
    for f in range(MAX_PACKED_RES):
        d = (p >> (3 * f)) & 7
        lead = torch.where(d != 0, d, lead)
    return lead


def _rot_fields_packed(p, pow_tab, rot, res: int):
    """Apply CCW^rot to every digit field of p (rot may be per-point)."""
    out = torch.zeros_like(p)
    base = rot * 7
    for f in range(res):
        d = (p >> (3 * f)) & 7
        out = out | (pow_tab[base + d].to(p.dtype) << (3 * f))
    return out


def _apply_rotations_packed(face, ijk, p, res: int):
    """Base-cell lookup + home-orientation digit rotations on the packed
    chain (res <= 10).  Returns (base cell, rotated chain), int32."""
    T = _tables_on(face.device)
    i, j, k = ijk
    flat = (((face * 3 + i) * 3 + j) * 3 + k).long()
    bc = T["face_ijk_bc"][flat]
    rot = T["face_ijk_rot"][flat]
    if res == 0:
        return bc.to(torch.int32), p
    pow_tab = T["ccw_pow"]
    is_pent = T["bc_pent"][bc] != 0
    cw_offset = T["pent_cw_offset"][bc * 20 + face] != 0

    # pentagon deleted-subsequence offset (leading K rotated out cw/ccw)
    k_leading = is_pent & (_lead_digit_packed(p) == K_AXES_DIGIT)
    # CW == CCW^5
    pre_rot = torch.where(cw_offset, 5, 1)
    p = torch.where(k_leading, _rot_fields_packed(p, pow_tab, pre_rot, res), p)

    # hexagons: plain CCW^rot in one pass
    ones = torch.ones_like(rot)
    p_hex = _rot_fields_packed(p, pow_tab, rot, res)

    # pentagons: rot x pent-ccw (skip the deleted K subsequence each step)
    p_pent = p
    for t in range(5):
        active = is_pent & (rot > t)
        p1 = _rot_fields_packed(p_pent, pow_tab, ones, res)
        fix = _lead_digit_packed(p1) == K_AXES_DIGIT
        p1 = torch.where(fix, _rot_fields_packed(p1, pow_tab, ones, res), p1)
        p_pent = torch.where(active, p1, p_pent)

    return bc.to(torch.int32), torch.where(is_pent, p_pent, p_hex)


def _pack_packed(bc, p, res: int):
    """Packed chain -> (hi, lo) H3 index words as int32 bit patterns
    (res <= 10).

    p's fields are already in H3 digit order; the whole block lands at bit
    offset 3*(15-res) of the 64-bit index.  The words are built in int64,
    where every shift is exact, and narrowed to their low 32 bits."""
    hi = (_tables.H3_MODE_CELL << 27) | (res << 20) | (bc.long() << 13)
    lo = torch.zeros_like(hi)
    off = 3 * (15 - res)
    pu = p.long()
    if res > 0:
        if off >= 32:
            hi = hi | (pu << (off - 32))
        else:
            lo = lo | ((pu << off) & 0xFFFFFFFF)
            if off + 3 * res > 32:
                hi = hi | (pu >> (32 - off))
    filler = 0
    for r in range(res + 1, 16):
        filler |= 7 << (3 * (15 - r))
    hi = hi | ((filler >> 32) & 0xFFFFFFFF)
    lo = lo | (filler & 0xFFFFFFFF)
    return _low_word(hi), _low_word(lo)


def _low_word(x):
    """int64 in [0, 2**32) -> int32 with the same 32-bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


# ---------------------------------------------------------------------------
# Forward transform
# ---------------------------------------------------------------------------

def _geo_to_hex2d_vec(lat, lng, res: int, dtype):
    """(N,) lat/lng radians -> (face, x, y) hex-plane coords at `res`."""
    # the face search is a float matmul: keep it in full precision on
    # CUDA (TF32 would move the face choice at face edges)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    faces_xyz, u1, u2 = _geometry_on(dtype, lat.device)

    clat = torch.cos(lat)
    v = torch.stack([clat * torch.cos(lng), clat * torch.sin(lng),
                     torch.sin(lat)], dim=-1)
    dots = v @ faces_xyz.T                      # (N, 20)
    face = torch.argmax(dots, dim=-1)
    d = torch.gather(dots, 1, face[:, None])    # cos(angular distance), > 0.93

    c = faces_xyz[face]                         # (N, 3)
    p = v / d - c                               # gnomonic tangent vector
    b1 = u1[face]
    b2 = u2[face]
    x = p[:, 0] * b1[:, 0] + p[:, 1] * b1[:, 1] + p[:, 2] * b1[:, 2]
    y = p[:, 0] * b2[:, 0] + p[:, 1] * b2[:, 1] + p[:, 2] * b2[:, 2]

    if is_class_iii(res):
        cr = _scalar(math.cos(M_AP7_ROT_RADS), dtype)
        sr = _scalar(math.sin(M_AP7_ROT_RADS), dtype)
        x, y = x * cr + y * sr, y * cr - x * sr

    scale = _scalar(M_SQRT7 ** res, dtype)
    return face.to(torch.int32), x * scale, y * scale


def _scalar(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (a python float that multiplies a
    tensor of that dtype the same way on every device)."""
    return float(np.float32(value)) if dtype == torch.float32 else value


def _forward_digits(lat, lng, res: int, dtype):
    """Geometry stage: (face, res-0 ijk, packed digit chain), exact ints.

    The chain is one (N,) int32 with the digits in 3-bit fields, coarsest
    on top (res <= 10)."""
    face, x, y = _geo_to_hex2d_vec(lat, lng, res, dtype)
    i, j, k = _hex2d_to_ijk(x, y)
    p = torch.zeros_like(i)
    for r in range(res, 0, -1):
        last = (i, j, k)
        if is_class_iii(r):
            i, j, k = _up_ap7(i, j, k)
            ci, cj, ck = _lin3(_DOWN_AP7, i, j, k)
        else:
            i, j, k = _up_ap7r(i, j, k)
            ci, cj, ck = _lin3(_DOWN_AP7R, i, j, k)
        di, dj, dk = _ijk_normalize(last[0] - ci, last[1] - cj, last[2] - ck)
        p = p | ((4 * di + 2 * dj + dk) << (3 * (res - r)))
    # guard: res-0 coords are mathematically within [0,2]; clamp for safety
    i = torch.clamp(i, 0, 2)
    j = torch.clamp(j, 0, 2)
    k = torch.clamp(k, 0, 2)
    return face, (i, j, k), p


def check_res(res: int) -> None:
    if not 0 <= res <= MAX_PACKED_RES:
        raise NotImplementedError(
            f"H3 res {res}: the port snaps res 0..{MAX_PACKED_RES} only")


def latlng_to_cell_vec(lat, lng, res: int, dtype=torch.float32):
    """Batched (lat, lng) radians -> H3 cell index words (hi, lo) as int32
    bit patterns, on ``lat``'s device.  ``res`` is 0..10; inputs must be
    validated or masked by the caller (the engine does this)."""
    check_res(res)
    lat = lat.to(dtype)
    lng = lng.to(dtype)
    face, ijk, p = _forward_digits(lat, lng, res, dtype)
    bc, p = _apply_rotations_packed(face, ijk, p, res)
    return _pack_packed(bc, p, res)
