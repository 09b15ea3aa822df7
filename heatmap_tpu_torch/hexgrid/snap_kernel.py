"""The H3 snap's geometry stage as a CUDA kernel, with its plain version.

The counterpart of ``heatmap_tpu/hexgrid/pallas_kernel.py``.  The snap has
two stages:

1. **Geometry** (``csrc/snap_geometry.cu``): lat/lng -> unit vector -> best
   of 20 icosahedron faces -> gnomonic hex-plane coordinates -> the exact
   int aperture-7 digit chain.  Elementwise float and int work over the
   points, one thread per point with every intermediate in registers.
2. **Tables** (PyTorch ops, ``device._apply_rotations_packed`` /
   ``device._pack_packed``): base-cell and rotation lookups in tables of
   under 3 KB, then the 64-bit packing.

``snap_geometry`` launches the kernel on CUDA tensors and runs
``snap_geometry_reference``, the same arithmetic in PyTorch ops, on CPU
tensors; any other device raises.  ``snap_geometry.launches`` counts the
kernel's launches.

The geometry differs from the plain XLA-style snap (``device``) only in
its expression tree: the face search is an unrolled strict ``d > best``
over scalar constants instead of a matmul plus argmax, so a point within
~1e-3 grid units of a cell edge may snap to the neighbouring cell, as
between the reference's Pallas and XLA snaps.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from heatmap_tpu_torch import _build
from heatmap_tpu_torch.hexgrid import device as dev
from heatmap_tpu_torch.hexgrid.constants import (
    FACE_CENTER_XYZ,
    M_AP7_ROT_RADS,
    M_SQRT7,
)
from heatmap_tpu_torch.hexgrid.mathlib import is_class_iii

SOURCE = "hexgrid/csrc/snap_geometry.cu"


@functools.lru_cache(maxsize=1)
def _face_constants() -> np.ndarray:
    """(20, 9) float32: per face the center xyz and the two tangent-basis
    vectors (device._projection_bases), the unrolled face loop's
    constants."""
    u1, u2 = dev._projection_bases()
    c = np.asarray(FACE_CENTER_XYZ, np.float64)
    return np.concatenate([c, u1, u2], axis=1).astype(np.float32)


def _res_constants(res: int) -> tuple[float, float, float]:
    """(cos, sin) of the Class III rotation and sqrt(7)**res, each rounded
    to float32."""
    f = lambda v: float(np.float32(v))
    return (f(math.cos(M_AP7_ROT_RADS)), f(math.sin(M_AP7_ROT_RADS)),
            f(M_SQRT7 ** res))


def snap_geometry_reference(lat, lng, res: int):
    """Plain PyTorch version of the kernel: (N,) f32 radians ->
    (face, flat27, packed digits), each (N,) int32.  Every product and sum
    is its own rounded op, as the kernel computes them."""
    dev.check_res(res)
    clat = torch.cos(lat)
    vx = clat * torch.cos(lng)
    vy = clat * torch.sin(lng)
    vz = torch.sin(lat)

    consts = _face_constants()
    best = torch.full_like(vx, -2.0)
    face = torch.zeros_like(vx, dtype=torch.int32)
    acc = [torch.zeros_like(vx) for _ in range(9)]
    for f in range(20):
        c = [float(v) for v in consts[f]]
        d = vx * c[0] + vy * c[1] + vz * c[2]
        m = d > best
        best = torch.where(m, d, best)
        face = torch.where(m, f, face)
        acc = [torch.where(m, c[t], acc[t]) for t in range(9)]
    cxv, cyv, czv, u1x, u1y, u1z, u2x, u2y, u2z = acc

    # gnomonic projection onto the winning face's tangent plane
    px = vx / best - cxv
    py = vy / best - cyv
    pz = vz / best - czv
    x = px * u1x + py * u1y + pz * u1z
    y = px * u2x + py * u2y + pz * u2z
    cr, sr, scale = _res_constants(res)
    if is_class_iii(res):
        x, y = x * cr + y * sr, y * cr - x * sr
    x = x * scale
    y = y * scale

    i, j, k = dev._hex2d_to_ijk(x, y)
    p = torch.zeros_like(i)
    for r in range(res, 0, -1):
        last = (i, j, k)
        if is_class_iii(r):
            i, j, k = dev._up_ap7(i, j, k)
            ci, cj, ck = dev._lin3(dev._DOWN_AP7, i, j, k)
        else:
            i, j, k = dev._up_ap7r(i, j, k)
            ci, cj, ck = dev._lin3(dev._DOWN_AP7R, i, j, k)
        di, dj, dk = dev._ijk_normalize(last[0] - ci, last[1] - cj,
                                        last[2] - ck)
        p = p | ((4 * di + 2 * dj + dk) << (3 * (res - r)))

    i = torch.clamp(i, 0, 2)
    j = torch.clamp(j, 0, 2)
    k = torch.clamp(k, 0, 2)
    flat = ((face * 3 + i) * 3 + j) * 3 + k
    return face, flat.to(torch.int32), p.to(torch.int32)


@functools.lru_cache(maxsize=1)
def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.snap_geometry_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _host_constants(res: int) -> np.ndarray:
    """The kernel's constant block for ``res``: 180 face constants, then
    cos, sin and scale (kept alive here while native code reads it)."""
    return np.ascontiguousarray(np.concatenate([
        _face_constants().reshape(-1),
        np.asarray(_res_constants(res), np.float32)]))


def _check_input(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: snap kernel takes float32, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: expected shape ({n},), got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: snap kernel takes contiguous tensors")


def snap_geometry(lat, lng, res: int):
    """(N,) float32 radians -> (face, flat27, packed digits), (N,) int32
    each: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if lat.device.type == "cpu":
        return snap_geometry_reference(lat, lng, res)
    if lat.device.type != "cuda":
        raise ValueError(f"snap_geometry: no kernel for {lat.device}")
    dev.check_res(res)
    n = lat.shape[0]
    _check_input("lat", lat, n, lat.device)
    _check_input("lng", lng, n, lat.device)
    out = [torch.empty(n, dtype=torch.int32, device=lat.device)
           for _ in range(3)]
    if n == 0:  # nothing to launch, so nothing to count
        return tuple(out)
    consts = _host_constants(res)
    with torch.cuda.device(lat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(lat.data_ptr(), lng.data_ptr(), n, res,
                          consts.ctypes.data, out[0].data_ptr(),
                          out[1].data_ptr(), out[2].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"snap_geometry kernel launch failed: CUDA "
                           f"error {err}")
    snap_geometry.launches += 1
    return tuple(out)


snap_geometry.launches = 0


def latlng_to_cell_kernel(lat, lng, res: int):
    """(lat, lng) f32 radians -> H3 index words (hi, lo) as int32 bit
    patterns: the geometry kernel, then the table stage."""
    face, flat, p = snap_geometry(lat, lng, res)
    ijk = ((flat // 9) % 3, (flat // 3) % 3, flat % 3)
    bc, p = dev._apply_rotations_packed(face, ijk, p, res)
    return dev._pack_packed(bc, p, res)
