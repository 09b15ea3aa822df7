"""The H3 snap as one fused CUDA kernel, with its plain version.

The counterpart of ``heatmap_tpu/hexgrid/pallas_kernel.py`` and of the
table stage the JAX package leaves to XLA.  ``csrc/snap_cell.cu`` takes
(lat, lng) f32 radians and returns the H3 index words (hi, lo) in one
launch:

1. **Geometry**: lat/lng -> unit vector -> best of 20 icosahedron faces ->
   gnomonic hex-plane coordinates -> the exact int aperture-7 digit chain.
2. **Tables**: base-cell and rotation lookups in tables of under 4 KB (one
   uint8 blob, ``table_blob``), the digit rotations, the 64-bit packing.

``latlng_to_cell_kernel`` launches the kernel on CUDA tensors and runs
``latlng_to_cell_reference`` on CPU tensors; any other device raises.
``latlng_to_cell_kernel.launches`` counts the kernel's launches.  The plain
version is ``snap_geometry_reference`` (the kernel's geometry op for op)
followed by the plain snap's table stage (``device``).

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

SOURCE = "hexgrid/csrc/snap_cell.cu"


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
    """The geometry stage of the plain version: (N,) f32 radians ->
    (face, flat27, packed digits), each (N,) int32, the outputs of the
    reference's Pallas kernel.  Every product and sum is its own rounded
    op, as the kernel computes them."""
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


def latlng_to_cell_reference(lat, lng, res: int):
    """Plain PyTorch version of the fused kernel: (N,) f32 radians -> the H3
    index words (hi, lo) as int32 bit patterns.  The geometry stage
    (``snap_geometry_reference``), then the table stage and the packing of
    the plain snap (``device._apply_rotations_packed`` /
    ``device._pack_packed``)."""
    face, flat, p = snap_geometry_reference(lat, lng, res)
    ijk = ((flat // 9) % 3, (flat // 3) % 3, flat % 3)
    bc, p = dev._apply_rotations_packed(face, ijk, p, res)
    return dev._pack_packed(bc, p, res)


# The kernel's lookup tables, flat and in this order, one byte an entry, in
# one blob zero-padded to a multiple of 16 bytes (the offsets in
# csrc/snap_cell.cu follow this order).
TABLE_ORDER = ("face_ijk_bc", "face_ijk_rot", "bc_pent", "pent_cw_offset",
               "ccw_pow")


def table_offsets() -> dict[str, tuple[int, int]]:
    """Each table's (offset, length) in the blob, in bytes."""
    T = dev._DeviceTables()
    out, off = {}, 0
    for name in TABLE_ORDER:
        size = getattr(T, name).size
        out[name] = (off, size)
        off += size
    return out


@functools.lru_cache(maxsize=1)
def table_blob() -> np.ndarray:
    """The uint8 blob of the kernel's lookup tables (every entry fits a
    byte, which tests/test_torch_hexgrid.py checks by decoding it)."""
    T = dev._DeviceTables()
    flat = np.concatenate([getattr(T, name) for name in TABLE_ORDER]
                          ).astype(np.uint8)
    blob = np.zeros(-(-flat.size // 16) * 16, np.uint8)
    blob[:flat.size] = flat
    return blob


@functools.lru_cache(maxsize=None)
def _blob_on(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(table_blob()).to(device)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel_constants(res: int) -> np.ndarray:
    """The kernel's f32 constants for ``res``: 180 face constants, then
    cos, sin and scale (kept alive here while native code reads it)."""
    return np.ascontiguousarray(np.concatenate([
        _face_constants().reshape(-1),
        np.asarray(_res_constants(res), np.float32)]))


@functools.lru_cache(maxsize=1)
def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.snap_cell_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_input(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the snap takes float32, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected shape (N,), got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the snap takes contiguous tensors")


def latlng_to_cell_kernel(lat, lng, res: int):
    """(N,) float32 radians -> H3 index words (hi, lo), (N,) int32 bit
    patterns each: the fused CUDA kernel on CUDA tensors, the plain version
    on CPU tensors; any other device raises."""
    dev.check_res(res)
    _check_input("lat", lat, lat.device)
    _check_input("lng", lng, lat.device)
    if lng.shape != lat.shape:
        raise ValueError(f"lat {tuple(lat.shape)} and lng "
                         f"{tuple(lng.shape)} differ in shape")
    if lat.device.type == "cpu":
        return latlng_to_cell_reference(lat, lng, res)
    if lat.device.type != "cuda":
        raise ValueError(f"latlng_to_cell_kernel: no kernel for "
                         f"{lat.device}")
    n = lat.shape[0]
    hi, lo = (torch.empty(n, dtype=torch.int32, device=lat.device)
              for _ in range(2))
    if n == 0:  # nothing to launch, so nothing to count
        return hi, lo
    blob = _blob_on(lat.device)
    with torch.cuda.device(lat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(lat.data_ptr(), lng.data_ptr(), n, res,
                          _kernel_constants(res).ctypes.data,
                          blob.data_ptr(), blob.numel(),
                          _sm_count(lat.device), hi.data_ptr(),
                          lo.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"snap_cell kernel launch failed: CUDA error "
                           f"{err}")
    latlng_to_cell_kernel.launches += 1
    return hi, lo


latlng_to_cell_kernel.launches = 0
