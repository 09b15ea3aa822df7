"""The port's H3 snap (heatmap_tpu_torch.hexgrid) against the JAX package's.

Bars, the reference's own for its Pallas kernel against its XLA snap
(tests/test_hexgrid_device.py): at least 99.8% identical cells on city
points and 99.5% on global points.  Exact agreement is not reachable on the
CPU: the reference's cos/sin come from the C library and PyTorch's from its
vector math library, which differ in the last ulp for a few percent of
inputs, and a point within ~1e-3 grid units of a cell edge then lands in
the neighbouring cell.  Everything downstream of the float geometry is
integer work and must match exactly: the table stage on identical inputs,
and the f64 snap on the golden corpus.

The Pallas kernel runs here in interpret mode, at one resolution and one
size only (its CPU compile is slow); other resolutions are held against the
reference's XLA snap.
"""

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heatmap_tpu.hexgrid import _tables as jtables
from heatmap_tpu.hexgrid import device as jdev
from heatmap_tpu.hexgrid import host
from heatmap_tpu.hexgrid import pallas_kernel
from heatmap_tpu_torch.hexgrid import _tables as ttables
from heatmap_tpu_torch.hexgrid import device as tdev
from heatmap_tpu_torch.hexgrid import snap_kernel

GOLDEN = Path(__file__).parent / "data" / "h3_golden_mini.csv"
N_REGION = 8192
BARS = {"city": 0.998, "global": 0.995}


def points(seed=0):
    """N_REGION Boston-box points then N_REGION global points (radians)."""
    rng = np.random.default_rng(seed)
    lat = np.concatenate([rng.uniform(42.2, 42.5, N_REGION),
                          rng.uniform(-89.9, 89.9, N_REGION)])
    lng = np.concatenate([rng.uniform(-71.3, -70.8, N_REGION),
                          rng.uniform(-180.0, 180.0, N_REGION)])
    return (np.radians(lat).astype(np.float32),
            np.radians(lng).astype(np.float32))


def as_u64(hi, lo):
    return jdev.cells_to_uint64(np.asarray(hi).view(np.uint32),
                                np.asarray(lo).view(np.uint32))


def t(a):
    return torch.from_numpy(np.array(a))


def agreement_by_region(same):
    return {"city": same[:N_REGION].mean(), "global": same[N_REGION:].mean()}


@pytest.mark.parametrize("res", [7, 8, 9, 10])
def test_latlng_to_cell_vec_matches_jax(res):
    lat, lng = points()
    want = as_u64(*jdev.latlng_to_cell_vec(lat, lng, res))
    hi, lo = tdev.latlng_to_cell_vec(t(lat), t(lng), res)
    assert hi.dtype == lo.dtype == torch.int32
    got = as_u64(hi.numpy(), lo.numpy())
    for region, share in agreement_by_region(got == want).items():
        assert share >= BARS[region], (res, region, share)


def test_snap_geometry_reference_matches_pallas_interpret():
    lat, lng = points(seed=1)
    lat, lng = lat[::2], lng[::2]   # 8192 points: 4096 city, 4096 global
    ref = [np.asarray(a) for a in
           pallas_kernel._snap_geometry(lat, lng, 9, interpret=True)]
    got = [a.numpy() for a in
           snap_kernel.snap_geometry_reference(t(lat), t(lng), 9)]
    for a in got:
        assert a.dtype == np.int32 and a.shape == lat.shape
    same = (ref[0] == got[0]) & (ref[1] == got[1]) & (ref[2] == got[2])
    half = len(lat) // 2
    assert same[:half].mean() >= BARS["city"], same[:half].mean()
    assert same[half:].mean() >= BARS["global"], same[half:].mean()
    # the wrapper takes the plain version on CPU tensors
    via = snap_kernel.snap_geometry(t(lat), t(lng), 9)
    for a, b in zip(via, got):
        np.testing.assert_array_equal(a.numpy(), b)


def pentagon_points():
    """Points around the 12 pentagon base-cell centers (pentagon digit
    rotations) plus global points."""
    rng = np.random.default_rng(7)
    T = host.tables()
    pent = np.nonzero(T.BC_PENT)[0]
    c = T.BC_CENTER_GEO[pent]                     # radians
    jit = rng.normal(0.0, 0.02, (len(pent), 200, 2))
    lat = (c[:, None, 0] + jit[..., 0]).reshape(-1)
    lng = (c[:, None, 1] + jit[..., 1]).reshape(-1)
    glat, glng = points(seed=3)
    lat = np.clip(np.concatenate([lat, glat]), -1.5707, 1.5707)
    lng = np.concatenate([lng, glng])
    return lat.astype(np.float32), lng.astype(np.float32)


@pytest.mark.parametrize("res", [0, 1, 2, 5, 8, 9, 10])
def test_table_stage_exact_on_identical_inputs(res):
    lat, lng = pentagon_points()
    face, ijk, p = jax.jit(
        lambda a, b: jdev._forward_digits(a, b, res, jnp.float32,
                                          packed=True))(lat, lng)
    want = jax.jit(lambda f, i, j, k, q: jdev._pack_packed(
        *jdev._apply_rotations_packed(f, (i, j, k), q, res), res))(
            face, *ijk, p)
    tf, tijk, tp = (t(np.asarray(face)), [t(np.asarray(a)) for a in ijk],
                    t(np.asarray(p)))
    bc, q = tdev._apply_rotations_packed(tf, tijk, tp, res)
    hi, lo = tdev._pack_packed(bc, q, res)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  np.asarray(want[1]))


def test_tables_equal_the_reference():
    for name in ("FACE_IJK_BC", "FACE_IJK_ROT", "BC_PENT", "PENT_CW_OFFSET"):
        a, b = getattr(jtables, name), getattr(ttables, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert ttables.H3_MODE_CELL == host.H3_MODE_CELL


def golden_rows():
    """(lat rad, lng rad, res, cell) from the mini corpus: the canonical
    forward snaps at res <= 10 and the center-child rows (each base cell's
    center at res 5, 7, 8 and 9)."""
    rows = []
    for line in GOLDEN.read_text().splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split(",")
        if parts[0] == "fwd" and int(parts[3]) <= tdev.MAX_PACKED_RES:
            rows.append((math.radians(float(parts[1])),
                         math.radians(float(parts[2])), int(parts[3]),
                         host.string_to_h3(parts[4])))
        elif parts[0] == "center_child":
            bc, res = int(parts[1]), int(parts[2])
            la, ln = host.cell_to_latlng_rad(host.pack(bc, [], 0))
            rows.append((la, ln, res, host.string_to_h3(parts[3])))
    return rows


def test_golden_corpus():
    rows = golden_rows()
    assert sum(1 for r in rows if r[2] in (7, 8, 9)) >= 366
    by_res: dict[int, list] = {}
    for r in rows:
        by_res.setdefault(r[2], []).append(r)
    for res, rs in by_res.items():
        lat = np.array([r[0] for r in rs])
        lng = np.array([r[1] for r in rs])
        want = np.array([r[3] for r in rs], np.uint64)
        hi, lo = tdev.latlng_to_cell_vec(t(lat), t(lng), res,
                                         dtype=torch.float64)
        np.testing.assert_array_equal(as_u64(hi.numpy(), lo.numpy()), want,
                                      err_msg=f"f64 snap, res {res}")
        # the kernel's plain version (float32): these points sit at cell
        # centers, far from any edge
        hi, lo = snap_kernel.latlng_to_cell_kernel(
            t(lat.astype(np.float32)), t(lng.astype(np.float32)), res)
        np.testing.assert_array_equal(as_u64(hi.numpy(), lo.numpy()), want,
                                      err_msg=f"kernel path, res {res}")


def test_resolutions_above_10_raise():
    x = torch.zeros(4)
    with pytest.raises(NotImplementedError):
        tdev.latlng_to_cell_vec(x, x, 11)
    with pytest.raises(NotImplementedError):
        snap_kernel.snap_geometry(x, x, 11)


def test_kernel_wrapper_rejects_other_devices():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        snap_kernel.snap_geometry(x, x, 9)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc: building a kernel raises; nothing falls back to the plain
    version."""
    from heatmap_tpu_torch import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build(snap_kernel.SOURCE)
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").iterdir())


def test_kernel_library_name_follows_the_source(monkeypatch, tmp_path):
    """An edited source builds to a new library; an unchanged one maps to
    the same path."""
    from heatmap_tpu_torch import _build

    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    monkeypatch.setattr(_build, "PKG_DIR", tmp_path)
    first = _build.library_path("k.cu")
    assert first == _build.library_path("k.cu")
    src.write_text("// v2\n")
    assert _build.library_path("k.cu") != first
    assert first.parent == _build.BUILD_DIR
