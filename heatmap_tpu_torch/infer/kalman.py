"""Constant-velocity Kalman filtering over rounds, one launch per batch.

The counterpart of ``heatmap_tpu/infer/kalman.py``.  State per entity:
``x = [pn, pe, vn, ve]`` (metres and m/s in the entity's local north-east
frame, anchored at its seed reference) with full 4x4 covariance;
measurements are positions only.  A batch's observations are grouped into
K *rounds* -- round j holds each present entity's j-th observation in
(timestamp, stream order) -- so one pass over the rounds, each a predict
and a Joseph-form update over the M present entities, processes every
observation in the order a row-at-a-time filter would.  A Mahalanobis gate
(chi-square, 2 dof) marks impossible-teleport innovations, which re-seed
the track at the observed position instead of updating it.  Out-of-order
gaps clamp to dt = 0.

``filter_rounds`` takes and returns host numpy, as the reference's does.
On a CUDA device it copies the rounds to the card, launches
``csrc/kalman_rounds.cu`` (``kalman_rounds``) and copies the outputs back,
all on a stream of the caller's own (``RoundsStaging``), since the caller
needs the outputs at once; on the CPU it runs the plain version,
``filter_rounds_reference``, which applies the reference's ``_round`` to
(M,) tensors round by round in the reference's order of operations.  K and
M are not padded: nothing here compiles per shape.

The kernel moves its round planes with TMA, which takes rows 16-byte
aligned.  So on the card every (K, M) plane (valid, reseed, dt, z and the
outputs) has its rows ``ld = row_pitch(M)`` entities apart, M rounded up
to 16, and the kernel gets the ``[:, :M]`` views of (K, ld) buffers
(``pitched``); ``kalman_rounds`` raises on a CUDA plane whose pitch it
cannot take.  The plain version takes the same views, or any others.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from heatmap_tpu_torch import _build

SOURCE = "infer/csrc/kalman_rounds.cu"
M_PER_DEG = 111_320.0  # meters per degree latitude (spherical mean)

# compact symmetric storage: P[i, j] == p10[_SYM[i, j]]; the unique
# upper-triangle entries in row-major order are (IU[k], JU[k])
_SYM = np.array([[0, 1, 2, 3], [1, 4, 5, 6], [2, 5, 7, 8], [3, 6, 8, 9]])
_IU = (0, 0, 0, 0, 1, 1, 1, 2, 2, 3)
_JU = (0, 1, 2, 3, 1, 2, 3, 2, 3, 3)


def pad_pow2(n: int, floor: int = 8) -> int:
    """Next power-of-two bucket >= n.  The reference pads K and M to these
    so that XLA compiles per bucket; here it only sizes the staging
    buffers, which grow in such steps."""
    if n <= floor:
        return floor
    return 1 << int(n - 1).bit_length()


# the row pitch of the round planes on the card, in entities: TMA takes
# global rows 16 bytes apart, and a row of a byte plane (valid, reseed,
# tele) is one byte an entity
PITCH = 16


def row_pitch(m: int) -> int:
    """Entities from one row of a round plane to the next on the card:
    ``m`` rounded up to ``PITCH``."""
    return -(-m // PITCH) * PITCH


def pitched(k: int, m: int, tail: tuple, dtype, device,
            ld: int | None = None) -> torch.Tensor:
    """An uninitialised (k, m, *tail) round plane whose rows lie ``ld``
    (by default ``row_pitch(m)``) entities apart: the ``[:, :m]`` view of
    a (k, ld, *tail) buffer."""
    ld = row_pitch(m) if ld is None else ld
    return torch.empty((k, ld, *tail), dtype=dtype, device=device)[:, :m]


def filter_consts(q: float, r_m: float, gate: float, p0_pos: float,
                  p0_vel: float) -> tuple[float, ...]:
    """(q, r2, gate, p0_pos, p0_vel), each rounded to float32 as the
    reference rounds them before its scan."""
    f = lambda v: float(np.float32(v))
    return f(q), f(r_m * r_m), f(gate), f(p0_pos), f(p0_vel)


def filter_rounds_reference(x, P, z, dt, valid, reseed, consts):
    """The plain version: the reference's ``_round`` on (M,) tensors, one
    round after another, on the device the tensors lie on.  ``consts`` is
    ``filter_consts``'s tuple.  Returns (x', P', nis, tele, spd, inn).

    Each op is one PyTorch kernel, so each product and sum rounds on its
    own.  The divisors 3 and 2 are tensors on the device: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal instead."""
    q, r2, gate, p0_pos, p0_vel = consts
    k, m = valid.shape
    dev = x.device
    three = torch.tensor(3.0, dtype=torch.float32, device=dev)
    two = torch.tensor(2.0, dtype=torch.float32, device=dev)
    xs = [x[:, i] for i in range(4)]
    p = [P[:, i, j] for i, j in zip(_IU, _JU)]  # symmetrize from the top
    zero = torch.zeros(m, dtype=torch.float32, device=dev)
    nis_out = torch.empty((k, m), dtype=torch.float32, device=dev)
    tele_out = torch.empty((k, m), dtype=torch.bool, device=dev)
    spd_out = torch.empty((k, m), dtype=torch.float32, device=dev)
    inn_out = torch.empty((k, m, 2), dtype=torch.float32, device=dev)
    for r in range(k):
        zr, v, rs = z[r], valid[r], reseed[r]
        d = torch.clamp_min(dt[r], 0.0)
        dt2, dt3 = d * d, d * d * d
        (p00, p01, p02, p03, p11, p12, p13, p22, p23, p33) = p
        pp00 = p00 + d * (p02 + p02) + dt2 * p22 + q * dt3 / three
        pp01 = p01 + d * p03 + d * p12 + dt2 * p23
        pp02 = p02 + d * p22 + q * dt2 / two
        pp03 = p03 + d * p23
        pp11 = p11 + d * (p13 + p13) + dt2 * p33 + q * dt3 / three
        pp12 = p12 + d * p23
        pp13 = p13 + d * p33 + q * dt2 / two
        pp22 = p22 + q * d
        pp23 = p23
        pp33 = p33 + q * d
        xp0 = xs[0] + xs[2] * d
        xp1 = xs[1] + xs[3] * d
        y0 = zr[:, 0] - xp0
        y1 = zr[:, 1] - xp1
        s00, s01, s11 = pp00 + r2, pp01, pp11 + r2
        det = torch.clamp_min(s00 * s11 - s01 * s01, 1e-12)
        si00, si01, si11 = s11 / det, -s01 / det, s00 / det
        nis = (y0 * (si00 * y0 + si01 * y1)
               + y1 * (si01 * y0 + si11 * y1))
        pi0 = (pp00, pp01, pp02, pp03)
        pi1 = (pp01, pp11, pp12, pp13)
        k0 = [pi0[i] * si00 + pi1[i] * si01 for i in range(4)]
        k1 = [pi0[i] * si01 + pi1[i] * si11 for i in range(4)]
        xpv = (xp0, xp1, xs[2], xs[3])
        xu = [xpv[i] + k0[i] * y0 + k1[i] * y1 for i in range(4)]
        pm = ((pp00, pp01, pp02, pp03), (pp01, pp11, pp12, pp13),
              (pp02, pp12, pp22, pp23), (pp03, pp13, pp23, pp33))
        b = [[pm[i][j] - k0[i] * pm[0][j] - k1[i] * pm[1][j]
              for j in range(4)] for i in range(4)]
        pu = [b[_IU[u]][_JU[u]]
              - b[_IU[u]][0] * k0[_JU[u]] - b[_IU[u]][1] * k1[_JU[u]]
              + r2 * (k0[_IU[u]] * k0[_JU[u]] + k1[_IU[u]] * k1[_JU[u]])
              for u in range(10)]
        upd = v & ~rs
        tele = upd & (nis > gate)
        seed = v & (rs | tele)
        ok = upd & ~tele
        xt = (zr[:, 0], zr[:, 1], zero, zero)
        pt = (p0_pos, 0.0, 0.0, 0.0, p0_pos, 0.0, 0.0, p0_vel, 0.0, p0_vel)
        xs = [torch.where(ok, xu[i], torch.where(seed, xt[i], xs[i]))
              for i in range(4)]
        p = [torch.where(ok, pu[u],
                         torch.where(seed, torch.full_like(y0, pt[u]), p[u]))
             for u in range(10)]
        nis_out[r] = torch.where(upd, nis, zero)
        tele_out[r] = tele
        spd_out[r] = torch.where(v, torch.hypot(xs[2], xs[3]), zero)
        inn_out[r, :, 0] = torch.where(upd, y0, zero)
        inn_out[r, :, 1] = torch.where(upd, y1, zero)
    p10 = torch.stack(p, dim=1)
    sym = torch.from_numpy(_SYM.reshape(-1)).to(dev)
    return (torch.stack(xs, dim=1), p10[:, sym].reshape(m, 4, 4), nis_out,
            tele_out, spd_out, inn_out)


@functools.lru_cache(maxsize=1)
def _launcher():
    lib = _build.load(SOURCE)
    fn = lib.kalman_rounds_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 7)
    fn.restype = ctypes.c_int
    return fn


_SHAPES = {"x": ("m", 4), "P": ("m", 4, 4), "z": ("k", "m", 2),
           "dt": ("k", "m"), "valid": ("k", "m"), "reseed": ("k", "m")}
# the outputs (x', P', nis, tele, spd, inn): each takes the shape of the
# input it names
_OUT_SHAPES = (("x", torch.float32), ("P", torch.float32),
               ("dt", torch.float32), ("valid", torch.bool),
               ("dt", torch.float32), ("z", torch.float32))
# byte alignment of every base the kernel's TMA maps start at
_ALIGN = 16


def _check(name: str, t: torch.Tensor, k: int, m: int, device):
    """Dtype, shape, device and layout of the tensor ``name`` names (an
    output by the input it is shaped like).  x and P are contiguous; a
    round plane holds its entities side by side in each row, the rows any
    distance apart.  Returns the plane's row pitch in entities (None for x
    and P, and for a plane of at most one row, whose pitch nothing reads)."""
    want = tuple(k if d == "k" else m if d == "m" else d
                 for d in _SHAPES[name])
    dtype = torch.bool if name in ("valid", "reseed") else torch.float32
    if t.dtype != dtype:
        raise TypeError(f"{name}: the rounds take {dtype}, got {t.dtype}")
    if tuple(t.shape) != want:
        raise ValueError(f"{name}: expected shape {want}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if name in ("x", "P"):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the rounds take contiguous tensors")
        return None
    if k and not t[0].is_contiguous():
        raise ValueError(f"{name}: the rounds take rows of adjacent "
                         f"entities")
    if k <= 1:
        return None
    width = 2 if name == "z" else 1  # floats an entity
    if t.stride(0) % width:
        raise ValueError(f"{name}: row stride {t.stride(0)} is not a whole "
                         f"number of entities")
    return t.stride(0) // width


def kernel_pitch(tensors: dict, pitches, k: int, m: int) -> int:
    """The one row pitch ``ld`` of the round planes that the kernel takes:
    shared by every plane, >= ``m``, a multiple of ``PITCH``, every base
    16-byte aligned; raises otherwise.  ``pitches`` are ``_check``'s."""
    found = {p for p in pitches if p is not None}
    if len(found) > 1:
        raise ValueError(f"kalman_rounds: the round planes' row pitches "
                         f"differ ({sorted(found)} entities); the kernel "
                         f"takes one")
    ld = found.pop() if found else row_pitch(m)
    if ld < m or ld % PITCH:
        raise ValueError(f"kalman_rounds: row pitch {ld} for {m} entities;"
                         f" TMA takes rows a multiple of {PITCH} entities "
                         f"apart (stage the planes with kalman.pitched)")
    for name, t in tensors.items():
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"kalman_rounds: {name} not {_ALIGN}-byte "
                             f"aligned")
    return ld


def kalman_rounds(x, P, z, dt, valid, reseed, consts, out=None):
    """The rounds scan on tensors: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors; any other device raises.  ``consts`` is
    ``filter_consts``'s tuple; ``out`` optionally gives the six output
    tensors (x', P', nis, tele, spd, inn) for the kernel to write.  On the
    card the round planes, in and out, share one row pitch that
    ``kernel_pitch`` accepts (``pitched`` makes such planes); outputs it
    allocates are pitched so.  ``kalman_rounds.launches`` counts the
    kernel's launches."""
    k, m = valid.shape
    ins = dict(x=x, P=P, z=z, dt=dt, valid=valid, reseed=reseed)
    pitches = [_check(name, t, k, m, x.device) for name, t in ins.items()]
    if x.device.type == "cpu":
        return filter_rounds_reference(x, P, z, dt, valid, reseed, consts)
    ld = kernel_pitch(ins, pitches, k, m) if m else 0
    if x.device.type != "cuda":
        raise ValueError(f"kalman_rounds: no kernel for {x.device}")
    if out is None:
        out = tuple(torch.empty_like(ins[like], dtype=dtype)
                    if like in ("x", "P")
                    else pitched(k, m, ins[like].shape[2:], dtype, x.device,
                                 ld)
                    for like, dtype in _OUT_SHAPES)
    pitches = [_check(like, t, k, m, x.device)
               for (like, _), t in zip(_OUT_SHAPES, out)]
    if m == 0:  # nothing to launch, so nothing to count
        return out
    kernel_pitch({f"out{i}": t for i, t in enumerate(out)}, [ld, *pitches],
                 k, m)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(*(t.data_ptr() for t in ins.values()), k, m, ld,
                          *consts, *(t.data_ptr() for t in out), stream)
    if err < 0:
        raise RuntimeError(f"kalman_rounds: encoding a TMA tensor map "
                           f"failed: CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"kalman_rounds kernel launch failed: CUDA "
                           f"error {err}")
    kalman_rounds.launches += 1
    return out


kalman_rounds.launches = 0


class RoundsStaging:
    """A CUDA stream of its own and reused buffers for ``filter_rounds``:
    pinned host buffers for the copies and device buffers for the
    kernel's inputs and outputs, each grown to the largest call seen.  A
    round plane's buffers, host and device alike, are (K, ld) with ``ld =
    row_pitch(M)``, so each copy moves one block and the kernel gets the
    ``[:, :M]`` views.  The call's copy -> kernel -> copy runs on this
    stream and ends in a wait for it, so it never queues behind the fold's
    work on the runtime's stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self._host: dict = {}
        self._dev: dict = {}

    @staticmethod
    def _buf(pool, name, shape, dtype, **kw):
        n = int(np.prod(shape))
        buf = pool.get(name)
        if buf is None or buf.numel() < n:
            buf = pool[name] = torch.empty(pad_pow2(n, floor=1024),
                                           dtype=dtype, **kw)
        return buf[:n].view(shape)

    def run(self, arrays: dict, consts):
        k, m = arrays["valid"].shape
        ld = row_pitch(m)
        # each buffer's shape, a round plane's with its rows ld apart
        shapes = {name: tuple(k if d == "k" else ld if d == "m" else d
                              for d in dims) if dims[0] == "k"
                  else (m, *dims[1:])
                  for name, dims in _SHAPES.items()}

        def view(name, t):
            return t[:, :m] if _SHAPES[name][0] == "k" else t

        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            ins = []
            for name, a in arrays.items():
                dtype = torch.bool if a.dtype == bool else torch.float32
                h = self._buf(self._host, name, shapes[name], dtype,
                              pin_memory=True)
                view(name, h.numpy())[...] = a
                d = self._buf(self._dev, name, shapes[name], dtype,
                              device=self.device)
                d.copy_(h, non_blocking=True)
                ins.append(view(name, d))
            outs = [self._buf(self._dev, f"out{i}", shapes[like], dtype,
                              device=self.device)
                    for i, (like, dtype) in enumerate(_OUT_SHAPES)]
            kalman_rounds(*ins, consts,
                          out=tuple(view(like, d) for (like, _), d
                                    in zip(_OUT_SHAPES, outs)))
            host = []
            for i, ((like, dtype), d) in enumerate(zip(_OUT_SHAPES, outs)):
                h = self._buf(self._host, f"out{i}", shapes[like], dtype,
                              pin_memory=True)
                h.copy_(d, non_blocking=True)
                host.append(view(like, h.numpy()))
            self.stream.synchronize()
            return tuple(h.copy() for h in host)


def filter_rounds(x: np.ndarray, P: np.ndarray, z: np.ndarray,
                  dt: np.ndarray, valid: np.ndarray,
                  reseed: np.ndarray, *, q: float, r_m: float,
                  gate: float, p0_pos: float, p0_vel: float,
                  device="cuda", staging: RoundsStaging | None = None):
    """Run the rounds scan; all inputs/outputs are host numpy.

    ``x`` (M,4), ``P`` (M,4,4) -- current state of the M present
    entities; ``z`` (K,M,2) measured local-frame positions, ``dt``
    (K,M) seconds since each entity's previous observation, ``valid``
    (K,M) round-occupancy mask, ``reseed`` (K,M) handoff re-seed
    rounds.  Returns (x', P', nis (K,M), teleport (K,M), speed (K,M),
    innovation (K,M,2)); the innovation rows are zeroed outside non-reseed
    valid rounds, the same mask as ``nis``.  On a CUDA ``device`` the
    kernel runs on ``staging``'s stream (a fresh one when None); on the
    CPU the plain version runs."""
    consts = filter_consts(q, r_m, gate, p0_pos, p0_vel)
    arrays = {"x": np.ascontiguousarray(x, np.float32),
              "P": np.ascontiguousarray(P, np.float32),
              "z": np.ascontiguousarray(z, np.float32),
              "dt": np.ascontiguousarray(dt, np.float32),
              "valid": np.ascontiguousarray(valid, bool),
              "reseed": np.ascontiguousarray(reseed, bool)}
    device = torch.device(device)
    if device.type == "cuda":
        if staging is None:
            staging = RoundsStaging(device)
        return staging.run(arrays, consts)
    if device.type != "cpu":
        raise ValueError(f"filter_rounds: no route for {device}")
    out = kalman_rounds(*(torch.from_numpy(a) for a in arrays.values()),
                        consts)
    return tuple(t.numpy() for t in out)


def local_xy(lat_deg: np.ndarray, lng_deg: np.ndarray,
             ref: np.ndarray) -> np.ndarray:
    """Degrees -> local north-east meters about per-entity references
    ``ref`` (n,3) = (lat0, lon0, cos lat0).  f64 differencing before the
    f32 narrowing: city-scale offsets keep centimeter precision where
    naive f32 absolute degrees would quantize at ~0.5 m."""
    dn = (lat_deg.astype(np.float64) - ref[:, 0]) * M_PER_DEG
    de = (lng_deg.astype(np.float64) - ref[:, 1]) * M_PER_DEG * ref[:, 2]
    return np.stack([dn, de], axis=1).astype(np.float32)


def latlng_of(x: np.ndarray, ref: np.ndarray):
    """Inverse of :func:`local_xy` for state rows ``x`` (n,4)."""
    lat = ref[:, 0] + x[:, 0].astype(np.float64) / M_PER_DEG
    cos = np.maximum(ref[:, 2], 1e-6)
    lng = ref[:, 1] + x[:, 1].astype(np.float64) / (M_PER_DEG * cos)
    return lat, lng
