"""Host (scalar, f64) reference implementation of the hex grid system.

A copy of ``heatmap_tpu/hexgrid/host.py``: the *oracle* for the snap and
the serving-side geometry (``cell_to_boundary`` for the tile polygons,
``h3_to_string`` for the cell ids, ``latlng_to_cell_int`` for the query
tier's region covers); deliberately scalar and readable.

Index layout (64-bit, H3-compatible):
  bit 63          reserved (0)
  bits 59..62     mode (1 = cell)
  bits 56..58     reserved (0)
  bits 52..55     resolution (0..15)
  bits 45..51     base cell (0..121)
  bits 3r..3r+2   digit for res (15-r), unused digits = 7
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from heatmap_tpu_torch.hexgrid import mathlib as ml
from heatmap_tpu_torch.hexgrid.mathlib import (
    CENTER_DIGIT,
    IK_AXES_DIGIT,
    INVALID_DIGIT,
    I_AXES_DIGIT,
    K_AXES_DIGIT,
    ROTATE60_CCW,
    ROTATE60_CW,
    is_class_iii,
)


class Tables:
    """Namespace holding the derived lookup tables (see gen_tables.py)."""

    def __init__(self, mod):
        self.FACE_IJK_BC = np.asarray(mod.FACE_IJK_BC)        # (20,3,3,3) int
        self.FACE_IJK_ROT = np.asarray(mod.FACE_IJK_ROT)      # (20,3,3,3) int
        self.BC_HOME_FACE = np.asarray(mod.BC_HOME_FACE)      # (122,) int
        self.BC_HOME_IJK = np.asarray(mod.BC_HOME_IJK)        # (122,3) int
        self.BC_PENT = np.asarray(mod.BC_PENT)                # (122,) bool
        self.PENT_CW_OFFSET = np.asarray(mod.PENT_CW_OFFSET)  # (122,20) bool
        # face -> edge ('IJ'|'KI'|'JK') -> (face2, ccw_rot60, translate ijk)
        self.FACE_NEIGHBORS = mod.FACE_NEIGHBORS
        self.BC_CENTER_GEO = np.asarray(mod.BC_CENTER_GEO)    # (122,2) rad


def _default_tables() -> Tables:
    from heatmap_tpu_torch.hexgrid import _tables

    return Tables(_tables)


_TABLES: Tables | None = None


def tables() -> Tables:
    global _TABLES
    if _TABLES is None:
        _TABLES = _default_tables()
    return _TABLES


# ---------------------------------------------------------------------------
# Index packing
# ---------------------------------------------------------------------------

H3_MODE_CELL = 1


def pack(base_cell: int, digits: Sequence[int], res: int) -> int:
    h = (H3_MODE_CELL << 59) | (res << 52) | (base_cell << 45)
    for r in range(1, 16):
        d = digits[r - 1] if r <= res else INVALID_DIGIT
        h |= d << (3 * (15 - r))
    return h


def unpack(h: int) -> Tuple[int, List[int], int]:
    res = (h >> 52) & 0xF
    base_cell = (h >> 45) & 0x7F
    digits = [(h >> (3 * (15 - r))) & 0x7 for r in range(1, res + 1)]
    return base_cell, digits, res


def get_resolution(h: int) -> int:
    return (h >> 52) & 0xF


def get_base_cell(h: int) -> int:
    return (h >> 45) & 0x7F


def is_pentagon(h: int, T: Tables | None = None) -> bool:
    T = T or tables()
    return bool(T.BC_PENT[get_base_cell(h)]) and _leading_nonzero(unpack(h)[1]) == 0


def h3_to_string(h: int) -> str:
    return format(h, "x")


def string_to_h3(s: str) -> int:
    return int(s, 16)


def _leading_nonzero(digits: Sequence[int]) -> int:
    for d in digits:
        if d != CENTER_DIGIT:
            return d
    return CENTER_DIGIT


def _rotate_digits(digits: List[int], table) -> List[int]:
    return [table[d] for d in digits]


def rotate_pent60_ccw(digits: List[int]) -> List[int]:
    """Pentagonal ccw rotation: like a plain rotation, but the deleted K-axes
    subsequence is skipped (leading digit may never be K)."""
    out = _rotate_digits(digits, ROTATE60_CCW)
    if _leading_nonzero(out) == K_AXES_DIGIT:
        out = _rotate_digits(out, ROTATE60_CCW)
    return out


def rotate_pent60_cw(digits: List[int]) -> List[int]:
    out = _rotate_digits(digits, ROTATE60_CW)
    if _leading_nonzero(out) == K_AXES_DIGIT:
        out = _rotate_digits(out, ROTATE60_CW)
    return out


# ---------------------------------------------------------------------------
# Forward: (lat, lng) -> cell
# ---------------------------------------------------------------------------

def forward_raw(lat: float, lng: float, res: int) -> Tuple[int, Tuple[int, int, int], List[int]]:
    """Geometry-only forward stage: (face, res-0 ijk, unrotated digit chain).

    Table-independent; used by the table generator's parameter search and by
    latlng_to_cell_int below.
    """
    face, x, y = ml.geo_to_hex2d(lat, lng, res)
    ijk = ml.hex2d_to_ijk(x, y)

    digits = [CENTER_DIGIT] * res
    for r in range(res - 1, -1, -1):
        last = ijk
        if is_class_iii(r + 1):
            ijk = ml.up_ap7(*ijk)
            last_center = ml.down_ap7(*ijk)
        else:
            ijk = ml.up_ap7r(*ijk)
            last_center = ml.down_ap7r(*ijk)
        diff = ml.ijk_sub(last, last_center)
        digits[r] = ml.unit_ijk_to_digit(*diff)

    if max(ijk) > 2:
        raise ValueError(f"res-0 overflow: face={face} ijk={ijk} for {lat},{lng}")
    return face, ijk, digits


def finish_forward(
    face: int, ijk: Tuple[int, int, int], digits: List[int], res: int, T: Tables
) -> int:
    """Apply base-cell/rotation tables to a raw forward result and pack."""
    i, j, k = ijk
    bc = int(T.FACE_IJK_BC[face, i, j, k])
    rot = int(T.FACE_IJK_ROT[face, i, j, k])

    if T.BC_PENT[bc]:
        if _leading_nonzero(digits) == K_AXES_DIGIT:
            if T.PENT_CW_OFFSET[bc, face]:
                digits = _rotate_digits(digits, ROTATE60_CW)
            else:
                digits = _rotate_digits(digits, ROTATE60_CCW)
        for _ in range(rot):
            digits = rotate_pent60_ccw(digits)
    else:
        for _ in range(rot):
            digits = _rotate_digits(digits, ROTATE60_CCW)

    return pack(bc, digits, res)


def latlng_to_cell_int(lat: float, lng: float, res: int, T: Tables | None = None) -> int:
    """Index the hex cell containing the point, lat/lng in radians.

    Raises ValueError on out-of-range inputs, mirroring the bounds guard the
    reference applies before its H3 UDF (reference: heatmap_stream.py:66-69).
    """
    if not 0 <= res <= 15:
        raise ValueError(f"resolution must be in [0, 15], got {res}")
    if not (math.isfinite(lat) and math.isfinite(lng)):
        raise ValueError(f"non-finite coordinates: {lat}, {lng}")
    if abs(lat) > math.pi / 2 + 1e-12:
        raise ValueError(f"latitude out of range: {lat} rad")
    if abs(lng) > math.pi + 1e-12:
        raise ValueError(f"longitude out of range: {lng} rad")
    T = T or tables()
    face, ijk, digits = forward_raw(lat, lng, res)
    return finish_forward(face, ijk, digits, res, T)


def latlng_to_cell(lat_deg: float, lng_deg: float, res: int, T: Tables | None = None) -> str:
    """Degree-input convenience matching the h3-py API shape."""
    return h3_to_string(
        latlng_to_cell_int(math.radians(lat_deg), math.radians(lng_deg), res, T)
    )


# ---------------------------------------------------------------------------
# Inverse: cell -> face IJK -> geo
# ---------------------------------------------------------------------------

def _rotate60cw_raw(i: int, j: int, k: int) -> Tuple[int, int, int]:
    """Linear (non-normalizing) 60-degree cw rotation of cube coords."""
    return (i + j, j + k, i + k)


def _adjust_overage_class_ii(
    face: int,
    ijk: Tuple[int, int, int],
    res: int,
    pent_leading_4: bool,
    substrate: bool,
    T: Tables,
) -> Tuple[int, Tuple[int, int, int], int]:
    """If ijk overflows `face` at Class II `res`, hop to the neighbor face.

    Returns (overage, new_ijk, new_face); overage: 0 none, 1 on-edge, 2 new face.
    """
    overage = 0
    max_dim = 2 * 7 ** (res // 2)
    if substrate:
        max_dim *= 3
    i, j, k = ijk
    s = i + j + k
    if substrate and s == max_dim:
        overage = 1
    elif s > max_dim:
        overage = 2
        if k > 0:
            if j > 0:
                edge = "JK"
            else:
                edge = "KI"
                if pent_leading_4:
                    # rotate out of the deleted k-axes subsequence: translate
                    # the origin to the pentagon vertex, rotate 60cw, translate back
                    oi = max_dim
                    ti, tj, tk = _rotate60cw_raw(i - oi, j, k)
                    i, j, k = ti + oi, tj, tk
        else:
            edge = "IJ"
        face2, ccw_rot, trans = T.FACE_NEIGHBORS[face][edge]
        face = face2
        for _ in range(ccw_rot):
            i, j, k = ml.ijk_rotate60_ccw(i, j, k)
        unit_scale = 7 ** (res // 2)
        if substrate:
            unit_scale *= 3
        i += trans[0] * unit_scale
        j += trans[1] * unit_scale
        k += trans[2] * unit_scale
        i, j, k = ml.ijk_normalize(i, j, k)
        if substrate and (i + j + k) == max_dim:
            overage = 1
    return overage, (i, j, k), face


def _cell_to_faceijk(h: int, T: Tables) -> Tuple[int, Tuple[int, int, int], int]:
    """Cell index -> (face, ijk coords at cell res on that face, res)."""
    bc, digits, res = unpack(h)
    is_pent = bool(T.BC_PENT[bc])
    if is_pent and _leading_nonzero(digits) == IK_AXES_DIGIT:
        digits = _rotate_digits(digits, ROTATE60_CW)

    face = int(T.BC_HOME_FACE[bc])
    ijk = tuple(int(v) for v in T.BC_HOME_IJK[bc])
    possible_overage = not (
        not is_pent and (res == 0 or (ijk[0] == 0 and ijk[1] == 0 and ijk[2] == 0))
    )
    for r in range(1, res + 1):
        if is_class_iii(r):
            ijk = ml.down_ap7(*ijk)
        else:
            ijk = ml.down_ap7r(*ijk)
        ijk = ml.neighbor(*ijk, digits[r - 1])

    if not possible_overage:
        return face, ijk, res

    orig_ijk = ijk
    adj_res = res
    if is_class_iii(res):
        ijk = ml.down_ap7r(*ijk)
        adj_res += 1
    pent_leading_4 = is_pent and _leading_nonzero(digits) == I_AXES_DIGIT

    overage, ijk2, face2 = _adjust_overage_class_ii(
        face, ijk, adj_res, pent_leading_4, False, T
    )
    if overage == 2:
        face, ijk = face2, ijk2
        if is_pent:
            for _ in range(6):
                overage, ijk2, face2 = _adjust_overage_class_ii(
                    face, ijk, adj_res, False, False, T
                )
                if overage != 2:
                    break
                face, ijk = face2, ijk2
        if adj_res != res:
            ijk = ml.up_ap7r(*ijk)
    else:
        if adj_res != res:
            ijk = orig_ijk
    return face, ijk, res


def cell_to_latlng_rad(h: int, T: Tables | None = None) -> Tuple[float, float]:
    T = T or tables()
    face, ijk, res = _cell_to_faceijk(h, T)
    x, y = ml.ijk_to_hex2d(*ijk)
    return ml.hex2d_to_geo(x, y, face, res, substrate=False)


def cell_to_latlng(cell: str | int, T: Tables | None = None) -> Tuple[float, float]:
    """Cell -> (lat, lng) degrees."""
    h = string_to_h3(cell) if isinstance(cell, str) else cell
    lat, lng = cell_to_latlng_rad(h, T)
    return math.degrees(lat), math.degrees(lng)


# ---------------------------------------------------------------------------
# Boundary (cell -> polygon ring) — serving path (reference: app.py:19-41)
# ---------------------------------------------------------------------------

# Hexagon vertices in the aperture 3-3 substrate grid, Class II and Class III.
_VERTS_CII = ((2, 1, 0), (1, 2, 0), (0, 2, 1), (0, 1, 2), (1, 0, 2), (2, 0, 1))
_VERTS_CIII = ((5, 4, 0), (1, 5, 0), (0, 5, 4), (0, 1, 5), (4, 0, 5), (5, 0, 1))

_DOWN_AP3 = ((2, 0, 1), (1, 2, 0), (0, 1, 2))
_DOWN_AP3R = ((2, 1, 0), (0, 2, 1), (1, 0, 2))


def _down_ap3(i, j, k):
    return ml._lin3(_DOWN_AP3, i, j, k)


def _down_ap3r(i, j, k):
    return ml._lin3(_DOWN_AP3R, i, j, k)


def _insert_face_crossings(verts_rad: List[Tuple[float, float]]
                           ) -> List[Tuple[float, float]]:
    """Insert "distortion" vertices where ring edges cross icosahedron
    face boundaries (Class III cells only — Class II cell edges run
    ALONG face edges and never cross them mid-segment).

    The C library (behind the reference's app.py:19-41) finds these
    points by 2D line intersection in the home face's gnomonic plane.
    Gnomonic projection maps great circles to straight lines, so that
    intersection IS the point on the vertex-to-vertex great arc where
    the containing face changes; we find the same point by bisection on
    the max-dot face predicate (mathlib.closest_face's geometry), which
    needs no per-face coordinate plumbing and handles pentagon rings
    (whose vertices span up to five faces) identically.
    """
    import numpy as np

    from heatmap_tpu_torch.hexgrid.constants import FACE_CENTER_XYZ, geo_to_xyz

    n = len(verts_rad)
    xyz = [geo_to_xyz(np.array([la, ln])) for la, ln in verts_rad]
    # max-dot needs no normalization and no trig round-trip: scaling a
    # vector scales every face dot equally, leaving the argmax unchanged
    faces = [int(np.argmax(FACE_CENTER_XYZ @ v)) for v in xyz]
    out: List[Tuple[float, float]] = []
    for a in range(n):
        b = (a + 1) % n
        out.append(verts_rad[a])
        if faces[a] == faces[b]:
            continue
        va, vb, fa = xyz[a], xyz[b], faces[a]
        lo, hi = 0.0, 1.0
        for _ in range(52):  # ~1 ulp of the chord parameter
            mid = 0.5 * (lo + hi)
            v = va + mid * (vb - va)
            if int(np.argmax(FACE_CENTER_XYZ @ v)) == fa:
                lo = mid
            else:
                hi = mid
        t = 0.5 * (lo + hi)
        if t < 1e-9 or t > 1.0 - 1e-9:
            # crossing coincides with a ring vertex: the adjacent edges
            # each lie on a single face, no extra vertex needed (the C
            # library's isIntersectionAtVertex case)
            continue
        v = va + t * (vb - va)
        v = v / np.linalg.norm(v)
        out.append((math.asin(float(v[2])),
                    math.atan2(float(v[1]), float(v[0]))))
    return out


def cell_to_boundary(cell: str | int, T: Tables | None = None) -> List[Tuple[float, float]]:
    """Cell -> list of (lat, lng) degree vertices (5/6 hex corners, plus
    edge-crossing "distortion" vertices for Class III cells straddling
    icosahedron edges, like the C library behind the reference's
    app.py:19-41 — without them, face-crossing cells (routine for the
    global OpenSky config) render visibly wrong polygons)."""
    T = T or tables()
    h = string_to_h3(cell) if isinstance(cell, str) else cell
    face, ijk, res = _cell_to_faceijk(h, T)
    pent = is_pentagon(h, T)

    # center into the substrate grid
    ijk = _down_ap3(*ijk)
    ijk = _down_ap3r(*ijk)
    adj_res = res
    if is_class_iii(res):
        ijk = ml.down_ap7r(*ijk)
        adj_res += 1
    verts = _VERTS_CIII if is_class_iii(res) else _VERTS_CII
    ring: List[Tuple[float, float]] = []
    idxs = range(6)
    if pent:
        idxs = range(5)  # drop the vertex in the deleted K direction
    for v in idxs:
        vi = ml.ijk_normalize(ijk[0] + verts[v][0], ijk[1] + verts[v][1], ijk[2] + verts[v][2])
        vface, vijk = face, vi
        for _ in range(4):
            overage, vijk2, vface2 = _adjust_overage_class_ii(
                vface, vijk, adj_res, False, True, T
            )
            if overage != 2:
                break
            vface, vijk = vface2, vijk2
        x, y = ml.ijk_to_hex2d(*vijk)
        ring.append(ml.hex2d_to_geo(x, y, vface, adj_res, substrate=True))
    if is_class_iii(res):
        ring = _insert_face_crossings(ring)
    return [(math.degrees(la), math.degrees(ln)) for la, ln in ring]
