"""Host-side f64 spherical and hex-lattice math for the icosahedral grid.

A copy of ``heatmap_tpu/hexgrid/mathlib.py``: the scalar geometry the host
oracle (``host.py``) runs on (spherical azimuth/distance <-> face-local
gnomonic 2D <-> hex IJK+ coordinates <-> aperture-7 digit chains), and the
constants the snap's geometry and table stages read (the Class III test,
the aperture-7 down-step images and the 60-degree digit rotations).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from heatmap_tpu_torch.hexgrid.constants import (
    EPSILON,
    FACE_AXES_AZ_CII,
    FACE_CENTER_GEO,
    FACE_CENTER_XYZ,
    M_AP7_ROT_RADS,
    M_SIN60,
    M_SQRT7,
    RES0_U_GNOMONIC,
)

M_PI = math.pi
M_2PI = 2.0 * math.pi

# Hex digit values (direction from a cell center to a neighbor one finer).
CENTER_DIGIT = 0
K_AXES_DIGIT = 1
J_AXES_DIGIT = 2
JK_AXES_DIGIT = 3
I_AXES_DIGIT = 4
IK_AXES_DIGIT = 5
IJ_AXES_DIGIT = 6
INVALID_DIGIT = 7

# digit -> unit IJK vector
UNIT_VECS = (
    (0, 0, 0),  # 0 center
    (0, 0, 1),  # 1 K
    (0, 1, 0),  # 2 J
    (0, 1, 1),  # 3 JK
    (1, 0, 0),  # 4 I
    (1, 0, 1),  # 5 IK
    (1, 1, 0),  # 6 IJ
)

# 60-degree rotations of a digit (direction), counterclockwise / clockwise.
ROTATE60_CCW = (0, 5, 3, 1, 6, 4, 2)  # K->IK, J->JK, JK->K, I->IJ, IK->I, IJ->J
ROTATE60_CW = (0, 3, 6, 2, 5, 1, 4)   # K->JK, J->IJ, JK->J, I->IK, IK->K, IJ->I


def angdist(lat1: float, lng1: float, lat2: float, lng2: float) -> float:
    """Great-circle distance in radians."""
    c = (
        math.sin(lat1) * math.sin(lat2)
        + math.cos(lat1) * math.cos(lat2) * math.cos(lng1 - lng2)
    )
    return math.acos(min(1.0, max(-1.0, c)))


def unit_angle(res: int) -> float:
    """Approximate angular size of one grid unit at `res`."""
    return math.atan(RES0_U_GNOMONIC) * 7.0 ** (-res / 2.0)


def pos_angle(a: float) -> float:
    """Normalize an angle into [0, 2*pi)."""
    a = math.fmod(a, M_2PI)
    return a + M_2PI if a < 0.0 else a


def geo_azimuth(lat1: float, lng1: float, lat2: float, lng2: float) -> float:
    """Azimuth (radians east of north) from point 1 to point 2."""
    return math.atan2(
        math.cos(lat2) * math.sin(lng2 - lng1),
        math.cos(lat1) * math.sin(lat2)
        - math.sin(lat1) * math.cos(lat2) * math.cos(lng2 - lng1),
    )


def geo_az_distance(lat: float, lng: float, az: float, distance: float) -> Tuple[float, float]:
    """Destination point at `distance` radians along azimuth `az` from start."""
    if distance < EPSILON:
        return lat, lng
    az = pos_angle(az)
    sinlat = math.sin(lat) * math.cos(distance) + math.cos(lat) * math.sin(distance) * math.cos(az)
    sinlat = min(1.0, max(-1.0, sinlat))
    lat2 = math.asin(sinlat)
    if abs(math.cos(lat2)) < EPSILON:  # pole
        return (M_PI / 2 if lat2 > 0 else -M_PI / 2), 0.0
    sinlng = math.sin(az) * math.sin(distance) / math.cos(lat2)
    coslng = (math.cos(distance) - math.sin(lat) * sinlat) / (math.cos(lat) * math.cos(lat2))
    lng2 = lng + math.atan2(sinlng, coslng)
    # normalize to (-pi, pi]
    lng2 = math.fmod(lng2 + M_PI, M_2PI)
    if lng2 <= 0.0:
        lng2 += M_2PI
    return lat2, lng2 - M_PI


def closest_face(lat: float, lng: float) -> Tuple[int, float]:
    """Icosahedron face whose center is nearest, and the angular distance."""
    clat = math.cos(lat)
    v = np.array([clat * math.cos(lng), clat * math.sin(lng), math.sin(lat)])
    dots = FACE_CENTER_XYZ @ v
    face = int(np.argmax(dots))
    r = math.acos(min(1.0, max(-1.0, float(dots[face]))))
    return face, r


def geo_to_hex2d(lat: float, lng: float, res: int) -> Tuple[int, float, float]:
    """Project a point onto its nearest face's gnomonic plane in res units."""
    face, r = closest_face(lat, lng)
    if r < EPSILON:
        return face, 0.0, 0.0
    fc_lat, fc_lng = FACE_CENTER_GEO[face]
    theta = pos_angle(
        FACE_AXES_AZ_CII[face] - pos_angle(geo_azimuth(fc_lat, fc_lng, lat, lng))
    )
    if is_class_iii(res):
        theta = pos_angle(theta - M_AP7_ROT_RADS)
    r = math.tan(r) / RES0_U_GNOMONIC
    for _ in range(res):
        r *= M_SQRT7
    return face, r * math.cos(theta), r * math.sin(theta)


def hex2d_to_geo(x: float, y: float, face: int, res: int, substrate: bool = False) -> Tuple[float, float]:
    """Inverse of geo_to_hex2d for a *given* face (extended gnomonic plane)."""
    r = math.hypot(x, y)
    fc_lat, fc_lng = FACE_CENTER_GEO[face]
    if r < EPSILON:
        return float(fc_lat), float(fc_lng)
    theta = math.atan2(y, x)
    for _ in range(res):
        r /= M_SQRT7
    if substrate:
        # substrate grids are 3x finer in unit scale (used for boundaries)
        r /= 3.0
        if is_class_iii(res):
            r /= M_SQRT7
    r = math.atan(r * RES0_U_GNOMONIC)
    if not substrate and is_class_iii(res):
        theta = pos_angle(theta + M_AP7_ROT_RADS)
    az = pos_angle(FACE_AXES_AZ_CII[face] - theta)
    return geo_az_distance(fc_lat, fc_lng, az, r)


def is_class_iii(res: int) -> bool:
    return res % 2 == 1


# ---------------------------------------------------------------------------
# IJK+ coordinate ops
# ---------------------------------------------------------------------------

def ijk_normalize(i: int, j: int, k: int) -> Tuple[int, int, int]:
    if i < 0:
        j -= i
        k -= i
        i = 0
    if j < 0:
        i -= j
        k -= j
        j = 0
    if k < 0:
        i -= k
        j -= k
        k = 0
    m = min(i, j, k)
    if m > 0:
        i -= m
        j -= m
        k -= m
    return i, j, k


def hex2d_to_ijk(x: float, y: float) -> Tuple[int, int, int]:
    """Round 2D hex-plane coordinates to the containing cell's IJK+ coords."""
    a1 = abs(x)
    a2 = abs(y)
    x2 = a2 / M_SIN60
    x1 = a1 + x2 / 2.0
    m1 = int(x1)
    m2 = int(x2)
    r1 = x1 - m1
    r2 = x2 - m2
    k = 0
    if r1 < 0.5:
        if r1 < 1.0 / 3.0:
            if r2 < (1.0 + r1) / 2.0:
                i, j = m1, m2
            else:
                i, j = m1, m2 + 1
        else:
            j = m2 if r2 < (1.0 - r1) else m2 + 1
            i = m1 + 1 if (1.0 - r1) <= r2 < (2.0 * r1) else m1
    else:
        if r1 < 2.0 / 3.0:
            j = m2 if r2 < (1.0 - r1) else m2 + 1
            i = m1 if (2.0 * r1 - 1.0) < r2 < (1.0 - r1) else m1 + 1
        else:
            if r2 < (r1 / 2.0):
                i, j = m1 + 1, m2
            else:
                i, j = m1 + 1, m2 + 1
    # fold across the axes if necessary
    if x < 0.0:
        if j % 2 == 0:
            axisi = j // 2
            diff = i - axisi
            i = i - 2 * diff
        else:
            axisi = (j + 1) // 2
            diff = i - axisi
            i = i - (2 * diff + 1)
    if y < 0.0:
        i = i - (2 * j + 1) // 2
        j = -j
    return ijk_normalize(i, j, k)


def ijk_to_hex2d(i: int, j: int, k: int) -> Tuple[float, float]:
    ii = i - k
    jj = j - k
    return ii - 0.5 * jj, jj * M_SIN60


def _lround(x: float) -> int:
    return int(math.floor(x + 0.5)) if x >= 0.0 else int(math.ceil(x - 0.5))


def up_ap7(i: int, j: int, k: int) -> Tuple[int, int, int]:
    """Coarsen one aperture-7 counter-clockwise (Class III -> Class II) step."""
    ii = i - k
    jj = j - k
    return ijk_normalize(_lround((3 * ii - jj) / 7.0), _lround((ii + 2 * jj) / 7.0), 0)


def up_ap7r(i: int, j: int, k: int) -> Tuple[int, int, int]:
    """Coarsen one aperture-7 clockwise (Class II -> Class III) step."""
    ii = i - k
    jj = j - k
    return ijk_normalize(_lround((2 * ii + jj) / 7.0), _lround((3 * jj - ii) / 7.0), 0)


_DOWN_AP7 = ((3, 0, 1), (1, 3, 0), (0, 1, 3))    # ccw: images of i, j, k
_DOWN_AP7R = ((3, 1, 0), (0, 3, 1), (1, 0, 3))   # cw


def _lin3(vecs, i: int, j: int, k: int) -> Tuple[int, int, int]:
    iv, jv, kv = vecs
    return ijk_normalize(
        i * iv[0] + j * jv[0] + k * kv[0],
        i * iv[1] + j * jv[1] + k * kv[1],
        i * iv[2] + j * jv[2] + k * kv[2],
    )


def down_ap7(i: int, j: int, k: int) -> Tuple[int, int, int]:
    return _lin3(_DOWN_AP7, i, j, k)


def down_ap7r(i: int, j: int, k: int) -> Tuple[int, int, int]:
    return _lin3(_DOWN_AP7R, i, j, k)


_ROT_CCW_VECS = ((1, 1, 0), (0, 1, 1), (1, 0, 1))  # images of i, j, k
_ROT_CW_VECS = ((1, 0, 1), (1, 1, 0), (0, 1, 1))


def ijk_rotate60_ccw(i: int, j: int, k: int) -> Tuple[int, int, int]:
    return _lin3(_ROT_CCW_VECS, i, j, k)


def ijk_rotate60_cw(i: int, j: int, k: int) -> Tuple[int, int, int]:
    return _lin3(_ROT_CW_VECS, i, j, k)


def unit_ijk_to_digit(i: int, j: int, k: int) -> int:
    ijk = ijk_normalize(i, j, k)
    try:
        return UNIT_VECS.index(ijk)
    except ValueError:
        return INVALID_DIGIT


def neighbor(i: int, j: int, k: int, digit: int) -> Tuple[int, int, int]:
    u = UNIT_VECS[digit]
    return ijk_normalize(i + u[0], j + u[1], k + u[2])


def ijk_sub(a, b) -> Tuple[int, int, int]:
    return ijk_normalize(a[0] - b[0], a[1] - b[1], a[2] - b[2])
