"""Icosahedron constants the H3 snap reads.

A copy of the values in ``heatmap_tpu/hexgrid/constants.py`` (the public
H3 grid-system constants): face centers, Class II axis azimuths, the
gnomonic res-0 scale, the Class III rotation and sqrt(7).
"""

import numpy as np

# Gnomonic radius of a res-0 unit hex edge... precisely: tan(angular dist of
# one res-0 grid unit from a face center) == RES0_U_GNOMONIC == (3 - sqrt(5))/2.
RES0_U_GNOMONIC = 0.38196601125010500003

M_SQRT7 = 2.6457513110645905905016157536392604257102
# Rotation between Class II and Class III grids: asin(sqrt(3/28)).
M_AP7_ROT_RADS = 0.333473172251832115336090755351601070065900389
M_SIN60 = 0.8660254037844386467637231707529361834714

EPSILON = 1.0e-16

# Icosahedron face centers in (lat, lng) radians.
FACE_CENTER_GEO = np.array([
    [0.803582649718989942, 1.248397419617396099],     # face  0
    [1.307747883455638156, 2.536945009877921159],     # face  1
    [1.054751253523952054, -1.347517358900396623],    # face  2
    [0.600191595538186799, -0.450603909469755746],    # face  3
    [0.491715428198773866, 0.401988202911306943],     # face  4
    [0.172745327415618701, 1.678146885280433686],     # face  5
    [0.605929321571350690, 2.953923329812411617],     # face  6
    [0.427370518328979641, -1.888876200336285401],    # face  7
    [-0.079066118549212831, -0.733429513380867741],   # face  8
    [-0.230961644455383637, 0.506495587332349035],    # face  9
    [0.079066118549212831, 2.408163140208925497],     # face 10
    [0.230961644455383637, -2.635097066257444203],    # face 11
    [-0.172745327415618701, -1.463445768309359553],   # face 12
    [-0.605929321571350690, -0.187669323777381622],   # face 13
    [-0.427370518328979641, 1.252716453253507838],    # face 14
    [-0.600191595538186799, 2.690988744120037492],    # face 15
    [-0.491715428198773866, -2.739604450678486295],   # face 16
    [-0.803582649718989942, -1.893195233972397139],   # face 17
    [-1.307747883455638156, -0.604647643711872080],   # face 18
    [-1.054751253523952054, 1.794075294689396615],    # face 19
], dtype=np.float64)

# Azimuth (radians east of north) from each face center to its Class II
# i-axis (which points at one of the face's three icosahedron vertices).
FACE_AXES_AZ_CII = np.array([
    5.619958268523939882,   # face  0
    5.760339081714187279,   # face  1
    0.780213654393430055,   # face  2
    0.430469363979999913,   # face  3
    6.130269123335111400,   # face  4
    2.692877706530642877,   # face  5
    2.982963003477243874,   # face  6
    3.532912002790141181,   # face  7
    3.494305004259568154,   # face  8
    3.003214169499538391,   # face  9
    5.930472956509811562,   # face 10
    0.138378484090254847,   # face 11
    0.448714947059150361,   # face 12
    0.158629650112549365,   # face 13
    5.891865957979238535,   # face 14
    2.711123289609793325,   # face 15
    3.294508837434268316,   # face 16
    3.804819692245439833,   # face 17
    3.664438879055192436,   # face 18
    2.361378999196363184,   # face 19
], dtype=np.float64)


def geo_to_xyz(latlng: np.ndarray) -> np.ndarray:
    """(..., 2) lat/lng radians -> (..., 3) unit vectors."""
    lat = latlng[..., 0]
    lng = latlng[..., 1]
    clat = np.cos(lat)
    return np.stack([clat * np.cos(lng), clat * np.sin(lng), np.sin(lat)], axis=-1)


FACE_CENTER_XYZ = geo_to_xyz(FACE_CENTER_GEO)
