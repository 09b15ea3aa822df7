"""Hex-lattice constants the H3 snap reads.

A copy of the parts of ``heatmap_tpu/hexgrid/mathlib.py`` that the
snap's geometry and table stages use: the Class III test, the
aperture-7 down-step images and the 60-degree digit rotations.
"""

from __future__ import annotations

K_AXES_DIGIT = 1

# 60-degree rotations of a digit (direction), counterclockwise / clockwise.
ROTATE60_CCW = (0, 5, 3, 1, 6, 4, 2)  # K->IK, J->JK, JK->K, I->IJ, IK->I, IJ->J
ROTATE60_CW = (0, 3, 6, 2, 5, 1, 4)   # K->JK, J->IJ, JK->J, I->IK, IK->K, IJ->I

_DOWN_AP7 = ((3, 0, 1), (1, 3, 0), (0, 1, 3))    # ccw: images of i, j, k
_DOWN_AP7R = ((3, 1, 0), (0, 3, 1), (1, 0, 3))   # cw


def is_class_iii(res: int) -> bool:
    return res % 2 == 1
