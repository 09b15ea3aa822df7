"""Host-side C++ H3 snap (native/h3_snap.cpp), in f64.

A copy of ``heatmap_tpu/hexgrid/native_snap.py``.  The port's device snap
(``snap_kernel``) keys the fold; this host snap keys what the inference
engine derives from its entity table (the velocity field, the forecasts,
the anomaly cells, the logical entity partition), as the reference's
engine does, so those cells are the reference's bit for bit.  f32 device
snaps may put a point within ~0.4 m of a cell edge in the neighbouring
cell; both are valid snaps.
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=1)
def _snap():
    from heatmap_tpu_torch.native import NativeH3Snap

    return NativeH3Snap()  # raises, with the compiler's output, if no build


def snap_arrays(lat_rad, lng_rad, res: int):
    """(N,) f32 radians -> (hi, lo) uint32 numpy arrays via the C++
    snap; res 0..10 (the packed-digit-chain form)."""
    return _snap().snap(lat_rad, lng_rad, res)
