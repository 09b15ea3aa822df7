"""Host-side C++ H3 snap (native/h3_snap.cpp), in f64.

A copy of ``heatmap_tpu/hexgrid/native_snap.py``.  It keys the fold
itself under ``HEATMAP_H3_IMPL=native`` (and ``auto`` on the CPU): the
runtime passes its keys to the fold as ``prekeys``, as the reference's
native route does.  It also keys what the inference engine derives from
its entity table (the velocity field, the forecasts, the anomaly cells,
the logical entity partition), as the reference's engine does, so those
cells are the reference's bit for bit.  The f32 device snap
(``snap_kernel``) may put a point within ~0.4 m of a cell edge in the
neighbouring cell; both are valid snaps.
"""

from __future__ import annotations

import functools


@functools.lru_cache(maxsize=1)
def host_snap():
    """The process's ``NativeH3Snap``, built on first use: raises, with
    the compiler's output, if the library cannot be built (a failure is
    not cached)."""
    from heatmap_tpu_torch.native import NativeH3Snap

    return NativeH3Snap()


def snap_arrays(lat_rad, lng_rad, res: int):
    """(N,) f32 radians -> (hi, lo) uint32 numpy arrays via the C++
    snap; res 0..10 (the packed-digit-chain form)."""
    return host_snap().snap(lat_rad, lng_rad, res)
