"""hexgrid — the icosahedral aperture-7 hexagonal grid (H3-compatible).

The counterpart of ``heatmap_tpu/hexgrid``: ``constants``, ``mathlib`` and
``_tables`` (the grid geometry), ``host`` (the scalar f64 oracle, whose
public names are re-exported here for the serving tier), ``device`` and
``snap_kernel`` (the snap on the card: the fused CUDA kernel and its plain
version), ``native_snap`` (the f64 C++ host snap).  Importing this package
imports neither torch nor a compiler.
"""

from heatmap_tpu_torch.hexgrid.host import (  # noqa: F401
    latlng_to_cell,
    latlng_to_cell_int,
    cell_to_latlng,
    cell_to_boundary,
    h3_to_string,
    string_to_h3,
    get_resolution,
    get_base_cell,
    is_pentagon,
)
