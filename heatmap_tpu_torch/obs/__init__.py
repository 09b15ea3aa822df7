"""obs — the observability substrate the read path uses.

The counterpart of ``heatmap_tpu/obs``, for now its metrics registry
(``registry``: the materialized tile view, the continuous-query engine,
the replication and history tiers and the serve tier register their
families in it, and ``/metrics`` exposes them), the atomic JSON write and
fleet staleness budget (``xproc``) and the doc content hash (``audit``).
The rest of ``heatmap_tpu/obs`` is not ported yet.
"""

from heatmap_tpu_torch.obs.registry import (  # noqa: F401
    Registry,
    render_flat_counters,
)
