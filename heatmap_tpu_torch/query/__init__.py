"""query — the materialized tile-view tier between the sink and the API.

The counterpart of ``heatmap_tpu/query``:

- ``matview``  — ``TileMatView``: an in-memory per-grid view of
  (windowStart, cell) → tile doc, applied on the AsyncWriter thread
  AFTER each sink write has durably applied (the view never exposes
  rows that aren't in the store), with a monotonic ``view_seq``, a
  bounded per-grid changelog powering ``/api/tiles/delta`` and the SSE
  stream, and lazy staleAt window eviction matching the store's TTL
  semantics.  ``StoreViewRefresher`` rebuilds the same view by Store
  scan + version polling for serve-only processes.
- ``pyramid``  — incremental multi-resolution rollup (``?res=``).
- ``geom``     — bbox/polygon → H3 cell-set compilation for standing
  queries.
- ``continuous`` — the standing-query engine: range/topk
  subscriptions, geofence enter/exit, threshold and anomaly alerts,
  evaluated O(changed) off the view's mutation stream.

The reference's replication (``repl``) and history (``history``) tiers
are not ported yet.
"""

from heatmap_tpu_torch.query.matview import (  # noqa: F401
    StoreViewRefresher,
    TileMatView,
)
from heatmap_tpu_torch.query.pyramid import Pyramid, cell_to_parent  # noqa: F401
