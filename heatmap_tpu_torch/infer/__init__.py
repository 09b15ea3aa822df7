"""Streaming inference: pluggable reducers over the columnar fold.

The counterpart of ``heatmap_tpu/infer``.  ``HEATMAP_REDUCERS`` selects
the reducer set (default ``count``: the fused device fold itself, with
nothing of this package on the hot path).  ``kalman`` adds a
constant-velocity Kalman filter over a bounded per-entity slot table
(``EntityTable``), run by ``InferenceEngine`` over every dispatched batch:
its rounds scan is the CUDA kernel ``csrc/kalman_rounds.cu`` on the card
(``kalman.kalman_rounds``), the plain version on the CPU.  It yields a
count-weighted per-cell velocity field (the tile docs' ``vxKmh`` /
``vyKmh``), short-horizon occupancy forecasts, and reason-tagged anomaly
events (stopped / teleport / deviation).
"""

from heatmap_tpu_torch.infer.engine import ANOMALY_REASONS, InferenceEngine
from heatmap_tpu_torch.infer.entities import EntityTable
from heatmap_tpu_torch.infer.reducer import KNOWN_REDUCERS, parse_reducers

__all__ = [
    "ANOMALY_REASONS",
    "EntityTable",
    "InferenceEngine",
    "KNOWN_REDUCERS",
    "parse_reducers",
]
