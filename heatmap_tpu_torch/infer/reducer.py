"""The reducer set: which per-step analytics ride the fold's batches.

The counterpart of ``heatmap_tpu/infer/reducer.py``.  ``HEATMAP_REDUCERS``
selects the set.  ``count`` names the fused device histogram fold itself
and is always a member; ``kalman`` adds the entity filter, which the
runtime builds as ``infer.engine.InferenceEngine`` and folds after each
step's ring flush.  With only ``count`` enabled the runtime constructs
nothing from this package on the hot path, so the count path's docs are
byte for byte what they are without it.

The set is validated by ``config.load_config``, so the names live in
``config`` (which depends on nothing above it) and are re-exported here.
"""

from heatmap_tpu_torch.config import KNOWN_REDUCERS, parse_reducers

__all__ = ["KNOWN_REDUCERS", "parse_reducers"]
