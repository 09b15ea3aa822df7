"""PyTorch / CUDA port of the heatmap stream fold (``heatmap_tpu``).

The JAX package ``heatmap_tpu`` is the reference; this package runs the
``synthetic_backfill`` pipeline (H3 snap -> sorted-slab fold -> tile docs)
with PyTorch ops and hand-written CUDA kernels for the NVIDIA H100, and
imports nothing of JAX or of ``heatmap_tpu``.  Entry point:
``python -m heatmap_tpu_torch.stream``.
"""
