"""serve — REST API + embedded map UI over the port's stores and view.

The counterpart of ``heatmap_tpu/serve``: GeoJSON FeatureCollections, hex
Polygon rings as closed [[lng, lat], ...] loops, Point features for
vehicle positions, the binary wire frames and SSE streams, served by the
stdlib WSGI server (threaded), standalone against a Store (``python -m
heatmap_tpu_torch.serve``) or embedded in the streaming process.
"""

from heatmap_tpu_torch.serve.api import (  # noqa: F401
    make_wsgi_app,
    serve_forever,
    start_background,
    stop_background,
)
