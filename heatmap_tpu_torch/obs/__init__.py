"""obs — the observability substrate of the port.

The counterpart of ``heatmap_tpu/obs``, all of it host Python:

- :mod:`registry` — counters, gauges and fixed-bucket histograms with
  Prometheus text exposition; the runtime, the view, the replication and
  history tiers and the serve tier register their families in one
  registry a runtime, which ``/metrics`` exposes;
- :mod:`tracebuf` — the bounded ring of per-batch trace records
  (``/trace/recent``; the JSONL export ``HEATMAP_TRACE_JSONL``);
- :mod:`lineage` — per-batch freshness lineage (event ts to the sink
  commit ack, staged), behind ``heatmap_event_age_seconds`` and
  ``/debug/freshness``;
- :mod:`flightrec` — the crash-time state dump to
  ``HEATMAP_FLIGHTREC_DIR``;
- :mod:`runtimeinfo` — builds on the step's entry points, device memory
  watermarks, and the SLO watchdog;
- :mod:`prof` — the sampling stack profiler behind ``/debug/stacks``;
- :mod:`xproc` — the atomic JSON write, the fleet staleness budget and
  the fleet's environment names;
- :mod:`audit` — the doc content hash the history tier uses.

The telemetry time machine (``tsdb``, ``slo``), the fleet aggregator,
the delivery lineage, the rest of the integrity observatory and the
quality observatory are ROADMAP A6b, A7, A6c and A5.
"""

from heatmap_tpu_torch.obs.flightrec import FlightRecorder  # noqa: F401
from heatmap_tpu_torch.obs.lineage import LineageTracker  # noqa: F401
from heatmap_tpu_torch.obs.prof import StackSampler, get_sampler  # noqa: F401
from heatmap_tpu_torch.obs.registry import (  # noqa: F401
    DEFAULT_LAG_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Registry,
    render_flat_counters,
)
from heatmap_tpu_torch.obs.tracebuf import TraceRing  # noqa: F401
