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
- :mod:`delivery` — the read-path delivery lineage (publish enqueue to
  feed transit to replica apply to fan-out to the subscriber's socket
  write), behind ``heatmap_delivered_age_seconds``, ``/debug/delivery``
  and ``/fleet/delivery`` (``HEATMAP_DELIVERY``);
- :mod:`xproc` — the file-backed supervisor channel
  (``HEATMAP_SUPERVISOR_CHANNEL``), the member snapshots, shard
  watermarks and episode broadcasts beside it, and the atomic JSON
  write;
- :mod:`audit` — the integrity observatory (``HEATMAP_AUDIT``): the
  event-conservation ledger and the per-window content digests;
- :mod:`tsdb` — the telemetry time machine: the member's own exposition
  and /healthz verdict recorded into rings and retained blocks
  (``HEATMAP_TSDB``), the reader and the incident timelines;
- :mod:`slo` — declarative SLOs with error budgets and multi-window
  burn-rate alerts, evaluated on each tsdb scrape;
- :mod:`fleet` — the fleet aggregator behind ``/fleet/*``, and the
  exposition parser and merged-bucket quantile those two read through;
- :mod:`quality` — the inference quality observatory
  (``HEATMAP_QUALITY``): live forecast scorecards and the Kalman
  filter's calibration ledgers.

As in the reference, the audit, tsdb, slo, fleet and quality modules
are imported where they are used, only under their knobs or routes.
"""

from heatmap_tpu_torch.obs.delivery import (  # noqa: F401
    DELIVERY_STAGES,
    DeliveryTracker,
    delivery_enabled,
)
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
from heatmap_tpu_torch.obs.xproc import ENV_CHANNEL, SupervisorChannel  # noqa: F401
