"""Flat env-var configuration: the fields the port reads.

A copy of the part of ``heatmap_tpu/config.py`` that the streaming slice
uses, with the same environment names and defaults, so one environment
configures both packages the same way.  A knob of the reference that turns
on a subsystem the port lacks (``UNPORTED_KNOBS``) raises
``NotImplementedError`` in ``load_config`` when it asks for more than the
reference's default, instead of being silently ignored.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Mapping


def _int(env: Mapping[str, str], name: str, default: int) -> int:
    return int(env.get(name, default))


def _float(env: Mapping[str, str], name: str, default: float) -> float:
    return float(env.get(name, default))


def _ints(env: Mapping[str, str], name: str, default: str) -> tuple[int, ...]:
    return tuple(int(x) for x in str(env.get(name, default)).split(",") if x != "")


def _default_checkpoint_dir() -> str:
    """``heatmap-checkpoint`` under the temp directory (``TMPDIR``)."""
    return os.path.join(tempfile.gettempdir(), "heatmap-checkpoint")


def _flag_on(v: str) -> bool:
    """A HEATMAP_* boolean knob as the reference's load_config reads it."""
    return v not in ("0", "false", "")


# HEATMAP_REDUCERS' closed name set, in canonical order
KNOWN_REDUCERS = ("count", "kalman")


def parse_reducers(spec: str) -> tuple:
    """Normalize a ``HEATMAP_REDUCERS`` value to a validated, ordered,
    deduplicated tuple.  ``count`` is mandatory: the device fold always
    runs — a set that pretends otherwise would stamp artifacts with a
    reducer set the runtime cannot honor."""
    names = [s.strip() for s in str(spec).split(",") if s.strip()]
    seen: list = []
    for n in names:
        if n not in KNOWN_REDUCERS:
            raise ValueError(
                f"HEATMAP_REDUCERS names unknown reducer {n!r}; known: "
                f"{','.join(KNOWN_REDUCERS)}")
        if n not in seen:
            seen.append(n)
    if "count" not in seen:
        raise ValueError(
            "HEATMAP_REDUCERS must include 'count' (the fused device "
            "fold always runs; extra reducers ride its batches)")
    # canonical order = KNOWN_REDUCERS order, so artifact stamps and
    # regression-family comparisons never see two spellings of one set
    return tuple(n for n in KNOWN_REDUCERS if n in seen)


# knob -> (does this value ask for the subsystem?, the ROADMAP item that
# ports it); the reference's value when the knob is unset never does.
# HEATMAP_DELIVERY, HEATMAP_SUPERVISOR_CHANNEL and HEATMAP_HEARTBEAT_FILE
# are read where they are used (obs.delivery, obs.xproc, the runtime's
# beacon), as in the reference
UNPORTED_KNOBS = {
    # jax.distributed and a mesh (parallel/multihost.py, stream/__main__)
    "HEATMAP_COORDINATOR": (bool, "A8, the mesh"),
    "NUM_SHARDS": (lambda v: int(v) > 1, "A8, the mesh"),
}


@dataclasses.dataclass(frozen=True)
class Config:
    mongo_uri: str = "mongodb://127.0.0.1:27017"
    mongo_db: str = "mobility"
    kafka_bootstrap: str = "localhost:9092"
    kafka_topic: str = "mobility.positions.v1"
    city: str = "ath"
    checkpoint_dir: str = dataclasses.field(
        default_factory=_default_checkpoint_dir)
    h3_res: int = 8                    # typical 7-9 for city heatmaps
    tile_minutes: int = 5              # aggregation window size
    ttl_minutes: int = 45              # tile TTL after window end
    watermark_minutes: int = 10
    resolutions: tuple[int, ...] = (8,)     # multi-res hex pyramid, e.g. 7,8,9
    windows_minutes: tuple[int, ...] = (5,)  # sliding multi-window, e.g. 1,5,15
    batch_size: int = 1 << 17          # events per fixed-shape micro-batch
    state_capacity_log2: int = 17      # state slab rows per pair
    state_max_log2: int = 0            # growth ceiling; 0 = capacity+4 (16x);
                                       # == state_capacity_log2 disables growth
    # Per-cell speed histogram driving the p95 stats: interpolated p95 is
    # exact to within one bin width (speed_hist_max_kmh / speed_hist_bins),
    # and speeds >= the max saturate into the last bin.
    speed_hist_bins: int = 64
    speed_hist_max_kmh: float = 256.0
    # emit pulls: "prefix" pulls the head rows, then one power-of-two
    # bucket of live rows; "full" the whole matrix; "auto" is prefix on a
    # CUDA device and full on the CPU (where a second copy saves nothing)
    emit_pull: str = "auto"
    # depth of the device-resident emit ring: the packed emits of up to K
    # batches stay on the device and are pulled in one flush
    emit_flush_k: int = 8
    # "error": overflowing groups are dropped, counted and logged; "fail":
    # the run stops and commits nothing past the last good checkpoint
    on_overflow: str = "error"
    # free-slot margin the slab grower keeps: "worst" = 2x batch (a batch
    # can mint one group per event, so overflow cannot happen below the
    # ceiling); "observed" = 4x the largest per-batch minting seen (floor
    # batch/8), with overflow as the loud backstop
    grow_margin: str = "worst"
    # batches polled, padded and copied to the device ahead of the fold
    prefetch_batches: int = 1
    flightrec_dir: str = ""            # HEATMAP_FLIGHTREC_DIR: directory
                                       # for post-mortem flight records
                                       # (obs.flightrec): on an abnormal
                                       # exit or SIGTERM the runtime dumps
                                       # its trace tail, lineage tail,
                                       # metrics snapshot and config
                                       # there.  Empty disables.  A normal
                                       # close writes nothing unless
                                       # HEATMAP_FLIGHTREC_ALWAYS=1.
    lineage_tail: int = 256            # HEATMAP_LINEAGE_TAIL: closed
                                       # freshness-lineage records kept
                                       # for /debug/freshness and the
                                       # flight recorder (obs.lineage)
    trigger_ms: int = 0                # 0 = as fast as possible (ref default)
    refresh_ms: int = 5000             # the UI's poll period (REFRESH_MS)
    serve_host: str = "127.0.0.1"
    serve_port: int = 5000             # 0 binds an ephemeral port
    store: str = "auto"                # "auto" | "memory" | "mongo" | "jsonl"
    shards: int = 1                    # HEATMAP_SHARDS: total runtime
                                       # shard processes partitioning
                                       # the event stream by H3 parent
                                       # cell (stream/shardmap.py); 1 =
                                       # unsharded (the default)
    shard_index: int = 0               # HEATMAP_SHARD_INDEX: this
                                       # process's shard in 0..N-1 (the
                                       # fleet supervisor sets it per
                                       # child)
    shard_res: int = -1                # HEATMAP_SHARD_RES: H3 parent
                                       # resolution of the partition
                                       # key; -1 = the snap resolution
                                       # itself (parent == cell).  Must
                                       # not exceed min(resolutions).
    shard_oversample: int = 0          # HEATMAP_SHARD_OVERSAMPLE: how
                                       # many feed batches of stream
                                       # rows a shard polls a step
                                       # before the ownership filter
                                       # compacts them (0 = the shard
                                       # count; 1 = one feed shape, the
                                       # byte-exact differential mode)
    govern: bool = False               # HEATMAP_GOVERN: adaptive
                                       # micro-batching (stream/
                                       # govern.py): the live batch
                                       # bucket, emit_flush_k and
                                       # prefetch_batches move within
                                       # the bounds below to hold
                                       # HEATMAP_SLO_FRESHNESS_P50_MS;
                                       # the static knobs become the
                                       # initial values.  0 = static
    govern_interval_s: float = 5.0     # HEATMAP_GOVERN_INTERVAL_S:
                                       # control-loop cadence
    govern_min_batch: int = 4096       # HEATMAP_GOVERN_MIN_BATCH: the
                                       # bucket ladder's floor (powers
                                       # of two from here up to
                                       # BATCH_SIZE, each warmed at
                                       # startup)
    govern_max_flush_k: int = 32       # HEATMAP_GOVERN_MAX_FLUSH_K:
                                       # flush-K ceiling (floor 1)
    govern_max_prefetch: int = 4       # HEATMAP_GOVERN_MAX_PREFETCH:
                                       # prefetch ceiling (floor 0)
    govern_healthy_frac: float = 0.5   # HEATMAP_GOVERN_HEALTHY_FRAC:
                                       # upward moves only while the
                                       # recent event-age p50 is below
                                       # this fraction of the SLO
    # HEATMAP_REDUCERS: the per-step reducer set riding the dispatched
    # batches (parse_reducers); "count" is the fused device fold itself
    # and always a member; "kalman" adds the entity filter (infer/engine.py)
    reducers: tuple[str, ...] = ("count",)
    entity_capacity: int = 1 << 17     # HEATMAP_ENTITY_CAPACITY: slot-table
                                       # bound; TTL then exact-LRU eviction
    entity_ttl_s: float = 900.0        # HEATMAP_ENTITY_TTL_S: an entity
                                       # silent past this (event time) is
                                       # evicted; also the filter's dt clamp
    entity_shards: int = 0             # HEATMAP_ENTITY_SHARDS: logical
                                       # entity-partition shard count for
                                       # handoff re-seeds (0 = HEATMAP_SHARDS)
    entity_stop_s: float = 120.0       # HEATMAP_ENTITY_STOP_S: filtered
                                       # speed below the stop gate this long
                                       # (after moving) raises "stopped"
    query_view: bool = True            # HEATMAP_QUERY_VIEW: maintain the
                                       # materialized tile view (query/
                                       # matview) feeding /api/tiles/
                                       # delta, ETag 304s, SSE, topk and
                                       # ?res= rollups; 0 disables — reads
                                       # fall back to direct Store renders
    delta_log: int = 4096              # HEATMAP_DELTA_LOG: per-grid
                                       # changed-cell changelog depth
                                       # backing /api/tiles/delta
    pyramid_levels: int = 2            # HEATMAP_PYRAMID_LEVELS: coarser
                                       # H3 parent resolutions the view
                                       # maintains per grid for ?res=
                                       # zoom-out; 0 disables rollups
    view_poll_ms: int = 1000           # HEATMAP_VIEW_POLL_MS: serve-only
                                       # view rebuild TTL (covers stores
                                       # written by OTHER processes)
    sse_max_clients: int = 64          # HEATMAP_SSE_MAX_CLIENTS: open SSE
                                       # connections before new ones get
                                       # 503 (each holds a server thread)
    sse_heartbeat_s: float = 15.0      # HEATMAP_SSE_HEARTBEAT_S: SSE
                                       # comment-ping cadence
    sse_queue: int = 64                # HEATMAP_SSE_QUEUE: bounded per-
                                       # subscriber send queue (frames);
                                       # an overflow sheds the subscriber
                                       # with `event: lagged`
    sse_send_timeout_s: float = 30.0   # HEATMAP_SSE_SEND_TIMEOUT_S: socket
                                       # send timeout on SSE connections;
                                       # 0 disables
    serve_max_inflight: int = 256      # HEATMAP_SERVE_MAX_INFLIGHT: in-
                                       # flight render/encode requests on
                                       # the data endpoints before 503 +
                                       # Retry-After; 0 disables
    serve_workers: int = 1             # HEATMAP_SERVE_WORKERS: serve
                                       # worker processes `python -m
                                       # heatmap_tpu_torch.serve` forks,
                                       # each binding the same port via
                                       # SO_REUSEPORT and running its own
                                       # replica follower
    serve_core: str = "thread"         # HEATMAP_SERVE_CORE: which HTTP
                                       # core hosts the serve app —
                                       # "thread" (wsgiref, a thread
                                       # per request + per SSE
                                       # subscriber) or "epoll" (the
                                       # selectors event loop with
                                       # zero-copy SSE fan-out,
                                       # serve/evloop.py)
    serve_loop_handlers: int = 8       # HEATMAP_SERVE_LOOP_HANDLERS:
                                       # WSGI handler threads behind
                                       # the epoll core's loop — app
                                       # calls (store reads, history
                                       # scans) run here so blocking
                                       # work never stalls the loop
    repl_dir: str = ""                 # HEATMAP_REPL_DIR: directory the
                                       # writer process publishes the
                                       # view-replication feed into
                                       # (query/repl.py: segment log +
                                       # snapshots + meta, one writer
                                       # per dir).  The serve app also
                                       # re-exposes the feed at
                                       # /api/repl/* for remote
                                       # replicas.  Empty disables
                                       # publishing.
    repl_feed: str = ""                # HEATMAP_REPL_FEED: what a
                                       # serve-only worker FOLLOWS to
                                       # hold a hot seq-consistent
                                       # replica view with zero
                                       # steady-state store reads: a
                                       # feed directory (same host) or
                                       # an http(s):// base URL of a
                                       # process serving /api/repl/*.
                                       # Empty keeps store-scan polling.
    repl_seg_bytes: int = 1 << 22      # HEATMAP_REPL_SEG_BYTES: feed
                                       # segment rotation bound; each
                                       # rotation also refreshes the
                                       # catch-up snapshot
    repl_segments: int = 4             # HEATMAP_REPL_SEGMENTS: feed
                                       # segments retained on disk
                                       # (including the live one); a
                                       # follower that falls behind the
                                       # oldest re-bootstraps from the
                                       # snapshot
    repl_poll_ms: int = 200            # HEATMAP_REPL_POLL_MS: replica
                                       # follower tail-poll cadence
    hist_dir: str = ""                 # HEATMAP_HIST_DIR: space-time
                                       # history store (query/
                                       # history.py).  On the writer:
                                       # rotated repl segments retire
                                       # here instead of being deleted
                                       # and a compactor folds them
                                       # into immutable (grid, parent
                                       # cell, time bucket) chunks.
                                       # On any serve worker: enables
                                       # /api/tiles/range|at|diff and
                                       # the /api/hist/* re-export.
                                       # Empty disables the tier.
    hist_retention_s: float = 604800.0  # HEATMAP_HIST_RETENTION_S:
                                       # history retention (7 days).
                                       # Chunks age out past it; raw
                                       # segments prune only once
                                       # chunks cover them AND they
                                       # age past it.
    hist_bucket_s: int = 3600          # HEATMAP_HIST_BUCKET_S: time-
                                       # bucket width of one chunk key
    hist_parent_res: int = 3           # HEATMAP_HIST_PARENT_RES: H3
                                       # parent resolution of the
                                       # chunk partition key (clamped
                                       # per cell to its own res)
    hist_compact_s: float = 2.0        # HEATMAP_HIST_COMPACT_S:
                                       # compaction cadence of the
                                       # writer-side compactor thread
    hist_backfill: bool = True         # HEATMAP_HIST_BACKFILL: replica
                                       # cold-start backfill of pre-
                                       # snapshot windows from history
                                       # chunks (query/repl.py); 0
                                       # disables
    cq: bool = True                    # HEATMAP_CQ: the continuous spatial
                                       # query engine (query/continuous)
                                       # on view-backed serve surfaces;
                                       # 0 removes the endpoints
    cq_max_queries: int = 1 << 20      # HEATMAP_CQ_MAX_QUERIES
    cq_ttl_s: float = 3600.0           # HEATMAP_CQ_TTL_S: default standing-
                                       # query TTL (0 = never expires)
    cq_events: int = 256               # HEATMAP_CQ_EVENTS: match records
                                       # buffered per query for resume
    cq_max_cells: int = 4096           # HEATMAP_CQ_MAX_CELLS: compiled
                                       # cell-set budget per query
    tsdb: bool = False                 # HEATMAP_TSDB: the telemetry time
                                       # machine (obs/tsdb.py): a sampler
                                       # thread records the runtime's
                                       # /metrics exposition and /healthz
                                       # verdict into history rings,
                                       # persisted as blocks under
                                       # HEATMAP_TSDB_DIR, and the SLO
                                       # burn-rate engine (obs/slo.py)
                                       # evaluates on each scrape.  0
                                       # builds nothing
    tsdb_dir: str = ""                 # HEATMAP_TSDB_DIR: per-member
                                       # history directory; empty with
                                       # tsdb=1: rings and the SLO engine
                                       # run, nothing persists and the
                                       # timeline routes 503
    tsdb_scrape_s: float = 5.0         # HEATMAP_TSDB_SCRAPE_S: scrape
                                       # cadence, also the SLO engine's
                                       # tick and budget-spend unit
    tsdb_retain_s: float = 259200.0    # HEATMAP_TSDB_RETAIN_S: retention
                                       # (3 days)
    tsdb_hot_s: float = 3600.0         # HEATMAP_TSDB_HOT_S: raw-resolution
                                       # span; older blocks merge into a
                                       # downsampled tier
    tsdb_flush_s: float = 60.0         # HEATMAP_TSDB_FLUSH_S: block
                                       # persistence cadence (an SLO alert
                                       # flushes at once)
    slo_budget_frac: float = 0.01      # HEATMAP_SLO_BUDGET_FRAC: share of
                                       # scrape ticks allowed to breach an
                                       # SLO inside the budget window
    slo_budget_window_s: float = 86400.0  # HEATMAP_SLO_BUDGET_WINDOW_S:
                                       # rolling error-budget window; the
                                       # canonical 30-day burn-rate alert
                                       # windows scale to it
    quality: bool = False              # HEATMAP_QUALITY: the inference
                                       # quality observatory
                                       # (obs/quality.py), with the kalman
                                       # reducer: live forecast scoring,
                                       # calibration ledgers, drift SLOs.
                                       # 0 builds nothing
    quality_window_s: float = 600.0    # HEATMAP_QUALITY_WINDOW_S: rolling
                                       # event-time window of the
                                       # calibration ledger
    quality_lookback_s: float = 300.0  # HEATMAP_QUALITY_LOOKBACK_S: span
                                       # summed around the base and target
                                       # instants when scoring
    quality_mature_s: float = 60.0     # HEATMAP_QUALITY_MATURE_S: event-
                                       # time slack past a scorecard's
                                       # target before it scores
    quality_ttl_s: float = 3600.0      # HEATMAP_QUALITY_TTL_S: a matured
                                       # scorecard unanswerable this long
                                       # expires as expired_unscorable
    audit: bool = False                # HEATMAP_AUDIT: the integrity
                                       # observatory (obs/audit.py) —
                                       # observe-only event-conservation
                                       # ledger at every pipeline
                                       # boundary plus per-(grid,
                                       # window) content digests
                                       # verified across replicas.  Zero
                                       # data-path mutation; 0 (the
                                       # default) disables entirely
    audit_settle_s: float = 10.0       # HEATMAP_AUDIT_SETTLE_S: how
                                       # long a non-zero ledger
                                       # residual must go without
                                       # draining before /healthz
                                       # degrades naming the boundary

    def pair_grid(self, res: int, wmin: int) -> str:
        """Sink grid label for a (res, window) pair: "h3r{res}" for the
        reference tile window, "h3r{res}m{wmin}" otherwise."""
        return (f"h3r{res}" if wmin == self.tile_minutes
                else f"h3r{res}m{wmin}")

    def default_grid(self) -> str:
        """The grid bare /api/tiles/latest serves: the configured h3_res
        (or the first resolution), under the reference tile window when
        it is configured, else the first window — always a grid the
        runtime actually writes."""
        res_list = self.resolutions or (self.h3_res,)
        res = self.h3_res if self.h3_res in res_list else res_list[0]
        wins = self.windows_minutes or (self.tile_minutes,)
        wmin = self.tile_minutes if self.tile_minutes in wins else wins[0]
        return self.pair_grid(res, wmin)


def load_config(env: Mapping[str, str] | None = None, **overrides) -> Config:
    """Build a Config from env vars (same names as the reference) + overrides."""
    e = dict(os.environ if env is None else env)
    for knob, (on, item) in UNPORTED_KNOBS.items():
        if knob in e and on(e[knob]):
            raise NotImplementedError(
                f"{knob}={e[knob]!r}: not ported to heatmap_tpu_torch yet "
                f"(ROADMAP {item}); unset it")
    cfg = Config(
        mongo_uri=e.get("MONGO_URI", Config.mongo_uri),
        mongo_db=e.get("MONGO_DB", Config.mongo_db),
        kafka_bootstrap=e.get("KAFKA_BOOTSTRAP", Config.kafka_bootstrap),
        kafka_topic=e.get("KAFKA_TOPIC", Config.kafka_topic),
        city=e.get("CITY", Config.city),
        checkpoint_dir=e.get("CHECKPOINT", _default_checkpoint_dir()),
        h3_res=_int(e, "H3_RES", Config.h3_res),
        tile_minutes=_int(e, "TILE_MINUTES", Config.tile_minutes),
        ttl_minutes=_int(e, "TTL_MINUTES", Config.ttl_minutes),
        watermark_minutes=_int(e, "WATERMARK_MINUTES", Config.watermark_minutes),
        resolutions=_ints(e, "H3_RESOLUTIONS", e.get("H3_RES", "8")),
        windows_minutes=_ints(e, "WINDOW_MINUTES", e.get("TILE_MINUTES", "5")),
        batch_size=_int(e, "BATCH_SIZE", Config.batch_size),
        state_capacity_log2=_int(e, "STATE_CAPACITY_LOG2", Config.state_capacity_log2),
        state_max_log2=_int(e, "HEATMAP_STATE_MAX_LOG2", Config.state_max_log2),
        speed_hist_bins=_int(e, "SPEED_HIST_BINS", Config.speed_hist_bins),
        speed_hist_max_kmh=_float(e, "SPEED_HIST_MAX_KMH", Config.speed_hist_max_kmh),
        emit_pull=e.get("HEATMAP_EMIT_PULL", Config.emit_pull),
        emit_flush_k=_int(e, "HEATMAP_EMIT_FLUSH_K", Config.emit_flush_k),
        on_overflow=e.get("HEATMAP_ON_OVERFLOW", Config.on_overflow),
        grow_margin=e.get("HEATMAP_GROW_MARGIN", Config.grow_margin),
        prefetch_batches=_int(e, "HEATMAP_PREFETCH_BATCHES",
                              Config.prefetch_batches),
        flightrec_dir=e.get("HEATMAP_FLIGHTREC_DIR", Config.flightrec_dir),
        lineage_tail=_int(e, "HEATMAP_LINEAGE_TAIL", Config.lineage_tail),
        trigger_ms=_int(e, "TRIGGER_MS", Config.trigger_ms),
        store=e.get("HEATMAP_STORE", Config.store),
        govern=_flag_on(e.get("HEATMAP_GOVERN", "0")),
        govern_interval_s=_float(e, "HEATMAP_GOVERN_INTERVAL_S",
                                 Config.govern_interval_s),
        govern_min_batch=_int(e, "HEATMAP_GOVERN_MIN_BATCH",
                              Config.govern_min_batch),
        govern_max_flush_k=_int(e, "HEATMAP_GOVERN_MAX_FLUSH_K",
                                Config.govern_max_flush_k),
        govern_max_prefetch=_int(e, "HEATMAP_GOVERN_MAX_PREFETCH",
                                 Config.govern_max_prefetch),
        govern_healthy_frac=_float(e, "HEATMAP_GOVERN_HEALTHY_FRAC",
                                   Config.govern_healthy_frac),
        shards=_int(e, "HEATMAP_SHARDS", Config.shards),
        shard_index=_int(e, "HEATMAP_SHARD_INDEX", Config.shard_index),
        shard_res=_int(e, "HEATMAP_SHARD_RES", Config.shard_res),
        shard_oversample=_int(e, "HEATMAP_SHARD_OVERSAMPLE",
                              Config.shard_oversample),
        reducers=tuple(
            s.strip() for s in e.get("HEATMAP_REDUCERS", "count").split(",")
            if s.strip()),
        entity_capacity=_int(e, "HEATMAP_ENTITY_CAPACITY",
                             Config.entity_capacity),
        entity_ttl_s=_float(e, "HEATMAP_ENTITY_TTL_S", Config.entity_ttl_s),
        entity_shards=_int(e, "HEATMAP_ENTITY_SHARDS", Config.entity_shards),
        entity_stop_s=_float(e, "HEATMAP_ENTITY_STOP_S",
                             Config.entity_stop_s),
        refresh_ms=_int(e, "REFRESH_MS", Config.refresh_ms),
        serve_host=e.get("SERVE_HOST", Config.serve_host),
        serve_port=_int(e, "SERVE_PORT", Config.serve_port),
        query_view=e.get("HEATMAP_QUERY_VIEW", "1") not in ("0", "false", ""),
        delta_log=_int(e, "HEATMAP_DELTA_LOG", Config.delta_log),
        pyramid_levels=_int(e, "HEATMAP_PYRAMID_LEVELS",
                            Config.pyramid_levels),
        view_poll_ms=_int(e, "HEATMAP_VIEW_POLL_MS", Config.view_poll_ms),
        sse_max_clients=_int(e, "HEATMAP_SSE_MAX_CLIENTS",
                             Config.sse_max_clients),
        sse_heartbeat_s=_float(e, "HEATMAP_SSE_HEARTBEAT_S",
                               Config.sse_heartbeat_s),
        sse_queue=_int(e, "HEATMAP_SSE_QUEUE", Config.sse_queue),
        sse_send_timeout_s=_float(e, "HEATMAP_SSE_SEND_TIMEOUT_S",
                                  Config.sse_send_timeout_s),
        serve_max_inflight=_int(e, "HEATMAP_SERVE_MAX_INFLIGHT",
                                Config.serve_max_inflight),
        serve_workers=_int(e, "HEATMAP_SERVE_WORKERS",
                           Config.serve_workers),
        serve_core=e.get("HEATMAP_SERVE_CORE", Config.serve_core),
        serve_loop_handlers=_int(e, "HEATMAP_SERVE_LOOP_HANDLERS",
                                 Config.serve_loop_handlers),
        repl_dir=e.get("HEATMAP_REPL_DIR", Config.repl_dir),
        repl_feed=e.get("HEATMAP_REPL_FEED", Config.repl_feed),
        repl_seg_bytes=_int(e, "HEATMAP_REPL_SEG_BYTES",
                            Config.repl_seg_bytes),
        repl_segments=_int(e, "HEATMAP_REPL_SEGMENTS",
                           Config.repl_segments),
        repl_poll_ms=_int(e, "HEATMAP_REPL_POLL_MS",
                          Config.repl_poll_ms),
        hist_dir=e.get("HEATMAP_HIST_DIR", Config.hist_dir),
        hist_retention_s=_float(e, "HEATMAP_HIST_RETENTION_S",
                                Config.hist_retention_s),
        hist_bucket_s=_int(e, "HEATMAP_HIST_BUCKET_S",
                           Config.hist_bucket_s),
        hist_parent_res=_int(e, "HEATMAP_HIST_PARENT_RES",
                             Config.hist_parent_res),
        hist_compact_s=_float(e, "HEATMAP_HIST_COMPACT_S",
                              Config.hist_compact_s),
        hist_backfill=e.get("HEATMAP_HIST_BACKFILL", "1")
        not in ("0", "false", ""),
        tsdb=e.get("HEATMAP_TSDB", "0") not in ("0", "false", ""),
        tsdb_dir=e.get("HEATMAP_TSDB_DIR", Config.tsdb_dir),
        tsdb_scrape_s=_float(e, "HEATMAP_TSDB_SCRAPE_S",
                             Config.tsdb_scrape_s),
        tsdb_retain_s=_float(e, "HEATMAP_TSDB_RETAIN_S",
                             Config.tsdb_retain_s),
        tsdb_hot_s=_float(e, "HEATMAP_TSDB_HOT_S", Config.tsdb_hot_s),
        tsdb_flush_s=_float(e, "HEATMAP_TSDB_FLUSH_S",
                            Config.tsdb_flush_s),
        slo_budget_frac=_float(e, "HEATMAP_SLO_BUDGET_FRAC",
                               Config.slo_budget_frac),
        slo_budget_window_s=_float(e, "HEATMAP_SLO_BUDGET_WINDOW_S",
                                   Config.slo_budget_window_s),
        quality=e.get("HEATMAP_QUALITY", "0") not in ("0", "false", ""),
        quality_window_s=_float(e, "HEATMAP_QUALITY_WINDOW_S",
                                Config.quality_window_s),
        quality_lookback_s=_float(e, "HEATMAP_QUALITY_LOOKBACK_S",
                                  Config.quality_lookback_s),
        quality_mature_s=_float(e, "HEATMAP_QUALITY_MATURE_S",
                                Config.quality_mature_s),
        quality_ttl_s=_float(e, "HEATMAP_QUALITY_TTL_S",
                             Config.quality_ttl_s),
        cq=e.get("HEATMAP_CQ", "1") not in ("0", "false", ""),
        cq_max_queries=_int(e, "HEATMAP_CQ_MAX_QUERIES",
                            Config.cq_max_queries),
        cq_ttl_s=_float(e, "HEATMAP_CQ_TTL_S", Config.cq_ttl_s),
        cq_events=_int(e, "HEATMAP_CQ_EVENTS", Config.cq_events),
        cq_max_cells=_int(e, "HEATMAP_CQ_MAX_CELLS",
                          Config.cq_max_cells),
        audit=e.get("HEATMAP_AUDIT", "0") not in ("0", "false", ""),
        audit_settle_s=_float(e, "HEATMAP_AUDIT_SETTLE_S",
                              Config.audit_settle_s),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if cfg.on_overflow not in ("error", "fail"):
        # a typo here would silently downgrade a stop-on-data-loss knob
        raise ValueError(
            f"HEATMAP_ON_OVERFLOW must be 'error' or 'fail', "
            f"got {cfg.on_overflow!r}")
    if cfg.state_max_log2 and cfg.state_max_log2 < cfg.state_capacity_log2:
        raise ValueError(
            f"HEATMAP_STATE_MAX_LOG2 ({cfg.state_max_log2}) below "
            f"STATE_CAPACITY_LOG2 ({cfg.state_capacity_log2})")
    if cfg.grow_margin not in ("worst", "observed"):
        raise ValueError(
            f"HEATMAP_GROW_MARGIN must be 'worst' or 'observed', "
            f"got {cfg.grow_margin!r}")
    if cfg.emit_pull not in ("auto", "full", "prefix"):
        raise ValueError(f"HEATMAP_EMIT_PULL must be auto|full|prefix, "
                         f"got {cfg.emit_pull!r}")
    if cfg.emit_flush_k < 1:
        raise ValueError(
            f"HEATMAP_EMIT_FLUSH_K must be >= 1, got {cfg.emit_flush_k}")
    if cfg.store not in ("auto", "memory", "jsonl", "mongo"):
        raise ValueError(f"HEATMAP_STORE must be auto|memory|jsonl|mongo, "
                         f"got {cfg.store!r}")
    if not (0 <= cfg.prefetch_batches <= 32):
        raise ValueError(
            f"HEATMAP_PREFETCH_BATCHES must be in 0..32, "
            f"got {cfg.prefetch_batches}")
    if cfg.lineage_tail < 1:
        raise ValueError(
            f"HEATMAP_LINEAGE_TAIL must be >= 1, got {cfg.lineage_tail}")
    if cfg.shards < 1:
        raise ValueError(f"HEATMAP_SHARDS must be >= 1, got {cfg.shards}")
    if not 0 <= cfg.shard_index < cfg.shards:
        raise ValueError(
            f"HEATMAP_SHARD_INDEX must be in 0..{cfg.shards - 1}, "
            f"got {cfg.shard_index}")
    if cfg.shards > 1:
        snap_res = min(cfg.resolutions)
        if not (cfg.shard_res == -1 or 0 <= cfg.shard_res <= snap_res):
            raise ValueError(
                f"HEATMAP_SHARD_RES must be -1 or in 0..{snap_res} "
                f"(the coarsest fold resolution), got {cfg.shard_res}")
    if cfg.govern_interval_s <= 0:
        raise ValueError(
            f"HEATMAP_GOVERN_INTERVAL_S must be > 0, "
            f"got {cfg.govern_interval_s}")
    if cfg.govern_min_batch < 64:
        raise ValueError(
            f"HEATMAP_GOVERN_MIN_BATCH must be >= 64, "
            f"got {cfg.govern_min_batch}")
    if cfg.govern and cfg.govern_min_batch > cfg.batch_size:
        raise ValueError(
            f"HEATMAP_GOVERN_MIN_BATCH ({cfg.govern_min_batch}) above "
            f"BATCH_SIZE ({cfg.batch_size}); the ladder floor cannot "
            f"exceed its ceiling")
    if cfg.govern_max_flush_k < 1:
        raise ValueError(
            f"HEATMAP_GOVERN_MAX_FLUSH_K must be >= 1, "
            f"got {cfg.govern_max_flush_k}")
    if not 0 <= cfg.govern_max_prefetch <= 32:
        raise ValueError(
            f"HEATMAP_GOVERN_MAX_PREFETCH must be in 0..32, "
            f"got {cfg.govern_max_prefetch}")
    if not 0 < cfg.govern_healthy_frac < 1:
        raise ValueError(
            f"HEATMAP_GOVERN_HEALTHY_FRAC must be in (0, 1), "
            f"got {cfg.govern_healthy_frac}")
    if not 0 <= cfg.shard_oversample <= 64:
        raise ValueError(
            f"HEATMAP_SHARD_OVERSAMPLE must be in 0..64, "
            f"got {cfg.shard_oversample}")
    object.__setattr__(cfg, "reducers", parse_reducers(
        ",".join(cfg.reducers) if isinstance(cfg.reducers, (tuple, list))
        else cfg.reducers))
    if cfg.entity_capacity < 8:
        raise ValueError(
            f"HEATMAP_ENTITY_CAPACITY must be >= 8, "
            f"got {cfg.entity_capacity}")
    if cfg.entity_ttl_s <= 0:
        raise ValueError(
            f"HEATMAP_ENTITY_TTL_S must be > 0, got {cfg.entity_ttl_s}")
    if cfg.entity_shards < 0:
        raise ValueError(
            f"HEATMAP_ENTITY_SHARDS must be >= 0 (0 = HEATMAP_SHARDS), "
            f"got {cfg.entity_shards}")
    if cfg.entity_stop_s <= 0:
        raise ValueError(
            f"HEATMAP_ENTITY_STOP_S must be > 0, "
            f"got {cfg.entity_stop_s}")
    if cfg.quality_window_s <= 0:
        raise ValueError(
            f"HEATMAP_QUALITY_WINDOW_S must be > 0, "
            f"got {cfg.quality_window_s}")
    if cfg.quality_lookback_s <= 0:
        raise ValueError(
            f"HEATMAP_QUALITY_LOOKBACK_S must be > 0, "
            f"got {cfg.quality_lookback_s}")
    if cfg.quality_mature_s < 0:
        raise ValueError(
            f"HEATMAP_QUALITY_MATURE_S must be >= 0, "
            f"got {cfg.quality_mature_s}")
    if cfg.quality_ttl_s < cfg.quality_mature_s:
        raise ValueError(
            f"HEATMAP_QUALITY_TTL_S ({cfg.quality_ttl_s}) below "
            f"HEATMAP_QUALITY_MATURE_S ({cfg.quality_mature_s}) — a "
            f"scorecard cannot expire before it matures")
    if cfg.delta_log < 1:
        raise ValueError(
            f"HEATMAP_DELTA_LOG must be >= 1, got {cfg.delta_log}")
    if not (0 <= cfg.pyramid_levels <= 15):
        raise ValueError(
            f"HEATMAP_PYRAMID_LEVELS must be in 0..15, "
            f"got {cfg.pyramid_levels}")
    if cfg.view_poll_ms < 0:
        raise ValueError(
            f"HEATMAP_VIEW_POLL_MS must be >= 0, got {cfg.view_poll_ms}")
    if cfg.sse_max_clients < 1:
        raise ValueError(
            f"HEATMAP_SSE_MAX_CLIENTS must be >= 1, "
            f"got {cfg.sse_max_clients}")
    if cfg.sse_heartbeat_s <= 0:
        raise ValueError(
            f"HEATMAP_SSE_HEARTBEAT_S must be > 0, "
            f"got {cfg.sse_heartbeat_s}")
    if cfg.sse_queue < 1:
        raise ValueError(
            f"HEATMAP_SSE_QUEUE must be >= 1, got {cfg.sse_queue}")
    if cfg.sse_send_timeout_s < 0:
        raise ValueError(
            f"HEATMAP_SSE_SEND_TIMEOUT_S must be >= 0 (0 = no "
            f"timeout), got {cfg.sse_send_timeout_s}")
    if cfg.serve_max_inflight < 0:
        raise ValueError(
            f"HEATMAP_SERVE_MAX_INFLIGHT must be >= 0 (0 = "
            f"unbounded), got {cfg.serve_max_inflight}")
    if cfg.serve_workers < 1:
        raise ValueError(
            f"HEATMAP_SERVE_WORKERS must be >= 1, "
            f"got {cfg.serve_workers}")
    if cfg.serve_core not in ("thread", "epoll"):
        raise ValueError(
            f"HEATMAP_SERVE_CORE must be 'thread' or 'epoll', "
            f"got {cfg.serve_core!r}")
    if cfg.serve_loop_handlers < 1:
        raise ValueError(
            f"HEATMAP_SERVE_LOOP_HANDLERS must be >= 1, "
            f"got {cfg.serve_loop_handlers}")
    if cfg.repl_seg_bytes < 4096:
        raise ValueError(
            f"HEATMAP_REPL_SEG_BYTES must be >= 4096, "
            f"got {cfg.repl_seg_bytes}")
    if cfg.repl_segments < 1:
        raise ValueError(
            f"HEATMAP_REPL_SEGMENTS must be >= 1, got {cfg.repl_segments}")
    if cfg.repl_poll_ms < 10:
        raise ValueError(
            f"HEATMAP_REPL_POLL_MS must be >= 10, got {cfg.repl_poll_ms}")
    if cfg.hist_retention_s <= 0:
        raise ValueError(
            f"HEATMAP_HIST_RETENTION_S must be > 0, "
            f"got {cfg.hist_retention_s}")
    if cfg.hist_bucket_s < 60:
        raise ValueError(
            f"HEATMAP_HIST_BUCKET_S must be >= 60, "
            f"got {cfg.hist_bucket_s}")
    if not 0 <= cfg.hist_parent_res <= 15:
        raise ValueError(
            f"HEATMAP_HIST_PARENT_RES must be in 0..15, "
            f"got {cfg.hist_parent_res}")
    if cfg.hist_compact_s <= 0:
        raise ValueError(
            f"HEATMAP_HIST_COMPACT_S must be > 0, "
            f"got {cfg.hist_compact_s}")
    if cfg.cq_max_queries < 1:
        raise ValueError(
            f"HEATMAP_CQ_MAX_QUERIES must be >= 1, "
            f"got {cfg.cq_max_queries}")
    if cfg.cq_ttl_s < 0:
        raise ValueError(
            f"HEATMAP_CQ_TTL_S must be >= 0 (0 = no expiry), "
            f"got {cfg.cq_ttl_s}")
    if cfg.cq_events < 1:
        raise ValueError(
            f"HEATMAP_CQ_EVENTS must be >= 1, got {cfg.cq_events}")
    if cfg.cq_max_cells < 1:
        raise ValueError(
            f"HEATMAP_CQ_MAX_CELLS must be >= 1, "
            f"got {cfg.cq_max_cells}")
    if cfg.audit_settle_s <= 0:
        raise ValueError(
            f"HEATMAP_AUDIT_SETTLE_S must be > 0, "
            f"got {cfg.audit_settle_s}")
    if cfg.tsdb_scrape_s <= 0:
        raise ValueError(
            f"HEATMAP_TSDB_SCRAPE_S must be > 0, "
            f"got {cfg.tsdb_scrape_s}")
    if cfg.tsdb_flush_s < 0:
        raise ValueError(
            f"HEATMAP_TSDB_FLUSH_S must be >= 0, "
            f"got {cfg.tsdb_flush_s}")
    if cfg.tsdb_retain_s < cfg.tsdb_hot_s:
        raise ValueError(
            f"HEATMAP_TSDB_RETAIN_S ({cfg.tsdb_retain_s}) below "
            f"HEATMAP_TSDB_HOT_S ({cfg.tsdb_hot_s}) — retention "
            f"cannot be shorter than the raw tier it feeds")
    if not 0 < cfg.slo_budget_frac <= 1:
        raise ValueError(
            f"HEATMAP_SLO_BUDGET_FRAC must be in (0, 1], "
            f"got {cfg.slo_budget_frac}")
    if cfg.slo_budget_window_s <= 0:
        raise ValueError(
            f"HEATMAP_SLO_BUDGET_WINDOW_S must be > 0, "
            f"got {cfg.slo_budget_window_s}")
    return cfg
