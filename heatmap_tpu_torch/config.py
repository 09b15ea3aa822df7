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


# knob -> (does this value ask for the subsystem?, the ROADMAP item that
# ports it); the reference's value when the knob is unset never does
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


UNPORTED_KNOBS = {
    "HEATMAP_SHARDS": (lambda v: int(v) > 1, "A7, the process fleet"),
    "HEATMAP_SHARD_INDEX": (lambda v: int(v) != 0, "A7, the process fleet"),
    "HEATMAP_GOVERN": (_flag_on, "A7, the governor"),
    "HEATMAP_AUDIT": (_flag_on, "A6, observability"),
    "HEATMAP_QUALITY": (_flag_on, "A5, the inference quality "
                                  "observatory, after A4"),
    "HEATMAP_REPL_DIR": (bool, "A4, the serve and query tier"),
    "HEATMAP_HIST_DIR": (bool, "A4, the serve and query tier"),
    "HEATMAP_TSDB": (_flag_on, "A6, observability"),
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
    trigger_ms: int = 0                # 0 = as fast as possible (ref default)
    store: str = "auto"                # "auto" | "memory" | "mongo" | "jsonl"
    # HEATMAP_SHARD_RES: H3 parent resolution of a partition key; -1 = the
    # snap resolution itself.  Read by the logical entity partition
    # (HEATMAP_ENTITY_SHARDS); the process fleet is not ported
    shard_res: int = -1
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

    def pair_grid(self, res: int, wmin: int) -> str:
        """Sink grid label for a (res, window) pair: "h3r{res}" for the
        reference tile window, "h3r{res}m{wmin}" otherwise."""
        return (f"h3r{res}" if wmin == self.tile_minutes
                else f"h3r{res}m{wmin}")


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
        trigger_ms=_int(e, "TRIGGER_MS", Config.trigger_ms),
        store=e.get("HEATMAP_STORE", Config.store),
        shard_res=_int(e, "HEATMAP_SHARD_RES", Config.shard_res),
        reducers=tuple(
            s.strip() for s in e.get("HEATMAP_REDUCERS", "count").split(",")
            if s.strip()),
        entity_capacity=_int(e, "HEATMAP_ENTITY_CAPACITY",
                             Config.entity_capacity),
        entity_ttl_s=_float(e, "HEATMAP_ENTITY_TTL_S", Config.entity_ttl_s),
        entity_shards=_int(e, "HEATMAP_ENTITY_SHARDS", Config.entity_shards),
        entity_stop_s=_float(e, "HEATMAP_ENTITY_STOP_S",
                             Config.entity_stop_s),
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
    return cfg
