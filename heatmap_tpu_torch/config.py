"""Flat env-var configuration: the fields the port reads.

A copy of the part of ``heatmap_tpu/config.py`` that the streaming slice
uses, with the same environment names and defaults, so one environment
configures both packages the same way.
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


@dataclasses.dataclass(frozen=True)
class Config:
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

    def pair_grid(self, res: int, wmin: int) -> str:
        """Sink grid label for a (res, window) pair: "h3r{res}" for the
        reference tile window, "h3r{res}m{wmin}" otherwise."""
        return (f"h3r{res}" if wmin == self.tile_minutes
                else f"h3r{res}m{wmin}")


def load_config(env: Mapping[str, str] | None = None, **overrides) -> Config:
    """Build a Config from env vars (same names as the reference) + overrides."""
    e = dict(os.environ if env is None else env)
    cfg = Config(
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
    if not (0 <= cfg.prefetch_batches <= 32):
        raise ValueError(
            f"HEATMAP_PREFETCH_BATCHES must be in 0..32, "
            f"got {cfg.prefetch_batches}")
    return cfg
