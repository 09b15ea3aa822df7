"""Flat env-var configuration: the fields the port reads.

A copy of the part of ``heatmap_tpu/config.py`` that the streaming slice
uses, with the same environment names and defaults, so one environment
configures both packages the same way.  The port pulls the packed emits of
every batch (the reference's HEATMAP_EMIT_FLUSH_K=1), so it has no
flush-depth field.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping


def _int(env: Mapping[str, str], name: str, default: int) -> int:
    return int(env.get(name, default))


def _float(env: Mapping[str, str], name: str, default: float) -> float:
    return float(env.get(name, default))


def _ints(env: Mapping[str, str], name: str, default: str) -> tuple[int, ...]:
    return tuple(int(x) for x in str(env.get(name, default)).split(",") if x != "")


@dataclasses.dataclass(frozen=True)
class Config:
    city: str = "ath"
    h3_res: int = 8                    # typical 7-9 for city heatmaps
    tile_minutes: int = 5              # aggregation window size
    ttl_minutes: int = 45              # tile TTL after window end
    watermark_minutes: int = 10
    resolutions: tuple[int, ...] = (8,)     # multi-res hex pyramid, e.g. 7,8,9
    windows_minutes: tuple[int, ...] = (5,)  # sliding multi-window, e.g. 1,5,15
    batch_size: int = 1 << 17          # events per fixed-shape micro-batch
    state_capacity_log2: int = 17      # state slab rows per pair
    # Per-cell speed histogram driving the p95 stats: interpolated p95 is
    # exact to within one bin width (speed_hist_max_kmh / speed_hist_bins),
    # and speeds >= the max saturate into the last bin.
    speed_hist_bins: int = 64
    speed_hist_max_kmh: float = 256.0

    def pair_grid(self, res: int, wmin: int) -> str:
        """Sink grid label for a (res, window) pair: "h3r{res}" for the
        reference tile window, "h3r{res}m{wmin}" otherwise."""
        return (f"h3r{res}" if wmin == self.tile_minutes
                else f"h3r{res}m{wmin}")


def load_config(env: Mapping[str, str] | None = None, **overrides) -> Config:
    """Build a Config from env vars (same names as the reference) + overrides."""
    e = dict(os.environ if env is None else env)
    cfg = Config(
        city=e.get("CITY", Config.city),
        h3_res=_int(e, "H3_RES", Config.h3_res),
        tile_minutes=_int(e, "TILE_MINUTES", Config.tile_minutes),
        ttl_minutes=_int(e, "TTL_MINUTES", Config.ttl_minutes),
        watermark_minutes=_int(e, "WATERMARK_MINUTES", Config.watermark_minutes),
        resolutions=_ints(e, "H3_RESOLUTIONS", e.get("H3_RES", "8")),
        windows_minutes=_ints(e, "WINDOW_MINUTES", e.get("TILE_MINUTES", "5")),
        batch_size=_int(e, "BATCH_SIZE", Config.batch_size),
        state_capacity_log2=_int(e, "STATE_CAPACITY_LOG2", Config.state_capacity_log2),
        speed_hist_bins=_int(e, "SPEED_HIST_BINS", Config.speed_hist_bins),
        speed_hist_max_kmh=_float(e, "SPEED_HIST_MAX_KMH", Config.speed_hist_max_kmh),
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
