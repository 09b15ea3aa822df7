"""Named pipeline configurations: Config + source factory.

The port registers BASELINE.json's five configurations with the same
settings as ``heatmap_tpu/models/pipelines.py``.  The four live pipelines
consume the Kafka ingress (``KafkaSource``, the port's wire client) when a
broker answers, and otherwise fall back to synthetic data with the
reference's warning; ``synthetic_backfill`` replays 10M synthetic events.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable

from heatmap_tpu_torch.config import Config, load_config
from heatmap_tpu_torch.stream.source import (KafkaSource, Source,
                                             SyntheticSource)

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Pipeline:
    name: str
    description: str
    config: Config
    make_source: Callable[[Config], Source]


def _kafka_or_synthetic(cfg: Config) -> Source:
    """Live pipelines consume the Kafka ingress when a broker is reachable
    (the reference contract); otherwise fall back to synthetic data so the
    pipeline still runs hermetically, as the reference does.

    ``HEATMAP_FEEDER=proc`` (the reference's shared-memory feeder process)
    is not ported and raises, as do the unported consumer impls and event
    formats (``KafkaSource``): none of them falls back."""
    if os.environ.get("HEATMAP_FEEDER") == "proc":
        raise NotImplementedError(
            "HEATMAP_FEEDER=proc: the shared-memory feeder process is not "
            "ported to heatmap_tpu_torch; unset it to consume in-process")
    try:
        return KafkaSource(cfg.kafka_bootstrap, cfg.kafka_topic)
    except NotImplementedError:
        raise
    except (ImportError, ConnectionError, OSError, RuntimeError) as e:
        # RuntimeError covers KafkaError (unknown topic / leaderless)
        log.warning("kafka unreachable (%s); using synthetic source", e)
        return SyntheticSource(n_vehicles=1000, events_per_second=1000)


def _synthetic_backfill(cfg: Config) -> Source:
    return SyntheticSource(
        n_events=10_000_000, n_vehicles=20_000, events_per_second=1_000_000,
    )


PIPELINES: dict[str, Pipeline] = {}


def _register(name, description, make_source, **cfg_overrides):
    # env (KAFKA_BOOTSTRAP, ...) applies as in the reference; the preset's
    # own axes (res/windows/...) win on top
    cfg = load_config(None, **cfg_overrides)
    PIPELINES[name] = Pipeline(name, description, cfg, make_source)


# 1. the reference's default configuration (BASELINE config #1)
_register(
    "mbta_default",
    "MBTA Boston feed, H3_RES=8, TILE_MINUTES=5 (reference defaults)",
    _kafka_or_synthetic,
    # nothing pinned but the city: H3_RES / TILE_MINUTES / etc. flow from
    # the env as in the reference (load_config derives the tuple axes)
    city="bos",
)

# 2. OpenSky global aircraft (BASELINE config #2)
_register(
    "opensky_global",
    "OpenSky global aircraft, H3_RES=7, 5-min window",
    _kafka_or_synthetic,
    city="global", h3_res=7, resolutions=(7,), windows_minutes=(5,),
    tile_minutes=5,
    state_capacity_log2=19,   # global cardinality
    # aircraft ground speeds run to ~1100 km/h: 128 bins over 1280 km/h
    # keep the one-bin p95 error bound at 10 km/h
    speed_hist_bins=128, speed_hist_max_kmh=1280.0,
)

# 3. synthetic 10M-event backfill (BASELINE config #3)
_register(
    "synthetic_backfill",
    "Synthetic replay: 10M-event single-city backfill, H3_RES=9",
    _synthetic_backfill,
    city="bos", h3_res=9, resolutions=(9,), windows_minutes=(5,),
    tile_minutes=5,
    batch_size=1 << 19, state_capacity_log2=20,
)

# 4. multi-resolution hex pyramid (BASELINE config #4)
_register(
    "hex_pyramid",
    "Merged MBTA+OpenSky, multi-resolution 7/8/9 hex pyramid",
    _kafka_or_synthetic,
    city="bos", h3_res=8, resolutions=(7, 8, 9), windows_minutes=(5,),
    tile_minutes=5,
)

# 5. sliding multi-window with extended stats (BASELINE config #5)
_register(
    "multi_window",
    "Sliding multi-window (1/5/15-min), count + avgSpeed + p95-speed stats",
    _kafka_or_synthetic,
    city="bos", h3_res=8, resolutions=(8,), windows_minutes=(1, 5, 15),
    tile_minutes=5,  # the 5-min window keeps the reference grid/_id naming
)


def get_pipeline(name: str) -> Pipeline:
    if name not in PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(PIPELINES)}")
    return PIPELINES[name]
