"""Named pipeline configurations: Config + source factory.

The port registers ``synthetic_backfill`` (BASELINE config #3) with the
same settings as ``heatmap_tpu/models/pipelines.py``.  The reference's
other four pipelines read Kafka and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from heatmap_tpu_torch.config import Config, load_config
from heatmap_tpu_torch.stream.source import Source, SyntheticSource


@dataclasses.dataclass(frozen=True)
class Pipeline:
    name: str
    description: str
    config: Config
    make_source: Callable[[Config], Source]


def _synthetic_backfill(cfg: Config) -> Source:
    return SyntheticSource(
        n_events=10_000_000, n_vehicles=20_000, events_per_second=1_000_000,
    )


PIPELINES: dict[str, Pipeline] = {}


def _register(name, description, make_source, **cfg_overrides):
    # env applies as in the reference; the preset's own axes win on top
    cfg = load_config(None, **cfg_overrides)
    PIPELINES[name] = Pipeline(name, description, cfg, make_source)


# 3. synthetic 10M-event backfill (BASELINE config #3)
_register(
    "synthetic_backfill",
    "Synthetic replay: 10M-event single-city backfill, H3_RES=9",
    _synthetic_backfill,
    city="bos", h3_res=9, resolutions=(9,), windows_minutes=(5,),
    tile_minutes=5,
    batch_size=1 << 19, state_capacity_log2=20,
)


def get_pipeline(name: str) -> Pipeline:
    if name not in PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(PIPELINES)}")
    return PIPELINES[name]
