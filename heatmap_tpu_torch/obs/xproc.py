"""Cross-process file artifacts: the atomic JSON write and the fleet
staleness budget.

A copy of the two pieces of ``heatmap_tpu/obs/xproc.py`` the replication
and history tiers use (``atomic_write_json``, ``fleet_max_age_s``).  The
supervisor channel, member snapshots and episode broadcasts of that module
belong to the process fleet and observability (ROADMAP A6/A7) and are not
ported yet.
"""

from __future__ import annotations

import json
import logging
import os

log = logging.getLogger(__name__)

ENV_FLEET_MAX_AGE = "HEATMAP_FLEET_MAX_AGE_S"


def fleet_max_age_s(default: float = 30.0) -> float:
    raw = os.environ.get(ENV_FLEET_MAX_AGE, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        log.warning("%s=%r is not a number; using %s",
                    ENV_FLEET_MAX_AGE, raw, default)
        return default


def atomic_write_json(path: str, payload: dict) -> None:
    """THE tmp+rename JSON write (feed meta, snapshots, history state all
    use it): a reader can never see a half-written file; the tmp is
    cleaned up on failure and the error re-raised for the caller to
    contextualize."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, separators=(",", ":"))
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
