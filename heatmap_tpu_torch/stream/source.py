"""Pull sources with replayable offsets.

A copy of ``Source`` and ``SyntheticSource`` from
``heatmap_tpu/stream/source.py``: ``poll`` returns up to ``max_events``
events past the current position, ``offset``/``seek`` expose a
serializable position.  ``SyntheticSource`` generates the same bytes as the
reference's for the same arguments.
"""

from __future__ import annotations

import abc
import math
from typing import Any

import numpy as np

from heatmap_tpu_torch.stream.events import EventColumns, columns_from_arrays


class Source(abc.ABC):
    @abc.abstractmethod
    def poll(self, max_events: int) -> EventColumns:
        """Up to max_events events at the current position (may be empty)."""

    def offset(self) -> Any:
        """JSON-serializable replay position."""
        return None

    def seek(self, offset: Any) -> None:
        pass

    @property
    def exhausted(self) -> bool:
        """True when no more data will ever arrive (bounded replays)."""
        return False

    def close(self) -> None:
        pass


class SyntheticSource(Source):
    """Deterministic synthetic city traffic (BASELINE.json config #3).

    Every event is a pure function of its absolute index: vehicle
    ``i % n_vehicles`` follows a parametric orbit around a per-vehicle
    anchor inside the city box.  That makes ``seek`` exact and O(1) — a
    resumed replay is bit-identical regardless of batch chunking — and the
    generator is fully vectorized (no JSON on the bench hot path).
    Offset = number of events emitted.
    """

    def __init__(
        self,
        n_events: int | None = None,
        n_vehicles: int = 2000,
        center=(42.3601, -71.0589),      # Boston (reference default view)
        radius_deg: float = 0.15,
        t0: int = 1_700_000_000,
        events_per_second: int = 100_000,
        seed: int = 0,
    ):
        self.n_events = n_events  # None = unbounded
        self.n_vehicles = n_vehicles
        self.center = center
        self.radius = radius_deg
        self.t0 = t0
        self.eps = events_per_second
        self.seed = seed
        self._emitted = 0
        rng = np.random.default_rng(seed)  # init-time only: fixed draw order
        self._anchor = np.stack([
            center[0] + rng.uniform(-radius_deg, radius_deg, n_vehicles),
            center[1] + rng.uniform(-radius_deg, radius_deg, n_vehicles),
        ], axis=1)
        self._orbit_r = rng.uniform(0.002, 0.03, n_vehicles)      # deg
        self._speed = rng.uniform(10, 90, n_vehicles).astype(np.float32)
        # angular velocity (rad/s of sim time) consistent with the speed
        self._omega = (self._speed / 3.6) / (self._orbit_r * 111_000.0)
        self._phase = rng.uniform(0, 2 * math.pi, n_vehicles)
        self._vehicles = [f"veh-{i}" for i in range(n_vehicles)]

    def poll(self, max_events: int) -> EventColumns:
        n = max_events
        if self.n_events is not None:
            n = min(n, self.n_events - self._emitted)
        if n <= 0:
            return columns_from_arrays([], [], [], [])
        i = self._emitted + np.arange(n, dtype=np.int64)
        vid = (i % self.n_vehicles).astype(np.int32)
        sim_t = i / self.eps
        ang = self._omega[vid] * sim_t + self._phase[vid]
        lat = self._anchor[vid, 0] + self._orbit_r[vid] * np.cos(ang)
        lng = self._anchor[vid, 1] + self._orbit_r[vid] * np.sin(ang)
        # deterministic per-event speed jitter
        speed = np.maximum(
            self._speed[vid] + 2.0 * np.sin(0.7 * i).astype(np.float32), 0.0
        )
        ts = self.t0 + i // self.eps
        cols = columns_from_arrays(
            lat.astype(np.float32),
            lng.astype(np.float32),
            speed.astype(np.float32),
            ts.astype(np.int32),
            provider_id=np.zeros(n, np.int32),
            vehicle_id=vid,
            providers=["synthetic"],
            vehicles=self._vehicles,
        )
        self._emitted += n
        return cols

    def offset(self):
        return self._emitted

    def seek(self, offset) -> None:
        self._emitted = int(offset or 0)

    @property
    def exhausted(self) -> bool:
        return self.n_events is not None and self._emitted >= self.n_events
