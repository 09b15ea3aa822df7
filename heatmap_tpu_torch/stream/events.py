"""Columnar GPS event batches (host side).

A copy of the parts of ``heatmap_tpu/stream/events.py`` the port reads:
``EventColumns`` (struct-of-arrays with the reference's validation already
applied), ``columns_from_arrays`` for columnar sources and
``slice_columns``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_D2R = np.float32(np.pi / 180.0)


@dataclass
class EventColumns:
    """Struct-of-arrays batch of validated events (host side)."""

    lat_rad: np.ndarray      # float32
    lng_rad: np.ndarray      # float32
    lat_deg: np.ndarray      # float32 (kept for positions docs)
    lng_deg: np.ndarray      # float32
    speed_kmh: np.ndarray    # float32 (missing -> 0, like the ref's avg of nulls)
    ts_s: np.ndarray         # int32 epoch seconds
    provider_id: np.ndarray  # int32 index into providers
    vehicle_id: np.ndarray   # int32 index into vehicles
    providers: list[str] = field(default_factory=list)
    vehicles: list[str] = field(default_factory=list)
    n_dropped: int = 0       # failed validation

    def __len__(self) -> int:
        return len(self.lat_rad)


def columns_from_arrays(lat_deg, lng_deg, speed_kmh, ts_s,
                        provider_id=None, vehicle_id=None,
                        providers=None, vehicles=None) -> EventColumns:
    """Zero-parse path for columnar sources."""
    lat_deg = np.asarray(lat_deg, np.float32)
    lng_deg = np.asarray(lng_deg, np.float32)
    n = len(lat_deg)
    z = np.zeros(n, np.int32)
    return EventColumns(
        lat_rad=lat_deg * _D2R,
        lng_rad=lng_deg * _D2R,
        lat_deg=lat_deg,
        lng_deg=lng_deg,
        speed_kmh=np.asarray(speed_kmh, np.float32),
        ts_s=np.asarray(ts_s, np.int32),
        provider_id=np.asarray(provider_id, np.int32) if provider_id is not None else z,
        vehicle_id=np.asarray(vehicle_id, np.int32) if vehicle_id is not None else z,
        providers=providers or ["synthetic"],
        vehicles=vehicles or [],
    )


def slice_columns(cols: EventColumns, start: int, stop: int) -> EventColumns:
    """Row slice of a batch (string tables shared, n_dropped stays with
    the head slice so counts aren't double-booked)."""
    return EventColumns(
        lat_rad=cols.lat_rad[start:stop],
        lng_rad=cols.lng_rad[start:stop],
        lat_deg=cols.lat_deg[start:stop],
        lng_deg=cols.lng_deg[start:stop],
        speed_kmh=cols.speed_kmh[start:stop],
        ts_s=cols.ts_s[start:stop],
        provider_id=cols.provider_id[start:stop],
        vehicle_id=cols.vehicle_id[start:stop],
        providers=cols.providers,
        vehicles=cols.vehicles,
        n_dropped=cols.n_dropped if start == 0 else 0,
    )
