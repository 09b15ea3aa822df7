"""GPS event schema and columnar batches (host side).

A copy of the parts of ``heatmap_tpu/stream/events.py`` the port reads.
The reference's event is an 8-field JSON object

    provider, vehicleId, lat, lon, speedKmh, bearing, accuracyM, ts

``parse_events`` turns a list of event dicts into ``EventColumns``
(struct-of-arrays) with the reference's validation folded in (null
provider/vehicleId dropped, lat/lon bounds, unparseable ts dropped);
``columns_from_arrays`` is the zero-parse path of columnar sources;
``empty_columns`` and ``slice_columns`` serve the batch-granular sources
(columnar values, the feeder process) and the runtime's carry.
"""

from __future__ import annotations

import datetime as dt
from dataclasses import dataclass, field

import numpy as np

UTC = dt.timezone.utc
_D2R = np.float32(np.pi / 180.0)


def parse_ts(value) -> float | None:
    """ISO-8601 (Z or offset) string or epoch number -> epoch seconds."""
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, dt.datetime):
        if value.tzinfo is None:
            value = value.replace(tzinfo=UTC)
        return value.timestamp()
    try:
        s = str(value)
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        d = dt.datetime.fromisoformat(s)
        if d.tzinfo is None:
            d = d.replace(tzinfo=UTC)
        return d.timestamp()
    except (ValueError, TypeError):
        return None


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


def parse_events(events, intern_p=None, intern_v=None) -> EventColumns:
    """Validate + columnarize a list of event dicts.

    ``intern_p``/``intern_v`` are optional persistent {str: int} intern maps
    (a source passes its own so ids are stable across batches)."""
    lat, lng, spd, ts, pid, vid = [], [], [], [], [], []
    p_map = intern_p if intern_p is not None else {}
    v_map = intern_v if intern_v is not None else {}
    dropped = 0
    for e in events:
        try:
            la = float(e["lat"])
            lo = float(e["lon"])
            provider = e.get("provider")
            vehicle = e.get("vehicleId")
            t = parse_ts(e.get("ts"))
        except (KeyError, TypeError, ValueError):
            dropped += 1
            continue
        # the reference's filters (heatmap_stream.py:96-104), plus ts sanity:
        # NaN/inf and out-of-epoch-seconds-range (e.g. milliseconds) dropped
        if (provider is None or vehicle is None or t is None
                or not np.isfinite(t) or not (0.0 <= t < 2**31)
                or not (-90.0 <= la <= 90.0) or not (-180.0 <= lo <= 180.0)
                or not np.isfinite(la) or not np.isfinite(lo)):
            dropped += 1
            continue
        s = e.get("speedKmh")
        try:
            s = float(s) if s is not None else 0.0
            if not np.isfinite(s):
                s = 0.0
        except (TypeError, ValueError):
            s = 0.0
        lat.append(la)
        lng.append(lo)
        spd.append(s)
        ts.append(int(t))
        pid.append(p_map.setdefault(str(provider), len(p_map)))
        vid.append(v_map.setdefault(str(vehicle), len(v_map)))

    lat_deg = np.asarray(lat, np.float32)
    lng_deg = np.asarray(lng, np.float32)
    return EventColumns(
        lat_rad=lat_deg * _D2R,
        lng_rad=lng_deg * _D2R,
        lat_deg=lat_deg,
        lng_deg=lng_deg,
        speed_kmh=np.asarray(spd, np.float32),
        ts_s=np.asarray(ts, np.int32),
        provider_id=np.asarray(pid, np.int32),
        vehicle_id=np.asarray(vid, np.int32),
        providers=list(p_map),
        vehicles=list(v_map),
        n_dropped=dropped,
    )


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



def empty_columns(providers=None, vehicles=None) -> EventColumns:
    """A zero-row batch (shared string tables passed through, NOT the
    defaulted ones columns_from_arrays would substitute)."""
    import dataclasses

    cols = columns_from_arrays([], [], [], [])
    return dataclasses.replace(
        cols,
        providers=providers if providers is not None else [],
        vehicles=vehicles if vehicles is not None else [],
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
