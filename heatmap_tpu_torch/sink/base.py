"""Document builders and the Store interface.

A copy of ``heatmap_tpu/sink/base.py``: tile docs mirror the reference
contract, timestamps are timezone-aware UTC datetimes, and
``packed_tile_docs`` decodes the rows of a packed emit matrix (uint32, the
layout of engine.step.pack_emit) into tile docs.
"""

from __future__ import annotations

import abc
import datetime as dt
from typing import Any, Iterable, NamedTuple, Sequence

UTC = dt.timezone.utc


def iso_z(t: dt.datetime) -> str:
    """The reference's windowStart key format '%Y-%m-%dT%H:%M:%SZ'
    (heatmap_stream.py:173)."""
    return t.astimezone(UTC).strftime("%Y-%m-%dT%H:%M:%SZ")


def epoch_to_dt(sec: int | float) -> dt.datetime:
    return dt.datetime.fromtimestamp(sec, UTC)


def TileDoc(
    city: str,
    res: int,
    cell_id: str,
    window_start: dt.datetime,
    window_end: dt.datetime,
    count: int,
    avg_speed_kmh: float,
    avg_lat: float,
    avg_lon: float,
    ttl_minutes: int,
    extra: dict[str, Any] | None = None,
    grid: str | None = None,
) -> dict:
    """Build a tiles doc (reference: heatmap_stream.py:173-187).

    ``extra`` carries extensions (p95SpeedKmh, stddev, window
    length tags for the multi-window configs) without disturbing the base
    contract.  ``grid`` overrides the default ``h3r{res}`` label (and the
    matching _id segment) for non-default window lengths."""
    if grid is None:
        grid = f"h3r{res}"
    _id = f"{city}|{grid}|{cell_id}|{iso_z(window_start)}"
    doc = {
        "_id": _id,
        "city": city,
        "grid": grid,
        "cellId": cell_id,
        "windowStart": window_start,
        "windowEnd": window_end,
        "count": int(count),
        "avgSpeedKmh": float(avg_speed_kmh),
        "centroid": {"type": "Point", "coordinates": [float(avg_lon), float(avg_lat)]},
        "staleAt": window_end + dt.timedelta(minutes=ttl_minutes),
    }
    if extra:
        doc.update(extra)
    return doc


def PositionDoc(provider: str, vehicle_id: str, ts: dt.datetime,
                lat: float, lon: float) -> dict:
    """Build a positions_latest doc (reference: heatmap_stream.py:217-227)."""
    return {
        "_id": f"{provider}|{vehicle_id}",
        "provider": provider,
        "vehicleId": vehicle_id,
        "ts": ts,
        "loc": {"type": "Point", "coordinates": [float(lon), float(lat)]},
    }


class TilePackMeta(NamedTuple):
    """Static per-(res, window) context for sinking packed emit rows.

    ``grid`` is the full label ("h3r8", or "h3r8m1" for non-default
    windows); ``window_minutes_tag`` is 0 for the default window, else the
    window length to record as the doc's windowMinutes field (mirrors
    stream.runtime's multi-window doc contract)."""

    city: str
    grid: str
    window_s: int
    ttl_minutes: int
    window_minutes_tag: int
    with_p95: bool


def packed_tile_docs(body, meta: TilePackMeta) -> list[dict]:
    """Portable tile-doc builder from packed emit BODY rows ((E, 13)
    uint32, engine.step.pack_emit layout).  The doc schema itself is
    TileDoc's — this function only decodes the columnar lanes.

    The sum lanes are per-group residual sums about the anchor lanes
    (engine.state.TileState): averages recombine ``anchor + resid/count``
    here in f64, which is what preserves microdegree centroid precision
    on an f64-free device.  Speed variance is anchor-invariant
    (Var(v) = E[r²] − E[r]²), so it uses the residual moments directly."""
    import numpy as np

    body = np.asarray(body)
    valid = body[:, 8] != 0
    count = body[:, 3].view(np.int32)
    idx = np.nonzero(valid & (count > 0))[0]
    cells = (body[:, 0].astype(np.uint64) << np.uint64(32)) | \
        body[:, 1].astype(np.uint64)
    ws = body[:, 2].view(np.int32)
    sum_speed = body[:, 4].view(np.float32)
    sum_speed2 = body[:, 5].view(np.float32)
    sum_lat = body[:, 6].view(np.float32)
    sum_lon = body[:, 7].view(np.float32)
    p95 = body[:, 9].view(np.float32)
    anchor_speed = body[:, 10].view(np.float32)
    anchor_lat = body[:, 11].view(np.float32)
    anchor_lon = body[:, 12].view(np.float32)
    docs = []
    for j in idx:
        c = int(count[j])
        mean_r = float(sum_speed[j]) / c
        extra = {
            "stddevSpeedKmh": float(
                max(float(sum_speed2[j]) / c - mean_r ** 2, 0.0) ** 0.5),
        }
        if meta.with_p95:
            extra["p95SpeedKmh"] = float(p95[j])
        if meta.window_minutes_tag:
            extra["windowMinutes"] = meta.window_minutes_tag
        start = epoch_to_dt(int(ws[j]))
        docs.append(TileDoc(
            city=meta.city,
            res=0,  # unused: grid label is explicit
            cell_id=format(int(cells[j]), "x"),
            window_start=start,
            window_end=epoch_to_dt(int(ws[j]) + meta.window_s),
            count=c,
            avg_speed_kmh=float(anchor_speed[j]) + mean_r,
            avg_lat=float(anchor_lat[j]) + float(sum_lat[j]) / c,
            avg_lon=float(anchor_lon[j]) + float(sum_lon[j]) / c,
            ttl_minutes=meta.ttl_minutes,
            extra=extra,
            grid=meta.grid,
        ))
    return docs


class PositionRows(NamedTuple):
    """Columnar changed-vehicle positions for the packed sink path."""

    lat: Any        # (n,) float32 degrees
    lon: Any        # (n,) float32 degrees
    ts_ms: Any      # (n,) int64 epoch milliseconds
    providers: list  # n provider strings
    vehicles: list   # n vehicleId strings

    def to_docs(self) -> list[dict]:
        return [PositionDoc(self.providers[i], self.vehicles[i],
                            epoch_to_dt(int(self.ts_ms[i]) / 1000.0),
                            float(self.lat[i]), float(self.lon[i]))
                for i in range(len(self.ts_ms))]


class Store(abc.ABC):
    """Write + read interface over the two collections.

    Writes are idempotent upserts; ``upsert_positions`` must apply the
    monotonic-ts guard (only-if-newer) race-free."""

    @abc.abstractmethod
    def upsert_tiles(self, docs: Sequence[dict]) -> int:
        """Upsert tile docs by _id; returns number written."""

    def upsert_tiles_packed(self, body, meta: TilePackMeta) -> int:
        """Upsert tiles straight from packed emit body rows.  Default:
        build docs in Python."""
        return self.upsert_tiles(packed_tile_docs(body, meta))

    @abc.abstractmethod
    def upsert_positions(self, docs: Sequence[dict]) -> int:
        """Monotonic upsert position docs by _id; returns number applied."""

    def upsert_positions_packed(self, rows: "PositionRows") -> int:
        """Monotonic upsert straight from columnar changed-vehicle rows.
        Default: build docs in Python."""
        return self.upsert_positions(rows.to_docs())

    @abc.abstractmethod
    def latest_window_start(self, grid: str | None = None) -> dt.datetime | None:
        """Max windowStart over live tiles (app.py:51)."""

    @abc.abstractmethod
    def tiles_in_window(self, window_start: dt.datetime,
                        grid: str | None = None) -> Iterable[dict]:
        """All tile docs of one window (app.py:57)."""

    @abc.abstractmethod
    def all_positions(self) -> Iterable[dict]:
        """Full scan of positions_latest (app.py:78)."""

    def grids(self) -> "list[str]":
        """Distinct grid labels with live tiles, sorted — the query tier
        uses it to describe a store a serve-only view hasn't
        materialized yet (/debug/view).  Stores that cannot enumerate
        cheaply may return []."""
        return []

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def version(self) -> "int | None":
        """Monotonic write-version for cache invalidation, or None when
        this store cannot know about writers outside this process (the
        serve layer then falls back to a short TTL).  Single-writer
        stores (memory/jsonl; mongo in the embedded deployment where
        this process is the only writer) bump it on every upsert, so an
        unchanged version means a cached rendering is exact."""
        return None
