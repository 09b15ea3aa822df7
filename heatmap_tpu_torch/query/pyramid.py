"""Incremental multi-resolution rollup over one grid's tile view.

A copy of ``heatmap_tpu/query/pyramid.py``.

The UI zooms out; the configured pyramid only goes as fine as the
streamed resolutions.  Re-aggregating a whole window per request would
be the same O(city) rebuild the matview exists to kill, so the rollup
is maintained INCREMENTALLY: every base-cell upsert the view applies is
turned into a delta (new minus old contribution) and propagated to the
cell's H3 parent at each maintained coarser resolution — O(levels) per
changed cell, O(changed) per batch, never a window scan.

What rolls up, and what provably can't:
- ``count`` sums exactly.
- ``avgSpeedKmh`` and the centroid are count-weighted means, so their
  weighted SUMS add exactly and the mean recombines at render time.
- ``p95SpeedKmh``/``stddevSpeedKmh`` do NOT combine from per-cell
  aggregates (quantiles and variances need the raw moments the sink
  rows don't carry per parent), so rollup tiles omit them — documented
  in the endpoint contract rather than silently wrong.

Parent math: an H3 index's parent is the index itself with the
resolution field lowered and the now-unused digits set to the invalid
marker (7) — pure bit surgery, no geometry, exact for pentagons too.
"""

from __future__ import annotations

import datetime as dt

RES_SHIFT = 52
RES_MASK = 0xF << RES_SHIFT


def cell_to_parent(cell: int, parent_res: int) -> int:
    """H3 parent of ``cell`` at ``parent_res`` (must not exceed the
    cell's own resolution)."""
    res = (cell >> RES_SHIFT) & 0xF
    if parent_res > res:
        raise ValueError(f"parent res {parent_res} finer than cell res {res}")
    out = (cell & ~RES_MASK) | (parent_res << RES_SHIFT)
    for r in range(parent_res + 1, res + 1):
        out |= 0x7 << (3 * (15 - r))
    return out


class Pyramid:
    """Per-grid rollup state: {res: {window_start_epoch: {parent_cell_int:
    [count, speed_wsum, lat_wsum, lon_wsum]}}}.

    Not thread-safe by itself — the owning TileMatView serializes every
    call under its own lock."""

    __slots__ = ("resolutions", "_agg")

    def __init__(self, base_res: int, levels: int):
        lo = max(0, base_res - max(0, levels))
        self.resolutions = tuple(range(lo, base_res))
        self._agg: dict[int, dict[int, dict[int, list]]] = {
            r: {} for r in self.resolutions}

    def apply(self, ws: int, cell: int, old: dict | None, new: dict) -> None:
        """Propagate one base-cell upsert (``old`` is the previously
        visible doc for the same (window, cell), or None)."""
        dc = int(new.get("count", 0)) - (int(old.get("count", 0)) if old else 0)
        dspeed = self._wsum(new, "avgSpeedKmh") - self._wsum(old, "avgSpeedKmh")
        dlat = self._cwsum(new, 1) - self._cwsum(old, 1)
        dlon = self._cwsum(new, 0) - self._cwsum(old, 0)
        if not dc and not dspeed and not dlat and not dlon:
            return
        for res in self.resolutions:
            parent = cell_to_parent(cell, res)
            wins = self._agg[res].setdefault(ws, {})
            a = wins.get(parent)
            if a is None:
                a = wins[parent] = [0, 0.0, 0.0, 0.0]
            a[0] += dc
            a[1] += dspeed
            a[2] += dlat
            a[3] += dlon
            if a[0] <= 0:
                del wins[parent]

    @staticmethod
    def _wsum(doc: dict | None, key: str) -> float:
        if doc is None:
            return 0.0
        return float(doc.get(key, 0.0)) * int(doc.get("count", 0))

    @staticmethod
    def _cwsum(doc: dict | None, axis: int) -> float:
        if doc is None:
            return 0.0
        try:
            coord = doc["centroid"]["coordinates"][axis]
        except (KeyError, TypeError, IndexError):
            return 0.0
        return float(coord) * int(doc.get("count", 0))

    def drop_window(self, ws: int) -> None:
        for wins in self._agg.values():
            wins.pop(ws, None)

    def docs(self, res: int, ws: int, window_end: dt.datetime | None,
             window_start: dt.datetime | None) -> list[dict]:
        """Synthesized rollup tile docs for one (res, window), shaped so
        the serving renderer's ``_tile_props`` consumes them unchanged.
        p95/stddev are intentionally absent (non-combinable)."""
        from heatmap_tpu_torch.hexgrid import h3_to_string

        wins = self._agg.get(res)
        if wins is None:
            raise KeyError(res)
        out = []
        for parent, (c, sw, slat, slon) in wins.get(ws, {}).items():
            out.append({
                "cellId": h3_to_string(parent),
                "count": int(c),
                "avgSpeedKmh": sw / c,
                "windowStart": window_start,
                "windowEnd": window_end,
                "centroid": {"type": "Point",
                             "coordinates": [slon / c, slat / c]},
            })
        return out
