"""Geometry → H3 cell-set compilation for continuous spatial queries.

A copy of ``heatmap_tpu/query/geom.py``.

A standing query (bbox range subscription, polygon geofence) is
registered ONCE and then evaluated against every view mutation forever,
so the geometry work happens exactly once here: the region is compiled
to an H3 cell set at the grid's snap resolution, and membership of a
changed cell is thereafter one or two set lookups — never a
point-in-polygon test on the hot path.

The compiled set is two-tier, riding the same parent bit surgery the
pyramid rollup uses (query.pyramid.cell_to_parent):

- ``parents`` — coarse cells (``coarse_res``) whose entire boundary
  lies inside the region: every snap-res cell under such a parent is a
  member, so city-scale interiors compress to a handful of entries.
- ``cells``   — the boundary sliver at snap res: cells touched by the
  region whose coarse parent is NOT fully interior.

``CellSet.contains`` is therefore ``cell in cells or parent(cell) in
parents`` — O(1), and the engine's inverted index (cell → query ids)
keys on the same coarse parent, so a view mutation touches only the
queries whose compiled set can possibly contain the changed cell.

Membership semantics: a cell belongs to the region iff it contains a
sample point of a lattice laid over the region at ~0.8 hex-edge
spacing (corners/vertices always sampled).  That makes a zero-area
bbox compile to exactly the one cell containing the point (the natural
point-geofence), keeps tiny fences at a few cells, and leaves no holes
in large regions (the lattice step is well under the minimal hex
width).  Edge cells with slim overlap may fall either way — the
compiled set IS the query's definition, which is what the differential
replay invariant pins; geometric perfection at the sliver is not part
of the contract.

Antimeridian: a bbox whose ``min_lon > max_lon`` is taken as crossing
the antimeridian and compiled as the union of the two straddling
boxes.  (The serving-tier ``bbox=`` parser for one-shot topk rejects
that shape; standing queries accept it here.)
"""

from __future__ import annotations

import math

from heatmap_tpu_torch.query.pyramid import cell_to_parent

# Mean H3 hexagon edge length per resolution, meters (the published H3
# table; only used to size the sampling lattice, so mean is fine — the
# 0.8 factor keeps the step under the minimal hex width everywhere).
EDGE_M = (1107712.591, 418676.0055, 158244.6558, 59810.85794,
          22606.3794, 8544.408276, 3229.482772, 1220.629759,
          461.354684, 174.375668, 65.907807, 24.910561,
          9.415526, 3.559893, 1.348575, 0.509713)

_M_PER_DEG_LAT = 111320.0


class CellSet:
    """One compiled region: coarse interior parents + snap-res sliver.

    Immutable after construction; ``contains`` is the only hot-path
    call.  ``index_keys`` are the coarse-res cells the engine's
    inverted index files this query under (every member cell's parent
    is one of them, so index lookup never misses)."""

    __slots__ = ("res", "coarse_res", "parents", "cells")

    def __init__(self, res: int, coarse_res: int, parents, cells):
        self.res = int(res)
        self.coarse_res = int(coarse_res)
        self.parents = frozenset(parents)
        self.cells = frozenset(cells)

    def contains(self, cell: int) -> bool:
        return (cell in self.cells
                or cell_to_parent(cell, self.coarse_res) in self.parents)

    def index_keys(self) -> frozenset:
        return self.parents | frozenset(
            cell_to_parent(c, self.coarse_res) for c in self.cells)

    def size(self) -> int:
        """Compiled entries held (parents compress whole interiors, so
        this is the memory/metric figure, not the member-cell count)."""
        return len(self.parents) + len(self.cells)


def _wrap_lon(lon: float) -> float:
    while lon > 180.0:
        lon -= 360.0
    while lon < -180.0:
        lon += 360.0
    return lon


def point_in_ring(lon: float, lat: float, ring) -> bool:
    """Ray-casting point-in-polygon on plain lon/lat (the polygon is
    registered in the same coordinate plane the UI draws in; small
    regions only — no great-circle edges)."""
    inside = False
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        if (y1 > lat) != (y2 > lat):
            xin = x1 + (lat - y1) / (y2 - y1) * (x2 - x1)
            if lon < xin:
                inside = not inside
    return inside


def _lattice(lo_lon: float, lo_lat: float, hi_lon: float, hi_lat: float,
             res: int, max_samples: int):
    """Sample points covering one non-wrapping bbox: a lattice at
    ~0.8 hex-edge spacing, corners included.  Degenerate (zero-area)
    boxes collapse to their corner point(s)."""
    step_m = 0.8 * EDGE_M[res]
    dlat = step_m / _M_PER_DEG_LAT
    # lon degrees shrink with latitude; size the step at the widest
    # (most equatorward) latitude of the box so spacing never opens up
    coslat = max(0.05, math.cos(math.radians(
        min(abs(lo_lat), abs(hi_lat)))))
    dlon = step_m / (_M_PER_DEG_LAT * coslat)
    n_lat = max(1, int(math.ceil((hi_lat - lo_lat) / dlat)) + 1)
    n_lon = max(1, int(math.ceil((hi_lon - lo_lon) / dlon)) + 1)
    if n_lat * n_lon > max_samples:
        raise ValueError(
            f"region too large to compile at res {res}: "
            f"{n_lat * n_lon} samples exceeds the {max_samples} budget "
            f"(register against a coarser grid or shrink the region)")
    for i in range(n_lat):
        lat = hi_lat if n_lat == 1 else lo_lat + (hi_lat - lo_lat) \
            * i / (n_lat - 1)
        for j in range(n_lon):
            lon = hi_lon if n_lon == 1 else lo_lon + (hi_lon - lo_lon) \
                * j / (n_lon - 1)
            yield lat, lon


def _snap_many(points, res: int) -> set:
    from heatmap_tpu_torch.hexgrid import host

    T = host.tables()
    out: set = set()
    for lat, lon in points:
        lat = max(-90.0, min(90.0, lat))
        out.add(host.latlng_to_cell_int(
            math.radians(lat), math.radians(_wrap_lon(lon)), res, T))
    return out


def _promote(cells: set, res: int, coarse_res: int,
             inside_fn) -> tuple[set, set]:
    """Split sampled snap cells into fully-interior coarse parents and
    the boundary sliver: a parent is promoted when its centroid and
    every boundary vertex pass ``inside_fn`` — then all its children
    are members and the snap entries compress away."""
    from heatmap_tpu_torch.hexgrid import host

    if coarse_res >= res:
        return set(), set(cells)
    by_parent: dict[int, set] = {}
    for c in cells:
        by_parent.setdefault(cell_to_parent(c, coarse_res), set()).add(c)
    parents: set = set()
    sliver: set = set()
    # a fully-interior parent has every child containing a lattice
    # sample (the lattice is denser than the child cells), so a parent
    # with under half its 7^Δ children sampled cannot be interior —
    # skipping the boundary-geometry test there is what keeps a
    # 100k-tiny-fence registration storm (tools/bench_cq.py) cheap
    min_members = (7 ** (res - coarse_res)) // 2
    for p, members in by_parent.items():
        if len(members) < min_members:
            sliver |= members
            continue
        try:
            lat, lng = host.cell_to_latlng(p)
            verts = host.cell_to_boundary(p)
        except Exception:
            sliver |= members
            continue
        if inside_fn(lng, lat) and all(inside_fn(vlng, vlat)
                                       for vlat, vlng in verts):
            parents.add(p)
        else:
            sliver |= members
    return parents, sliver


def _budgeted(cs: CellSet, max_cells: int) -> CellSet:
    """Enforce HEATMAP_CQ_MAX_CELLS on the COMPILED set (parents +
    sliver) — the budget the knob documents; parent promotion means a
    city interior is cheap to hold even when its raw sampling was not
    (the raw cost is bounded separately by ``max_samples``)."""
    if cs.size() > max_cells:
        raise ValueError(
            f"region compiles to {cs.size()} entries at res {cs.res}, "
            f"over the {max_cells} budget (HEATMAP_CQ_MAX_CELLS); "
            f"register against a coarser grid or shrink the region")
    return cs


def compile_bbox(bbox, res: int, coarse_res: int | None = None,
                 max_cells: int = 4096,
                 max_samples: int = 262144) -> CellSet:
    """``(min_lon, min_lat, max_lon, max_lat)`` → CellSet at ``res``.
    ``min_lon > max_lon`` crosses the antimeridian (two-box union);
    ``min_lat > max_lat`` is an error; equal bounds are a legal
    degenerate box (a point compiles to its one containing cell)."""
    lo_lon, lo_lat, hi_lon, hi_lat = (float(v) for v in bbox)
    if not all(map(math.isfinite, (lo_lon, lo_lat, hi_lon, hi_lat))):
        raise ValueError("bbox values must be finite numbers")
    if lo_lat > hi_lat:
        raise ValueError("bbox min_lat exceeds max_lat")
    if not (-90.0 <= lo_lat <= 90.0 and -90.0 <= hi_lat <= 90.0):
        raise ValueError("bbox latitudes must be in [-90, 90]")
    if not (0 <= res <= 15):
        raise ValueError(f"resolution must be in [0, 15], got {res}")
    if coarse_res is None:
        coarse_res = max(0, res - 2)
    boxes = ([(lo_lon, lo_lat, hi_lon, hi_lat)] if lo_lon <= hi_lon
             # antimeridian crossing: the box runs east from lo_lon
             # through 180/-180 to hi_lon
             else [(lo_lon, lo_lat, 180.0, hi_lat),
                   (-180.0, lo_lat, hi_lon, hi_lat)])
    cells: set = set()
    for b in boxes:
        cells |= _snap_many(_lattice(*b, res, max_samples), res)

    def inside(lon: float, lat: float) -> bool:
        lon = _wrap_lon(lon)
        return any(b[0] <= lon <= b[2] and b[1] <= lat <= b[3]
                   for b in boxes)

    parents, sliver = _promote(cells, res, coarse_res, inside)
    return _budgeted(CellSet(res, coarse_res, parents, sliver),
                     max_cells)


def compile_polygon(ring, res: int, coarse_res: int | None = None,
                    max_cells: int = 4096,
                    max_samples: int = 262144) -> CellSet:
    """Closed (or auto-closed) ``[[lon, lat], ...]`` ring → CellSet.
    Vertices always sample in, so a sliver polygon still compiles to
    the cells it actually touches.  Antimeridian-spanning polygons are
    not supported (register two, or use a wrapping bbox)."""
    pts = [(float(lon), float(lat)) for lon, lat in ring]
    if pts and pts[0] == pts[-1]:
        pts = pts[:-1]
    if len(pts) < 3:
        raise ValueError("polygon needs at least 3 distinct vertices")
    for lon, lat in pts:
        if not (math.isfinite(lon) and math.isfinite(lat)
                and -90.0 <= lat <= 90.0 and -180.0 <= lon <= 180.0):
            raise ValueError(f"polygon vertex out of range: "
                             f"({lon}, {lat})")
    if not (0 <= res <= 15):
        raise ValueError(f"resolution must be in [0, 15], got {res}")
    if coarse_res is None:
        coarse_res = max(0, res - 2)
    lo_lon = min(p[0] for p in pts)
    hi_lon = max(p[0] for p in pts)
    lo_lat = min(p[1] for p in pts)
    hi_lat = max(p[1] for p in pts)

    def inside(lon: float, lat: float) -> bool:
        return point_in_ring(lon, lat, pts)

    samples = [(lat, lon) for lat, lon in
               _lattice(lo_lon, lo_lat, hi_lon, hi_lat, res, max_samples)
               if inside(lon, lat)]
    samples.extend((lat, lon) for lon, lat in pts)
    cells = _snap_many(samples, res)
    parents, sliver = _promote(cells, res, coarse_res, inside)
    return _budgeted(CellSet(res, coarse_res, parents, sliver),
                     max_cells)
