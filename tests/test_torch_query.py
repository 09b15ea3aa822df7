"""The port's query tier against the JAX package's, on the CPU.

- ``hexgrid/host.py``, the f64 oracle the serve tier renders with:
  ``latlng_to_cell_int``, ``h3_to_string`` / ``string_to_h3``,
  ``cell_to_latlng`` and ``cell_to_boundary`` equal to the reference's,
  exactly, over 11,000 seeded points at res 0-10 and the 12 pentagons at
  every res; the host tables equal the generated ones.
- ``cell_to_parent`` and the ``Pyramid`` rollup, exactly.
- ``TileMatView``: the same doc sequence (new windows, late docs into an
  older window, a store-fed rebuild, stale windows evicted under a fake
  clock) applied to both views gives, after every step, equal ``seq``,
  equal delta replays from every ``since``, equal topk (with and without
  a bbox, and rolled up), equal rollups and snapshots, and ETags equal
  but for each process's nonce.
- ``StoreViewRefresher`` over equal stores: equal views after each
  rebuild (first scan, a same-window change, a window switch), and equal
  catch-up health when the store fails.
"""

import datetime as dt
import re

import numpy as np
import pytest

from heatmap_tpu.hexgrid import _tables as jtables
from heatmap_tpu.hexgrid import host as jhost
from heatmap_tpu.query import StoreViewRefresher as JaxRefresher
from heatmap_tpu.query import TileMatView as JaxView
from heatmap_tpu.query import pyramid as jpyramid
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu_torch.hexgrid import _tables as ttables
from heatmap_tpu_torch.hexgrid import host as thost
from heatmap_tpu_torch.query import StoreViewRefresher, TileMatView
from heatmap_tpu_torch.query import pyramid as tpyramid
from heatmap_tpu_torch.sink.base import TileDoc
from heatmap_tpu_torch.sink.memory import MemoryStore

UTC = dt.timezone.utc
GRID = "h3r8"
WIN_S = 300
TTL_MIN = 45
CENTER = (42.3601, -71.0589)   # the synthetic source's city


# --- the host oracle ---------------------------------------------------------

def seeded_points(n, seed):
    """(lat_rad, lng_rad, res): uniform on the sphere, res 0-10."""
    rng = np.random.default_rng(seed)
    lat = np.arcsin(rng.uniform(-1.0, 1.0, n))
    lng = rng.uniform(-np.pi, np.pi, n)
    res = rng.integers(0, 11, n)
    return [(float(a), float(b), int(r)) for a, b, r in zip(lat, lng, res)]


def pentagon_points():
    """The 12 pentagon base cells' centers at every res 0-10."""
    pents = np.flatnonzero(np.asarray(jtables.BC_PENT))
    assert len(pents) == 12
    geo = np.asarray(jtables.BC_CENTER_GEO)
    return [(float(geo[bc, 0]), float(geo[bc, 1]), r)
            for bc in pents for r in range(11)]


def test_host_tables_equal_the_generated_ones():
    for name in ("BC_HOME_FACE", "BC_HOME_IJK", "BC_CENTER_GEO", "BC_PENT",
                 "PENT_CW_OFFSET", "FACE_IJK_BC", "FACE_IJK_ROT"):
        np.testing.assert_array_equal(getattr(ttables, name),
                                      getattr(jtables, name), err_msg=name)
    assert ttables.FACE_NEIGHBORS == jtables.FACE_NEIGHBORS


@pytest.mark.parametrize("seed", [0, 1])
def test_host_oracle_matches_jax(seed):
    """5,500 seeded points a case (pentagons in each), res 0-10: every
    oracle function the read path calls, bit for bit."""
    pts = seeded_points(5_500 - 132, seed) + pentagon_points()
    n_pent = 0
    for lat, lng, res in pts:
        h = thost.latlng_to_cell_int(lat, lng, res)
        assert h == jhost.latlng_to_cell_int(lat, lng, res), (lat, lng, res)
        s = thost.h3_to_string(h)
        assert s == jhost.h3_to_string(h)
        assert thost.string_to_h3(s) == jhost.string_to_h3(s) == h
        assert thost.cell_to_latlng(s) == jhost.cell_to_latlng(s)
        assert thost.cell_to_boundary(h) == jhost.cell_to_boundary(h)
        pent = thost.is_pentagon(h)
        assert pent == jhost.is_pentagon(h)
        n_pent += pent
    assert n_pent >= 132


# --- the pyramid -------------------------------------------------------------

def city_cells(n, res, seed):
    """Distinct cells around the synthetic source's city."""
    rng = np.random.default_rng(seed)
    lat = np.radians(CENTER[0] + rng.uniform(-0.12, 0.12, 4 * n))
    lng = np.radians(CENTER[1] + rng.uniform(-0.12, 0.12, 4 * n))
    cells = dict.fromkeys(jhost.latlng_to_cell_int(float(a), float(b), res)
                          for a, b in zip(lat, lng))
    return list(cells)[:n]


def test_cell_to_parent_matches_jax():
    for res in (7, 8, 9, 10):
        for cell in city_cells(200, res, res):
            for p in range(res + 1):
                assert (tpyramid.cell_to_parent(cell, p)
                        == jpyramid.cell_to_parent(cell, p))
            with pytest.raises(ValueError):
                tpyramid.cell_to_parent(cell, res + 1)


def test_pyramid_matches_jax():
    rng = np.random.default_rng(3)
    cells = city_cells(300, 8, 3)
    ws_dt = dt.datetime.fromtimestamp(1_700_000_100, UTC)
    we_dt = ws_dt + dt.timedelta(seconds=WIN_S)
    mine, ref = tpyramid.Pyramid(8, 3), jpyramid.Pyramid(8, 3)
    assert mine.resolutions == ref.resolutions == (5, 6, 7)
    old: dict = {}
    for step in range(3):
        for cell in cells[step * 50:step * 50 + 200]:
            doc = {"count": int(rng.integers(1, 50)),
                   "avgSpeedKmh": float(rng.uniform(0, 90)),
                   "centroid": {"type": "Point", "coordinates": [
                       float(rng.uniform(-71.2, -70.9)),
                       float(rng.uniform(42.2, 42.5))]}}
            for p in (mine, ref):
                p.apply(1_700_000_100, cell, old.get(cell), doc)
            old[cell] = doc
        for res in mine.resolutions:
            assert (mine.docs(res, 1_700_000_100, we_dt, ws_dt)
                    == ref.docs(res, 1_700_000_100, we_dt, ws_dt))
    for p in (mine, ref):
        p.drop_window(1_700_000_100)
    assert mine.docs(6, 1_700_000_100, we_dt, ws_dt) == []


# --- the view ----------------------------------------------------------------

def tile_docs(cells, ws_epoch, rng, grid=GRID, city="bos"):
    """Tile docs as the sink writes them (the port's ``TileDoc``), with
    p95 and stddev; floats drawn from ``rng``."""
    ws = dt.datetime.fromtimestamp(ws_epoch, UTC)
    we = ws + dt.timedelta(seconds=WIN_S)
    out = []
    for cell in cells:
        out.append(TileDoc(
            city=city, res=8, cell_id=format(cell, "x"), window_start=ws,
            window_end=we, count=int(rng.integers(1, 400)),
            avg_speed_kmh=float(rng.uniform(0, 90)),
            avg_lat=CENTER[0] + float(rng.uniform(-0.12, 0.12)),
            avg_lon=CENTER[1] + float(rng.uniform(-0.12, 0.12)),
            ttl_minutes=TTL_MIN,
            extra={"p95SpeedKmh": float(rng.uniform(0, 120)),
                   "stddevSpeedKmh": float(rng.uniform(0, 20))},
            grid=grid))
    return out


def etag_shape(etag):
    """An ETag with its per-process nonce taken out."""
    m = re.fullmatch(r'"([0-9a-f]{8})\.(.*)"', etag)
    assert m, etag
    return m.group(2)


BBOX = (CENTER[1] - 0.05, CENTER[0] - 0.05, CENTER[1] + 0.05,
        CENTER[0] + 0.05)


def outcome(fn, *args, **kw):
    """``fn``'s result, or the type of what it raised."""
    try:
        return fn(*args, **kw)
    except KeyError as e:
        return KeyError, e.args


def assert_views_equal(mine, ref, grids=(GRID,)):
    """Everything a client can read off the two views."""
    assert mine.seq == ref.seq
    assert mine.cells_live() == ref.cells_live()
    for grid in grids:
        assert etag_shape(mine.etag(grid)) == etag_shape(ref.etag(grid))
        for since in range(0, ref.seq + 2):
            assert mine.delta(grid, since) == ref.delta(grid, since), since
            assert (mine.changed_since(grid, since)
                    == ref.changed_since(grid, since))
        for res in (None, 3, 6, 7):
            got = outcome(mine.snapshot_seq, grid, res)
            want = outcome(ref.snapshot_seq, grid, res)
            if want[0] is KeyError:
                assert got == want
                continue
            assert etag_shape(got[0]) == etag_shape(want[0])
            assert got[1:] == want[1:], res
            for bbox in (None, BBOX):
                assert (mine.topk(grid, 7, res=res, bbox=bbox)
                        == ref.topk(grid, 7, res=res, bbox=bbox))
    assert mine.export_state() == ref.export_state()


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


def test_view_matches_jax_through_windows_and_eviction():
    rng = np.random.default_rng(5)
    cells = city_cells(120, 8, 5)
    w0 = 1_700_000_100 // WIN_S * WIN_S
    clock = _Clock(w0 + 60)
    mine = TileMatView(delta_log=64, pyramid_levels=2, now_fn=clock)
    ref = JaxView(delta_log=64, pyramid_levels=2, now_fn=clock)
    assert_views_equal(mine, ref)
    steps = [
        tile_docs(cells[:40], w0, rng),                 # first window
        tile_docs(cells[25:50], w0, rng),               # updates + new
        tile_docs(cells[30:70], w0 + WIN_S, rng),       # window advance
        tile_docs(cells[:20], w0, rng),                 # late, not latest
        tile_docs(cells[60:90], w0 + WIN_S, rng),
        tile_docs(cells[:10], w0 + WIN_S, rng, grid="h3r8m15"),
    ]
    for docs in steps:
        assert mine.apply_docs(docs) == ref.apply_docs(docs)
        assert_views_equal(mine, ref, grids=(GRID, "h3r8m15"))
    # unchanged docs bump nothing
    assert mine.apply_docs(steps[-2]) == ref.apply_docs(steps[-2]) == 0
    # the first window goes stale (not the latest: no seq bump), then a
    # third window, then every window (the latest evicted: a resync)
    clock.t = w0 + WIN_S + TTL_MIN * 60 + 1
    assert_views_equal(mine, ref, grids=(GRID, "h3r8m15"))
    docs = tile_docs(cells[80:120], w0 + 2 * WIN_S, rng)
    assert mine.apply_docs(docs) == ref.apply_docs(docs)
    assert_views_equal(mine, ref, grids=(GRID, "h3r8m15"))
    clock.t = w0 + 3 * WIN_S + TTL_MIN * 60 + 1
    assert_views_equal(mine, ref, grids=(GRID, "h3r8m15"))
    assert mine.cells_live() == 0
    # a store-fed rebuild after the eviction, then the view poisoned
    docs = tile_docs(cells[:30], w0 + 10 * WIN_S, rng)
    clock.t = w0 + 10 * WIN_S
    assert mine.replace_grid(GRID, docs) == ref.replace_grid(GRID, docs)
    assert_views_equal(mine, ref)
    for v in (mine, ref):
        v.poison()
        assert v.poisoned and v.wait_changed(GRID, 10**6, timeout=0.01)


def test_view_delta_horizon_and_watchers_match_jax():
    """A changelog shorter than the changes forces a full resync in both,
    and the watchers see the same mutation records."""
    rng = np.random.default_rng(6)
    cells = city_cells(60, 8, 6)
    w0 = 1_700_000_100 // WIN_S * WIN_S
    clock = _Clock(w0)
    mine = TileMatView(delta_log=8, now_fn=clock)
    ref = JaxView(delta_log=8, now_fn=clock)
    got: dict = {"mine": [], "ref": []}
    mine.add_watcher(got["mine"].append)
    ref.add_watcher(got["ref"].append)
    for i in range(5):
        docs = tile_docs(cells[i * 10:i * 10 + 15], w0, rng)
        mine.apply_docs(docs)
        ref.apply_docs(docs)
    assert_views_equal(mine, ref)
    assert mine.delta(GRID, 2)["mode"] == "full"
    for v in (mine, ref):
        v.publish_anomalies(GRID, [{"entity": "v1", "reason": "teleport",
                                    "cell": format(cells[0], "x")}])
    assert got["mine"] == got["ref"] and len(got["mine"]) == 6
    assert mine.seq == ref.seq == 6
    assert_views_equal(mine, ref)


# --- the store-fed refresher -------------------------------------------------

class _FailingStore:
    def version(self):
        return None

    def latest_window_start(self, grid=None):
        raise OSError("store down")


def test_refresher_over_equal_stores_matches_jax():
    rng = np.random.default_rng(7)
    cells = city_cells(80, 8, 7)
    now = int(dt.datetime.now(UTC).timestamp()) // WIN_S * WIN_S
    store, jstore = MemoryStore(), JaxMemoryStore()
    mine, ref = TileMatView(), JaxView()
    rm = StoreViewRefresher(store, mine, poll_s=60.0)
    rr = JaxRefresher(jstore, ref, poll_s=60.0)
    for docs in (tile_docs(cells[:40], now - WIN_S, rng),
                 tile_docs(cells[20:60], now - WIN_S, rng),   # same window
                 tile_docs(cells[50:80], now, rng)):          # a new one
        store.upsert_tiles(docs)
        jstore.upsert_tiles(docs)
        rm.refresh(GRID)
        rr.refresh(GRID)
        assert_views_equal(mine, ref)
        assert rm.health() == rr.health() == {"value": "ok", "ok": True}
        # an unchanged store within the poll TTL rebuilds nothing
        seq = mine.seq
        rm.refresh(GRID)
        rr.refresh(GRID)
        assert mine.seq == ref.seq == seq
    for r in (rm, rr):
        r.store = _FailingStore()
        r.view = type(r.view)()
        r.ever_ok = False
        r._st.clear()
        r.refresh(GRID)
    assert rm.health() == rr.health() == {"value": "catching up",
                                          "ok": False}
