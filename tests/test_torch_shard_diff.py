"""The port's sharded runtime (HEATMAP_SHARDS, heatmap_tpu_torch/stream/
runtime.py with stream/shardmap.py) against the JAX package's, on the CPU.

Counterparts of ``tests/test_shard_diff.py``.  For exact comparisons both
packages key the fold with the host snap (``HEATMAP_H3_IMPL=native``):

- a 3-shard port fleet over ``mk_stream``'s hazards (invalid, late and
  duplicate rows) gives merged docs equal, doc for doc, to the JAX
  package's unsharded fold and to a JAX 3-shard fleet, and its shared
  view equals the unsharded port run's own view;
- a shard that owns none of a batch still dispatches it, empty, and
  advances offsets and the watermark;
- a shard killed mid-stream resumes from its own namespace and replays
  only its own offsets; the merged store converges;
- the oversample mode is exact on the integer lanes and within rel 1e-5
  on the floats, the reference's own bar;
- the watermark alignment holds the cutoff at the fleet's low bound,
  drops a stale peer, and never moves the cutoff back;
- two governed shards under skewed load converge to different buckets
  while the merged docs equal the ungoverned fleet's;
- on the in-program route, rows at cell edges where the kernel's snap
  and the host snap disagree stay in one shard: no tile ``_id`` lands in
  two shard logs (the fault logged as C8 in ROADMAP.md; the port keys
  ownership on the fold's own cells).
"""

import copy
import json
import time

import numpy as np
import pytest
import torch

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.engine import step as jstep
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MemorySource as JaxMemorySource
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.hexgrid import host as thost
from heatmap_tpu_torch.hexgrid import snap_kernel
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.sink import JsonlStore, make_store
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.events import parse_events
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.shardmap import ShardMap, join_words
from heatmap_tpu_torch.stream.source import JsonlReplaySource, MemorySource

T_NOW = int(time.time()) - 600
BATCH = 256
N_SHARDS = 3


@pytest.fixture(autouse=True)
def host_keys(monkeypatch):
    """Both packages key the fold with the host snap; the JAX runtime's
    module slots it pins at init are restored after."""
    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    for slot in ("SNAP_IMPL", "MERGE_IMPL", "FASTPATH", "MERGE_BANK_PIN"):
        monkeypatch.setattr(jstep, slot, getattr(jstep, slot))


def mk_stream():
    """The reference test's stream: clean traffic over a wide box, invalid
    rows, duplicates and rows an hour late."""
    rng = np.random.default_rng(11)

    def ev(i, t, lat=None, lon=None):
        v = i % 37
        return {
            "provider": "mbta" if v % 3 else "opensky",
            "vehicleId": f"veh-{v}",
            "lat": float(rng.uniform(42.3, 42.5)) if lat is None else lat,
            "lon": float(rng.uniform(-71.2, -71.0)) if lon is None else lon,
            "speedKmh": float(rng.uniform(0, 80)),
            "bearing": 0.0,
            "accuracyM": 5.0,
            "ts": t,
        }

    out = [ev(i, T_NOW + i % 120) for i in range(3 * BATCH)]
    bad = [ev(1, T_NOW + 130, lat=95.0), ev(2, T_NOW + 130, lon=-200.0),
           ev(3, -5), ev(4, T_NOW + 130, lat=float("nan"))]
    dup = ev(0, T_NOW + 200, lat=42.35, lon=-71.05)
    out += bad + [copy.deepcopy(dup) for _ in range(8)]
    out += [ev(i, T_NOW - 3600) for i in range(24)]
    out += [ev(i, T_NOW + 210 + i % 30) for i in range(BATCH - 36)]
    return out


def _axes(tmp_path, tag, **over):
    kw = dict(batch_size=BATCH, state_capacity_log2=12, speed_hist_bins=8,
              store="memory", emit_flush_k=3,
              checkpoint_dir=str(tmp_path / f"ckpt-{tag}"))
    kw.update(over)
    return kw


def run_shard(tmp_path, events, store, tag, shards=1, index=0, view=None,
              oversample=1, max_batches=None, checkpoint_every=0,
              source=None, shard_res=-1, **over):
    cfg = load_config({}, **_axes(tmp_path, tag, shards=shards,
                                  shard_index=index,
                                  shard_oversample=oversample,
                                  shard_res=shard_res, **over))
    if source is None:
        source = MemorySource(copy.deepcopy(events))
        source.finish()
    rt = MicroBatchRuntime(cfg, source, store, device="cpu",
                           checkpoint_every=checkpoint_every, view=view)
    rt.run(max_batches=max_batches)
    return rt


def run_jax(tmp_path, events, store, tag, shards=1, index=0, oversample=1):
    cfg = jax_load_config({}, **_axes(tmp_path, f"jax-{tag}", shards=shards,
                                      shard_index=index,
                                      shard_oversample=oversample))
    src = JaxMemorySource(copy.deepcopy(events))
    src.finish()
    rt = JaxRuntime(cfg, src, store, checkpoint_every=0)
    rt.run()
    return rt


def test_one_vs_n_shards_byte_identical(tmp_path):
    events = mk_stream()
    base_store = MemoryStore()
    rt1 = run_shard(tmp_path, events, base_store, "base")
    merged_view = TileMatView(delta_log=4096, pyramid_levels=2)
    fleet_store = MemoryStore()
    fleet = [run_shard(tmp_path, events, fleet_store, f"s{i}",
                       shards=N_SHARDS, index=i, view=merged_view)
             for i in range(N_SHARDS)]
    jax_base, jax_fleet = JaxMemoryStore(), JaxMemoryStore()
    run_jax(tmp_path, events, jax_base, "base")
    for i in range(N_SHARDS):
        run_jax(tmp_path, events, jax_fleet, f"s{i}", shards=N_SHARDS,
                index=i)

    assert len(base_store._tiles) > 100
    assert (fleet_store._tiles == base_store._tiles == jax_base._tiles
            == jax_fleet._tiles)
    assert (fleet_store._positions == base_store._positions
            == jax_base._positions == jax_fleet._positions)
    assert len(base_store._positions) > 0

    c1 = rt1.counters
    for key in ("events_valid", "events_late", "tiles_emitted"):
        assert sum(rt.counters[key] for rt in fleet) == c1[key], key
    for i, rt in enumerate(fleet):
        assert rt.counters["events_invalid"] == c1["events_invalid"]
        assert rt.counters.get("events_out_of_shard", 0) > 0
        assert rt.max_event_ts == rt1.max_event_ts
        assert rt.matview is merged_view and rt.repl_pub is None
        assert rt._fresh_tag == f"shard{i}"
        fams = rt.registry._families
        assert fams["heatmap_shard_index"].value == i
        assert fams["heatmap_shard_count"].value == N_SHARDS
    assert set(rt1.matview._grids) == set(merged_view._grids)
    for grid in rt1.matview._grids:
        _, ws1, docs1 = rt1.matview.snapshot(grid)
        _, wsn, docsn = merged_view.snapshot(grid)
        assert ws1 == wsn
        by_cell = lambda docs: {d["cellId"]: d for d in docs}
        assert by_cell(docs1) == by_cell(docsn), grid


def test_all_foreign_batches_still_advance_the_stream(tmp_path):
    rng = np.random.default_rng(7)
    events = [{"provider": "p", "vehicleId": f"v{i % 5}",
               "lat": 42.3601 + float(rng.uniform(-1e-4, 1e-4)),
               "lon": -71.0589 + float(rng.uniform(-1e-4, 1e-4)),
               "speedKmh": 1.0, "ts": T_NOW + i} for i in range(2 * BATCH)]
    sm = ShardMap(4, 0, 8, parent_res=5)
    cells = sm.cells_of(np.radians([42.3601]).astype(np.float32),
                        np.radians([-71.0589]).astype(np.float32))
    loser = (int(sm.shard_of_cells(cells)[0]) + 1) % 4
    store = MemoryStore()
    rt = run_shard(tmp_path, events, store, "loser", shards=4, index=loser,
                   shard_res=5, h3_res=8, resolutions=(8,))
    c = rt.counters
    assert c["events_valid"] == 0
    assert c["events_out_of_shard"] == 2 * BATCH
    assert rt.epoch == 2
    assert rt.source.offset() == 2 * BATCH
    assert rt.max_event_ts == T_NOW + 2 * BATCH - 1
    assert len(store._tiles) == 0
    fams = rt.registry._families
    assert fams["heatmap_events_dropped_total"].labels(
        reason="out_of_shard").value == 2 * BATCH


def test_sharded_resume_replays_only_own_offsets(tmp_path):
    events = mk_stream()
    path = tmp_path / "corpus.jsonl"
    with open(path, "w") as fh:
        for e in events:
            fh.write(json.dumps(e) + "\n")
    base_store = MemoryStore()
    run_shard(tmp_path, events, base_store, "rbase",
              source=JsonlReplaySource(str(path)))
    fleet_store = MemoryStore()
    ckpt = tmp_path / "fleet-ckpt"
    kw = _axes(tmp_path, "x", shards=2, shard_oversample=1,
               checkpoint_dir=str(ckpt))

    def shard(i):
        return MicroBatchRuntime(load_config({}, shard_index=i, **kw),
                                 JsonlReplaySource(str(path)), fleet_store,
                                 device="cpu", checkpoint_every=1)

    shard(0).run()
    rt1a = shard(1)
    rt1a.run(max_batches=2)
    assert (ckpt / "shard1").is_dir() and (ckpt / "shard0").is_dir()
    rt1b = shard(1)
    assert rt1b.source.offset() == rt1a.source.offset()
    assert rt1b.epoch == rt1a.epoch > 0
    rt1b.run()
    assert fleet_store._tiles == base_store._tiles
    assert fleet_store._positions == base_store._positions


def test_oversample_mode_is_semantically_equivalent(tmp_path):
    events = mk_stream()[:3 * BATCH]
    base_store, jax_base = MemoryStore(), JaxMemoryStore()
    run_shard(tmp_path, events, base_store, "obase")
    run_jax(tmp_path, events, jax_base, "obase")
    fleet_store = MemoryStore()
    fleet = [run_shard(tmp_path, events, fleet_store, f"os{i}", shards=2,
                       index=i, oversample=2) for i in range(2)]
    for rt in fleet:
        assert rt._shard_oversample == 2
        fams = rt.registry._families["heatmap_events_dropped_total"]
        assert fams.labels(reason="oversample").value > 0
        assert fams.labels(reason="out_of_shard").value == 0
    assert base_store._tiles == jax_base._tiles
    assert base_store._tiles.keys() == fleet_store._tiles.keys()
    for k, d1 in base_store._tiles.items():
        dn = fleet_store._tiles[k]
        assert d1["count"] == dn["count"], k
        assert d1["avgSpeedKmh"] == pytest.approx(dn["avgSpeedKmh"],
                                                  rel=1e-5), k


def test_watermark_alignment_holds_cutoff_at_fleet_low_bound(
        tmp_path, monkeypatch):
    from heatmap_tpu.obs.xproc import \
        shard_watermarks_from as jax_watermarks
    from heatmap_tpu_torch.obs import ENV_CHANNEL
    from heatmap_tpu_torch.obs.xproc import (publish_shard_watermark,
                                             shard_watermark_path,
                                             shard_watermarks_from)

    chan = str(tmp_path / "chan")
    monkeypatch.setenv(ENV_CHANNEL, chan)
    events = [{"provider": "p", "vehicleId": "v0", "lat": 42.36,
               "lon": -71.05, "speedKmh": 1.0, "ts": T_NOW}]
    rt = run_shard(tmp_path, events, MemoryStore(), "wm", shards=2,
                   index=0)
    # the shard published its watermark; the JAX package reads the file
    assert shard_watermarks_from(chan, max_age_s=60.0).get("shard0") \
        == rt.max_event_ts == T_NOW
    assert jax_watermarks(chan, max_age_s=60.0) == {"shard0": T_NOW}

    publish_shard_watermark(chan, "shard1", T_NOW - 500)
    rt._shard_wm_read_last = 0.0
    assert rt._effective_max_ts() == T_NOW - 500
    assert rt._g_shard_wm_lag.value == 500
    # monotone: a peer republishing an OLDER watermark (a resume from an
    # older commit) holds the cutoff, never moves it back
    publish_shard_watermark(chan, "shard1", T_NOW - 900)
    rt._shard_wm_read_last = 0.0
    assert rt._effective_max_ts() == T_NOW - 500
    # a stale straggler drops out of the bound
    with open(shard_watermark_path(chan, "shard1"), "w") as fh:
        json.dump({"max_event_ts": T_NOW - 9000,
                   "updated_unix": time.time() - 3600}, fh)
    rt._shard_wm_read_last = 0.0
    assert rt._effective_max_ts() == T_NOW
    assert rt._g_shard_wm_lag.value == 0


def test_governed_shards_converge_apart_results_identical(tmp_path):
    """Two governed shards under skewed load converge to different
    buckets (each governs off its own fill), while the merged docs equal
    the ungoverned fleet's; only the breach signal is scripted."""
    from heatmap_tpu_torch.stream.events import columns_from_arrays

    rng = np.random.default_rng(5)
    cand = np.stack([42.30 + rng.uniform(0, 0.2, 48),
                     -71.20 + rng.uniform(0, 0.2, 48)], axis=1)
    owned0, _, _ = ShardMap(2, 0, snap_res=8).filter_columns(
        columns_from_arrays(
            cand[:, 0].astype(np.float32), cand[:, 1].astype(np.float32),
            np.zeros(48, np.float32), np.full(48, T_NOW, np.int64),
            vehicle_id=np.arange(48, dtype=np.int32),
            vehicles=[str(i) for i in range(48)]))
    mine0 = {int(v) for v in owned0.vehicle_id}
    heavy = [i for i in range(48) if i in mine0][:12]
    light = [i for i in range(48) if i not in mine0][:3]
    assert len(heavy) == 12 and len(light) == 3

    def ev(slot, k, t, lat=None):
        return {"provider": "p", "vehicleId": f"veh-{slot}",
                "lat": float(cand[slot, 0]) if lat is None else lat,
                "lon": float(cand[slot, 1]),
                "speedKmh": (k % 320) * 0.25, "bearing": 0.0,
                "accuracyM": 5.0, "ts": t}

    events = [ev(heavy[k % 12] if k % 5 else light[k % 3], k,
                 T_NOW + k % 120) for k in range(5 * BATCH)]
    events.append(ev(heavy[0], 1, T_NOW + 130, lat=95.0))
    events += [ev(heavy[1], 7, T_NOW + 200) for _ in range(8)]
    events += [ev(heavy[i % 12], i, T_NOW - 3600) for i in range(24)]

    class _Clk:
        t = 1000.0

        def __call__(self):
            return self.t

    def run_fleet(governed):
        store = MemoryStore()
        view = TileMatView(delta_log=4096, pyramid_levels=2)
        rts, srcs = [], []
        for i in range(2):
            cfg = load_config({}, **_axes(
                tmp_path, f"gv{int(governed)}-{i}", h3_res=8,
                resolutions=(8,), emit_flush_k=1, shards=2, shard_index=i,
                shard_oversample=1, govern=governed, govern_min_batch=64,
                govern_interval_s=1e-3))
            src = MemorySource(copy.deepcopy(events))
            src.finish()
            rt = MicroBatchRuntime(cfg, src, store, device="cpu",
                                   checkpoint_every=0, view=view)
            if governed:
                rt.governor.clock = _Clk()
                rt.governor._last_decide = rt.governor.clock.t
            rts.append(rt)
            srcs.append(src)
        live, rounds = [True, True], 0
        while any(live):
            for i, rt in enumerate(rts):
                if not live[i]:
                    continue
                if governed and rounds < 4:
                    h = rt.telemetry.event_age.labels(bound="mean")
                    h.observe(999.0)
                    h.observe(999.0)
                if governed and 1 <= rounds <= 4:
                    rt.governor.clock.t += 1.0
                if not rt.step_once() and srcs[i].exhausted:
                    live[i] = False
            rounds += 1
        for rt in rts:
            rt.close()
        return rts, store

    rts_g, store_g = run_fleet(True)
    rts_u, store_u = run_fleet(False)
    gov0, gov1 = rts_g[0].governor, rts_g[1].governor
    assert gov0.batch_rows == BATCH, gov0.snapshot()
    assert gov1.batch_rows == 64, gov1.snapshot()
    for rt in rts_g:
        assert rt.runtimeinfo.compile.snapshot()[
            "retraces_after_warmup"] == 0
    assert len(store_g._tiles) > 10
    assert store_g._tiles == store_u._tiles
    assert store_g._positions == store_u._positions
    for rt_g, rt_u in zip(rts_g, rts_u):
        assert rt_g.max_event_ts == rt_u.max_event_ts
        for key in ("events_valid", "events_late", "events_invalid",
                    "events_out_of_shard"):
            assert rt_g.counters.get(key, 0) == rt_u.counters.get(key, 0)


# --- C8: ownership keyed on the fold's own cells ---------------------------

RES_EDGE = 9


def _edge_events(n_points=200_000, want=24):
    """Events at seeded global points where the kernel's arithmetic (the
    plain snap) and the host snap disagree AND the two cells hash to
    different shards of 2, each with a companion event at the centre of
    its kernel cell (where both snaps agree): keyed on the host snap, the
    edge row's shard and the companion's shard would both emit that
    cell's tile."""
    rng = np.random.default_rng(20261018)
    lat = np.degrees(np.arcsin(rng.uniform(-0.95, 0.95, n_points)))
    lng = rng.uniform(-180, 180, n_points)
    base = [{"provider": "p", "vehicleId": f"e{i}", "lat": float(lat[i]),
             "lon": float(lng[i]), "speedKmh": 10.0, "ts": T_NOW}
            for i in range(n_points)]
    cols = parse_events(base, {}, {})
    hi, lo = snap_kernel.latlng_to_cell_kernel(
        torch.from_numpy(cols.lat_rad), torch.from_numpy(cols.lng_rad),
        RES_EDGE)
    kern = join_words(hi.numpy(), lo.numpy())
    host = ShardMap(1, 0, RES_EDGE).cells_of(cols.lat_rad, cols.lng_rad)
    sm = ShardMap(2, 0, RES_EDGE)
    split = np.flatnonzero((kern != host) & (sm.shard_of_cells(kern)
                                             != sm.shard_of_cells(host)))
    assert len(split) >= want, len(split)
    events = []
    for j, i in enumerate(split[:want]):
        clat, clng = thost.cell_to_latlng(int(kern[i]))
        events.append(dict(base[i], vehicleId=f"edge{j}"))
        events.append(dict(base[i], vehicleId=f"centre{j}", lat=clat,
                           lon=clng))
    return events, kern[split[:want]]


def test_edge_rows_stay_in_one_shard_on_the_device_route(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("HEATMAP_H3_IMPL", "pallas")
    events, kcells = _edge_events()
    # the hazard is in the data: each edge row's host cell and kernel
    # cell lie in different shards' spaces, and both snaps put the
    # companion in the kernel cell
    ecols = parse_events(events, {}, {})
    hi, lo = snap_kernel.latlng_to_cell_kernel(
        torch.from_numpy(ecols.lat_rad), torch.from_numpy(ecols.lng_rad),
        RES_EDGE)
    kern = join_words(hi.numpy(), lo.numpy())
    host = ShardMap(1, 0, RES_EDGE).cells_of(ecols.lat_rad, ecols.lng_rad)
    np.testing.assert_array_equal(kern[0::2], kcells)
    np.testing.assert_array_equal(kern[1::2], kcells)
    np.testing.assert_array_equal(host[1::2], kcells)
    assert (host[0::2] != kcells).all()

    kw = dict(h3_res=RES_EDGE, resolutions=(RES_EDGE,), store="jsonl",
              query_view=False, checkpoint_dir=str(tmp_path / "fleet"))
    for i in range(2):
        cfg = load_config({}, **_axes(tmp_path, "edge", shards=2,
                                      shard_index=i, shard_oversample=1,
                                      **kw))
        src = MemorySource(copy.deepcopy(events))
        src.finish()
        store = make_store(cfg)
        rt = MicroBatchRuntime(cfg, src, store, device="cpu",
                               checkpoint_every=0)
        assert rt.snap_impl == "pallas"
        rt.run()
        store.close()
    ids = []
    for i in range(2):
        log_ = JsonlStore(str(tmp_path / "fleet" / f"shard{i}"))
        ids.append(set(log_._tiles))
        log_.close()
    assert ids[0] and ids[1]
    assert not ids[0] & ids[1], sorted(ids[0] & ids[1])[:4]
    # the merged read equals one unsharded device-route fold: one doc a
    # kernel cell, holding both of its rows
    single = MemoryStore()
    run_shard(tmp_path, events, single, "edge-one", h3_res=RES_EDGE,
              resolutions=(RES_EDGE,), query_view=False)
    reader = make_store(load_config({"HEATMAP_SHARDS": "2"}, **kw),
                        writer=False)
    assert reader._tiles == single._tiles
    assert len(single._tiles) == len(kcells)
    assert all(d["count"] == 2 for d in single._tiles.values())
    reader.close()


@pytest.mark.parametrize("crash_after", [1, 3])
def test_crashed_shard_over_a_flaky_store_replays_to_the_fold(tmp_path,
                                                             crash_after):
    """The resume chaos with the port's fault injectors: shard 1 of 2 dies
    mid-stream (``CrashingSource``), both shards write through a store
    that fails transiently (``FlakyStore``, the writer's retries absorb
    it), and a fresh shard 1 resumes from its own namespace: the merged
    store equals the unsharded fold's, doc for doc."""
    from heatmap_tpu_torch.testing.faults import (CrashingSource,
                                                  FlakyStore, InjectedCrash)

    events = mk_stream()
    base = MemoryStore()
    run_shard(tmp_path, events, base, "chaos-base")
    flaky = FlakyStore(MemoryStore(), fail_rate=0.3, seed=crash_after)
    kw = _axes(tmp_path, "chaos", shards=2, shard_oversample=1)

    def shard(i, wrap=None):
        src = MemorySource(copy.deepcopy(events))
        src.finish()
        rt = MicroBatchRuntime(load_config({}, shard_index=i, **kw),
                               wrap(src) if wrap else src, flaky,
                               device="cpu", checkpoint_every=1)
        rt.writer.backoff_s = 0.01
        return rt

    shard(0).run()
    with pytest.raises(InjectedCrash):
        shard(1, lambda s: CrashingSource(s, crash_after)).run()
    resumed = shard(1)
    assert resumed.epoch > 0
    resumed.run()
    assert flaky.injected > 0
    assert flaky.inner._tiles == base._tiles
    assert flaky.inner._positions == base._positions


def test_broken_store_poisons_the_writer():
    """The port's ``BrokenStore`` fails every write: the writer gives up
    after its retries, is poisoned and refuses more, as the JAX package's
    does over its own copy."""
    from heatmap_tpu.sink import AsyncWriter as JaxAsyncWriter
    from heatmap_tpu.testing.faults import BrokenStore as JaxBrokenStore
    from heatmap_tpu_torch.sink.writer import AsyncWriter
    from heatmap_tpu_torch.testing.faults import BrokenStore

    for writer_cls, store_cls in ((AsyncWriter, BrokenStore),
                                  (JaxAsyncWriter, JaxBrokenStore)):
        w = writer_cls(store_cls(), retries=1, backoff_s=0.01)
        w.submit_tiles([{"_id": "x"}])
        with pytest.raises(RuntimeError):
            w.drain()
        assert w.poisoned
        with pytest.raises(RuntimeError):
            w.submit_tiles([{"_id": "y"}])
