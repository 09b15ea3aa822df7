"""The port's Kalman reducer (``heatmap_tpu_torch.infer``) against the JAX
package's (``heatmap_tpu.infer``), on the CPU.

Every input is made with numpy from a seed and handed to both packages.
The JAX side runs as its own tests run it (XLA on the CPU); the port's
rounds scan runs its plain version (``filter_rounds_reference``), which is
what ``csrc/kalman_rounds.cu`` is held to, bit for bit, on the card
(``chip_smoke.py``'s ``infer`` phase).

The bars:

- **The rounds scan** (``filter_rounds``): the teleport lanes are equal;
  x, P, NIS, speed and innovation agree within rtol 1e-5 and atol 1e-3 in
  metres, m/s and m^2 (``assert_rounds_close``).  XLA on the CPU contracts
  some products and sums into FMAs and the port rounds each op on its own,
  so the two differ in the last bits of a lane, and those differences
  carry through the rounds scaled by the state's magnitude (up to ~1e5 m
  on the teleport lanes).  The reference's own filter cases
  (``tests/test_infer.py``) run against the port unchanged.
- **The entity table** is numpy in both packages: equal arrays.
- **The engine** over a multi-batch fleet corpus (moving, stopping, noisy,
  teleporting, late and duplicated rows), with and without 3 logical
  entity shards: the anomaly lists equal in order, entity, reason, time,
  cell and position, their scores within 1e-3 (score, rounded to 3
  places) and 0.01 km/h (speed, rounded to 2); the table's integer and
  flag lanes equal, its x, P and NIS EWMA within the bar above; the
  ``member_block`` counters equal; the velocity field's cells and counts
  equal, its values within 1e-3 km/h; the forecasts equal.  Within the
  port, one batch, three batches and shuffled rows give byte-identical
  tables (the NIS EWMA within 1e-6: it is rounded to f32 at each batch
  end, as in the reference), fields and forecasts.
- **The host snap** (``native/h3_snap.cpp``, both entries) equals JAX's
  bit for bit, as do the partition's ``parent_cells``, ``_fmix64`` and
  ``shard_of_cells``.
- **The runtimes** with ``reducers=("count", "kalman")`` over one
  stream: the tile docs meet ``test_torch_pipelines.py``'s bars, with
  ``vxKmh``/``vyKmh`` on the same docs and within 0.01 km/h (they are
  rounded to 2 places after an f32 filter); the port's docs with kalman
  off equal its docs with kalman on, velocity columns aside, exactly; a
  commit carrying ``extra-infer.npz`` resumes across the packages both
  ways to the uninterrupted run's docs and table.
"""

import copy
import functools
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_infer
from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.hexgrid import native_snap as jax_native_snap
from heatmap_tpu.infer import engine as jengine
from heatmap_tpu.infer import entities as jentities
from heatmap_tpu.infer import kalman as jkalman
from heatmap_tpu.infer import reducer as jreducer
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MemorySource as JaxMemorySource
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import shardmap as jshardmap
from heatmap_tpu.stream.events import columns_from_arrays as jax_columns
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.hexgrid import native_snap
from heatmap_tpu_torch.infer import engine as tengine
from heatmap_tpu_torch.infer import entities as tentities
from heatmap_tpu_torch.infer import kalman as tkalman
from heatmap_tpu_torch.infer import reducer as treducer
from heatmap_tpu_torch.native import NativeH3Snap
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream import shardmap as tshardmap
from heatmap_tpu_torch.stream.events import columns_from_arrays, parse_events
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import MemorySource, SyntheticSource
from test_torch_pipelines import snap_touched
from test_torch_stream import REPO, _pin_reference

RTOL, ATOL = 1e-5, 1e-3          # the rounds scan's bar (module docstring)
KW = dict(q=0.5, r_m=25.0, gate=13.816, p0_pos=625.0, p0_vel=100.0)
T0 = 1_700_000_000
LAT0, LNG0 = 42.30, -71.15
_VEL = ("vxKmh", "vyKmh")


def assert_rounds_close(got, ref):
    """(x, P, nis, tele, spd, inn) of the two packages under the bar."""
    names = ("x", "P", "nis", "tele", "spd", "inn")
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "tele":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=name)


# --- the rounds scan ---------------------------------------------------------

def rounds_corpus(seed, k, m):
    """A seeded (K, M) corpus: random states and covariances, invalid and
    reseed lanes, teleports far above the gate, dt of 0 and below 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 30, (m, 4)).astype(np.float32)
    a = rng.normal(0, 1, (m, 4, 4))
    P = (a @ a.transpose(0, 2, 1) * 40 + np.eye(4) * 100).astype(np.float32)
    # a constant-velocity walk plus GPS noise, so most rounds update
    v = rng.normal(0, 8, (m, 2))
    t = np.cumsum(rng.uniform(1, 10, (k, m)), axis=0)
    z = (x[None, :, :2] + v[None] * t[..., None]
         + rng.normal(0, 15, (k, m, 2))).astype(np.float32)
    jump = rng.random((k, m)) < 0.04
    z[jump] += np.float32(80_000.0)
    dt = np.diff(t, axis=0, prepend=0.0).astype(np.float32)
    dt[rng.random((k, m)) < 0.05] = 0.0
    dt[rng.random((k, m)) < 0.05] *= -1.0
    valid = rng.random((k, m)) < 0.85
    reseed = rng.random((k, m)) < 0.04
    return x, P, z, dt, valid, reseed


@pytest.mark.parametrize("seed,k,m", [(1, 1, 1), (2, 3, 5), (3, 13, 37),
                                      (4, 7, 100), (5, 29, 9)])
def test_filter_rounds_matches_jax(seed, k, m):
    args = rounds_corpus(seed, k, m)
    ref = jkalman.filter_rounds(*args, **KW)
    got = tkalman.filter_rounds(*args, **KW, device="cpu")
    assert_rounds_close(got, ref)
    # the gate fires, though not on every lane (too few lanes to say at 1x1)
    assert not ref[3].all() and (ref[3].any() or k * m < 30)


def test_filter_rounds_tensor_wrapper_takes_the_plain_version_on_cpu():
    """``kalman_rounds`` on CPU tensors is the plain version, and counts no
    launch; a wrong dtype or shape raises."""
    args = rounds_corpus(6, 4, 10)
    ts = [torch.from_numpy(a) for a in args]
    consts = tkalman.filter_consts(**KW)
    before = tkalman.kalman_rounds.launches
    got = tkalman.kalman_rounds(*ts, consts)
    ref = tkalman.filter_rounds_reference(*ts, consts)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert tkalman.kalman_rounds.launches == before
    with pytest.raises(TypeError, match="valid"):
        tkalman.kalman_rounds(*ts[:4], ts[4].float(), ts[5], consts)
    with pytest.raises(ValueError, match="dt"):
        tkalman.kalman_rounds(*ts[:3], ts[3][:, :5], *ts[4:], consts)


@pytest.mark.parametrize("case", [
    "test_kalman_converges_on_constant_velocity",
    "test_kalman_gate_reseeds_on_teleport",
    "test_kalman_handoff_reseed_precedence_over_gate",
    "test_kalman_padding_and_dt_clamp_invariance",
])
def test_reference_filter_cases_hold_for_the_port(monkeypatch, case):
    """The reference's own filter tests, with the port's ``filter_rounds``
    in place of JAX's."""
    monkeypatch.setattr(test_infer, "filter_rounds",
                        functools.partial(tkalman.filter_rounds,
                                          device="cpu"))
    getattr(test_infer, case)()


# --- the entity table --------------------------------------------------------

TABLE_COLS = ("vid", "last_ts", "seed_ts", "owner", "ref", "x", "P",
              "nis_ewma", "n_upd", "moving", "stop_ts", "stop_alerted",
              "dev_alerted")
TABLE_COUNTS = ("occupancy", "n_seeded", "n_evicted_ttl", "n_evicted_lru",
                "n_reseed_handoff", "n_reseed_teleport")


def assert_tables_equal(a, b):
    for col in TABLE_COLS:
        np.testing.assert_array_equal(getattr(a, col), getattr(b, col),
                                      err_msg=col)
    assert a.names == b.names
    for c in TABLE_COUNTS:
        assert getattr(a, c) == getattr(b, c), c


def test_entity_table_matches_jax():
    """Seed, lookup, TTL and LRU eviction, the same calls on both tables:
    equal arrays after each."""
    tabs = [jentities.EntityTable(8), tentities.EntityTable(8)]
    lat = np.full(8, LAT0, np.float32)
    lng = np.full(8, LNG0, np.float32)
    for t in tabs:
        t.seed(np.arange(8, dtype=np.int64), [f"v{i}" for i in range(8)],
               lat, lng, np.arange(1000, 1008, dtype=np.int64),
               np.zeros(8, np.int16), now_ts=1008, ttl_s=900.0,
               p0_pos=625.0, p0_vel=100.0)
    assert_tables_equal(*tabs)
    assert [t.evict_ttl(now_ts=1004 + 900, ttl_s=900.0) for t in tabs] \
        == [4, 4]
    assert_tables_equal(*tabs)
    new = np.arange(8, 14, dtype=np.int64)
    for t in tabs:
        t.seed(new, [f"v{i}" for i in new], lat[:6], lng[:6],
               np.full(6, 1500, np.int64), np.zeros(6, np.int16),
               now_ts=1500, ttl_s=900.0, p0_pos=625.0, p0_vel=100.0)
    assert_tables_equal(*tabs)
    assert tabs[1].n_evicted_lru == 2
    probe = np.arange(16, dtype=np.int64)
    np.testing.assert_array_equal(tabs[0].slots_of(probe),
                                  tabs[1].slots_of(probe))
    with pytest.raises(ValueError, match=">= 8"):
        tentities.EntityTable(4)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_entity_table_snapshot_restores_across_packages(direction):
    """A snapshot of either table restores into the other (names are the
    key), whole and into a smaller capacity (the newest kept)."""
    src_mod, dst_mod = ((jentities, tentities) if direction == "jax_to_port"
                        else (tentities, jentities))
    src = src_mod.EntityTable(16)
    vids = np.arange(12, dtype=np.int64)
    src.seed(vids, [f"veh-{i}" for i in range(12)],
             np.full(12, LAT0, np.float32), np.full(12, LNG0, np.float32),
             np.arange(100, 112, dtype=np.int64),
             np.arange(12, dtype=np.int16) % 3, now_ts=112, ttl_s=900.0,
             p0_pos=625.0, p0_vel=100.0)
    src.x[src.slots_of(vids)] = np.arange(48, dtype=np.float32).reshape(12, 4)
    snap = src.snapshot()
    for cap in (16, 8):
        ref_t, got_t = src_mod.EntityTable(cap), dst_mod.EntityTable(cap)
        ref_i, got_i = {}, {}
        assert (ref_t.restore(snap, ref_i, n_part=3)
                == got_t.restore(snap, got_i, n_part=3) == min(cap, 12))
        assert ref_i == got_i
        assert_tables_equal(ref_t, got_t)


# --- the engine --------------------------------------------------------------

def fleet_corpus(seed=7, n_veh=40, rounds=40, cadence=5, hazards=True):
    """Columns (numpy) of a fleet moving through the city at up to 15 m/s,
    one report per vehicle and round with 10% missed: a third stop part
    way (stopped anomalies), every seventh accelerates at 1 m/s^2 for its
    first 100 s (deviation), and with ``hazards`` two report 70 m noise,
    vehicle 0 teleports 60 km at round 25 and stays, and some rows are
    duplicated and some an hour late (appended at the end)."""
    rng = np.random.default_rng(seed)
    lat0 = LAT0 + 0.1 * rng.random(n_veh)
    lng0 = LNG0 + 0.15 * rng.random(n_veh)
    cos0 = np.cos(np.radians(lat0))
    vel = rng.uniform(-15, 15, (n_veh, 2))
    stop_at = np.where(rng.random(n_veh) < 0.33,
                       rng.integers(8, max(rounds // 2, 9), n_veh), rounds)
    acc = np.where(np.arange(n_veh) % 7 == 3, 1.0, 0.0)
    noise = np.where(hazards & (np.arange(n_veh) % 19 == 5), 70.0, 6.0)
    rows = []
    for r in range(rounds):
        for i in range(n_veh):
            if rng.random() < 0.1:
                continue
            tt = min(r, stop_at[i]) * cadence
            ta = min(tt, 100)
            d = vel[i] * tt + vel[i] / np.hypot(*vel[i]) * acc[i] * (
                0.5 * ta * ta + 100 * (tt - ta))
            dn, de = d + rng.normal(0, noise[i], 2)
            if hazards and i == 0 and r >= 25:
                dn += 60_000.0
            moving = r < stop_at[i]
            rows.append((lat0[i] + dn / tkalman.M_PER_DEG,
                         lng0[i] + de / (tkalman.M_PER_DEG * cos0[i]),
                         float(np.hypot(*vel[i]) * 3.6) if moving else 0.0,
                         T0 + r * cadence, i))
    if hazards:
        rows += [rows[j] for j in rng.integers(0, len(rows), 12)]
        for j in rng.integers(0, len(rows), 10):
            lat, lng, spd, ts, v = rows[j]
            rows.append((lat, lng, spd, ts - 3600, v))
    lat, lng, spd, ts, vid = map(np.asarray, zip(*rows))
    return dict(lat=lat, lng=lng, spd=spd, ts=ts.astype(np.int64),
                vid=vid.astype(np.int32),
                names=[f"veh-{i}" for i in range(n_veh)])


def corpus_batches(c, sel_list, mod):
    make = jax_columns if mod is jengine else columns_from_arrays
    return [make(c["lat"][s], c["lng"][s], c["spd"][s], c["ts"][s],
                 vehicle_id=c["vid"][s], vehicles=c["names"])
            for s in sel_list]


def engine_cfgs(**kw):
    kw = dict(reducers=("count", "kalman"), entity_stop_s=60.0, **kw)
    return (jax_load_config({}, store="memory", **kw),
            load_config({}, store="memory", **kw))


def fold_both(batches_of, **cfg_kw):
    """Both engines over the same batches; (jax, port, anomalies each)."""
    jcfg, tcfg = engine_cfgs(**cfg_kw)
    engines = (jengine.InferenceEngine(jcfg),
               tengine.InferenceEngine(tcfg, device="cpu"))
    anoms = ([], [])
    for eng, mod, out in zip(engines, (jengine, tengine), anoms):
        for cols in batches_of(mod):
            eng.fold_batch(cols)
            out.extend(eng.drain_anomalies())
    return engines[0], engines[1], anoms


def assert_engines_agree(je, te, janoms, tanoms, res=8):
    key = lambda e: (e["entity"], e["reason"], e["t"], e["cell"], e["lat"],
                     e["lon"])
    assert [key(e) for e in tanoms] == [key(e) for e in janoms]
    for a, b in zip(tanoms, janoms):
        assert abs(a["score"] - b["score"]) <= 1e-3 + 1e-5 * abs(b["score"])
        assert abs(a["speedKmh"] - b["speedKmh"]) <= 0.01 + 1e-9
    jt, tt = je.table, te.table
    for col in ("vid", "last_ts", "seed_ts", "owner", "ref", "n_upd",
                "moving", "stop_ts", "stop_alerted", "dev_alerted"):
        np.testing.assert_array_equal(getattr(tt, col), getattr(jt, col),
                                      err_msg=col)
    assert tt.names == jt.names
    for col in ("x", "P", "nis_ewma"):
        np.testing.assert_allclose(getattr(tt, col), getattr(jt, col),
                                   rtol=RTOL, atol=ATOL, err_msg=col)
    jb, tb = je.member_block(), te.member_block()
    jb.pop("last_fold_ms"), tb.pop("last_fold_ms")
    assert tb == jb
    jv, tv = je.velocity_field(res), te.velocity_field(res)
    assert tv.keys() == jv.keys() and tv
    for c, (vx, vy, n) in tv.items():
        assert n == jv[c][2]
        np.testing.assert_allclose((vx, vy), jv[c][:2], rtol=1e-5, atol=1e-3)
    for h in (0.0, 120.0, 600.0):
        assert te.forecast_cells(h, res) == je.forecast_cells(h, res)


@pytest.mark.parametrize("entity_shards", [0, 3])
def test_engine_matches_jax_over_a_fleet(entity_shards):
    c = fleet_corpus()
    n = len(c["ts"])
    cuts = [0, n // 5, n // 2, (3 * n) // 4, n]
    sels = [slice(a, b) for a, b in zip(cuts, cuts[1:])]
    je, te, (ja, ta) = fold_both(lambda mod: corpus_batches(c, sels, mod),
                                 entity_shards=entity_shards)
    assert_engines_agree(je, te, ja, ta)
    # the corpus reaches every detector, and the partition hands off
    reasons = {e["reason"] for e in ta}
    assert reasons == {"teleport", "stopped", "deviation"}, reasons
    if entity_shards:
        assert te.partition is not None and te.n_part == 3
        assert te.table.n_reseed_handoff == je.table.n_reseed_handoff > 0
        assert set(te.table.owner[te.table.vid >= 0]) == {0, 1, 2}
    else:
        assert te.partition is None and te.table.n_reseed_handoff == 0


def test_engine_untracked_overflow_matches_jax():
    """More new entities in one batch than the table holds: the rest fold
    as untracked, counted, in both packages."""
    c = fleet_corpus(seed=3, n_veh=20, rounds=3)
    allrows = [slice(None)]
    je, te, (ja, ta) = fold_both(lambda mod: corpus_batches(c, allrows, mod),
                                 entity_capacity=8)
    assert te.counters["infer_entities_untracked"] == 12
    assert te.table.occupancy == 8
    assert_engines_agree(je, te, ja, ta)


def test_engine_rebatching_byte_identity():
    """Within the port: one batch, three batches and shuffled rows give
    byte-identical tables, velocity fields and forecasts, and the same
    anomaly multiset."""
    c = fleet_corpus(seed=11, n_veh=25, rounds=24, hazards=False)
    n = len(c["ts"])
    # unique (vehicle, ts) rows: any permutation keeps each entity's order
    splits = ([slice(0, n)],
              [slice(0, n // 3), slice(n // 3, 2 * n // 3),
               slice(2 * n // 3, n)],
              [np.random.default_rng(5).permutation(n)])
    engines, anoms = [], []
    for sels in splits:
        eng = tengine.InferenceEngine(engine_cfgs()[1], device="cpu")
        out = []
        for cols in corpus_batches(c, sels, tengine):
            eng.fold_batch(cols)
            out.extend(eng.drain_anomalies())
        engines.append(eng)
        anoms.append(sorted((e["entity"], e["reason"], e["t"], e["cell"],
                             e["score"]) for e in out))
    base = engines[0]
    vids = np.arange(25)
    for eng, an in zip(engines[1:], anoms[1:]):
        a, b = base.table.slots_of(vids), eng.table.slots_of(vids)
        for col in ("x", "P", "n_upd", "last_ts", "moving", "stop_ts",
                    "stop_alerted", "dev_alerted"):
            np.testing.assert_array_equal(getattr(base.table, col)[a],
                                          getattr(eng.table, col)[b])
        # the NIS EWMA runs in f64 within a batch and is stored as f32
        # between batches (as in the reference), so a batch boundary
        # rounds it once more: within 1e-6 relative, not bit for bit
        np.testing.assert_allclose(base.table.nis_ewma[a],
                                   eng.table.nis_ewma[b], rtol=1e-6)
        assert base.velocity_field(8) == eng.velocity_field(8)
        assert base.forecast_cells(300.0, 8) == eng.forecast_cells(300.0, 8)
        assert an == anoms[0]


@pytest.mark.parametrize("case", [
    "test_engine_velocity_field_and_forecast_advect_north",
    "test_engine_stopped_anomaly_edge_triggered",
    "test_engine_teleport_anomaly_and_reseed_accounting",
    "test_engine_snapshot_restore_equals_uninterrupted",
    "test_engine_member_block_conservation",
    "test_entity_table_seed_lookup_ttl_lru",
    "test_entity_table_snapshot_restore_roundtrip",
])
def test_reference_engine_cases_hold_for_the_port(monkeypatch, case):
    """The reference's own engine and table tests, with the port's
    engine, table, columns and config in place of JAX's."""
    def cfg(**kw):
        kw.setdefault("store", "memory")
        kw.setdefault("reducers", ("count", "kalman"))
        return load_config({}, **kw)

    monkeypatch.setattr(test_infer, "_cfg", cfg)
    monkeypatch.setattr(test_infer, "InferenceEngine",
                        functools.partial(tengine.InferenceEngine,
                                          device="cpu"))
    monkeypatch.setattr(test_infer, "EntityTable", tentities.EntityTable)
    monkeypatch.setattr(test_infer, "columns_from_arrays",
                        columns_from_arrays)
    getattr(test_infer, case)()


def test_engine_snapshot_restores_across_packages():
    """Half the corpus in one package, its snapshot restored into the
    other, the rest folded there: the same table as the other package's
    uninterrupted fold, both ways."""
    c = fleet_corpus(seed=13, n_veh=30, rounds=24)
    n = len(c["ts"])
    halves = [slice(0, n // 2), slice(n // 2, n)]
    jcfg, tcfg = engine_cfgs()
    for first, second in ((jengine, tengine), (tengine, jengine)):
        make = lambda mod: (jengine.InferenceEngine(jcfg) if mod is jengine
                            else tengine.InferenceEngine(tcfg,
                                                         device="cpu"))
        solid = make(second)
        for cols in corpus_batches(c, halves, second):
            solid.fold_batch(cols)
        head = make(first)
        head.fold_batch(corpus_batches(c, halves[:1], first)[0])
        tail = make(second)
        intern = {}
        assert tail.restore(head.snapshot(), intern) == 30
        s = halves[1]
        re_vid = np.asarray([intern[c["names"][v]] for v in c["vid"][s]],
                            np.int32)
        mk = jax_columns if second is jengine else columns_from_arrays
        tail.fold_batch(mk(c["lat"][s], c["lng"][s], c["spd"][s],
                           c["ts"][s], vehicle_id=re_vid,
                           vehicles=list(intern)))
        a = solid.table.slots_of(np.arange(30))
        b = tail.table.slots_of(np.asarray(
            [intern[f"veh-{i}"] for i in range(30)], np.int64))
        for col in ("x", "P"):
            np.testing.assert_allclose(getattr(tail.table, col)[b],
                                       getattr(solid.table, col)[a],
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(tail.table.n_upd[b],
                                      solid.table.n_upd[a])
        assert tail.forecast_cells(300.0, 8) == solid.forecast_cells(300.0, 8)


# --- the host snap and the partition ----------------------------------------

def snap_points(region, n=20_000, seed=17):
    rng = np.random.default_rng(seed)
    if region == "city":
        lat, lng = rng.uniform(42.2, 42.5, n), rng.uniform(-71.3, -70.8, n)
    else:
        lat, lng = rng.uniform(-89.9, 89.9, n), rng.uniform(-180, 180, n)
    return (np.radians(lat).astype(np.float32),
            np.radians(lng).astype(np.float32))


@pytest.mark.parametrize("region", ["city", "global"])
@pytest.mark.parametrize("res", [7, 8, 9, 10])
def test_host_snap_matches_jax(region, res):
    """Block path (AVX-512 where the CPU has it) and scalar path, each
    bit for bit against JAX's native snap."""
    lat, lng = snap_points(region)
    ref = jax_native_snap.snap_arrays(lat, lng, res)
    snap = NativeH3Snap()
    for scalar in (False, True):
        hi, lo = snap.snap(lat, lng, res, scalar=scalar)
        np.testing.assert_array_equal(hi, ref[0])
        np.testing.assert_array_equal(lo, ref[1])
    got = native_snap.snap_arrays(lat, lng, res)
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("n_shards,parent_res", [(3, -1), (4, 6), (7, 8)])
def test_shard_partition_matches_jax(n_shards, parent_res):
    lat, lng = snap_points("city")
    jm = jshardmap.ShardMap(n_shards, 0, 8, parent_res)
    tm = tshardmap.ShardMap(n_shards, 0, 8, parent_res)
    cells = tm.cells_of(lat, lng)
    np.testing.assert_array_equal(cells, jm.cells_of(lat, lng))
    np.testing.assert_array_equal(tm.shard_of_cells(cells),
                                  jm.shard_of_cells(cells))
    for pr in (5, 7):
        np.testing.assert_array_equal(tshardmap.parent_cells(cells, 8, pr),
                                      jshardmap.parent_cells(cells, 8, pr))
    np.testing.assert_array_equal(tshardmap._fmix64(cells),
                                  jshardmap._fmix64(cells))
    with pytest.raises(ValueError, match="HEATMAP_SHARD_RES"):
        tshardmap.ShardMap(n_shards, 0, 8, 9)


# --- config ------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["count", "count,kalman", "kalman,count",
                                  " count , kalman , count ", "kalman",
                                  "count,sgd", ""])
def test_parse_reducers_matches_jax(spec):
    try:
        want = jreducer.parse_reducers(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            treducer.parse_reducers(spec)
        assert str(got.value) == str(e)
    else:
        assert treducer.parse_reducers(spec) == want


@pytest.mark.parametrize("env", [
    {"HEATMAP_REDUCERS": "count,kalman"},
    {"HEATMAP_REDUCERS": "kalman,count", "HEATMAP_ENTITY_CAPACITY": "64",
     "HEATMAP_ENTITY_TTL_S": "30.5", "HEATMAP_ENTITY_SHARDS": "3",
     "HEATMAP_ENTITY_STOP_S": "45", "HEATMAP_SHARD_RES": "6"},
    {"HEATMAP_ENTITY_CAPACITY": "4"},
    {"HEATMAP_ENTITY_TTL_S": "0"},
    {"HEATMAP_ENTITY_SHARDS": "-1"},
    {"HEATMAP_ENTITY_STOP_S": "-2"},
    {"HEATMAP_REDUCERS": "kalman"},
    {"HEATMAP_REDUCERS": "count,sgd"},
])
def test_reducer_and_entity_knobs_load_as_in_jax(env):
    """Equal fields, or the same error, from one environment."""
    fields = ("reducers", "entity_capacity", "entity_ttl_s",
              "entity_shards", "entity_stop_s", "shard_res")
    try:
        jcfg = jax_load_config(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            load_config(env)
        assert str(got.value) == str(e)
    else:
        cfg = load_config(env)
        assert ({f: getattr(cfg, f) for f in fields}
                == {f: getattr(jcfg, f) for f in fields})


@pytest.mark.parametrize("reducers", ["count,kalman", "count"])
def test_quality_knob_builds_the_observatory_with_kalman_only(tmp_path,
                                                             reducers):
    """HEATMAP_QUALITY=1 loads (it used to raise naming ROADMAP A5): on a
    kalman runtime it builds the observatory and hands it to the engine's
    fold, as the reference's runtime does; without kalman it builds
    nothing and registers no family."""
    cfg = load_config({"HEATMAP_QUALITY": "1",
                       "HEATMAP_REDUCERS": reducers},
                      checkpoint_dir=str(tmp_path), batch_size=1024,
                      state_capacity_log2=12)
    assert cfg.quality
    rt = MicroBatchRuntime(cfg, SyntheticSource(n_events=8), MemoryStore(),
                           device="cpu", checkpoint_every=0)
    try:
        if reducers == "count":
            assert rt.infer is None and rt.quality is None
            assert "heatmap_quality_" not in rt.registry.expose_text()
        else:
            assert rt.quality is not None
            assert rt.infer.quality is rt.quality
            assert ("heatmap_quality_nis_coverage"
                    in rt.registry.expose_text())
    finally:
        rt.close()


# --- the runtimes ------------------------------------------------------------

RT_SOURCE = dict(n_events=12 * 1024, n_vehicles=300, events_per_second=64,
                 t0=T0)
RT_AXES = dict(city="bos", h3_res=8, resolutions=(8,), windows_minutes=(5,),
               batch_size=1024, state_capacity_log2=13,
               reducers=("count", "kalman"))
N_RT = RT_SOURCE["n_events"]


def stream_events():
    """The runtimes' stream as event dicts (vehicle names intern in the
    runtime, so a commit's entity table resumes by name)."""
    cols = SyntheticSource(**RT_SOURCE).poll(N_RT)
    return [{"provider": "mbta", "vehicleId": cols.vehicles[v],
             "lat": float(la), "lon": float(lo), "speedKmh": float(s),
             "ts": int(t)}
            for la, lo, s, t, v in zip(cols.lat_deg, cols.lng_deg,
                                       cols.speed_kmh, cols.ts_s,
                                       cols.vehicle_id)]


_TOUCHED: dict = {}


def touched(res, win_s):
    if (res, win_s) not in _TOUCHED:
        cols = parse_events(stream_events())
        _TOUCHED[res, win_s] = snap_touched(cols.lat_rad, cols.lng_rad,
                                            cols.ts_s, res, win_s)
    return _TOUCHED[res, win_s]


def assert_docs_match_with_velocity(ref_docs, docs, cfg):
    """``test_torch_pipelines.py``'s bars on the count fields, and the
    velocity columns on the same docs within 0.01 km/h."""
    from test_torch_pipelines import assert_pair_docs_match

    strip = lambda ds: {k: {f: v for f, v in d.items() if f not in _VEL}
                        for k, d in ds.items()}
    assert_pair_docs_match(strip(ref_docs), strip(docs), cfg, N_RT, touched)
    bad, _ = touched(8, 300)
    key = lambda d: (d["cellId"], int(d["windowStart"].timestamp()))
    ref = {key(d): d for d in ref_docs.values()}
    n_vel = 0
    for d in docs.values():
        if key(d) in bad:
            continue
        r = ref[key(d)]
        assert (_VEL[0] in d) == (_VEL[0] in r), key(d)
        if _VEL[0] in d:
            n_vel += 1
            for f in _VEL:
                assert abs(d[f] - r[f]) <= 0.01 + 1e-9, (key(d), f)
    assert n_vel > 50


def port_rt(ckpt, store, events, every=0, **over):
    cfg = load_config(None, checkpoint_dir=str(ckpt),
                      **dict(RT_AXES, **over))
    src = MemorySource(events)
    src.finish()
    return MicroBatchRuntime(cfg, src, store, device="cpu",
                             checkpoint_every=every)


def jax_rt(ckpt, store, events, every=0, **over):
    cfg = jax_load_config(None, checkpoint_dir=str(ckpt), store="memory",
                          **dict(RT_AXES, **over))
    src = JaxMemorySource(events)
    src.finish()
    return JaxRuntime(cfg, src, store, checkpoint_every=every)


_RUNS: dict = {}


def uninterrupted(tmp_path_factory, pkg, flush_k=8):
    """Each package's uninterrupted kalman run with an emit ring
    ``flush_k`` deep (cached for the module): (docs, runtime)."""
    if (pkg, flush_k) not in _RUNS:
        make, store = ((port_rt, MemoryStore()) if pkg == "port"
                       else (jax_rt, JaxMemoryStore()))
        rt = make(tmp_path_factory.mktemp(pkg), store, stream_events(),
                  emit_flush_k=flush_k)
        rt.run()
        _RUNS[pkg, flush_k] = (store._tiles, rt)
    return _RUNS[pkg, flush_k]


def table_by_name(t):
    return {t.names[int(s)]: int(s) for s in np.nonzero(t.vid >= 0)[0]}


def assert_tables_close_by_name(a, b):
    na, nb = table_by_name(a), table_by_name(b)
    assert na.keys() == nb.keys() and na
    sa = np.asarray([na[k] for k in sorted(na)])
    sb = np.asarray([nb[k] for k in sorted(na)])
    for col in ("x", "P", "nis_ewma"):
        np.testing.assert_allclose(getattr(a, col)[sa], getattr(b, col)[sb],
                                   rtol=RTOL, atol=ATOL, err_msg=col)
    for col in ("last_ts", "n_upd", "moving", "stop_ts"):
        np.testing.assert_array_equal(getattr(a, col)[sa],
                                      getattr(b, col)[sb], err_msg=col)


def test_runtime_with_kalman_matches_jax(tmp_path_factory, monkeypatch):
    _pin_reference(monkeypatch, {})
    ref_docs, jrt = uninterrupted(tmp_path_factory, "jax")
    docs, rt = uninterrupted(tmp_path_factory, "port")
    assert rt.infer is not None and rt.cfg.reducers == ("count", "kalman")
    assert_docs_match_with_velocity(ref_docs, docs, rt.cfg)
    assert_tables_close_by_name(rt.infer.table, jrt.infer.table)
    jb, tb = jrt.infer.member_block(), rt.infer.member_block()
    for b in (jb, tb):
        b.pop("last_fold_ms")
    assert tb == jb and tb["anomalies"]["teleport"] > 0
    assert rt.counters["infer_events_folded"] == N_RT
    # the infer span: one per batch
    assert len(rt.span_ms["infer"]) == rt.counters["batches"] == 12
    assert rt.metrics["p50_span_ms"]["infer"] > 0


def test_count_docs_identical_with_kalman_on_and_off(tmp_path,
                                                     tmp_path_factory,
                                                     monkeypatch):
    _pin_reference(monkeypatch, {})
    on_docs, on_rt = uninterrupted(tmp_path_factory, "port")
    store = MemoryStore()
    off = port_rt(tmp_path, store, stream_events(),
                  reducers=("count",))
    off.run()
    assert off.infer is None and not off.span_ms["infer"]
    assert not any(_VEL[0] in d for d in store._tiles.values())
    strip = {k: {f: v for f, v in d.items() if f not in _VEL}
             for k, d in on_docs.items()}
    assert strip == store._tiles
    assert any(_VEL[0] in d for d in on_docs.values())
    assert store._positions == on_rt.store._positions
    same = ("batches", "events_valid", "events_late", "tiles_emitted",
            "positions_emitted", "checkpoints")
    assert ({k: off.counters[k] for k in same}
            == {k: on_rt.counters[k] for k in same})
    assert off.pulls == on_rt.pulls


def _killed_after_commit(rt, batches=6):
    """``batches`` batches (a commit every 4), the commit joined, the
    runtime abandoned."""
    for _ in range(batches):
        assert rt.step_once()
    rt._ckpt_join()
    rt.writer.drain()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_kalman_commit_resumes_across_packages(tmp_path, tmp_path_factory,
                                               monkeypatch, direction):
    """A commit of one package (window state, offsets and
    ``extra-infer.npz``) resumed by the other reaches the resumer's
    uninterrupted run: docs under the bars, velocity included, the
    entity table by name, the velocity field and the forecasts.  The
    velocity columns are the table's field at each doc's last flush, so
    all runs here flush after every batch (an emit ring 1 deep): the
    resumed run's docs are then last written at the batches the
    uninterrupted run's are."""
    _pin_reference(monkeypatch, {})
    first, second = (("jax", "port") if direction == "jax_to_port"
                     else ("port", "jax"))
    ref_docs, ref_rt = uninterrupted(tmp_path_factory, second, flush_k=1)
    mk = {"port": (port_rt, MemoryStore), "jax": (jax_rt, JaxMemoryStore)}
    store1 = mk[first][1]()
    rt1 = mk[first][0](tmp_path, store1, stream_events(), every=4,
                       emit_flush_k=1)
    _killed_after_commit(rt1)
    extra = rt1.ckpt.load_extra("infer")
    assert extra is not None and len(extra["names"]) == 300
    store2 = mk[second][1]()
    store2.upsert_tiles(copy.deepcopy(list(store1._tiles.values())))
    rt2 = mk[second][0](tmp_path, store2, stream_events(), emit_flush_k=1)
    assert rt2.epoch == 4 and rt2.infer.table.occupancy == 300
    rt2.run()
    assert_docs_match_with_velocity(ref_docs, store2._tiles, ref_rt.cfg)
    assert_tables_close_by_name(rt2.infer.table, ref_rt.infer.table)
    got, want = rt2.infer.velocity_field(8), ref_rt.infer.velocity_field(8)
    assert got.keys() == want.keys() and got
    for c, v in got.items():
        assert v[2] == want[c][2]
        np.testing.assert_allclose(v[:2], want[c][:2], rtol=1e-5, atol=1e-3)
    assert (rt2.infer.forecast_cells(300.0, 8)
            == ref_rt.infer.forecast_cells(300.0, 8))


_KALMAN_ISOLATION = r"""
import sys, tempfile
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
import heatmap_tpu_torch.infer
import heatmap_tpu_torch.hexgrid.native_snap
import heatmap_tpu_torch.stream.shardmap

cfg = load_config({"HEATMAP_REDUCERS": "count,kalman",
                   "HEATMAP_ENTITY_SHARDS": "2"}, batch_size=512,
                  state_capacity_log2=12, checkpoint_dir=tempfile.mkdtemp())
store = MemoryStore()
rt = MicroBatchRuntime(cfg, SyntheticSource(n_events=2048, n_vehicles=50,
                       events_per_second=16), store, device="cpu")
rt.run()
# (vehicle, owner) slots: more than the 50 vehicles once they hand off
assert rt.infer.table.n_reseed_handoff > 0
assert rt.infer.table.occupancy > 50
assert any("vxKmh" in d for d in store._tiles.values())
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "heatmap_tpu" or m.startswith("heatmap_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_kalman_runtime_never_imports_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    p = subprocess.run([sys.executable, "-c", _KALMAN_ISOLATION], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "LEAKED []" in p.stdout


def test_entry_point_with_kalman_writes_velocity_columns(tmp_path):
    """``python -m heatmap_tpu_torch.stream mbta_default --device cpu
    --max-batches 2`` with HEATMAP_REDUCERS=count,kalman into the JSONL
    store: tile docs carry vxKmh/vyKmh."""
    from test_torch_pipelines import _entry_env, _run_entry

    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    closed = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    env = _entry_env(tmp_path, KAFKA_BOOTSTRAP=closed,
                     HEATMAP_REDUCERS="count,kalman", HEATMAP_STORE="jsonl")
    out, _ = _run_entry(env, "mbta_default")
    assert out["infer_events_folded"] == out["events_valid"] == 3 * 1024
    assert out["p50_span_ms"]["infer"] > 0
    with open(tmp_path / "ckpt" / "store.jsonl", encoding="utf-8") as fh:
        lines = [json.loads(x) for x in fh]
    assert any("vxKmh" in json.dumps(x) for x in lines)
    assert os.path.exists(next(
        (tmp_path / "ckpt").glob("commit-*/extra-infer.npz")))
    shutil.rmtree(tmp_path / "ckpt")
