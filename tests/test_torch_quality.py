"""The inference quality observatory of the port
(heatmap_tpu_torch/obs/quality.py) against the JAX package's
(heatmap_tpu/obs/quality.py), on the CPU.

- the knob and the NIS band parse alike; the scoring math (``score_maps``,
  ``mae``, ``normalize``, ``features_to_counts``) is equal on seeded maps;
- one scripted ledger through both observatories, each over its own
  package's view holding the same windows: registration, window advance,
  maturity, the event-time TTL and the bounded pending set keep
  ``registered == scored + expired_unscorable + pending`` at every step,
  with equal identities, skills, counters, checks, member blocks and
  snapshots; the calibration ledger (``note_fold``) the same;
- a card registered before a kill scores after the restart from the
  history tier alone (the scheme of ``tests/test_quality.py:189``), with
  the port's view, feed, history log and compactor; each package restores
  the other's checkpoint payload;
- the port's runtime with ``HEATMAP_QUALITY`` off and on (kalman on):
  tiles, positions, counters and view state equal, no quality family knob
  off, the forecast bodies equal (observe-only), ``/debug/quality`` 200 on
  and the reference's 503 off; a resumed runtime keeps its pending cards;
- one run of each package's runtime over the same events, forecasts asked
  at the same points: the calibration feed of every fold and the
  scorecards against JAX's, to the bounds below;
- ``quality_stamp`` alike.

Bounds of the runtime comparison.  The rounds' floats agree with XLA to
rtol 1e-5 / atol 1e-3 per lane (``tests/test_torch_infer.py``: XLA
contracts multiply-adds the port's plain version rounds one by one), so
per fold: the integer counts (``updates``, the anomalies by reason, the
table's pressure, the event time) are equal exactly; ``inside`` (NIS <=
5.991) may differ only by lanes whose NIS lies on opposite sides of the
gate in the two packages, and each such lane must be within that
tolerance of the gate; each innovation sum may differ by at most atol per
update plus rtol of the summed magnitudes.  The forecast maps are
entities advected and snapped: an entity within float tolerance of a cell
edge may land in the neighbouring cell, so the maps may differ by at most
one entity in a hundred, and a card's skill is compared exactly when its
maps are equal (``score_maps`` on identical maps is exact host math).
"""

import copy
import dataclasses
import datetime as dt
import json
import time

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.infer import engine as jengine
from heatmap_tpu.obs import quality as jq
from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu.query import TileMatView as JaxView
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.sink.base import TileDoc as JaxTileDoc
from heatmap_tpu.stream import MemorySource as JaxMemorySource
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu_torch import hexgrid
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.infer import engine as tengine
from heatmap_tpu_torch.obs import quality as tq
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.sink.base import UTC, TileDoc
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import MemorySource
from test_torch_serve import call

BASE = 1_754_000_000                      # fixed event-time anchor
H = 120.0
CELLS = []
for _i in range(12):
    _c = int(hexgrid.latlng_to_cell(42.30 + _i * 7e-3, -71.05, 8), 16)
    if _c not in CELLS:
        CELLS.append(_c)
C0, C1, C2 = CELLS[:3]
PKGS = {"port": (tq, TileMatView, TileDoc, Registry, load_config),
        "jax": (jq, JaxView, JaxTileDoc, JaxRegistry, jax_load_config)}
# the rounds' float bar (tests/test_torch_infer.py) and the NIS gate
RTOL, ATOL = 1e-5, 1e-3
DEV_NIS = 5.991


def qcfg(pkg, **kw):
    kw.setdefault("quality", True)
    kw.setdefault("quality_lookback_s", 60.0)
    kw.setdefault("quality_mature_s", 60.0)
    kw.setdefault("quality_ttl_s", 600.0)
    if pkg == "jax":
        kw.setdefault("store", "memory")
    return PKGS[pkg][4]({}, **kw)


def view_of(pkg, windows):
    """A live view of ``pkg`` holding {ws_epoch: {cell: count}} windows."""
    _mod, view_cls, doc, _reg, _load = PKGS[pkg]
    v = view_cls()
    for ws, counts in windows.items():
        t = dt.datetime.fromtimestamp(ws, UTC)
        v.apply_docs([doc("bos", 8, format(int(c), "x"), t,
                          t + dt.timedelta(minutes=5), count=n,
                          avg_speed_kmh=30.0, avg_lat=42.3, avg_lon=-71.05,
                          ttl_minutes=10 ** 6, grid="h3r8")
                      for c, n in counts.items()])
    return v


def ledger(obs, reg):
    """Everything an observatory shows, for the comparison."""
    checks, degraded = obs.healthz_checks()
    fams = {n: {k: c.value for k, c in f.children.items()}
            for n, f in reg._families.items()}
    return {"identity": obs.identity(), "last": obs._last_score,
            "checks": checks, "degraded": degraded,
            "block": obs.member_block(), "snapshot": obs.snapshot(),
            "families": fams}


class Both:
    """The same observatory calls on both packages."""

    def __init__(self, windows=None, **cfg):
        self.obs, self.reg = {}, {}
        for pkg in PKGS:
            self.reg[pkg] = PKGS[pkg][3]()
            self.obs[pkg] = PKGS[pkg][0].QualityObservatory(
                qcfg(pkg, **cfg), registry=self.reg[pkg],
                view=view_of(pkg, windows) if windows else None,
                tag="shard3")

    def __getattr__(self, name):
        def call_both(*a, **kw):
            for o in self.obs.values():
                getattr(o, name)(*copy.deepcopy(a), **copy.deepcopy(kw))
            return self.equal()
        return call_both

    def equal(self):
        mine = ledger(self.obs["port"], self.reg["port"])
        assert mine == ledger(self.obs["jax"], self.reg["jax"])
        assert mine["identity"]["ok"], mine["identity"]
        return mine


@pytest.mark.parametrize("env", [
    {}, {"HEATMAP_QUALITY": "0"}, {"HEATMAP_QUALITY": "1"},
    {"HEATMAP_QUALITY": "false"},
    {"HEATMAP_SLO_NIS_BAND": "0.9,0.99"}, {"HEATMAP_SLO_NIS_BAND": "backwards"},
    {"HEATMAP_SLO_NIS_BAND": "0.99,0.9"}, {"HEATMAP_SLO_NIS_BAND": "1.5,2.0"},
    {"HEATMAP_SLO_NIS_BAND": "0.9"}, {"HEATMAP_SLO_NIS_BAND": "0,1"}])
def test_knob_and_band_parse_as_the_reference(env):
    assert tq.quality_enabled(env) == jq.quality_enabled(env)
    assert tq.parse_nis_band(env) == jq.parse_nis_band(env)
    assert tq.DEFAULT_NIS_BAND == jq.DEFAULT_NIS_BAND
    assert (tq.QUALITY_SLOS, tq.SCORE_OUTCOMES, tq.MIN_WINDOW_UPDATES,
            tq.MAX_PENDING, tq.SKILL_ROLL_N) == \
        (jq.QUALITY_SLOS, jq.SCORE_OUTCOMES, jq.MIN_WINDOW_UPDATES,
         jq.MAX_PENDING, jq.SKILL_ROLL_N)


@pytest.mark.parametrize("seed", range(4))
def test_scoring_math_matches_jax(seed):
    rng = np.random.default_rng(seed)

    def rmap():
        keys = rng.choice(40, int(rng.integers(0, 25)), replace=False)
        return {format(int(k) + 0x88000, "x"): float(rng.integers(1, 50))
                for k in keys}

    f, p, a = rmap(), rmap(), rmap()
    assert tq.score_maps(f, p, a) == jq.score_maps(f, p, a)
    assert tq.normalize(f) == jq.normalize(f)
    assert tq.mae(f, a) == jq.mae(f, a)
    feats = [{"cellId": k, "count": v} for k, v in f.items()] + [
        {"count": 3}, {"cellId": next(iter(f), "x"), "count": 2}]
    assert tq.features_to_counts(feats) == jq.features_to_counts(feats)


def test_conservation_through_advance_ttl_and_bounded_pending(monkeypatch):
    target = int(BASE + H)
    both = Both({BASE - 30: {C0: 5, C1: 5}, target - 30: {C0: 8, C1: 2}})
    both.register_forecast(8, H, BASE, {C0: 7.0, C1: 3.0})
    both.register_forecast(8, 10_000.0, BASE, {C0: 7.0})
    both.register_forecast(8, H, None, {C0: 1.0})      # unanchored: none
    assert both.equal()["identity"]["pending"] == 2
    assert both.mature(target + 30)["identity"]["pending"] == 2
    got = both.mature(target + 60)
    assert got["identity"] == {"registered": 2, "scored": 1,
                               "expired_unscorable": 0, "pending": 1,
                               "ok": True}
    assert got["last"]["skill_vs_persistence"] == 0.6667
    far = int(BASE + 10_000)
    assert both.mature(far + 60)["identity"]["pending"] == 1
    got = both.mature(far + 600)
    assert got["identity"] == {"registered": 2, "scored": 1,
                               "expired_unscorable": 1, "pending": 0,
                               "ok": True}
    fam = got["families"]["heatmap_quality_scorecards_total"]
    assert fam == {("scored",): 1.0, ("expired_unscorable",): 1.0}
    for mod in (tq, jq):
        monkeypatch.setattr(mod, "MAX_PENDING", 2)
    for _ in range(4):
        both.register_forecast(8, H, BASE, {C0: 1.0})
    got = both.equal()["identity"]
    assert got["pending"] == 2 and got["expired_unscorable"] == 3


def test_identity_holds_while_cards_mature():
    """The cards mature() is scoring still count as pending, so the
    identity a /healthz or scrape thread reads meanwhile holds (the
    reference's observatory reads registered > scored + expired + pending
    in that gap, and its watchdog degrades /healthz on it)."""
    target = int(BASE + H)
    obs = tq.QualityObservatory(qcfg("port"), view=view_of(
        "port", {BASE - 30: {C0: 5}, target - 30: {C0: 8, C1: 2}}),
        tag="s0")
    for h in (H, H + 1, 10_000.0):
        obs.register_forecast(8, h, BASE, {C0: 7.0, C1: 3.0})
    seen = []
    span = obs._span_counts

    def span_counts(*a):
        seen.append(obs.identity())
        return span(*a)

    obs._span_counts = span_counts
    obs.mature(target + 61)
    # the registration's span reads ran before the patch: these are the
    # two maturing cards' reads
    assert len(seen) == 2 and all(i["ok"] for i in seen), seen
    assert [i["pending"] for i in seen] == [3, 2]
    assert obs.identity() == {"registered": 3, "scored": 2,
                              "expired_unscorable": 0, "pending": 1,
                              "ok": True}


def test_calibration_ledger_matches_jax():
    target = int(BASE + H)
    both = Both({BASE - 30: {C0: 5, C1: 5}, target - 30: {C0: 8, C1: 2}},
                quality_window_s=100.0)
    both.register_forecast(8, H, BASE, {C0: 1.0, C1: 9.0})
    both.mature(target + 60)
    rng = np.random.default_rng(5)
    anomalies = {"stopped": 0, "teleport": 0, "deviation": 0}
    table = {"entities": 10, "capacity": 100, "evicted_ttl": 0,
             "evicted_lru": 0, "reseed_handoff": 0, "reseed_teleport": 0}
    for i in range(12):
        for r in anomalies:
            anomalies[r] += int(rng.integers(0, 4))
        table = {k: v + int(rng.integers(0, 3)) if k != "capacity" else v
                 for k, v in table.items()}
        upd = int(rng.integers(30, 90))
        got = both.note_fold(t=BASE + 25 * i, updates=upd,
                             inside=int(upd * rng.uniform(0.4, 1.0)),
                             inn_n=float(rng.normal(0, 50)),
                             inn_e=float(rng.normal(0, 50)),
                             anomalies=dict(anomalies), table=dict(table))
    assert got["degraded"]
    assert "shard=shard3" in got["checks"]["quality_forecast_skill"]["detail"]
    assert got["block"]["nis"]["updates"] >= tq.MIN_WINDOW_UPDATES
    with pytest.raises(ValueError, match="closed"):
        both.obs["port"].note_fold(t=BASE, updates=1, inside=1, inn_n=0.0,
                                   inn_e=0.0, anomalies={"wormhole": 1},
                                   table={})
    assert tengine.ANOMALY_REASONS == jengine.ANOMALY_REASONS


def test_kill_resume_scores_via_the_history_tier(tmp_path):
    """A card registered before a kill scores after the restart from the
    compacted history alone; each package restores the other's
    checkpoint payload to the same pending card and score."""
    from heatmap_tpu_torch.query.history import HistoryCompactor, HistoryLog
    from heatmap_tpu_torch.query.repl import DeltaLogPublisher

    target = int(BASE + H)
    clock = {"t": float(BASE + 900)}
    feed, hist = str(tmp_path / "feed"), str(tmp_path / "hist")
    w = TileMatView(now_fn=lambda: clock["t"])
    pub = DeltaLogPublisher(w, feed, start=False, hist=HistoryLog(hist))
    for ws, counts in ((BASE - 30, {C0: 5, C1: 5}),
                       (target - 30, {C0: 8, C1: 2})):
        t = dt.datetime.fromtimestamp(ws, UTC)
        w.apply_docs([TileDoc("bos", 8, format(c, "x"), t,
                              t + dt.timedelta(minutes=5), count=n,
                              avg_speed_kmh=30.0, avg_lat=42.3,
                              avg_lon=-71.05, ttl_minutes=10 ** 6,
                              grid="h3r8") for c, n in counts.items()])
        pub.flush()
    blobs = {}
    for pkg, view in (("port", w), ("jax", None)):
        first = PKGS[pkg][0].QualityObservatory(
            qcfg(pkg), view=view if view is not None else view_of(
                pkg, {BASE - 30: {C0: 5, C1: 5}}), tag="s0")
        first.register_forecast(8, H, BASE, {C0: 7.0, C1: 3.0})
        blobs[pkg] = first.snapshot_extra()
        assert blobs[pkg]["state"].dtype == np.uint8
    assert blobs["port"]["state"].tobytes() == blobs["jax"]["state"].tobytes()
    pub.close()
    assert HistoryCompactor(hist, feed_dir=feed,
                            clock=lambda: clock["t"]).step() > 0
    for pkg, other in (("port", "jax"), ("jax", "port")):
        mod = PKGS[pkg][0]
        reg = PKGS[pkg][3]()
        # no view: only the port's compacted history tier
        again = mod.QualityObservatory(qcfg(pkg, hist_dir=hist),
                                       registry=reg, view=None, tag="s0")
        assert again.restore_extra(blobs[other]) == 1
        assert again.identity()["pending"] == 1
        again.mature(target + 60)
        assert again.identity() == {"registered": 1, "scored": 1,
                                    "expired_unscorable": 0, "pending": 0,
                                    "ok": True}
        assert again._last_score["skill_vs_persistence"] == 0.6667
        assert ('heatmap_quality_forecast_skill{grid="h3r8",h="120"} 0.6667'
                in reg.expose_text())
    bad = {"state": np.frombuffer(b"not json", dtype=np.uint8)}
    assert tq.QualityObservatory(qcfg("port"), tag="x").restore_extra(bad) \
        == 0


def test_quality_stamp_matches_jax(tmp_path):
    both = Both()
    both.note_fold(t=BASE, updates=200, inside=190, inn_n=1.0, inn_e=2.0,
                   anomalies={}, table={})
    block = both.obs["port"].member_block()
    (tmp_path / "m0").mkdir()
    (tmp_path / "m0" / "slo-state.json").write_text(json.dumps({
        "specs": {"forecast_skill": {"alerts_total": 2},
                  "nis_band": {"alerts_total": 1},
                  "freshness_p50": {"alerts_total": 5}}}))
    for env in ({}, {"HEATMAP_QUALITY": "1"},
                {"HEATMAP_QUALITY": "1", "HEATMAP_TSDB_DIR": str(tmp_path)}):
        for blk in (None, block, {"skill": {"a|1": 0.5, "b|2": -0.25}}):
            assert tq.quality_stamp(blk, env) == jq.quality_stamp(blk, env)
    assert tq.quality_stamp(block, {"HEATMAP_QUALITY": "1",
                                    "HEATMAP_TSDB_DIR": str(tmp_path)})[
        "quality"]["drift_alerts"] == 3


# --- the runtimes --------------------------------------------------------

N_VEH = 17
BATCH = 128


def fleet_events(n_batches=4, seed=7):
    """17 vehicles on straight lines, one fix each every 5 s with GPS-like
    scatter, with event time near now so the view keeps every window."""
    rng = np.random.default_rng(seed)
    t0 = (int(time.time()) // 300 - 1) * 300
    pos = {v: (42.3 + 0.1 * rng.random(), -71.1 + 0.1 * rng.random())
           for v in range(N_VEH)}
    out = []
    for i in range(n_batches * BATCH):
        v = i % N_VEH
        la, lo = pos[v]
        pos[v] = (la + 6e-5, lo - 6e-5)
        # fixes scattered about the track as a GPS's are (~25 m), so NIS
        # lands on both sides of the gate
        la += 2.5e-4 * rng.standard_normal()
        lo += 2.5e-4 * rng.standard_normal()
        out.append({"provider": "mbta", "vehicleId": f"veh-{v}",
                    "lat": la, "lon": lo, "speedKmh": 25.0,
                    "ts": t0 + 5 * (i // N_VEH)})
    return out


def rt_cfg(pkg, tmp_path, name, quality, **kw):
    kw = dict(dict(batch_size=BATCH, state_capacity_log2=10,
                   speed_hist_bins=8, emit_flush_k=1,
                   reducers=("count", "kalman"), quality=quality,
                   quality_mature_s=0.0,
                   checkpoint_dir=str(tmp_path / f"ck-{name}")), **kw)
    if pkg == "jax":
        return jax_load_config({}, store="memory", **kw)
    return load_config({}, **kw)


def port_runtime(cfg, events, store=None):
    src = MemorySource(copy.deepcopy(events))
    src.finish()
    store = store if store is not None else MemoryStore()
    rt = MicroBatchRuntime(cfg, src, store, device="cpu",
                           checkpoint_every=0)
    return rt, store


@pytest.fixture
def native_snap(monkeypatch):
    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    for k in ("HEATMAP_QUALITY", "HEATMAP_TSDB", "HEATMAP_FLEET_TAG"):
        monkeypatch.delenv(k, raising=False)


def drive(rt, app, horizons=(15, 40)):
    """Step the runtime batch by batch, draining the writer (so the view
    holds every flushed window before the next fold matures cards) and
    asking each forecast horizon after each batch; returns the bodies."""
    bodies = []
    while rt.step_once():
        rt.writer.drain()
        for h in horizons:
            s, _, b = call(app, "/api/tiles/forecast", f"h={h}")
            assert s.startswith("200"), (s, b)
            bodies.append(b)
    return bodies


def test_knob_off_byte_identical_and_on_observe_only(tmp_path, native_snap):
    events = fleet_events()
    runs = {}
    for name, on in (("off", False), ("on", True)):
        rt, store = port_runtime(rt_cfg("port", tmp_path, name, on), events)
        app = tapi.make_wsgi_app(store, rt.cfg, rt)
        bodies = drive(rt, app)
        rt.close()
        runs[name] = (rt, store, app, bodies)
    (off, soff, aoff, boff), (on, son, aon, bon) = runs["off"], runs["on"]
    assert off.quality is None and off.infer.quality is None
    assert on.quality is not None and on.infer.quality is on.quality
    assert soff._tiles == son._tiles and soff._positions == son._positions
    keys = ("events_valid", "events_invalid", "events_late", "batches",
            "tiles_emitted", "positions_emitted")
    assert ({k: off.metrics[k] for k in keys}
            == {k: on.metrics[k] for k in keys})
    assert off.matview.export_state() == on.matview.export_state()
    assert boff == bon and len(bon) == 8
    text_off, text_on = off.registry.expose_text(), on.registry.expose_text()
    assert "heatmap_quality_" not in text_off
    assert "heatmap_quality_nis_coverage" in text_on
    ident = on.quality.identity()
    assert ident["ok"] and ident["registered"] == 8 and ident["scored"] >= 1
    s, _, b = call(aon, "/debug/quality")
    assert s.startswith("200") and json.loads(b)["scorecards"] == ident
    s, _, b = call(aoff, "/debug/quality")
    assert s.startswith("503")
    assert "HEATMAP_QUALITY=1" in json.loads(b)["error"]
    # the checks join /healthz
    hz = json.loads(call(aon, "/healthz")[2])["checks"]
    assert "quality_nis_coverage" in hz or "quality_forecast_skill" in hz
    assert not any(k.startswith("quality_")
                   for k in json.loads(call(aoff, "/healthz")[2])["checks"])


def test_pending_scorecards_resume_with_the_checkpoint(tmp_path,
                                                       native_snap):
    """The pending cards commit with the entity table (extra-quality.npz)
    and a new runtime on the same directory resumes them, the identity
    intact."""
    events = fleet_events(2)
    cfg = rt_cfg("port", tmp_path, "ck", True, quality_mature_s=3600.0,
                 quality_ttl_s=7200.0)
    rt, store = port_runtime(cfg, events)
    app = tapi.make_wsgi_app(store, cfg, rt)
    drive(rt, app)
    rt.close()
    before = rt.quality.identity()
    assert before["pending"] == 4 and before["registered"] == 4
    again, _ = port_runtime(cfg, [])
    try:
        assert again.quality.identity() == before
    finally:
        again.close()


def capture_rounds(monkeypatch, mod, sink):
    real = mod.filter_rounds

    def capture(*a, **kw):
        out = real(*a, **kw)
        sink.append((np.asarray(a[4]), np.asarray(out[2]),
                     np.asarray(out[3]), np.asarray(out[5])))
        return out

    monkeypatch.setattr(mod, "filter_rounds", capture)


def capture_feed(obs, sink):
    real = obs.note_fold

    def note_fold(**kw):
        sink.append(dict(kw))
        return real(**kw)

    obs.note_fold = note_fold


def test_runtime_against_jax(tmp_path, native_snap, monkeypatch):
    """Each package's runtime over the same events with HEATMAP_QUALITY=1,
    the same forecasts asked after each batch: the calibration feed of
    every fold and the scorecards held to the module docstring's bounds."""
    from test_torch_stream import _pin_reference

    _pin_reference(monkeypatch, {})
    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    events = fleet_events(5, seed=9)
    out = {}
    for pkg in ("jax", "port"):
        rounds, feed = [], []
        capture_rounds(monkeypatch, tengine if pkg == "port" else jengine,
                       rounds)
        cfg = rt_cfg(pkg, tmp_path, pkg, True)
        if pkg == "port":
            rt, store = port_runtime(cfg, events)
            app = tapi.make_wsgi_app(store, cfg, rt)
        else:
            src = JaxMemorySource(copy.deepcopy(events))
            src.finish()
            store = JaxMemoryStore()
            rt = JaxRuntime(cfg, src, store, checkpoint_every=0)
            app = japi.make_wsgi_app(store, cfg, rt)
        capture_feed(rt.quality, feed)
        bodies = drive(rt, app)
        rt.close()
        out[pkg] = (rt, bodies, rounds, feed)
    (jrt, jbodies, jrounds, jfeed) = out["jax"]
    (rt, bodies, rounds, feed) = out["port"]
    assert len(feed) == len(jfeed) == 5 == len(rounds) == len(jrounds)
    for f, jf, r, jr in zip(feed, jfeed, rounds, jrounds):
        for k in ("t", "updates", "anomalies", "table"):
            assert f[k] == jf[k], k
        valid, nis, tele, inn = r
        jvalid, jnis, jtele, jinn = jr
        np.testing.assert_array_equal(tele, jtele)
        upd = valid & ~tele
        assert int(upd.sum()) == f["updates"]
        np.testing.assert_allclose(nis[upd], jnis[upd], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(inn[upd], jinn[upd], rtol=RTOL,
                                   atol=ATOL)
        side = nis[upd] <= DEV_NIS
        jside = jnis[upd] <= DEV_NIS
        flipped = side != jside
        assert f["inside"] - jf["inside"] == int(side.sum() - jside.sum())
        assert np.all(np.abs(nis[upd][flipped] - DEV_NIS)
                      <= ATOL + RTOL * DEV_NIS)
        for k, c in (("inn_n", 0), ("inn_e", 1)):
            bound = ATOL * f["updates"] + RTOL * float(
                np.abs(inn[upd][:, c]).sum())
            assert abs(f[k] - jf[k]) <= bound, (k, f[k], jf[k])
    # the forecasts: maps within one entity in a hundred; equal maps give
    # equal cards, so the ledgers are equal when every map is
    moved = 0
    for b, jb in zip(bodies, jbodies):
        got = tq.features_to_counts(json.loads(b)["features"])
        want = tq.features_to_counts(json.loads(jb)["features"])
        moved = max(moved, sum(abs(got.get(k, 0) - want.get(k, 0))
                               for k in set(got) | set(want)) / 2)
    assert moved <= max(1, N_VEH // 100), moved
    ident = rt.quality.identity()
    assert ident == jrt.quality.identity()
    assert ident["scored"] >= 1 and ident["ok"]
    if moved == 0:
        assert rt.quality.member_block()["skill"] \
            == jrt.quality.member_block()["skill"]
        assert rt.quality._last_score == jrt.quality._last_score
