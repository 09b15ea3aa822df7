"""The port's continuous-query engine (``query/continuous.py``) against
the JAX package's, on the CPU.

- The same geofence, range, top-k and threshold queries registered in
  both engines, fed the same view mutations (applies, a window advance,
  a late doc, evictions under a fake clock, a store-fed resync): equal
  match and alert payloads (the query id and wall-clock stamp aside),
  equal incremental state and one-shot evaluations at every step.
- Registration through both apps' ``/api/queries`` (POST, GET, DELETE)
  gives the same descriptions and errors, and ``/api/queries/stream``
  pushes the query's events as SSE.
- Anomalies: both runtimes with ``HEATMAP_REDUCERS=count,kalman`` on a
  stream that raises anomalies, an anomaly query on each runtime's view:
  the events agree by entity, reason and cell, in order; the forecast
  route's body is byte-equal for the same ``forecast_cells`` dict.
"""

import json
import types

import numpy as np
import pytest

from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu.query import TileMatView as JaxView
from heatmap_tpu.query.continuous import \
    ContinuousQueryEngine as JaxEngine
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.query.continuous import ContinuousQueryEngine
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.sink.memory import MemoryStore
from test_torch_infer import jax_rt, port_rt, stream_events
from test_torch_query import (CENTER, GRID, TTL_MIN, WIN_S, _Clock,
                              city_cells, tile_docs)
from test_torch_serve import call
from test_torch_stream import _pin_reference

CITY_BBOX = [CENTER[1] - 0.16, CENTER[0] - 0.16, CENTER[1] + 0.16,
             CENTER[0] + 0.16]
SPECS = [
    {"type": "geofence", "bbox": [CENTER[1] - 0.04, CENTER[0] - 0.04,
                                  CENTER[1] + 0.04, CENTER[0] + 0.04]},
    {"type": "geofence", "polygon": [[CENTER[1] - 0.06, CENTER[0]],
                                     [CENTER[1], CENTER[0] + 0.06],
                                     [CENTER[1] + 0.06, CENTER[0]],
                                     [CENTER[1], CENTER[0] - 0.05]]},
    {"type": "range", "bbox": [CENTER[1] - 0.08, CENTER[0] - 0.02,
                               CENTER[1] + 0.02, CENTER[0] + 0.08]},
    {"type": "topk", "k": 5},
    {"type": "topk", "k": 3, "bbox": [CENTER[1] - 0.05, CENTER[0] - 0.05,
                                      CENTER[1] + 0.05, CENTER[0] + 0.05]},
    {"type": "threshold", "threshold": 200},
    {"type": "threshold", "threshold": 100, "bbox": CITY_BBOX},
]


def events_of(engine, qids):
    """Every query's events, without the query id and the wall clock."""
    out = []
    for qid in qids:
        out.append([{k: v for k, v in ev.items() if k not in ("query", "t")}
                    for ev in engine.events_since(qid, 0)])
    return out


def test_engines_match_jax_over_the_same_mutations():
    rng = np.random.default_rng(31)
    cells = city_cells(200, 8, 31)
    w0 = 1_700_000_100 // WIN_S * WIN_S
    clock = _Clock(w0)
    mine = TileMatView(now_fn=clock)
    ref = JaxView(now_fn=clock)
    eng = ContinuousQueryEngine(mine, registry=Registry())
    jeng = JaxEngine(ref, registry=JaxRegistry())
    seed = tile_docs(cells[:60], w0, rng)
    mine.apply_docs(seed)
    ref.apply_docs(seed)
    qids, jqids = [], []
    for spec in SPECS:
        d, jd = eng.register(dict(spec), GRID), jeng.register(dict(spec),
                                                               GRID)
        strip = lambda x: {k: v for k, v in x.items()
                           if k not in ("id", "created_unix")}
        assert strip(d) == strip(jd)
        qids.append(d["id"])
        jqids.append(jd["id"])
    steps = [
        lambda v: v.apply_docs(tile_docs(cells[40:120], w0, rng_a[v])),
        lambda v: v.apply_docs(tile_docs(cells[100:170], w0 + WIN_S,
                                         rng_a[v])),
        lambda v: v.apply_docs(tile_docs(cells[:10], w0, rng_a[v])),
        lambda v: v.apply_docs(tile_docs(cells[150:200], w0 + WIN_S,
                                         rng_a[v])),
        lambda v: v.replace_grid(GRID, tile_docs(cells[5:90],
                                                 w0 + 2 * WIN_S, rng_a[v])),
        lambda v: v.etag(GRID),     # the clock moved: evictions
    ]
    # one generator per view, same seed: both views see the same docs
    rng_a = {mine: np.random.default_rng(32), ref: np.random.default_rng(32)}
    for i, step in enumerate(steps):
        if i == len(steps) - 1:
            clock.t = w0 + 3 * WIN_S + TTL_MIN * 60
        step(mine)
        step(ref)
        eng.drain()
        jeng.drain()
        assert events_of(eng, qids) == events_of(jeng, jqids), i
        _, latest = ref.latest_docs(GRID)
        for q, jq in zip(qids, jqids):
            assert eng.state_of(q) == jeng.state_of(jq)
            e, je = eng.evaluate(q), jeng.evaluate(jq)
            e.pop("id"), je.pop("id")
            assert e == je
            # the replay invariant: the incremental engine equals the
            # one-shot evaluation of the view's latest window
            spec = eng.get(q).spec
            one = ContinuousQueryEngine.oneshot(spec, latest)
            assert one == JaxEngine.oneshot(spec, latest)
            assert one == {k: e[k] for k in one}, (i, spec)
    kinds = {ev["kind"] for evs in events_of(eng, qids) for ev in evs}
    assert kinds >= {"enter", "exit", "match", "topk", "above", "below"}
    assert eng.remove(qids[0]) and not eng.remove(qids[0])
    assert eng.list()["registered"] == jeng.list()["registered"] - 1
    for e in (eng, jeng):
        e.close()


def test_queries_endpoints_match_jax():
    store, jstore = MemoryStore(), JaxMemoryStore()
    apps = (tapi.make_wsgi_app(store, load_config({})),
            japi.make_wsgi_app(jstore, japi_cfg()))
    try:
        for spec in SPECS[:2] + [{"type": "nope"}, {"type": "topk", "k": 0},
                                 {"type": "geofence"}]:
            body = json.dumps(spec).encode()
            got = [call(a, "/api/queries", method="POST", body=body)
                   for a in apps]
            assert got[0][0] == got[1][0], spec
            d, jd = (json.loads(g[2]) for g in got)
            if "error" in d:
                assert d == jd
                continue
            qid = d.pop("id")
            jd.pop("id")
            d.pop("created_unix"), jd.pop("created_unix")
            assert d == jd
        s, _, b = call(apps[0], "/api/queries", f"id={qid}")
        assert s.startswith("200") and json.loads(b)["eval"]["cells"] == []
        it = apps[0]({"PATH_INFO": "/api/queries/stream",
                      "QUERY_STRING": f"id={qid}&since=0",
                      "REQUEST_METHOD": "GET"}, lambda *a: None)
        try:
            assert next(iter(it)) == b"retry: 3000\n\n"
        finally:
            it.close()
        s, _, b = call(apps[0], "/api/queries", f"id={qid}",
                       method="DELETE")
        assert json.loads(b) == {"id": qid, "removed": True}
        for a in apps:
            s, _, b = call(a, "/api/queries", "id=nope", method="DELETE")
            assert s.startswith("404")
            s, _, b = call(a, "/api/queries/stream", "id=nope")
            assert s.startswith("404")
        off = tapi.make_wsgi_app(store, load_config({"HEATMAP_CQ": "0"}))
        joff = japi.make_wsgi_app(jstore, japi_cfg({"HEATMAP_CQ": "0"}))
        assert (call(off, "/api/queries")[2]
                == call(joff, "/api/queries")[2])
        assert call(off, "/api/queries")[0].startswith("503")
    finally:
        apps[0].close()
        apps[1].close_repl()


def japi_cfg(env=None):
    from heatmap_tpu.config import load_config as jax_load_config

    return jax_load_config(env or {})


# --- anomalies from both runtimes ----------------------------------------------

def test_anomaly_queries_match_jax(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    _pin_reference(mp, {})
    out = {}
    try:
        for pkg, make, store in (("jax", jax_rt, JaxMemoryStore()),
                                 ("port", port_rt, MemoryStore())):
            rt = make(tmp_path_factory.mktemp(pkg), store, stream_events())
            Engine = JaxEngine if pkg == "jax" else ContinuousQueryEngine
            eng = Engine(rt.matview)
            q = eng.register({"type": "anomaly", "bbox": CITY_BBOX},
                             rt.cfg.default_grid())
            qt = eng.register({"type": "anomaly", "bbox": CITY_BBOX,
                               "reasons": ["teleport"]},
                              rt.cfg.default_grid())
            rt.run()
            eng.drain()
            out[pkg] = ([(ev["entity"], ev["reason"], ev["cell"])
                         for ev in eng.events_since(q["id"], 0, 10**6)],
                        [(ev["entity"], ev["reason"], ev["cell"])
                         for ev in eng.events_since(qt["id"], 0, 10**6)],
                        rt)
            eng.close()
    finally:
        mp.undo()
    evs, tele, rt = out["port"]
    jevs, jtele, _ = out["jax"]
    assert evs == jevs and tele == jtele
    assert len(tele) > 0 and {r for _, r, _ in evs} >= {"teleport"}
    assert all(r == "teleport" for _, r, _ in tele)
    # the forecast route renders the same cells to the same bytes
    cells = rt.infer.forecast_cells(60.0, 8)
    blk = rt.infer.member_block()
    assert cells
    stub = types.SimpleNamespace(
        base_res=8, forecast_cells=lambda h, res: dict(cells),
        member_block=lambda: dict(blk))
    app = tapi.make_wsgi_app(MemoryStore(), load_config({}),
                             types.SimpleNamespace(
                                 registry=Registry(), matview=None,
                                 infer=stub))
    japp = japi.make_wsgi_app(
        JaxMemoryStore(), japi_cfg(),
        types.SimpleNamespace(metrics=types.SimpleNamespace(
            registry=JaxRegistry()), matview=None, infer=stub))
    try:
        for qs in ("", "h=300", "h=30&res=7"):
            s, _, b = call(app, "/api/tiles/forecast", qs)
            js, _, jb = call(japp, "/api/tiles/forecast", qs)
            assert s == js and s.startswith("200") and b == jb, qs
        assert (call(app, "/api/tiles/forecast", "h=0")[2]
                == call(japp, "/api/tiles/forecast", "h=0")[2])
    finally:
        app.close()
        japp.close_repl()
