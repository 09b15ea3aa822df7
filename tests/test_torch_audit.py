"""The integrity observatory of the port (heatmap_tpu_torch/obs/audit.py)
against the JAX package's (heatmap_tpu/obs/audit.py), on the CPU.

Everything here is host Python over the same inputs, so the comparisons
are exact (no tolerance): the same docs, made from a seed with numpy, the
same ledger scripts, the same synthetic clock.

- ``DigestTable``: each package's table over the same seeded docs, in
  the same random order of upserts, removals, window drops and prunes,
  holds the same digests and snapshots, and the XOR algebra holds
  (order independence, upsert = old ^ new, the shard combine equals the
  merged digest, the empty window is 0, eviction retires the window);
- ``residuals_from_counts`` over seeded count dicts, and each package's
  ``AuditState`` over one seeded ledger script and clock: the same
  residuals, the same leaking boundary at the same tick, the same
  /healthz checks;
- one clean audited run of each runtime over a corpus with invalid and
  late rows: equal ledger counts, every residual 0 after the close, the
  fold's digest table equal to the view's, the ``heatmap_audit_*``
  families of the reference's types and labels, and the port's audited
  run byte-identical to its unaudited one;
- a port replica following a JAX writer's feed verifies every digest
  with 0 mismatches, and so does a JAX replica following the port's;
- a corrupted feed record is detected at its own seq in both packages:
  one mismatch, /healthz degraded naming (grid, window, seq), one flight
  record under one fleet episode; and a serve-only app of each package
  following that feed answers /healthz degraded with the same check.
"""

import copy
import datetime as dt
import glob
import json
import os
import time

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.obs import audit as jaudit
from heatmap_tpu.obs.flightrec import FlightRecorder as JaxFlightRecorder
from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu.obs.xproc import read_episode as jax_read_episode
from heatmap_tpu.query import TileMatView as JaxTileMatView
from heatmap_tpu.query import repl as jrepl
from heatmap_tpu.serve import api as japi
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.sink.base import TileDoc as JaxTileDoc
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.hexgrid.host import latlng_to_cell
from heatmap_tpu_torch.obs import audit as taudit
from heatmap_tpu_torch.obs.flightrec import FlightRecorder
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.obs.xproc import read_episode
from heatmap_tpu_torch.query import TileMatView
from heatmap_tpu_torch.query import repl as trepl
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.sink.base import UTC, TileDoc
from heatmap_tpu_torch.sink.memory import MemoryStore
from test_torch_serve import call
from test_torch_telemetry import _run_both, assert_families_match

PKGS = {
    "jax": dict(audit=jaudit, view=JaxTileMatView, repl=jrepl,
                reg=JaxRegistry, fr=JaxFlightRecorder,
                read_episode=jax_read_episode, doc=JaxTileDoc),
    "port": dict(audit=taudit, view=TileMatView, repl=trepl, reg=Registry,
                 fr=FlightRecorder, read_episode=read_episode, doc=TileDoc),
}


def seeded_docs(seed, n_cells=24, n_windows=3, ws0=None, pkg="port"):
    """Tile docs from a seed: ``n_cells`` res-8 cells around Boston in
    each of ``n_windows`` 5-minute windows from ``ws0``, counts and
    speeds drawn with numpy (speeds rounded as the sink rounds them)."""
    rng = np.random.default_rng(seed)
    ws0 = ws0 or dt.datetime.fromtimestamp(1_900_000_000, UTC)
    cells = []
    while len(cells) < n_cells:
        c = latlng_to_cell(float(rng.uniform(42.30, 42.40)),
                           float(rng.uniform(-71.12, -71.02)), 8)
        if c not in cells:
            cells.append(c)
    make = PKGS[pkg]["doc"]
    out = []
    for w in range(n_windows):
        ws = ws0 + dt.timedelta(minutes=5 * w)
        for c in cells:
            out.append(make(
                "bos", 8, c, ws, ws + dt.timedelta(minutes=5),
                count=int(rng.integers(1, 500)),
                avg_speed_kmh=round(float(rng.uniform(0, 90)), 2),
                avg_lat=42.35, avg_lon=-71.05, ttl_minutes=45,
                extra={"p95SpeedKmh":
                       round(float(rng.uniform(0, 120)), 2)}))
    return out


def _ws(doc) -> int:
    return int(doc["windowStart"].timestamp())


# ------------------------------------------------------------ digests
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digest_table_equals_jax_and_the_xor_algebra_holds(seed):
    docs = seeded_docs(seed)
    assert docs == seeded_docs(seed, pkg="jax")
    assert ([taudit.doc_hash(d) for d in docs]
            == [jaudit.doc_hash(d) for d in docs])
    rng = np.random.default_rng(100 + seed)
    tables = {pkg: m["audit"].DigestTable() for pkg, m in PKGS.items()}
    live: dict = {}  # (grid, ws, cid) -> doc, the table's expected state
    for step in range(400):
        op = rng.integers(0, 10)
        d = copy.deepcopy(docs[int(rng.integers(0, len(docs)))])
        key = ("h3r8", _ws(d), d["cellId"])
        if op < 6:                      # upsert, with a changed count
            d["count"] = int(rng.integers(1, 500))
            for t in tables.values():
                t.apply_doc(d)
            live[key] = d
        elif op < 8:                    # remove one cell
            for t in tables.values():
                t.update("h3r8", key[1], key[2], live.get(key), None)
            live.pop(key, None)
        elif op < 9:                    # evict a window
            for t in tables.values():
                t.drop_window("h3r8", key[1])
            live = {k: v for k, v in live.items() if k[1] != key[1]}
        else:                           # prune: nothing is stale yet
            assert [t.prune(1_800_000_000.0) for t in tables.values()] \
                == [0, 0]
        snaps = {p: t.snapshot() for p, t in tables.items()}
        assert snaps["port"] == snaps["jax"], step
        for ws in {k[1] for k in live}:
            want = taudit.combine_digests(
                taudit.doc_hash(v) for k, v in live.items() if k[1] == ws)
            assert tables["port"].digest("h3r8", ws) == want != 0
            assert tables["jax"].digest("h3r8", ws) == want
    # order independence, and the shard combine equals the merged digest
    window = [d for d in docs if _ws(d) == _ws(docs[0])]
    perm = [window[i] for i in rng.permutation(len(window))]
    merged, shuffled, s1, s2 = (taudit.DigestTable() for _ in range(4))
    merged.apply_docs(window)
    shuffled.apply_docs(perm)
    s1.apply_docs(window[::2])
    s2.apply_docs(window[1::2])
    ws = _ws(window[0])
    assert merged.digest("h3r8", ws) == shuffled.digest("h3r8", ws)
    assert (taudit.combine_digests([s1.digest("h3r8", ws),
                                    s2.digest("h3r8", ws)])
            == merged.digest("h3r8", ws))
    assert taudit.combine_digests([]) == jaudit.combine_digests([]) == 0
    merged.drop_window("h3r8", ws)
    assert merged.digest("h3r8", ws) is None
    # a window whose staleAt has passed is pruned from the snapshot
    assert shuffled.snapshot(now=2e9) == {} != shuffled.snapshot()


def test_shard_tables_prune_stale_windows_as_in_jax():
    """The emit tables' rate-limited sweep rides the ledger adds in both."""
    stale = dt.datetime.now(UTC) - dt.timedelta(hours=3)
    for pkg, m in PKGS.items():
        aud = m["audit"].AuditState(tag="p0")
        aud.shard_table(None).apply_docs(
            seeded_docs(3, n_cells=4, n_windows=1, ws0=stale, pkg=pkg))
        assert aud.shard_table(None).windows("h3r8")
        aud._prune_last = -1e9
        aud.add("polled", 1)
        assert aud.shard_table(None).windows("h3r8") == [], pkg


# ------------------------------------------------------------- ledger
STAGES = ("polled", "dispatched", "folded", "docs_emitted",
          "docs_committed", "docs_view_applied", "dropped_invalid",
          "dropped_late")


@pytest.mark.parametrize("seed", [0, 1])
def test_residuals_and_leaks_name_the_same_boundary(seed):
    """One seeded ledger script through both packages' ``AuditState``
    under one synthetic clock: at every tick the same residuals, the same
    leaking boundaries and the same /healthz checks; the first leak is
    named at the same tick."""
    rng = np.random.default_rng(seed)
    counts = {s: int(rng.integers(0, 1000)) for s in STAGES}
    for has_view in (True, False):
        assert (taudit.residuals_from_counts(counts, has_view)
                == jaudit.residuals_from_counts(counts, has_view))
    clock = [0.0]
    auds = {p: m["audit"].AuditState(m["reg"](), tag="t", settle_s=5.0,
                                     clock=lambda: clock[0])
            for p, m in PKGS.items()}
    first_leak = {}
    for tick in range(60):
        clock[0] = float(tick)
        for _ in range(int(rng.integers(0, 4))):
            stage = STAGES[int(rng.integers(0, len(STAGES)))]
            # after tick 30 the fold stops counting: a feed_fold leak
            if tick > 30 and stage == "folded":
                continue
            n = int(rng.integers(1, 50))
            for a in auds.values():
                a.add(stage, n)
        got = {p: (a.residuals(), a.leaking(), a.healthz_checks())
               for p, a in auds.items()}
        assert got["port"] == got["jax"], tick
        for p, (_, leaks, _) in got.items():
            for b in leaks:
                first_leak.setdefault((p, b), tick)
    assert first_leak
    assert ({b: t for (p, b), t in first_leak.items() if p == "port"}
            == {b: t for (p, b), t in first_leak.items() if p == "jax"})
    checks, degraded = auds["port"].healthz_checks()
    assert degraded and checks["audit_residual"]["ok"] is False


def test_drop_forwards_to_the_ledger():
    from heatmap_tpu_torch.stream.metrics import Metrics

    m = Metrics()
    aud = taudit.AuditState(tag="t")
    m.audit = aud
    m.drop("invalid", 3)
    m.drop("exchange", 5, audit=False)
    assert aud.counts() == {"dropped_invalid": 3}


# ----------------------------------------------- clean audited runs
AUDIT_ENV = {"HEATMAP_AUDIT": "1",
             "HEATMAP_SUPERVISOR_CHANNEL": "{dir}/channel.json"}


@pytest.fixture(scope="module")
def audited_runs(tmp_path_factory):
    out = _run_both(tmp_path_factory.mktemp("audited"), ("count",),
                    AUDIT_ENV)
    yield out
    out["jax"][1].close_repl()
    out["port"][1].close()


def test_audited_runs_conserve_and_count_as_jax(audited_runs):
    jrt, trt = audited_runs["jax"][0], audited_runs["port"][0]
    assert trt.audit is not None and jrt.audit is not None
    counts = trt.audit.counts()
    assert counts == jrt.audit.counts()
    # the corpus took every drop reason the feed side subtracts
    assert counts["dropped_invalid"] > 0 and counts["dropped_late"] > 0
    assert counts["polled"] == (counts["folded"] + counts["dropped_invalid"]
                                + counts["dropped_late"])
    assert (counts["docs_emitted"] == counts["docs_committed"]
            == counts["docs_view_applied"] > 0)
    res = trt.audit.residuals()
    assert res == jrt.audit.residuals() and not any(res.values()), res
    assert trt.audit.leaking() == {}
    # the fold's digest table is the view's
    assert (trt.audit.shard_table(None).snapshot()
            == trt.matview.audit_table.snapshot() != {})
    assert trt.audit.bench_stamp() == {"enabled": True, "max_residual": 0,
                                       "digests_verified": 0,
                                       "mismatches": 0}
    # the heatmap_audit_* families: the reference's types and labels
    assert_families_match(audited_runs)
    assert {n for n in trt.registry._families if "audit" in n} == \
        {n for n in jrt.metrics.registry._families if "audit" in n}


def test_audited_apps_answer_debug_audit_as_jax(audited_runs):
    (_, japp, *_), (_, tapp, *_) = (audited_runs["jax"],
                                    audited_runs["port"])
    s, _, b = call(tapp, "/debug/audit")
    js, _, jb = call(japp, "/debug/audit")
    assert s == js and s.startswith("200")
    mine, ref = json.loads(b), json.loads(jb)
    assert mine.keys() == ref.keys()
    for k in ("ledger", "residuals", "verify", "leaking",
              "worst_boundary", "settle_s", "tag"):
        assert mine[k] == ref[k], k
    assert mine["digests"].keys() == ref["digests"].keys()


def test_audited_run_member_snapshots_read_across_packages(audited_runs):
    """Each runtime left its member snapshot (a departure tombstone, the
    close being clean) beside its own channel; each package's reader
    reads both the same way, and the audit blocks carry the same keys."""
    from heatmap_tpu.obs.xproc import members_from as jmembers_from
    from heatmap_tpu_torch.obs.xproc import members_from

    snaps = {}
    for pkg in ("jax", "port"):
        chan = str(audited_runs[pkg][4] / "channel.json")
        assert members_from(chan) == jmembers_from(chan) \
            == ({}, {"p0": "left"})
        with open(chan + ".member-p0", encoding="utf-8") as fh:
            snaps[pkg] = json.load(fh)
    assert snaps["port"].keys() == snaps["jax"].keys()
    assert snaps["port"]["audit"].keys() == snaps["jax"]["audit"].keys()
    # the close publishes before its drain, as the reference's does: the
    # writer thread's stages are where that thread happened to be, the
    # step loop's are final (the last idle poll flushed the ring)
    step_side = {
        pkg: {k: v for k, v in snap["audit"]["ledger"].items()
              if k not in ("docs_committed", "docs_view_applied")}
        for pkg, snap in snaps.items()}
    assert step_side["port"] == step_side["jax"]
    assert step_side["port"]["docs_emitted"] > 0


def test_audited_run_is_byte_identical_to_unaudited(tmp_path,
                                                    monkeypatch):
    """The ledger and the digests are observe-only: the port's store and
    view after an audited run equal an unaudited run's."""
    from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
    from heatmap_tpu_torch.stream.source import MemorySource
    from test_torch_telemetry import AXES, make_events

    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    events = make_events()
    out = {}
    for audit in (False, True):
        cfg = load_config({}, checkpoint_dir=str(tmp_path / str(audit)),
                          audit=audit, **AXES)
        src, store = MemorySource(events), MemoryStore()
        src.finish()
        rt = MicroBatchRuntime(cfg, src, store, device="cpu",
                               checkpoint_every=0)
        rt.run()
        out[audit] = (store, rt)
    (s0, r0), (s1, r1) = out[False], out[True]
    assert r0.audit is None and r1.audit is not None
    assert s0._tiles == s1._tiles and len(s0._tiles) > 50
    assert s0._positions == s1._positions
    assert r0.matview.export_state() == r1.matview.export_state()


# ------------------------------------------------ replica verification
def _writer(pkg, feed):
    m = PKGS[pkg]
    view = m["view"](audit=m["audit"].DigestTable())
    return view, m["repl"].DeltaLogPublisher(view, feed, start=False)


def _replica(pkg, feed, **audit_kw):
    m = PKGS[pkg]
    reg = m["reg"]()
    aud = m["audit"].AuditState(reg, tag=f"{pkg}-replica", **audit_kw)
    view = m["view"](replica=True, audit=m["audit"].DigestTable())
    fol = m["repl"].ReplicaViewFollower(
        view, m["repl"].FileFeedSource(feed), registry=reg, audit=aud)
    aud.attach(view=view, follower=fol)
    return view, fol, aud, reg


@pytest.mark.parametrize("writer,replica", [("jax", "port"),
                                            ("port", "jax")])
def test_replica_verifies_the_other_packages_writer(tmp_path, writer,
                                                    replica):
    feed = str(tmp_path / "feed")
    wview, pub = _writer(writer, feed)
    rview, fol, aud, reg = _replica(replica, feed)
    ws0 = dt.datetime.now(UTC).replace(microsecond=0) - \
        dt.timedelta(minutes=12)
    for rnd in range(4):
        # each round rewrites the windows with fresh seeded counts, so
        # every record re-publishes each window's digest
        wview.apply_docs(seeded_docs(rnd, ws0=ws0, pkg=writer))
        pub.flush()
        while fol.step():
            pass
    assert fol.synced and rview.seq == wview.seq
    assert aud.mismatches == 0 and aud.verified >= 4
    assert aud.last_verified_seq == wview.seq
    latest = rview.latest_ws_of("h3r8")
    assert (rview.audit_digest("h3r8", latest)
            == wview.audit_digest("h3r8", latest) != 0)
    assert aud.residuals()["repl_replica"] == 0
    assert "heatmap_audit_digest_mismatch_total 0" in reg.expose_text()
    pub.close()


def _corrupt_last_record(feed, repl):
    seg = sorted(glob.glob(os.path.join(feed, "seg-*.jsonl")))[-1]
    with open(seg, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    bad = json.loads(lines[-1])
    bad["docs"][0]["count"] = 99_999
    lines[-1] = repl.dumps(bad)
    with open(seg, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return bad["seq"]


def test_corrupt_record_detected_within_one_seq_as_in_jax(tmp_path):
    """One corrupted (valid JSON) record in each package's feed: each
    replica detects it at that record's seq, /healthz degrades naming the
    same (grid, window, seq), and one flight record lands under the one
    fleet episode the mismatch claimed; a second mismatch in the same
    incident neither mints an episode nor dumps again."""
    ws = dt.datetime.now(UTC).replace(microsecond=0) - \
        dt.timedelta(minutes=2)
    got = {}
    for pkg, m in PKGS.items():
        feed, chan = str(tmp_path / pkg / "feed"), str(tmp_path / pkg / "ch")
        rec_dir = str(tmp_path / pkg / "fr")
        wview, pub = _writer(pkg, feed)
        _, fol, aud, reg = _replica(pkg, feed, channel_path=chan,
                                    flightrec=m["fr"](rec_dir))
        docs = seeded_docs(5, n_cells=6, n_windows=1, ws0=ws, pkg=pkg)
        wview.apply_docs(docs)
        pub.flush()
        while fol.step():
            pass
        assert aud.verified >= 1 and aud.mismatches == 0
        wview.apply_docs([dict(docs[0], count=docs[0]["count"] + 1)])
        pub.flush()
        seq = _corrupt_last_record(feed, m["repl"])
        fol.step()
        first = (aud.mismatches, dict(aud.last_mismatch))
        checks, degraded = aud.healthz_checks()
        ep = m["read_episode"](chan)
        dumps = glob.glob(os.path.join(rec_dir, "flightrec-*.json"))
        assert len(dumps) == 1 and ep["origin"] == f"{pkg}-replica"
        with open(dumps[0], encoding="utf-8") as fh:
            dumped = json.load(fh)
        assert dumped["episode_id"] == ep["episode_id"]
        assert dumped["audit"]["verify"]["mismatches"] == 1
        aud.note_digest_mismatch("h3r8", _ws(docs[0]), seq + 1)
        assert m["read_episode"](chan)["episode_id"] == ep["episode_id"]
        assert len(glob.glob(os.path.join(rec_dir, "flightrec-*"))) == 1
        got[pkg] = (seq, *first, degraded, checks["audit_digest"],
                    "heatmap_audit_digest_mismatch_total 2"
                    in reg.expose_text())
        pub.close()
    assert got["port"] == got["jax"]
    seq, mismatches, last, degraded, check, counted = got["port"]
    assert mismatches == 1
    assert (last["seq"], last["grid"], last["ws"]) == (seq, "h3r8",
                                                       int(ws.timestamp()))
    assert degraded and counted and check["ok"] is False
    for token in ("h3r8", str(int(ws.timestamp())), str(seq)):
        assert token in check["value"]


def test_serve_only_app_healthz_names_the_corrupt_record(tmp_path):
    """A serve-only app of each package with HEATMAP_AUDIT=1 follows the
    corrupted feed: /healthz answers degraded with the same audit_digest
    check, and /debug/audit names the same (grid, window, seq)."""
    ws = dt.datetime.now(UTC).replace(microsecond=0) - \
        dt.timedelta(minutes=2)
    feed = str(tmp_path / "feed")
    wview, pub = _writer("port", feed)
    docs = seeded_docs(6, n_cells=6, n_windows=1, ws0=ws)
    wview.apply_docs(docs)
    wview.apply_docs([dict(docs[0], count=docs[0]["count"] + 1)])
    pub.flush()
    seq = _corrupt_last_record(feed, trepl)
    env = {"HEATMAP_AUDIT": "1", "HEATMAP_REPL_FEED": feed,
           "HEATMAP_REPL_POLL_MS": "20"}
    apps = (tapi.make_wsgi_app(MemoryStore(), load_config(env)),
            japi.make_wsgi_app(JaxMemoryStore(),
                               jax_load_config(env, store="memory")))
    try:
        got = []
        for app in apps:
            deadline = time.monotonic() + 30
            while (time.monotonic() < deadline
                   and not app.serve_audit.mismatches):
                time.sleep(0.02)
            s, _, b = call(app, "/healthz")
            hz = json.loads(b)
            _, _, ab = call(app, "/debug/audit")
            got.append((s, hz["status"], hz["checks"]["audit_digest"],
                        json.loads(ab)["verify"]["last_mismatch"]))
        assert got[0] == got[1]
        status, verdict, check, last = got[0]
        assert verdict == "degraded" and not check["ok"]
        assert (last["grid"], last["ws"], last["seq"]) == (
            "h3r8", int(ws.timestamp()), seq)
    finally:
        apps[0].close()
        apps[1].close_repl()
        pub.close()


# ------------------------------------------------ the shard fleet
def test_sharded_replicated_conservation(tmp_path, monkeypatch):
    """Two port shards fan into one merged view replicated to a port and
    a JAX follower: no residual on either shard, the per-shard digests
    XOR-combine to the merged view's (the /fleet/audit stitch), and both
    replicas verify every published digest."""
    from test_audit import mk_stream as audit_stream
    from test_torch_shard_diff import run_shard

    from heatmap_tpu_torch.obs.fleet import fleet_audit

    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    feed = str(tmp_path / "feed")
    merged_view, pub = _writer("port", feed)
    replicas = [_replica(pkg, feed) for pkg in ("port", "jax")]
    store = MemoryStore()
    fleet = [run_shard(tmp_path, audit_stream(), store, f"a{i}", shards=2,
                       index=i, view=merged_view, audit=True)
             for i in range(2)]
    pub.flush()
    for _view, fol, _aud, _reg in replicas:
        while fol.step():
            pass
    pub.close()
    members = {}
    for i, rt in enumerate(fleet):
        assert rt.audit.leaking() == {}
        assert all(v == 0 for v in rt.audit.residuals().values())
        assert rt.counters.get("events_out_of_shard", 0) > 0
        rt.audit.attach(view=merged_view)
        members[f"shard{i}"] = {"audit": rt.audit.member_block()}
    stitched = fleet_audit(members)
    assert stitched["combine"]
    assert all(c["ok"] for c in stitched["combine"]), stitched["combine"]
    assert stitched["combine_mismatches"] == 0 and stitched["ok"]
    # the JAX package's stitch reads the port members' blocks the same way
    from heatmap_tpu.obs.fleet import fleet_audit as jax_fleet_audit

    assert jax_fleet_audit(members) == stitched
    for view, fol, aud, _ in replicas:
        assert fol.synced and fol.seq_lag() == 0
        assert aud.mismatches == 0 and aud.verified > 0
        assert aud.last_verified_seq == merged_view.seq
        assert view.export_state() == merged_view.export_state()
