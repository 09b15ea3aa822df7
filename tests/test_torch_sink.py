"""The port's sink (``heatmap_tpu_torch/sink``) against the JAX package's.

- BSON: the golden bytes and round trips of ``tests/test_mongowire.py``,
  and every encoding byte-identical to JAX's ``bson``.
- The wire contract both ways: the port's ``MongoStore`` (OP_MSG over the
  stdlib client, tiles and positions through the port's C++ encoders)
  against the port's ``MockMongod`` and against JAX's, and JAX's
  ``MongoStore`` against the port's ``MockMongod``: idempotent tile
  upserts, the monotonic positions guard, and docs read back equal to the
  Python doc path's (``assert_docs_equal``: everything exact but the
  floats, which may differ by the relative 1e-15 that the reference
  allows between its C++ tile encoder and its Python doc path,
  ``tests/test_native_encode.py``).
- The JSONL store reloads the same view after close (compacted) and after
  a crash (the op log).
- ``make_store`` for each ``HEATMAP_STORE`` kind, ``auto`` falling back to
  memory when nothing answers at ``MONGO_URI``.
- ``AsyncWriter``: drain, bounded retry with backoff, poison (sticky; no
  mark runs after it), close, counters, against JAX's writer on the same
  failing store.

Every test that talks to a server runs under a time limit of its own
(``time_limit``), and every server binds an ephemeral port.
"""

import datetime as dt
import signal
import socket

import numpy as np
import pytest

from heatmap_tpu.sink import bson as jbson
from heatmap_tpu.sink.mongo import MongoStore as JaxMongoStore
from heatmap_tpu.sink.mongo import _WireBackend as JaxWireBackend
from heatmap_tpu.sink.writer import AsyncWriter as JaxAsyncWriter
from heatmap_tpu.testing import MockMongod as JaxMockMongod
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.sink import (AsyncWriter, JsonlStore, MemoryStore,
                                    make_store)
from heatmap_tpu_torch.sink import bson
from heatmap_tpu_torch.sink.base import (UTC, PositionDoc, PositionRows,
                                         TileDoc, TilePackMeta, epoch_to_dt,
                                         packed_tile_docs)
from heatmap_tpu_torch.sink.mongo import MongoStore, _WireBackend
from heatmap_tpu_torch.sink.mongowire import WireClient, WireError, parse_uri
from heatmap_tpu_torch.testing.mock_mongod import MockMongod

SERVER_TEST_S = 30


def assert_docs_equal(a: dict, b: dict):
    """Docs by ``_id``: the same ids, fields and values; floats within the
    relative 1e-15 the reference allows between its C++ encoder and its
    Python doc path (the C++ stddev rounds once more or less)."""
    assert a.keys() == b.keys()
    for k, x in a.items():
        y = b[k]
        assert x.keys() == y.keys(), k
        for f, u in x.items():
            if isinstance(u, float):
                assert y[f] == pytest.approx(u, rel=1e-15, abs=1e-300), (k, f)
            else:
                assert y[f] == u, (k, f)


@pytest.fixture
def time_limit():
    """Fail the test (instead of hanging the worker) after SERVER_TEST_S."""
    def expire(signum, frame):
        raise TimeoutError(f"server test exceeded {SERVER_TEST_S} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, SERVER_TEST_S)
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, old)


# ---- BSON ------------------------------------------------------------------

ROUNDTRIP_DOC = {
    "f": 3.5, "i32": 42, "i64": 1 << 40, "neg": -7,
    "s": "Nächster Halt", "b_true": True, "b_false": False,
    "none": None,
    "when": dt.datetime(2026, 7, 29, 12, 0, 30, 500000, tzinfo=UTC),
    "nested": {"loc": {"type": "Point", "coordinates": [-71.06, 42.36]}},
    "arr": [1, "two", 3.0, None, {"k": "v"}],
    "blob": b"\x00\x01\xff",
}


def test_bson_golden_bytes():
    assert bson.encode({"a": 1}) == \
        b"\x0c\x00\x00\x00\x10a\x00\x01\x00\x00\x00\x00"
    assert bson.encode({"hello": "world"}) == (
        b"\x16\x00\x00\x00\x02hello\x00\x06\x00\x00\x00world\x00\x00")


def test_bson_roundtrip_all_types_and_jax_bytes():
    enc = bson.encode(ROUNDTRIP_DOC)
    assert enc == jbson.encode(ROUNDTRIP_DOC)
    out = bson.decode(enc)
    assert out == ROUNDTRIP_DOC == jbson.decode(enc)
    assert out["when"].tzinfo is not None


def test_bson_int_width_and_overflow():
    assert bson.encode({"x": 2**31})[4] == 0x12        # int64 tag
    assert bson.encode({"x": 2**31 - 1})[4] == 0x10    # int32 tag
    with pytest.raises(OverflowError):
        bson.encode({"x": 2**63})


def test_bson_naive_datetime_is_utc():
    naive = dt.datetime(2026, 1, 1, 0, 0, 0)
    out = bson.decode(bson.encode({"t": naive}))["t"]
    assert out == dt.datetime(2026, 1, 1, tzinfo=UTC)


def test_parse_uri():
    assert parse_uri("mongodb://localhost:27017") == ("localhost", 27017, None)
    assert parse_uri("mongodb://db.example:27018/mobility") == (
        "db.example", 27018, "mobility")
    assert parse_uri("localhost") == ("localhost", 27017, None)


# ---- the wire contract, both ways -----------------------------------------

SERVERS = {"port": MockMongod, "jax": JaxMockMongod}
STORES = {"port": (MongoStore, _WireBackend),
          "jax": (JaxMongoStore, JaxWireBackend)}
META = TilePackMeta(city="bos", grid="h3r8", window_s=300, ttl_minutes=45,
                    window_minutes_tag=0, with_p95=True)


def _body(rng, n):
    body = np.zeros((n, 13), np.uint32)
    body[:, 0] = rng.integers(0, 2**31, n)
    body[:, 1] = rng.integers(0, 2**32, n)
    ws = (1_700_000_000 + rng.integers(0, 20, n) * 300).astype(np.int32)
    body[:, 2] = ws.view(np.uint32)
    body[:, 3] = rng.integers(0, 50, n)
    for col, lo, hi in ((4, -50.0, 5000.0), (5, 0, 1e5), (6, -0.4, 0.4),
                        (7, -0.4, 0.4), (9, 0, 250.0), (10, 0, 200.0),
                        (11, -90.0, 90.0), (12, -180.0, 180.0)):
        body[:, col] = rng.uniform(lo, hi, n).astype(np.float32).view(
            np.uint32)
    body[:, 8] = (rng.random(n) > 0.15).astype(np.uint32)
    return body


@pytest.mark.parametrize("server,client", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_mongo_store_over_the_wire(time_limit, server, client):
    store_cls, backend = STORES[client]
    rng = np.random.default_rng(7)
    with SERVERS[server]() as uri:
        store = store_cls(uri, "mobility", backend=backend(uri, "mobility"))
        # tiles: idempotent upserts, read back as written
        ws, we = epoch_to_dt(1_700_000_000), epoch_to_dt(1_700_000_300)
        docs = [TileDoc("boston", 8, "88abc", ws, we, 5, 31.5, 42.3, -71.05,
                        45),
                TileDoc("boston", 7, "87def", ws, we, 2, 10.0, 42.4, -71.1,
                        45)]
        assert store.upsert_tiles(docs) == 2
        assert store.upsert_tiles(docs) == 2
        assert store.latest_window_start() == ws
        got = sorted(store.tiles_in_window(ws), key=lambda d: d["cellId"])
        assert [d["cellId"] for d in got] == ["87def", "88abc"]
        assert got[1]["staleAt"] == we + dt.timedelta(minutes=45)
        assert [d["cellId"] for d in store.tiles_in_window(
            ws, grid="h3r7")] == ["87def"]
        # packed rows (the C++ encoder) read back as the Python doc path's
        body, meta = _body(rng, 300), META._replace(grid="h3r9")
        n = store.upsert_tiles_packed(body, meta)
        want = {d["_id"]: d for d in packed_tile_docs(body, meta)}
        assert n == len(want) > 0
        back = {}
        for w in {d["windowStart"] for d in want.values()}:
            back.update({d["_id"]: d for d in store.tiles_in_window(
                w, grid="h3r9")})
        assert_docs_equal(back, want)
        # positions: monotonic, race-free; packed rows the same
        t1, t2 = epoch_to_dt(1_700_000_100), epoch_to_dt(1_700_000_200)
        new = PositionDoc("mbta", "veh-1", t2, 42.36, -71.06)
        old = PositionDoc("mbta", "veh-1", t1, 40.0, -70.0)
        assert store.upsert_positions([new]) == 1
        assert store.upsert_positions([old]) == 0
        assert store.upsert_positions([new]) == 0
        rows = PositionRows(
            lat=np.float32([1.5, 2.5, 3.5]), lon=np.float32([4.5, 5.5, 6.5]),
            ts_ms=np.int64([1_700_000_150_000, 1_700_000_300_000,
                            -86_400_000]),
            providers=["mbta", "mbta", "opensky"],
            vehicles=["veh-1", "veh-2", "pre-1970"])
        assert store.upsert_positions_packed(rows) == 2  # veh-1 is older
        pos = {d["_id"]: d for d in store.all_positions()}
        assert pos["mbta|veh-1"] == new
        assert pos == {d["_id"]: d for d in [new, *rows.to_docs()[1:]]}
        store.close()


def test_client_handshake_ping_and_errors(time_limit):
    with MockMongod() as uri:
        c = WireClient.from_uri(uri)
        assert c.max_wire_version >= 8
        c.ping()
        with pytest.raises(WireError):
            c.command("admin", {"bogusCommand": 1})
        updates = [{"q": {"_id": f"k{i}"},
                    "u": {"$set": {"_id": f"k{i}", "v": i}}, "upsert": True}
                   for i in range(25)]
        assert len(c.update("db", "things", updates)["upserted"]) == 25
        docs = list(c.find("db", "things", {}, sort={"v": 1}, batch_size=7))
        assert [d["v"] for d in docs] == list(range(25))
        r = c.update("db", "things", updates)
        assert r.get("upserted", []) == [] and r["nModified"] == 0
        c.close()


def test_indexes_reach_the_server(time_limit):
    m = MockMongod()
    try:
        store = MongoStore(m.uri, "mobility")      # the default backend
        assert isinstance(store._b, _WireBackend)  # no pymongo here
        assert any(i.get("unique") for i in
                   m.state.indexes[("mobility", "positions_latest")])
        assert any(i.get("expireAfterSeconds") == 0 for i in
                   m.state.indexes[("mobility", "tiles")])
        store.close()
    finally:
        m.close()


# ---- JSONL -----------------------------------------------------------------

def _fill(store, rng):
    store.upsert_tiles_packed(_body(rng, 200), META)
    store.upsert_positions([
        PositionDoc("mbta", f"veh-{i % 5}", epoch_to_dt(1_700_000_000 + i),
                    42.0 + i, -71.0) for i in range(12)])
    store.upsert_positions([PositionDoc("mbta", "veh-0",
                                        epoch_to_dt(1_600_000_000), 0, 0)])


@pytest.mark.parametrize("closed", [True, False])
def test_jsonl_store_reloads_its_view(tmp_path, closed):
    """Reopened after a close (the compacted file) or without one (the op
    log as a crash leaves it): the same tiles and positions."""
    rng = np.random.default_rng(3)
    store = JsonlStore(str(tmp_path))
    _fill(store, rng)
    want_t, want_p = store._tiles, store._positions
    if closed:
        store.close()
    else:
        store.flush()
    again = JsonlStore(str(tmp_path))
    assert again._tiles == want_t and again._positions == want_p
    assert again.n_positions == 5
    again.close()
    assert (tmp_path / "store.jsonl").exists()


# ---- make_store --------------------------------------------------------------

def _closed_port_uri():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"mongodb://127.0.0.1:{port}"


@pytest.mark.parametrize("kind", ["memory", "jsonl", "mongo", "auto",
                                  "auto_unreachable", "mongo_unreachable"])
def test_make_store_kinds(tmp_path, time_limit, kind, caplog):
    with MockMongod() as uri:
        env = {"HEATMAP_STORE": kind.split("_")[0], "MONGO_DB": "heat",
               "MONGO_URI": (_closed_port_uri() if "unreachable" in kind
                             else uri), "CHECKPOINT": str(tmp_path)}
        cfg = load_config(env)
        assert cfg.mongo_db == "heat" and cfg.store == env["HEATMAP_STORE"]
        if kind == "mongo_unreachable":
            with pytest.raises(OSError):
                make_store(cfg)
            return
        store = make_store(cfg)
        want = {"memory": MemoryStore, "jsonl": JsonlStore,
                "mongo": MongoStore, "auto": MongoStore,
                "auto_unreachable": MemoryStore}[kind]
        assert type(store) is want
        if kind == "jsonl":
            assert store.path == str(tmp_path / "store.jsonl")
        if kind == "auto_unreachable":
            assert "using in-memory store" in caplog.text
        store.close()


def test_store_knob_validated():
    with pytest.raises(ValueError, match="HEATMAP_STORE"):
        load_config({"HEATMAP_STORE": "mongodb"})


# ---- the writer ----------------------------------------------------------------

class _Flaky(MemoryStore):
    """Packed tile upserts raise on the calls in ``fail``."""

    def __init__(self, fail):
        super().__init__()
        self.calls, self.fail = 0, set(fail)

    def upsert_tiles_packed(self, body, meta):
        self.calls += 1
        if self.calls in self.fail:
            raise OSError("sink down")
        return super().upsert_tiles_packed(body, meta)


def _bodies():
    rng = np.random.default_rng(11)
    return [_body(rng, 64) for _ in range(4)]


def test_writer_drains_and_counts():
    store = MemoryStore()
    w = AsyncWriter(store)
    marks = []
    for b in _bodies():
        w.submit_tiles_packed(b, META)
    w.submit_positions_packed(PositionRows(
        np.float32([1.0]), np.float32([2.0]), np.int64([1_700_000_000_000]),
        ["p"], ["v"]))
    w.submit_positions_packed(PositionRows(np.float32([]), np.float32([]),
                                           np.int64([]), [], []))
    w.submit_mark(lambda: marks.append(store.n_tiles))
    w.drain()
    want = MemoryStore()
    for b in _bodies():
        want.upsert_tiles_packed(b, META)
    assert store._tiles == want._tiles and marks == [want.n_tiles]
    c = w.counters
    assert c["tiles_written"] == sum(
        len(packed_tile_docs(b, META)) for b in _bodies())
    assert c["positions_written"] == 1 and c["sink_retries"] == 0
    w.close()
    assert not w._thread.is_alive()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_writer_retries_a_transient_failure(pkg):
    """The 2nd write fails once: one retry, the docs as without it, the
    same in both packages."""
    store = _Flaky(fail={2})
    w = (AsyncWriter if pkg == "port" else JaxAsyncWriter)(
        store, backoff_s=0.01)
    for b in _bodies():
        w.submit_tiles_packed(b, META)
    w.close()
    want = MemoryStore()
    for b in _bodies():
        want.upsert_tiles_packed(b, META)
    assert store._tiles == want._tiles and not w.poisoned
    assert w.counters["sink_retries"] == 1 and store.calls == 5


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_writer_poisons_past_its_retries(pkg):
    """Write 2 fails on every attempt (1 + 3 retries): the writer poisons,
    drops the later writes and runs no later mark; drain, submit and close
    raise, sticky; the store holds write 1 only, the same in both
    packages."""
    store = _Flaky(fail={2, 3, 4, 5})
    w = (AsyncWriter if pkg == "port" else JaxAsyncWriter)(
        store, backoff_s=0.001)
    marks = []
    bodies = _bodies()
    for b in bodies:
        w.submit_tiles_packed(b, META)
    w.submit_mark(lambda: marks.append(1))
    with pytest.raises(RuntimeError, match="async sink write failed") as e:
        w.drain()
    assert isinstance(e.value.__cause__, OSError)
    assert w.poisoned and marks == [] and store.calls == 5
    assert w.counters["sink_retries"] == 3
    with pytest.raises(RuntimeError, match="async sink write failed"):
        w.submit_tiles_packed(bodies[0], META)
    with pytest.raises(RuntimeError, match="async sink write failed"):
        w.close()
    assert not w._thread.is_alive()
    want = MemoryStore()
    want.upsert_tiles_packed(bodies[0], META)
    assert store._tiles == want._tiles
