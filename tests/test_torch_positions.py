"""``positions_latest`` and the stores behind the writer thread: the port's
positions fold and runtime against the JAX package's.

- ``_fold_positions`` against JAX's on crafted batches through one
  persistent table each: ties on equal timestamps (the later row wins),
  pre-1970 timestamps, vehicle ids that grow the table, an older event
  after a newer one (nothing emitted), ids past the batch's name lists.
  The rows are compared field by field, exactly.
- Both runtimes consume one mock-broker topic on their native codecs
  (``heatmap_tpu.native.maybe_decoder`` left as it is), each writing
  through its writer thread into a memory, a JSONL and a mock-mongod store
  at once; the port's run is killed after a commit and one more batch and
  resumed by a new runtime with a new source (its decoder's intern tables
  start empty) and the JSONL store reopened from its log.  Within each
  package the three stores hold identical tile and position docs; across
  the packages the tile docs meet the bars of
  ``test_torch_pipelines.py::assert_pair_docs_match`` (within a package:
  ``test_torch_sink.py::assert_docs_equal``) and the
  ``positions_latest`` docs are identical: the newest event of each
  vehicle, with its own provider and vehicle names, whatever batches,
  intern ids or replays led there.
"""

import types

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.sink import JsonlStore as JaxJsonlStore
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.sink.mongo import MongoStore as JaxMongoStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import events as jevents
from heatmap_tpu.stream.source import KafkaSource as JaxKafkaSource
from heatmap_tpu.testing import MockMongod as JaxMockMongod
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.kafka import client as tclient
from heatmap_tpu_torch.sink import JsonlStore, MemoryStore
from heatmap_tpu_torch.sink.mongo import MongoStore
from heatmap_tpu_torch.stream import events as tevents
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import KafkaSource
from heatmap_tpu_torch.testing.mock_kafka import MockKafkaBroker
from heatmap_tpu_torch.testing.mock_mongod import MockMongod
from test_torch_kafka import (AXES, N_VALID, TOPIC, drain, produce_values,
                              step_until, stream_events, touched_of)
from test_torch_pipelines import assert_pair_docs_match
from test_torch_sink import assert_docs_equal
from test_torch_stream import _pin_reference

# (vehicle ids, timestamps) of each crafted batch
BATCHES = [
    ([0, 0, 0, 1, 1, 0], [100, 100, 99, 5, 5, 100]),    # equal-ts ties
    ([2, 2, 3, 3], [-500, -100, -1, -86_400]),          # pre-1970
    ([5000, 3000, 0, 5000], [200, 201, 200, 199]),      # the table grows
    ([0, 1, 3000], [150, 4, 201]),                      # all older
    ([1, 2, 7], [6, -50, 10]),                          # names past lists
]


def _fold(pkg, batches):
    """Each batch's rows from ``pkg``'s ``_fold_positions``, through one
    persistent table (the method on a bare object holding its state)."""
    mod, cls = ((tevents, MicroBatchRuntime) if pkg == "port"
                else (jevents, JaxRuntime))
    state = types.SimpleNamespace(_pos_ts=np.full(1024, -(2**62), np.int64),
                                  _pos_win=None)
    out = []
    for k, (vid, ts) in enumerate(batches):
        n = len(vid)
        rng = np.random.default_rng(k)
        names = [f"veh-{i}" for i in range(6)]
        cols = mod.columns_from_arrays(
            rng.uniform(-80, 80, n), rng.uniform(-170, 170, n),
            np.zeros(n, np.float32), np.int32(ts),
            provider_id=np.int32([i % 3 for i in range(n)]),
            vehicle_id=np.int32(vid), providers=["mbta", "opensky"],
            vehicles=names)
        out.append(cls._fold_positions(state, cols))
    return out


def test_fold_positions_matches_jax():
    mine, ref = _fold("port", BATCHES), _fold("jax", BATCHES)
    for k, (a, b) in enumerate(zip(mine, ref)):
        if b is None:
            assert a is None, k
            continue
        assert a._fields == b._fields
        for f in ("lat", "lon", "ts_ms"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (k, f)
        assert (a.providers, a.vehicles) == (b.providers, b.vehicles), k
    assert mine[3] is None                       # older events emit nothing
    assert list(mine[0].ts_ms) == [5_000, 100_000]   # rows 4 and 5 win
    assert "?" in mine[4].providers and "7" in mine[4].vehicles


class _Tee:
    """One runtime's writes into several stores at once (the first one's
    count is the write's)."""

    def __init__(self, *stores):
        self.stores = stores

    def _each(self, name, *args):
        return [getattr(s, name)(*args) for s in self.stores][0]

    def upsert_tiles(self, docs):
        return self._each("upsert_tiles", docs)

    def upsert_tiles_packed(self, body, meta):
        return self._each("upsert_tiles_packed", body, meta)

    def upsert_positions(self, docs):
        return self._each("upsert_positions", docs)

    def upsert_positions_packed(self, rows):
        return self._each("upsert_positions_packed", rows)

    def flush(self):
        self._each("flush")


def _contents(store):
    """(tiles by _id, positions by _id) that a store holds."""
    if hasattr(store, "_b"):                     # a MongoStore
        tiles = {d["_id"]: d for d in store._b.find("tiles", {})}
    else:
        tiles = store._tiles
    return tiles, {d["_id"]: d for d in store.all_positions()}


def _assert_same_contents(stores):
    """The stores' docs: the tiles under ``assert_docs_equal`` (Mongo's
    come from the C++ encoder), the positions exactly."""
    first = _contents(stores[0])
    for s in stores[1:]:
        got = _contents(s)
        assert_docs_equal(got[0], first[0])
        assert got[1] == first[1], type(s).__name__
    return first


def test_both_runtimes_write_the_same_docs_to_every_store(tmp_path,
                                                          monkeypatch):
    _pin_reference(monkeypatch, {})
    for k in ("HEATMAP_EVENT_FORMAT", "HEATMAP_KAFKA_IMPL",
              "HEATMAP_FETCH_MAX_BYTES", "HEATMAP_FEEDER"):
        monkeypatch.delenv(k, raising=False)
    keys, values, events = stream_events()
    with MockKafkaBroker() as bootstrap, MockMongod() as muri, \
            JaxMockMongod() as juri:
        jcfg = jax_load_config(None, checkpoint_dir=str(tmp_path / "jax"),
                               store="memory", kafka_bootstrap=bootstrap,
                               **AXES)
        jstores = (JaxMemoryStore(), JaxJsonlStore(str(tmp_path / "jj")),
                   JaxMongoStore(juri, "mobility"))
        jrt = JaxRuntime(jcfg, JaxKafkaSource(bootstrap, TOPIC, impl="wire"),
                         _Tee(*jstores))
        assert jrt.source._impl._dec is not None
        cfg = load_config({}, checkpoint_dir=str(tmp_path / "port"),
                          kafka_bootstrap=bootstrap, **AXES)
        runtime = lambda stores: MicroBatchRuntime(
            cfg, KafkaSource(bootstrap, TOPIC), _Tee(*stores), device="cpu",
            checkpoint_every=2)
        mem = MemoryStore()
        killed = (mem, JsonlStore(str(tmp_path / "pj")),
                  MongoStore(muri, "mobility"))
        rt = runtime(killed)
        produce_values(tclient, bootstrap, TOPIC, values, keys, batch=256)
        drain(jrt, len(values))
        # a commit at epoch 2, one batch more; what the writer was handed
        # lands, and the process "dies" (its JSONL file keeps the op log,
        # never compacted)
        step_until(rt, lambda: rt.epoch == 3)
        rt._ckpt_join()
        rt.writer.drain()
        killed[1]._fh.close()
        stores = (mem, JsonlStore(str(tmp_path / "pj")),
                  MongoStore(muri, "mobility"))
        resumed = runtime(stores)
        assert resumed.epoch == 2
        drain(resumed, len(values))
        m = resumed.metrics
        tiles, positions = _assert_same_contents(stores)
        jtiles, jpositions = _assert_same_contents(jstores)
        for s in (*stores, *jstores):
            s.close()
        reloaded = JsonlStore(str(tmp_path / "pj"))   # the compacted file
        assert _contents(reloaded) == (tiles, positions)
        reloaded.close()
    assert m["values_decoded_python"] == 0
    assert m["kafka_native_fallback_blobs"] == 0
    assert m["positions_emitted"] > 0
    assert m["positions_written"] <= m["positions_emitted"]
    assert_pair_docs_match(jtiles, tiles, cfg, N_VALID, touched_of(events))
    newest = {}
    for e in events:
        newest[e["vehicleId"]] = max(newest.get(e["vehicleId"], e["ts"]),
                                     e["ts"])
    assert positions == jpositions
    assert {d["vehicleId"]: int(d["ts"].timestamp())
            for d in positions.values()} == newest
    assert {d["provider"] for d in positions.values()} == {"synthetic"}
