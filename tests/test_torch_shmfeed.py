"""The port's shared-memory feeder process (``stream/shmfeed.py``,
``HEATMAP_FEEDER=proc``): the cases of the JAX package's
``tests/test_shmfeed.py`` against the port's runtime on the CPU.

The chain: the port's mock broker -> the feeder process (the port's wire
``KafkaSource``, columnar values, native codecs) -> the shm slot ring ->
``MicroBatchRuntime(device="cpu")`` -> ``MemoryStore``.

- conservation: every published event reaches the fold and the tile
  counts account for all of them;
- seek replay: after a seek to an earlier offset the feeder re-delivers
  exactly the suffix, no stale pre-seek slot leaking through;
- an oversize poll (values larger than a slot) arrives whole, spanning
  slots, its offset moving only with the final slice;
- restart replay: a runtime and its feeder abandoned after commits, then
  a fresh feeder resumed from the checkpoint, end with the uncrashed
  run's docs;
- clean close: the child exits, the block is unlinked, a second close
  does nothing;

and, beside them: a failing feeder raises from ``poll``; the columns
equal an in-process ``KafkaSource``'s on the same topic; and a fresh
interpreter that imports what the feeder child imports holds no
``torch``, ``jax`` or ``heatmap_tpu.*`` module.
"""

import subprocess
import sys

import pytest

from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.producers.base import KafkaPublisher
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.shmfeed import ShmFeederSource
from heatmap_tpu_torch.stream.source import KafkaSource, SyntheticSource
from heatmap_tpu_torch.testing.mock_kafka import MockKafkaBroker
from test_torch_stream import REPO

TOPIC = "t"


@pytest.fixture()
def broker(monkeypatch):
    for k in ("HEATMAP_FETCH_MAX_BYTES", "HEATMAP_FEEDER",
              "HEATMAP_H3_IMPL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HEATMAP_EVENT_FORMAT", "columnar")
    monkeypatch.setenv("HEATMAP_KAFKA_IMPL", "wire")
    b = MockKafkaBroker()
    yield b
    b.close()


def _publish(broker, n_events, batch=4096):
    syn = SyntheticSource(n_events=n_events, n_vehicles=200,
                          events_per_second=batch * 4)
    pub = KafkaPublisher(broker.bootstrap, TOPIC, event_format="columnar")
    published = 0
    while True:
        cols = syn.poll(batch)
        if not len(cols):
            break
        published += pub.publish_columns(cols)
    pub.close()
    return published


def _cfg(tmp_path, name, batch):
    return load_config({}, batch_size=batch, state_capacity_log2=12,
                       speed_hist_bins=0, store="memory",
                       checkpoint_dir=str(tmp_path / name))


def test_feeder_runtime_conservation(tmp_path, broker):
    batch = 2048
    src = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=batch, slots=3)
    try:
        published = _publish(broker, 20_000, batch)
        assert published == 20_000
        store = MemoryStore()
        rt = MicroBatchRuntime(_cfg(tmp_path, "ckpt", batch), src, store,
                               device="cpu", checkpoint_every=0)
        for _ in range(200):
            if rt.counters["events_valid"] >= published:
                break
            rt.step_once()
            rt.flush_pending()
        rt.writer.drain()
        assert rt.counters["events_valid"] == published
        assert sum(d["count"] for d in store._tiles.values()) == published
        m = rt.metrics
        assert m["values_decoded_native"] > 0
        assert m["values_decoded_python"] == 0
        assert m["p50_span_ms"]["wait"] is not None
        rt.close()
    finally:
        src.close()


def test_feeder_seek_replays_from_offset(broker):
    batch = 1024
    src = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=batch, slots=2)
    try:
        published = _publish(broker, 8_192, batch)
        first = first_off = None
        got = 0
        for _ in range(500):
            if got >= published:
                break
            cols = src.poll(batch)
            if first is None and len(cols):
                first_off = src.offset()
                first = got + len(cols)
            got += len(cols)
        assert got == published
        src.seek(first_off)
        regot = empties = 0
        while regot < published - first and empties < 50:
            cols = src.poll(batch)
            if len(cols):
                regot += len(cols)
                empties = 0
            else:
                empties += 1
        assert regot == published - first
    finally:
        src.close()


def test_oversize_poll_spans_slots(broker):
    src = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=512, slots=3)
    try:
        published = _publish(broker, 8_192, batch=4096)
        got = empties = 0
        oversize_seen = False
        while got < published and empties < 100:
            cols = src.poll(512)
            if len(cols) > 512:
                oversize_seen = True
            if len(cols):
                got += len(cols)
                empties = 0
            else:
                empties += 1
        assert got == published
        assert oversize_seen, (
            "publish chunks of 4096 over 3 partitions must produce "
            "records larger than the 512-row slots")
    finally:
        src.close()


def test_feeder_restart_replay_equivalence(tmp_path, broker):
    batch = 2048
    n_events = 16_384

    def drain(rt, target):
        for _ in range(200):
            if rt.counters["events_valid"] >= target:
                break
            rt.step_once()
            rt.flush_pending()
        rt.writer.drain()

    src0 = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=batch,
                           slots=2)
    try:
        published = _publish(broker, n_events, batch)
        store0 = MemoryStore()
        rt0 = MicroBatchRuntime(_cfg(tmp_path, "ckpt0", batch), src0, store0,
                                device="cpu", checkpoint_every=0)
        drain(rt0, published)
        expected = {k: (d["count"], d["avgSpeedKmh"])
                    for k, d in store0._tiles.items()}
        rt0.close()
    finally:
        src0.close()

    # the crashed run: a commit every batch, abandoned after 3 batches
    # with its feeder (the crash takes both)
    cfg = _cfg(tmp_path, "ckpt", batch)
    store = MemoryStore()
    src1 = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=batch,
                           slots=2)
    try:
        # a consumer attached after the publish sits at LATEST; replay the
        # topic from the start like the checkpointed seek would
        src1.seek({p: 0 for p in range(broker.state.num_partitions)})
        rt1 = MicroBatchRuntime(cfg, src1, store, device="cpu",
                                checkpoint_every=1)
        for _ in range(3):
            rt1.step_once()
        rt1.flush_pending()
        rt1.writer.drain()
        rt1._ckpt_join()
        assert rt1.counters["checkpoints"] >= 1
    finally:
        src1.close()

    src2 = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=batch,
                           slots=2)
    try:
        rt2 = MicroBatchRuntime(cfg, src2, store, device="cpu",
                                checkpoint_every=1)
        assert rt2.epoch >= 1
        idle = 0
        while idle < 8:
            before = rt2.counters["events_valid"]
            rt2.step_once()
            rt2.flush_pending()
            idle = idle + 1 if rt2.counters["events_valid"] == before else 0
        rt2.writer.drain()
        got = {k: (d["count"], d["avgSpeedKmh"])
               for k, d in store._tiles.items()}
        assert set(got) == set(expected)
        for k, (cnt, avg) in got.items():
            assert cnt == expected[k][0], k
            # fetch interleaving can shift batch boundaries between the
            # runs, so the Kahan sums may differ in the last ulp
            assert avg == pytest.approx(expected[k][1], rel=1e-5), k
        rt2.close()
    finally:
        src2.close()


def test_feeder_close_is_clean(broker):
    from multiprocessing import shared_memory

    src = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=512, slots=2)
    proc, name = src._proc, src._shm.name
    src.close()
    assert not proc.is_alive()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
    src.close()   # a second close does nothing


def test_feeder_columns_equal_the_in_process_source(broker):
    """The same topic through the feeder and through an in-process
    source polled the same way: the same rows, names and offsets."""
    src = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=4096, slots=4)
    ref = KafkaSource(broker.bootstrap, TOPIC)
    try:
        published = _publish(broker, 12_288, batch=4096)
        rows, ref_rows = [], []
        for _ in range(300):
            if len(rows) >= published:
                break
            cols = src.poll(4096)
            rows += [(cols.vehicles[v], int(t), float(x)) for v, t, x in
                     zip(cols.vehicle_id, cols.ts_s, cols.lat_deg)]
        for _ in range(50):
            if len(ref_rows) >= published:
                break
            cols = ref.poll(4096)
            if len(cols):
                ref_rows += [(cols.vehicles[v], int(t), float(x)) for v, t, x
                             in zip(cols.vehicle_id, cols.ts_s,
                                    cols.lat_deg)]
        assert sorted(rows) == sorted(ref_rows)
        assert len(rows) == published
        assert src.offset() == ref.offset()
        assert src.counters["values_decoded_native"] == \
            ref.counters["values_decoded_native"]
    finally:
        src.close()
        ref.close()


def test_feeder_failure_raises_from_poll(broker):
    """A feeder that fails (here: a seek to an offset map its source
    cannot read) reports its traceback, and ``poll`` raises it: nothing
    falls back to an in-process source or to empty batches."""
    src = ShmFeederSource(broker.bootstrap, TOPIC, batch_size=512, slots=2)
    try:
        src.seek({"0": "not-an-offset"})
        with pytest.raises(RuntimeError, match="shm feeder process failed"):
            for _ in range(100):
                src.poll(512)
    finally:
        src.close()


FEEDER_IMPORTS = """
import sys
import heatmap_tpu_torch.stream.shmfeed
from heatmap_tpu_torch.stream.shmfeed import _feeder_main
from heatmap_tpu_torch.stream.source import KafkaSource
import heatmap_tpu_torch.kafka, heatmap_tpu_torch.native
import heatmap_tpu_torch.stream.binfmt, heatmap_tpu_torch.stream.colfmt
bad = sorted(m for m in sys.modules if m in ("torch", "jax")
             or m.startswith(("torch.", "jax.", "heatmap_tpu.")))
print(",".join(bad) or "clean")
"""


def test_feeder_child_imports_no_torch():
    out = subprocess.run([sys.executable, "-c", FEEDER_IMPORTS], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
