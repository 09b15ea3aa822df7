"""The port's binary wire format (``serve/wire.py``) against the JAX
package's, on the CPU.

- Tile/delta frames: the port's native column writer (``NativeWireOps``,
  ``tile_ops.cpp`` ``enc_wire_cols``) and its Python writer
  (``encode_body_py``) give byte-identical frames, equal to the
  reference's ``encode`` (with its native writer), over docs that take
  every column: fixed-point and f64 speeds, p95/stddev subsets,
  windowMinutes, per-doc window overrides, naive datetimes, the velocity
  columns (the Python writer in both packages), an empty frame.
- Decoding either package's frame gives back the docs, so the serve
  tier's JSON render of the decoded docs equals the JSON path's bytes.
- The positions frame, byte for byte, and its decode.
- Docs the layout cannot represent raise ``ValueError`` in both.
- The fan-out: a slow subscriber is shed as lagged, ``finish`` closes.
- No g++: the app's native writer raises; nothing falls back.
"""

import datetime as dt

import numpy as np
import pytest

from heatmap_tpu.native import maybe_wire_ops
from heatmap_tpu.serve import api as japi
from heatmap_tpu.serve import wire as jwire
from heatmap_tpu_torch import _build
from heatmap_tpu_torch.native import NativeWireOps
from heatmap_tpu_torch.serve import api as tapi
from heatmap_tpu_torch.serve import wire as twire
from heatmap_tpu_torch.sink.base import PositionDoc
from test_torch_query import city_cells, tile_docs

UTC = dt.timezone.utc
WS = 1_700_000_100 // 300 * 300


def _docs(case, rng):
    cells = city_cells(300, 8, 11)
    docs = tile_docs(cells, WS, rng)
    if case == "f64":
        return docs
    if case == "fixed":
        for d in docs:
            d["avgSpeedKmh"] = round(d["avgSpeedKmh"], 2)
            d["p95SpeedKmh"] = round(d["p95SpeedKmh"], 2)
        return docs
    if case == "subsets":
        for i, d in enumerate(docs):
            if i % 3 == 0:
                del d["p95SpeedKmh"]
            if i % 4 == 0:
                del d["stddevSpeedKmh"]
            if i % 5 == 0:
                d["windowMinutes"] = 15
        return docs
    if case == "overrides":
        for d in docs[::7]:
            d["windowStart"] = d["windowStart"] - dt.timedelta(minutes=5)
            d["windowEnd"] = d["windowEnd"] - dt.timedelta(minutes=5)
        return docs
    if case == "naive":
        for d in docs:
            d["windowStart"] = d["windowStart"].replace(tzinfo=None)
            d["windowEnd"] = d["windowEnd"].replace(tzinfo=None)
        return docs
    if case == "velocity":
        for d in docs[::2]:
            d["vxKmh"] = round(float(rng.uniform(-50, 50)), 2)
            d["vyKmh"] = round(float(rng.uniform(-50, 50)), 2)
        return docs
    assert case == "empty"
    return []


CASES = ["f64", "fixed", "subsets", "overrides", "naive", "velocity",
         "empty"]


@pytest.fixture(scope="module")
def native():
    return NativeWireOps()


@pytest.mark.parametrize("mode", ["full", "delta"])
@pytest.mark.parametrize("case", CASES)
def test_frames_byte_identical_across_writers_and_packages(case, mode,
                                                           native):
    docs = _docs(case, np.random.default_rng(CASES.index(case)))
    ws = docs[0]["windowStart"] if docs else None
    nat = twire.encode(mode, 42, "h3r8", ws, docs, native=native)
    py = twire.encode(mode, 42, "h3r8", ws, docs)
    ref = jwire.encode(mode, 42, "h3r8", ws, docs, native=maybe_wire_ops())
    assert nat == py == ref
    assert twire.frame_seq(nat) == 42
    # decoding gives back the docs the JSON path renders
    for dec in (twire.decode(nat), jwire.decode(nat)):
        assert dec["mode"] == mode and dec["seq"] == 42
        assert (tapi._features_collection_json(dec["docs"])
                == tapi._features_collection_json(docs)
                == japi._features_collection_json(docs))
    assert twire.decode(nat) == jwire.decode(nat)


def test_native_column_writer_matches_the_python_one(native):
    """The column section alone, over random columns and both float
    encodings."""
    rng = np.random.default_rng(12)
    for n in (0, 1, 17, 1000):
        flags = [int(f) for f in rng.integers(0, 16, n)]
        deltas = [int(v) for v in rng.integers(-2**62, 2**62, n)]
        counts = [int(v) for v in rng.integers(0, 2**40, n)]
        speeds = [float(v) for v in rng.uniform(0, 200, n)]
        p95 = [round(float(v), 2) for v in rng.uniform(0, 200,
                                                       sum(f & 1 for f in flags))]
        std = [float(v) for v in rng.uniform(0, 20,
                                             sum(f >> 1 & 1 for f in flags))]
        wmin = [int(v) for v in rng.integers(0, 60,
                                             sum(f >> 2 & 1 for f in flags))]
        ovr = [int(v) for v in rng.integers(0, 2**50,
                                            2 * sum(f >> 3 & 1 for f in flags))]
        cols = (flags, deltas, counts, speeds, p95, std, wmin, ovr)
        assert (twire._encode_body_native(native, *cols)
                == twire.encode_body_py(*cols)
                == jwire.encode_body_py(*cols))


def test_positions_frame_matches_jax():
    rng = np.random.default_rng(13)
    docs = []
    for i in range(500):
        ts = dt.datetime.fromtimestamp(WS + int(rng.integers(0, 900)), UTC)
        if i % 11 == 0:
            ts = ts.replace(tzinfo=None)
        d = PositionDoc("mbta", f"v{i}", ts, float(rng.uniform(42.2, 42.5)),
                        float(rng.uniform(-71.2, -70.9)))
        if i % 13 == 0:
            del d["provider"]
        docs.append(d)
    frame = twire.encode_positions(docs)
    assert frame == jwire.encode_positions(docs)
    assert twire.decode_positions(frame) == jwire.decode_positions(frame)
    fc = lambda ds: tapi.json.dumps(tapi.positions_feature_collection(
        type("S", (), {"all_positions": lambda self: ds})()))
    assert fc(twire.decode_positions(frame)) == fc(docs)


@pytest.mark.parametrize("field,value", [
    ("p95SpeedKmh", 3), ("windowMinutes", 2.5), ("vxKmh", "east"),
    ("count", -1)])
def test_unrepresentable_docs_raise_in_both(field, value):
    docs = tile_docs(city_cells(5, 8, 14), WS, np.random.default_rng(14))
    docs[2][field] = value
    for w in (twire, jwire):
        with pytest.raises(ValueError):
            w.encode("full", 1, "h3r8", None, docs)
    with pytest.raises(ValueError):
        twire.decode(b"HW\x02\x00" + bytes(20))
    with pytest.raises(ValueError):
        twire.decode(twire.encode("full", 1, "h3r8", None, docs[:2])[:-3])


def test_fanout_sheds_a_lagged_subscriber_and_closes():
    shed = []
    hub = twire.FanoutHub(depth=2, on_lagged=lambda: shed.append(1))
    gate = twire.threading.Event()

    def pump(chan):
        gate.wait(5)
        for i in range(4):
            chan.broadcast(b"f%d" % i)
        chan.finish(b"end")

    chan, slow = hub.subscribe("k", pump)
    gate.set()
    got = []
    for _ in range(10):
        item = slow.pop(timeout=2)
        if item is None or item is twire.CLOSED:
            break
        got.append(item)
    assert got[-1] is twire.LAGGED and shed == [1]
    hub.unsubscribe(chan, slow)
    assert hub.max_write_stall_s() == 0.0


def test_missing_gxx_raises_for_the_wire_writer(monkeypatch, tmp_path):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ not found"):
        NativeWireOps()
    from heatmap_tpu_torch.config import load_config
    from heatmap_tpu_torch.sink.memory import MemoryStore

    with pytest.raises(_build.KernelBuildError):
        tapi.make_wsgi_app(MemoryStore(), load_config({}))
