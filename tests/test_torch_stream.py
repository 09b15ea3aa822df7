"""The port's streaming runtime against the JAX package's, and the port's
independence from JAX.

Both runtimes fold the same small ``SyntheticSource`` stream (timestamps
over several 5-minute windows, so windows close and evict) into a
``MemoryStore``.  The reference runs with HEATMAP_H3_IMPL=xla,
HEATMAP_MERGE_IMPL=sort, HEATMAP_FASTPATH=0 and HEATMAP_EMIT_FLUSH_K=1; the
port has one route for each of these, the same (its snap is the geometry
kernel's plain version on the CPU, then the table stage).

The two snaps are not bit-identical on the CPU: the face search differs in
its expression tree (an unrolled compare against a matmul plus argmax), and
the reference's cos/sin come from the C library, PyTorch's from its vector
math library, so a point within ~1e-3 grid units of a cell edge may land in
the neighbouring cell (tests/test_torch_hexgrid.py measures the share).
The bars:

- at most 0.2% of the events may snap differently (the reference's own bar
  between its two snaps), counted event by event;
- the docs of every (cell, window) that no such event touches: the same
  set on both sides, counts exact, average and stddev of speed and p95
  within 1e-6 relative (their sums match bit for bit, see
  test_torch_engine.py), centroid within 1e-5 degrees (the per-event
  half-ulp of the fused multiply-add noted in test_torch_engine.py);
- the counts summed over all docs equal on both sides (conservation).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.engine import step as jstep
from heatmap_tpu.hexgrid import device as jdev
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream import SyntheticSource as JaxSyntheticSource
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.hexgrid import snap_kernel
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource

REPO = Path(__file__).resolve().parents[1]
RES = 9
BATCH = 1 << 12
CAP_LOG2 = 14
# 3.5 batches at 8 events/s of sim time: ~30 minutes of event time
N_EVENTS = 3 * BATCH + BATCH // 2
SOURCE_ARGS = dict(n_events=N_EVENTS, n_vehicles=300,
                   events_per_second=8, t0=1_700_000_000)
AXES = dict(city="bos", h3_res=RES, resolutions=(RES,), windows_minutes=(5,),
            tile_minutes=5, batch_size=BATCH, state_capacity_log2=CAP_LOG2,
            speed_hist_bins=64)


@pytest.fixture
def reference_env(monkeypatch):
    for k, v in (("HEATMAP_H3_IMPL", "xla"), ("HEATMAP_MERGE_IMPL", "sort"),
                 ("HEATMAP_FASTPATH", "0"), ("HEATMAP_EMIT_FLUSH_K", "1")):
        monkeypatch.setenv(k, v)
    # the JAX runtime pins these module slots at init; restore them after
    for slot in ("SNAP_IMPL", "MERGE_IMPL", "FASTPATH", "MERGE_BANK_PIN"):
        monkeypatch.setattr(jstep, slot, getattr(jstep, slot))


def run_jax(tmp_path):
    cfg = jax_load_config(None, checkpoint_dir=str(tmp_path / "ckpt"),
                          store="memory", state_max_log2=CAP_LOG2,
                          emit_flush_k=1, **AXES)
    store = JaxMemoryStore()
    rt = JaxRuntime(cfg, JaxSyntheticSource(**SOURCE_ARGS), store,
                    checkpoint_every=0)
    rt.run()
    return store._tiles


def run_port():
    cfg = load_config(None, **AXES)
    store = MemoryStore()
    rt = MicroBatchRuntime(cfg, SyntheticSource(**SOURCE_ARGS), store,
                           device="cpu")
    rt.run()
    return store._tiles, rt.metrics


def snap_disagreements():
    """(cell id, window start) pairs touched by events that the port's snap
    (the runtime's own route) and the reference's XLA snap place
    differently, and the share of such events."""
    cols = SyntheticSource(**SOURCE_ARGS).poll(N_EVENTS)
    hi, lo = jdev.latlng_to_cell_vec(cols.lat_rad, cols.lng_rad, RES)
    ref = jdev.cells_to_uint64(hi, lo)
    th, tl = snap_kernel.latlng_to_cell_kernel(
        torch.from_numpy(cols.lat_rad), torch.from_numpy(cols.lng_rad), RES)
    mine = jdev.cells_to_uint64(th.numpy().view(np.uint32),
                                tl.numpy().view(np.uint32))
    bad = np.nonzero(ref != mine)[0]
    ws = (cols.ts_s // 300) * 300
    touched = set()
    for i in bad:
        for cell in (ref[i], mine[i]):
            touched.add((format(int(cell), "x"), int(ws[i])))
    return touched, len(bad) / N_EVENTS


def test_runtime_matches_jax_runtime(tmp_path, reference_env):
    ref_docs = run_jax(tmp_path)
    docs, metrics = run_port()
    touched, bad_share = snap_disagreements()
    assert bad_share <= 0.002, bad_share

    key = lambda d: (d["cellId"], int(d["windowStart"].timestamp()))
    ref = {key(d): d for d in ref_docs.values()}
    mine = {key(d): d for d in docs.values()}
    # several windows, and nothing lost on either side
    assert len({k[1] for k in mine}) >= 5
    assert sum(d["count"] for d in mine.values()) == N_EVENTS
    assert sum(d["count"] for d in ref.values()) == N_EVENTS
    assert metrics["events_valid"] == N_EVENTS
    assert metrics["state_overflow"] == 0

    clean_ref = {k: d for k, d in ref.items() if k not in touched}
    clean = {k: d for k, d in mine.items() if k not in touched}
    assert clean.keys() == clean_ref.keys()
    assert len(clean) >= len(ref) - 2 * len(touched)
    for k, d in clean.items():
        r = clean_ref[k]
        assert d["_id"] == r["_id"] and d["count"] == r["count"], k
        for f in ("avgSpeedKmh", "stddevSpeedKmh", "p95SpeedKmh"):
            assert d[f] == pytest.approx(r[f], rel=1e-6, abs=1e-9), (k, f)
        for a, b in zip(d["centroid"]["coordinates"],
                        r["centroid"]["coordinates"]):
            assert abs(a - b) <= 1e-5, (k, a, b)
        assert d["windowEnd"] == r["windowEnd"]
        assert d["staleAt"] == r["staleAt"]


def test_entry_point_needs_a_card_or_cpu(monkeypatch):
    """No CUDA device and no --device cpu: the entry point raises."""
    from heatmap_tpu_torch.stream import __main__ as entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["synthetic_backfill", "--max-batches", "1"])


_ISOLATION = r"""
import sys
import torch
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import SyntheticSource
import heatmap_tpu_torch.stream.__main__
import heatmap_tpu_torch._build
import heatmap_tpu_torch.hexgrid.snap_kernel
import heatmap_tpu_torch.profile_fold

cfg = load_config({}, city="bos", h3_res=9, resolutions=(9,),
                  batch_size=1024, state_capacity_log2=12)
store = MemoryStore()
rt = MicroBatchRuntime(cfg, SyntheticSource(n_events=2048), store,
                       device="cpu")
rt.run()
assert store.n_tiles > 0
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "heatmap_tpu" or m.startswith("heatmap_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_never_imports_jax_or_the_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    p = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "LEAKED []" in p.stdout


def test_port_sources_name_no_jax_import():
    """No file of the port imports jax or heatmap_tpu (source scan)."""
    import ast

    offenders = []
    for path in sorted((REPO / "heatmap_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "heatmap_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
