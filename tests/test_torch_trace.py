"""The port's ProfilerTracer (stream/trace.py): the cases of the JAX
package's ``tests/test_trace.py`` over a fake profiler seam (window
accounting, env handling, the partial window written at stop and on an
exception, double stop, run-time arming, the busy refusal), the window
knobs parsed as the reference parses them, the profiler prepared a batch
ahead of its window and a prepared window cancelled by a stop, and one
real ``torch.profiler`` window on the CPU over 2 batches that writes a
Chrome-trace file holding both batches' annotations and no other's."""

import json
import threading

import pytest
import torch

from heatmap_tpu.stream.trace import ProfilerTracer as JaxTracer
from heatmap_tpu_torch.stream import trace
from heatmap_tpu_torch.stream.trace import ProfilerTracer, Tracer


class FakeProfiler:
    """Stands in for torch.profiler: records windows prepared, started
    and cancelled, and the paths each finished window was written to."""

    def __init__(self, start_raises=None):
        self.prepared = 0
        self.starts = []
        self.written = []
        self.cancels = 0
        self._start_raises = start_raises

    def __call__(self, cuda):
        if self._start_raises:
            raise self._start_raises
        self.prepared += 1
        fake = self

        class Window:
            def start(self):
                fake.starts.append(cuda)

            def annotate(self, epoch):
                return torch.profiler.record_function(f"fake#{epoch}")

            def finish(self, path):
                fake.written.append(path)

            def cancel(self):
                fake.cancels += 1

        return Window()

    @property
    def stops(self):
        return len(self.written)


@pytest.fixture()
def fake(monkeypatch):
    fp = FakeProfiler()
    monkeypatch.setattr(trace, "open_window", fp)
    return fp


def _run_batches(tr, n, start=0):
    for epoch in range(start, start + n):
        with tr.batch(epoch):
            pass


def test_alias_is_the_same_class():
    assert Tracer is ProfilerTracer


def test_disabled_without_dir_never_touches_profiler(fake):
    tr = ProfilerTracer(env={})
    _run_batches(tr, 5)
    tr.stop()
    assert fake.starts == [] and fake.stops == 0


def test_skip_and_batches_accounting(fake, tmp_path):
    tr = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path),
                             "HEATMAP_PROFILE_SKIP": "2",
                             "HEATMAP_PROFILE_BATCHES": "3"})
    _run_batches(tr, 1)
    assert fake.prepared == 0
    _run_batches(tr, 1, start=1)      # the batch before the window
    assert fake.prepared == 1 and fake.starts == []
    _run_batches(tr, 1, start=2)
    assert fake.starts == [False] and fake.stops == 0
    assert fake.prepared == 1
    _run_batches(tr, 1, start=3)
    assert fake.stops == 0
    _run_batches(tr, 1, start=4)      # epoch 4 = 3rd traced batch
    assert fake.written == [str(tmp_path / f"trace-{_pid()}-2.pt.trace.json")]
    assert tr.written == fake.written and not tr.busy
    _run_batches(tr, 5, start=5)      # window done: no re-start
    assert fake.starts == [False] and fake.stops == 1


def _pid():
    import os

    return os.getpid()


@pytest.mark.parametrize("env", [
    {"HEATMAP_PROFILE_SKIP": "banana", "HEATMAP_PROFILE_BATCHES": "2"},
    {"HEATMAP_PROFILE_SKIP": "-5", "HEATMAP_PROFILE_BATCHES": "0"},
    {"HEATMAP_PROFILE_SKIP": "4", "HEATMAP_PROFILE_BATCHES": "4"},
    {},
])
def test_window_knobs_parse_as_the_reference(tmp_path, env):
    env = dict(env, HEATMAP_PROFILE_DIR=str(tmp_path))
    tr, jtr = ProfilerTracer(env=env), JaxTracer(env=env)
    assert (tr.skip, tr.batches, tr.busy) == (jtr.skip, jtr.batches,
                                              jtr.busy)


def test_negative_env_values_clamped(fake, tmp_path):
    tr = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path),
                             "HEATMAP_PROFILE_SKIP": "-5",
                             "HEATMAP_PROFILE_BATCHES": "0"})
    assert tr.skip == 0 and tr.batches == 1
    _run_batches(tr, 2)
    assert len(fake.starts) == 1 and fake.stops == 1


def test_partial_capture_flushed_on_early_close(fake, tmp_path):
    tr = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path),
                             "HEATMAP_PROFILE_SKIP": "0",
                             "HEATMAP_PROFILE_BATCHES": "100"})
    _run_batches(tr, 3)
    assert fake.starts and fake.stops == 0
    tr.stop()
    assert fake.stops == 1


def test_double_stop_safe(fake, tmp_path):
    tr = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path),
                             "HEATMAP_PROFILE_SKIP": "0"})
    _run_batches(tr, 1)
    tr.stop()
    tr.stop()
    assert fake.stops == 1
    tr2 = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path)})
    tr2.stop()
    assert fake.stops == 1


def test_exception_escaping_batch_flushes(fake, tmp_path):
    tr = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path),
                             "HEATMAP_PROFILE_SKIP": "0",
                             "HEATMAP_PROFILE_BATCHES": "50"})
    with pytest.raises(RuntimeError):
        with tr.batch(0):
            raise RuntimeError("boom")
    assert fake.stops == 1 and not tr.busy


def test_start_failure_disables_window(monkeypatch, tmp_path):
    fp = FakeProfiler(start_raises=RuntimeError("unsupported"))
    monkeypatch.setattr(trace, "open_window", fp)
    tr = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path),
                             "HEATMAP_PROFILE_SKIP": "0"})
    _run_batches(tr, 3)
    assert fp.stops == 0 and not tr.busy


def test_arm_runtime_window_and_busy_refusal(fake, tmp_path):
    tr = ProfilerTracer(env={})
    assert not tr.busy
    assert tr.arm(str(tmp_path), batches=2, skip=1, base_epoch=10)
    assert tr.busy
    assert not tr.arm(str(tmp_path), batches=2)      # pending -> refuse
    _run_batches(tr, 1, start=10)                    # skip batch
    assert fake.starts == []
    _run_batches(tr, 1, start=11)                    # window starts
    assert len(fake.starts) == 1
    assert not tr.arm(str(tmp_path), batches=2)      # active -> refuse
    _run_batches(tr, 1, start=12)                    # window ends
    assert fake.stops == 1 and not tr.busy
    assert tr.arm(str(tmp_path / "w2"), batches=1, base_epoch=13)
    _run_batches(tr, 1, start=13)
    assert fake.written[-1].startswith(str(tmp_path / "w2"))
    assert fake.stops == 2


def test_arm_rejects_empty_dir_and_clamps(fake, tmp_path):
    tr = ProfilerTracer(env={})
    assert not tr.arm("")
    assert tr.arm(str(tmp_path), batches=0, skip=-3, base_epoch=5)
    assert tr.batches == 1 and tr.skip == 5


def test_stop_cancels_a_prepared_window(fake, tmp_path):
    tr = ProfilerTracer(env={})
    assert tr.arm(str(tmp_path), batches=2, skip=3, base_epoch=0)
    _run_batches(tr, 3)               # prepared at epoch 2, never started
    assert fake.prepared == 1 and fake.starts == []
    tr.stop()
    assert fake.cancels == 1 and fake.stops == 0 and not tr.busy
    _run_batches(tr, 5, start=3)
    assert fake.prepared == 1 and fake.starts == []


def test_stop_cancels_pending_window(fake, tmp_path):
    tr = ProfilerTracer(env={})
    assert tr.arm(str(tmp_path), batches=4, skip=100, base_epoch=0)
    tr.stop()
    assert not tr.busy and fake.stops == 0
    _run_batches(tr, 200)
    assert fake.starts == []


def test_arm_is_thread_safe_single_winner(fake, tmp_path):
    tr = ProfilerTracer(env={})
    wins = []
    barrier = threading.Barrier(8)

    def try_arm(i):
        barrier.wait()
        if tr.arm(str(tmp_path / f"w{i}"), batches=1):
            wins.append(i)

    ts = [threading.Thread(target=try_arm, args=(i,)) for i in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert len(wins) == 1


def test_a_real_cpu_window_writes_a_chrome_trace(tmp_path):
    """torch.profiler on the CPU over 2 batches of a small matmul: one
    Chrome-trace file, holding both batches' annotations and their ops."""
    tr = ProfilerTracer(env={"HEATMAP_PROFILE_DIR": str(tmp_path / "prof"),
                             "HEATMAP_PROFILE_SKIP": "1",
                             "HEATMAP_PROFILE_BATCHES": "2"},
                        device=torch.device("cpu"))
    x = torch.ones(64, 64)
    for epoch in range(4):
        with tr.batch(epoch):
            x = (x @ x) / 64
    assert not tr.busy
    (path,) = tr.written
    assert path.endswith(".pt.trace.json")
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == [
        path.rsplit("/", 1)[1]]
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"microbatch#1", "microbatch#2"} <= names
    assert "microbatch#0" not in names and "microbatch#3" not in names
    assert any(n and "mm" in n for n in names)
