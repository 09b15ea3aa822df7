"""The port's runtime introspection (obs/runtimeinfo.py) on the CPU.

- ``CompileTracker`` with the ``_build`` probe: a library loaded during a
  wrapped call within warmup is a compile, a real ``g++`` build from a
  fresh ``HEATMAP_NATIVE_CACHE`` after warmup is a compile and a retrace;
  plain calls count nothing; its families and snapshot keys are the JAX
  package's.
- ``MemoryMonitor`` on the CPU: the live-buffer bytes are the tensors the
  runtime holds (slabs, emit ring, staged feeds), with their watermark,
  and no device gauge.
- The runtime wraps its fold's entry points under the reference's labels
  (``multi_step``, ``multi_step_pre``).
- The acceptance scenarios of the JAX package's ``test_runtimeinfo.py``
  on a port runtime: a build forced into a step after warmup, and a
  memory budget of 1 byte, each give the metric, a degraded /healthz and
  the watchdog's enriched flight record; ``healthz_checks`` stays quiet
  when healthy; the watchdog captures once an episode, re-arms on
  recovery, and an episode that begins in the cooldown is captured once
  it lapses; a crash's flight record carries the introspection.
"""

import json
import shutil
import time

import jax
import jax.numpy as jnp
import pytest

from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu.obs.runtimeinfo import CompileTracker as JaxCompileTracker
from heatmap_tpu.obs.runtimeinfo import MemoryMonitor as JaxMemoryMonitor
from heatmap_tpu_torch import _build
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.engine import multi as tmulti
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.obs.runtimeinfo import (
    CompileTracker,
    SloWatchdog,
    healthz_checks,
)
from heatmap_tpu_torch.serve.api import healthz_payload
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import MemorySource


@pytest.fixture(autouse=True)
def _quiesce_port_stack_sampler():
    """Stop the port's process-wide stack sampler after each test, as
    tests/conftest.py stops the JAX package's: a sampler left running
    holds frame references into the later tests of the same worker (an
    exported shared-memory view then blocks a SharedMemory close)."""
    yield
    from heatmap_tpu_torch.obs import prof

    if prof._SAMPLER is not None:
        prof._SAMPLER.stop()

FAMILIES = ("heatmap_compile_total", "heatmap_compile_seconds",
            "heatmap_retrace_after_warmup_total")


def _fam_shape(reg, name):
    f = reg._families[name]
    return f.type, f.labelnames


def _fresh_cache_with_copy(tmp_path, monkeypatch, name="copy"):
    """A fresh HEATMAP_NATIVE_CACHE holding a copy of the built native
    library, and no library loaded: the next ``load`` loads it anew."""
    lib = _build.build(_build.NATIVE_LIB)
    cache = tmp_path / name
    cache.mkdir()
    shutil.copy(lib, cache / lib.name)
    monkeypatch.setenv("HEATMAP_NATIVE_CACHE", str(cache))
    monkeypatch.setattr(_build, "_loaded", {})
    return cache


def test_compile_tracker_counts_builds_and_retraces(tmp_path, monkeypatch):
    reg = Registry()
    tr = CompileTracker(reg, warmup=3)
    what = {"load": False}

    def step(x):
        if what["load"]:
            _build.load(_build.NATIVE_LIB)
        return x + 1

    f = tr.wrap("f", step)
    # call 1, in warmup, loads a library: a compile, no retrace
    _fresh_cache_with_copy(tmp_path, monkeypatch)
    what["load"] = True
    assert f(1) == 2
    what["load"] = False
    for _ in range(2):
        f(1)
    assert reg._families["heatmap_compile_total"].labels(fn="f").value == 1
    assert tr.retraces_recent(600) == 0
    # call 4, past warmup, builds with g++ in a fresh cache: a retrace
    monkeypatch.setenv("HEATMAP_NATIVE_CACHE", str(tmp_path / "fresh"))
    monkeypatch.setattr(_build, "_loaded", {})
    what["load"] = True
    f(1)
    assert list((tmp_path / "fresh").glob("native-*.so"))
    assert reg._families["heatmap_compile_total"].labels(fn="f").value == 2
    assert (reg._families["heatmap_retrace_after_warmup_total"]
            .labels(fn="f").value == 1)
    assert reg._families["heatmap_compile_seconds"].labels(fn="f").count == 2
    assert tr.retraces_recent(600) == 1 == tr.retraces_total
    assert tr.retraces_recent(0) == 0
    snap = tr.snapshot()
    assert snap["functions"]["f"]["compiles"] == 2
    assert snap["functions"]["f"]["calls"] == 4
    assert snap["retraces_after_warmup"] == 1
    # a plain callable after that: nothing counted
    g = tr.wrap("g", lambda x: x * 2)
    assert g(21) == 42
    assert reg._families["heatmap_compile_total"].labels(fn="g").value == 0
    # the reference's families and snapshot shape
    jreg = JaxRegistry()
    jtr = JaxCompileTracker(jreg, warmup=3)
    jf = jtr.wrap("f", jax.jit(lambda x: x + 1))
    jf(jnp.ones(4)).block_until_ready()
    for name in FAMILIES:
        assert _fam_shape(reg, name) == _fam_shape(jreg, name), name
    jsnap = jtr.snapshot()
    assert set(snap) == set(jsnap)
    assert set(snap["functions"]["f"]) == set(jsnap["functions"]["f"])


# ------------------------------------------------------------ runtime
def _mk_events(n, age_s=2):
    t0 = int(time.time()) - age_s
    return [{"provider": "p", "vehicleId": f"v{i % 7}",
             "lat": 42.0 + (i % 40) * 1e-3, "lon": -71.0,
             "speedKmh": 10.0, "ts": t0} for i in range(n)]


def _mk_runtime(tmp_path, source=None, **over):
    over.setdefault("checkpoint_dir", str(tmp_path / "ckpt"))
    over.setdefault("batch_size", 16)
    over.setdefault("state_capacity_log2", 8)
    over.setdefault("speed_hist_bins", 4)
    over.setdefault("emit_flush_k", 1)
    over.setdefault("prefetch_batches", 0)
    cfg = load_config({}, **over)
    if source is None:
        source = MemorySource(_mk_events(16 * 4))
        source.finish()
    return MicroBatchRuntime(cfg, source, MemoryStore(), device="cpu",
                             checkpoint_every=0)


def _drain(rt):
    while rt.step_once():
        pass


@pytest.fixture
def quiet(monkeypatch):
    """The freshness budgets lifted and the watchdog's thread off, so a
    test reads the check it is about."""
    monkeypatch.setenv("HEATMAP_SLO_FRESHNESS_P50_MS", "1e9")
    monkeypatch.setenv("HEATMAP_SLO_WATCHDOG_S", "0")
    for k in ("HEATMAP_SLO_MEM_BYTES", "HEATMAP_SLO_RETRACES"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("impl,fn", [("xla", "multi_step"),
                                     ("native", "multi_step_pre")])
def test_runtime_wraps_its_entry_points(tmp_path, monkeypatch, quiet, impl,
                                        fn):
    monkeypatch.setenv("HEATMAP_H3_IMPL", impl)
    rt = _mk_runtime(tmp_path)
    try:
        _drain(rt)
        funcs = rt.runtimeinfo.compile.snapshot()["functions"]
        assert funcs[fn]["calls"] == 4 and funcs[fn]["compiles"] == 0
        other = ({"multi_step", "multi_step_pre"} - {fn}).pop()
        assert funcs[other]["calls"] == 0
        txt = rt.telemetry.expose_text()
        assert f'heatmap_compile_total{{fn="{fn}"}}' in txt
    finally:
        rt.close()


def test_memory_monitor_reads_the_runtimes_own_tensors(tmp_path, quiet):
    rt = _mk_runtime(tmp_path, prefetch_batches=1, emit_flush_k=4)
    try:
        rt.step_once()
        mm = rt.runtimeinfo.memory
        assert mm.sample()
        live = rt.registry._families["heatmap_live_buffer_bytes"].value
        slabs = sum(t.nbytes for st in rt.multi.states for t in st)
        assert live == rt._held_bytes() > slabs > 0
        assert rt._ring.nbytes > 0 and rt._prefetched
        assert mm.watermark_bytes >= live
        assert not mm.sample(min_interval_s=60.0)
        # no device gauge on the CPU
        for name in ("heatmap_device_bytes_in_use",
                     "heatmap_device_hbm_watermark_bytes"):
            assert not rt.registry._families[name].children
        snap = mm.snapshot()
        assert snap["watermark_bytes"] == mm.watermark_bytes
        jsnap = JaxMemoryMonitor(JaxRegistry()).snapshot()
        assert set(snap) == set(jsnap)
    finally:
        rt.close()


def _force_build_in_a_step(rt, tmp_path, monkeypatch):
    """Warm the step, then make the next step's fold load a library from
    a fresh cache: a build after warmup."""
    _drain(rt)
    assert rt.runtimeinfo.compile.retraces_recent(600) == 0
    _fresh_cache_with_copy(tmp_path, monkeypatch)
    real = tmulti.fused_fold

    def loading_fold(*a, **k):
        _build.load(_build.NATIVE_LIB)
        return real(*a, **k)

    monkeypatch.setattr(tmulti, "fused_fold", loading_fold)
    src2 = MemorySource(_mk_events(16 * 2))
    src2.finish()
    rt.source = src2
    _drain(rt)


def test_acceptance_post_warmup_build(tmp_path, monkeypatch, quiet):
    monkeypatch.setenv("HEATMAP_H3_IMPL", "xla")
    rt = _mk_runtime(tmp_path, flightrec_dir=str(tmp_path / "fr"))
    try:
        _force_build_in_a_step(rt, tmp_path, monkeypatch)
        fam = rt.registry._families["heatmap_retrace_after_warmup_total"]
        assert sum(c.value for c in fam.children.values()) == 1
        payload, down = healthz_payload(rt)
        assert not down and payload["status"] == "degraded"
        chk = payload["checks"]["retrace_after_warmup"]
        assert chk["value"] == 1 and not chk["ok"]
        path = rt.slo_watchdog.check_once()
        assert path is not None
        d = json.loads(open(path).read())
        assert d["reason"] == "slo degraded: retrace_after_warmup"
        fns = d["runtimeinfo"]["compile"]["functions"]
        assert fns["multi_step"]["compiles"] == 1
        assert d["runtimeinfo"]["compile"]["retraces_after_warmup"] == 1
        assert d["runtimeinfo"]["memory"]["watermark_bytes"] > 0
        assert isinstance(d["stacks"], list)
        assert not d["healthz"]["checks"]["retrace_after_warmup"]["ok"]
    finally:
        rt.close()


def test_acceptance_memory_watermark_breach(tmp_path, monkeypatch, quiet):
    monkeypatch.setenv("HEATMAP_SLO_MEM_BYTES", "1")
    rt = _mk_runtime(tmp_path, flightrec_dir=str(tmp_path / "fr"))
    try:
        _drain(rt)  # the loop samples memory at 1 Hz
        wm = rt.registry._families[
            "heatmap_live_buffer_watermark_bytes"].value
        assert wm > 1
        payload, down = healthz_payload(rt)
        assert payload["status"] == "degraded"
        chk = payload["checks"]["memory_watermark_bytes"]
        assert chk["value"] > chk["budget"] and not chk["ok"]
        path = rt.slo_watchdog.check_once()
        d = json.loads(open(path).read())
        assert "memory_watermark_bytes" in d["reason"]
        assert d["runtimeinfo"]["memory"]["watermark_bytes"] == wm
    finally:
        rt.close()


def test_healthz_checks_quiet_when_healthy(tmp_path, quiet):
    rt = _mk_runtime(tmp_path)
    try:
        _drain(rt)
        assert healthz_checks(rt) == ({}, False)
    finally:
        rt.close()
    assert healthz_checks(object()) == ({}, False)


def test_watchdog_one_capture_per_episode_and_cooldown(tmp_path,
                                                       monkeypatch, quiet):
    rt = _mk_runtime(tmp_path, flightrec_dir=str(tmp_path / "fr"))
    try:
        _drain(rt)
        wd = SloWatchdog(rt, interval_s=0, cooldown_s=0)
        monkeypatch.setenv("HEATMAP_SLO_MEM_BYTES", "1")   # degraded
        p1 = wd.check_once()
        assert p1 is not None
        assert wd.check_once() is None        # same episode: no dump
        monkeypatch.setenv("HEATMAP_SLO_MEM_BYTES", "1e18")  # recovered
        assert wd.check_once() is None
        wd.cooldown_s = 3600
        monkeypatch.setenv("HEATMAP_SLO_MEM_BYTES", "1")   # episode 2
        assert wd.check_once() is None        # inside the cooldown
        assert wd.check_once() is None        # still blocked, not consumed
        wd.cooldown_s = 0                     # the cooldown lapses
        p2 = wd.check_once()
        assert p2 is not None and p2 != p1
        assert wd.n_captures == 2
    finally:
        rt.close()


def test_watchdog_thread_fires_and_refuses_a_channel(tmp_path, monkeypatch,
                                                     quiet):
    monkeypatch.setenv("HEATMAP_SLO_MEM_BYTES", "1")
    frdir = tmp_path / "fr"
    rt = _mk_runtime(tmp_path, flightrec_dir=str(frdir))
    try:
        _drain(rt)
        wd = SloWatchdog(rt, interval_s=0.05, cooldown_s=0)
        assert wd.start()
        deadline = time.monotonic() + 5.0
        while wd.n_captures == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        wd.stop()
        assert wd.n_captures >= 1
        assert list(frdir.glob("flightrec-*.json"))
        # with a supervisor channel it runs in fleet mode, as the
        # reference's does: the degraded verdict claims one episode on
        # the channel and the dump carries its id
        from heatmap_tpu_torch.obs.xproc import read_episode

        chan = str(tmp_path / "chan.json")
        monkeypatch.setenv("HEATMAP_SUPERVISOR_CHANNEL", chan)
        fleet_wd = SloWatchdog(rt, cooldown_s=0, tag="p0")
        assert fleet_wd.channel_path == chan
        path = fleet_wd.check_once()
        ep = read_episode(chan)
        assert path and ep["origin"] == "p0"
        assert json.loads(open(path).read())["episode_id"] \
            == ep["episode_id"]
    finally:
        rt.close()


class _CrashingSource(MemorySource):
    def __init__(self, events, after):
        super().__init__(events)
        self.finish()
        self._polls_left = after

    def poll(self, max_events):
        if self._polls_left == 0:
            raise RuntimeError("injected crash")
        self._polls_left -= 1
        return super().poll(max_events)


def test_crash_dump_carries_runtime_introspection(tmp_path, quiet):
    frdir = tmp_path / "fr"
    rt = _mk_runtime(tmp_path, _CrashingSource(_mk_events(48), 2),
                     flightrec_dir=str(frdir))
    with pytest.raises(RuntimeError, match="injected crash"):
        rt.run()
    (f,) = frdir.glob("flightrec-*.json")
    d = json.loads(f.read_text())
    assert d["reason"] == "abnormal exit: RuntimeError: injected crash"
    ri = d["runtimeinfo"]
    assert set(ri["compile"]["functions"]) == {"multi_step",
                                               "multi_step_pre"}
    assert ri["memory"]["watermark_bytes"] > 0
    assert isinstance(d["stacks"], list)
    assert d["run_state"]["epoch"] == 2
