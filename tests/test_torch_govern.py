"""The port's batch governor (heatmap_tpu_torch/stream/govern.py) and its
wiring into the runtime, against the JAX package's, on the CPU.

Counterparts of ``tests/test_govern.py``:

- **scripted differential**: a port ``BatchGovernor`` and a JAX one share
  one fake clock, one memory reading and one compile tracker, and get the
  same scripted ``note_*`` calls and event ages (each into its own
  registry's histogram).  After every call their return values,
  ``snapshot()``, trail and gauge and counter families are equal.  One
  case a branch of the control law: breach backing flush-K off, saturated
  growth, starved recovery, headroom to the ceilings, the hysteresis
  band, no fresh samples, the rate limit, the memory guardrail, growth
  pressure, the retrace freeze and its latch, ``force`` and its refusal
  of an off-ladder bucket, initial values above the ceilings;
- **governed runs**: a governed port run that walks the ladder over an
  exact-arithmetic corpus gives docs equal to the ungoverned port run's
  and to the JAX governed run's, with no post-warmup build; the runtime
  applies the decisions and ``/healthz`` names a latched bucket;
- **the ramp on a virtual clock**: offered load ramps 100x up and back
  down against ``RampSource``'s real backlog.  One fake clock drives the
  governor, the source, the lineage and the runtime's ``time.monotonic``,
  and each step advances it by a fixed service time, so the run is
  deterministic: the p50 breaches in the high phase, the governor climbs
  to >= 4096 rows on ``saturated``, and the p50 recovers within 24
  intervals and stays recovered;
- **growth is no retrace**: a governed run whose slab grows stays
  unfrozen in the port (a build is a kernel library built or loaded,
  ``obs/runtimeinfo.py``; the reference retraces on the new shapes);
- the reference's ``tools/obs_top.py`` renders the port's governor rows,
  a single runtime's and a fleet's.
"""

import copy
import importlib.util
import os
import tempfile
import time

import numpy as np
import pytest

from heatmap_tpu.config import load_config as jax_load_config
from heatmap_tpu.engine import step as jstep
from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu.sink import MemoryStore as JaxMemoryStore
from heatmap_tpu.stream import MemorySource as JaxMemorySource
from heatmap_tpu.stream import MicroBatchRuntime as JaxRuntime
from heatmap_tpu.stream.govern import BatchGovernor as JaxGovernor
from heatmap_tpu.stream.govern import bucket_ladder as jax_ladder
from heatmap_tpu_torch.config import load_config
from heatmap_tpu_torch.obs.registry import Registry
from heatmap_tpu_torch.sink.memory import MemoryStore
from heatmap_tpu_torch.stream import runtime as truntime
from heatmap_tpu_torch.stream.govern import BatchGovernor, bucket_ladder
from heatmap_tpu_torch.stream.runtime import MicroBatchRuntime
from heatmap_tpu_torch.stream.source import MemorySource, RampSource

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
GOVERN_FAMILIES = ("heatmap_govern_batch_rows", "heatmap_govern_flush_k",
                   "heatmap_govern_prefetch", "heatmap_govern_frozen",
                   "heatmap_govern_adjust_total",
                   "heatmap_govern_last_adjust_age_seconds")


@pytest.fixture(autouse=True)
def host_keys(monkeypatch):
    monkeypatch.setenv("HEATMAP_H3_IMPL", "native")
    monkeypatch.setenv("HEATMAP_SLO_FRESHNESS_P50_MS", "1000")
    monkeypatch.delenv("HEATMAP_SLO_MEM_BYTES", raising=False)
    for slot in ("SNAP_IMPL", "MERGE_IMPL", "FASTPATH", "MERGE_BANK_PIN"):
        monkeypatch.setattr(jstep, slot, getattr(jstep, slot))


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class Tracker:
    retraces = 0

    def snapshot(self):
        return {"retraces_after_warmup": self.retraces}


class Mem:
    watermark_bytes = 0.0


class GovPair:
    """A port and a JAX governor over one clock, tracker and memory;
    every call goes to both and the two are compared after it."""

    def __init__(self, batch=1024, min_batch=128, flush_k=8, prefetch=1,
                 interval=1.0, **cfg_over):
        kw = dict(batch_size=batch, govern=True, govern_min_batch=min_batch,
                  emit_flush_k=flush_k, prefetch_batches=prefetch,
                  govern_interval_s=interval, **cfg_over)
        self.clock, self.tracker, self.mem = FakeClock(), Tracker(), Mem()
        self.sides = []
        for load, reg_cls, gov_cls in (
                (load_config, Registry, BatchGovernor),
                (jax_load_config, JaxRegistry, JaxGovernor)):
            reg = reg_cls()
            age = reg.histogram("test_event_age_seconds", "test ages")
            gov = gov_cls(load({}, **kw), reg, event_age=age,
                          compile_tracker=self.tracker, memory=self.mem,
                          clock=self.clock)
            self.sides.append((gov, age, reg))
        self.check()

    @property
    def gov(self):
        return self.sides[0][0]

    def _both(self, fn):
        out = [fn(gov, age) for gov, age, _ in self.sides]
        assert out[0] == out[1]
        self.check()
        return out[0]

    def check(self):
        (tg, _, treg), (jg, _, jreg) = self.sides
        assert tg.snapshot() == jg.snapshot()
        assert list(tg.trail) == list(jg.trail)
        assert tg.bounds() == jg.bounds()
        assert ((tg.batch_rows, tg.flush_k, tg.prefetch, tg.frozen,
                 tg.frozen_why, tg.latched_bucket)
                == (jg.batch_rows, jg.flush_k, jg.prefetch, jg.frozen,
                    jg.frozen_why, jg.latched_bucket))
        for name in GOVERN_FAMILIES:
            tf, jf = treg._families[name], jreg._families[name]
            assert (tf.type, tf.labelnames, tf.help) \
                == (jf.type, jf.labelnames, jf.help), name
            got = {k: c.value for k, c in tf.children.items()}
            want = {k: c.value for k, c in jf.children.items()}
            assert got.keys() == want.keys(), name
            for k in got:
                assert got[k] == want[k] or (got[k] != got[k]
                                             and want[k] != want[k]), name

    def drive(self, age_s, rows, disp, idles=0):
        """One observed interval, then one control step."""
        for a in ([age_s] if isinstance(age_s, (int, float)) else age_s):
            self._both(lambda g, h: h.observe(a))
        for _ in range(disp):
            self._both(lambda g, h: g.note_dispatch(rows // max(1, disp)))
        for _ in range(idles):
            self._both(lambda g, h: g.note_idle())
        self.clock.t += self.gov.interval_s + 0.01
        return self._both(lambda g, h: g.decide())

    def call(self, name, *args, **kw):
        return self._both(lambda g, h: getattr(g, name)(*args, **kw))


# --------------------------------------------------------------- ladder
def test_bucket_ladder_shapes():
    for args, want in (((1 << 17, 4096), [4096, 8192, 16384, 32768, 65536,
                                          1 << 17]),
                       ((100_000, 16384), [16384, 32768, 65536, 100_000]),
                       ((1024, 100), [128, 256, 512, 1024]),
                       ((256, 256), [256]), ((256, 4096), [256]),
                       ((1 << 19, 4096), [4096 << i for i in range(8)])):
        assert bucket_ladder(*args) == jax_ladder(*args) == want


@pytest.mark.parametrize("env", [
    {"HEATMAP_GOVERN_INTERVAL_S": "0"}, {"HEATMAP_GOVERN_MIN_BATCH": "8"},
    {"HEATMAP_GOVERN": "1", "HEATMAP_GOVERN_MIN_BATCH": "999999999"},
    {"HEATMAP_GOVERN_MAX_FLUSH_K": "0"},
    {"HEATMAP_GOVERN_MAX_PREFETCH": "99"},
    {"HEATMAP_GOVERN_HEALTHY_FRAC": "1.5"}])
def test_config_validation(env):
    with pytest.raises(ValueError) as mine:
        load_config(env)
    with pytest.raises(ValueError) as ref:
        jax_load_config(env)
    assert str(mine.value) == str(ref.value)


def test_config_loads_as_the_reference():
    assert load_config({}).govern is False
    env = {"HEATMAP_GOVERN": "1", "HEATMAP_GOVERN_INTERVAL_S": "2.5",
           "HEATMAP_GOVERN_MIN_BATCH": "512",
           "HEATMAP_GOVERN_MAX_FLUSH_K": "16",
           "HEATMAP_GOVERN_MAX_PREFETCH": "3",
           "HEATMAP_GOVERN_HEALTHY_FRAC": "0.25"}
    mine, ref = load_config(env), jax_load_config(env)
    for f in ("govern", "govern_interval_s", "govern_min_batch",
              "govern_max_flush_k", "govern_max_prefetch",
              "govern_healthy_frac"):
        assert getattr(mine, f) == getattr(ref, f), f
    assert mine.govern is True


# ---------------------------------------------------------- control law
def _breach_backoff(p):
    assert p.drive(5.0, 600, 1) and (p.gov.flush_k, p.gov.batch_rows) \
        == (4, 1024)
    assert p.drive(5.0, 600, 1) and p.gov.flush_k == 2
    assert p.drive(5.0, 600, 1) and p.gov.flush_k == 1
    assert p.drive(5.0, 100, 1)
    assert (p.gov.flush_k, p.gov.batch_rows) == (1, 512)
    assert all(t["reason"] == "latency" and t["dir"] == "down"
               for t in p.gov.trail)


def _saturated(p):
    p.call("force", batch_rows=128, reason="pin")
    assert p.drive(5.0, 128, 1) and p.gov.batch_rows == 256
    assert p.drive(5.0, 512, 2) and p.gov.batch_rows == 512
    assert p.gov.prefetch == 2
    assert list(p.gov.trail)[-1]["reason"] == "saturated"


def _starved(p):
    p.call("force", batch_rows=128, flush_k=1, prefetch=0, reason="pin")
    assert p.drive(0.1, 10, 1, idles=3)
    assert (p.gov.batch_rows, p.gov.flush_k, p.gov.prefetch) == (256, 2, 1)
    for _ in range(8):
        p.drive(0.1, 10, 1, idles=3)
    assert (p.gov.batch_rows, p.gov.flush_k, p.gov.prefetch) == (1024, 4, 1)


def _headroom(p):
    for _ in range(40):
        p.drive(0.1, 1024, 1)
    assert p.gov.flush_k == p.gov.flush_k_max
    assert p.gov.prefetch == p.gov.prefetch_max


def _hysteresis(p):
    assert not p.drive(0.8, 1024, 1)
    assert not p.drive(0.8, 10, 1, idles=2)
    assert len(p.gov.trail) == 0


def _no_samples(p):
    p.call("note_dispatch", 10)
    p.drive(99.0, 10, 1)
    p.call("note_dispatch", 10)
    p.clock.t += p.gov.interval_s + 0.01
    assert not p.call("decide")


def _rate_limit(p):
    p._both(lambda g, h: h.observe(99.0))
    p.call("note_dispatch", 10)
    p.clock.t += 1.0
    assert not p.call("decide")


def _mem(p, monkeypatch):
    monkeypatch.setenv("HEATMAP_SLO_MEM_BYTES", "1000")
    p.mem.watermark_bytes = 5000.0
    assert p.drive(5.0, 1024, 1)
    assert (p.gov.batch_rows, p.gov.prefetch) == (512, 0)
    assert list(p.gov.trail)[-1]["reason"] == "mem"


def _growth_pressure(p):
    p.call("note_growth_pressure")
    p.drive(0.1, 1024, 1)
    assert p.gov.flush_k == 4
    assert list(p.gov.trail)[-1]["reason"] == "growth_pressure"


def _retrace_freeze(p):
    p.call("force", batch_rows=512, reason="pin")
    assert not p.call("check_retrace")
    p.tracker.retraces = 1
    assert p.call("check_retrace")
    assert p.gov.frozen and p.gov.latched_bucket == 512
    assert 512 not in p.gov.ladder and p.gov.batch_rows == 512
    # the latch: decide is inert whatever the signals say
    assert not p.drive(99.0, 1024, 1)
    p.call("freeze", "again", bucket=256)        # a second freeze: no-op
    assert p.sides[0][2]._families["heatmap_govern_frozen"].value == 1.0


def _force(p):
    p.call("force", batch_rows=256, flush_k=2)
    assert (p.gov.batch_rows, p.gov.flush_k) == (256, 2)
    p.call("force", flush_k=999, prefetch=-3, reason="clamp")
    assert (p.gov.flush_k, p.gov.prefetch) == (p.gov.flush_k_max, 0)
    for gov, _, _ in p.sides:
        with pytest.raises(ValueError):
            gov.force(batch_rows=777)
    p.check()
    fam = p.sides[0][2]._families["heatmap_govern_adjust_total"]
    assert fam.labels(dir="set", reason="forced").value == 1


def _ceilings(p):
    assert (p.gov.flush_k, p.gov.flush_k_max) == (64, 64)
    assert (p.gov.prefetch, p.gov.prefetch_max) == (6, 6)
    for _ in range(3):
        p.drive(0.1, 1024, 1)
    assert p.gov.flush_k == 64


SCRIPTS = {
    "breach_backoff": (_breach_backoff, {}),
    "saturated": (_saturated, {"prefetch": 0}),
    "starved": (_starved, {"flush_k": 4, "prefetch": 1}),
    "headroom": (_headroom, {"flush_k": 4, "prefetch": 1}),
    "hysteresis": (_hysteresis, {}),
    "no_samples": (_no_samples, {}),
    "rate_limit": (_rate_limit, {"interval": 5.0}),
    "mem": (_mem, {"prefetch": 2}),
    "growth_pressure": (_growth_pressure, {}),
    "retrace_freeze": (_retrace_freeze, {}),
    "force": (_force, {}),
    "ceilings": (_ceilings, {"flush_k": 64, "prefetch": 6}),
}


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_scripted_differential(case, monkeypatch):
    script, kw = SCRIPTS[case]
    p = GovPair(**kw)
    if script is _mem:
        script(p, monkeypatch)
    else:
        script(p)
    p.check()


# ------------------------------------------------------- real runtimes
T0 = int(time.time()) - 600


def mk_exact_events(n=3000):
    """The reference's exact-arithmetic corpus: a fixed position a
    vehicle, speeds on a 0.25 grid, so every per-group f32 sum is exact
    however the batches are cut."""
    return [{"provider": "p", "vehicleId": f"v{i % 7}",
             "lat": 42.0 + (i % 7) * 1e-2, "lon": -71.0,
             "speedKmh": (i % 40) * 0.25, "ts": T0 + i % 30}
            for i in range(n)]


def _cfg_kw(tmp_path, governed, tag):
    return dict(batch_size=256, state_capacity_log2=10, speed_hist_bins=4,
                store="memory", govern=governed, govern_min_batch=64,
                checkpoint_dir=str(tempfile.mkdtemp(dir=tmp_path,
                                                    prefix=tag)))


CYCLE = (64, 256, 128, 256, 64, 128)


def _run_corpus(tmp_path, governed, cycle=(), jax=False):
    kw = _cfg_kw(tmp_path, governed, "jax-" if jax else "port-")
    if jax:
        src = JaxMemorySource(mk_exact_events())
        store = JaxMemoryStore()
        rt = JaxRuntime(jax_load_config({}, **kw), src, store,
                        checkpoint_every=0)
    else:
        src = MemorySource(mk_exact_events())
        store = MemoryStore()
        rt = MicroBatchRuntime(load_config({}, **kw), src, store,
                               device="cpu", checkpoint_every=0)
    src.finish()
    i = 0
    while True:
        progressed = rt.step_once()
        if governed and cycle:
            rt.governor.force(batch_rows=cycle[i % len(cycle)],
                              flush_k=1 + i % 4, prefetch=i % 2)
            i += 1
        if not progressed and src.exhausted:
            break
    rt.close()
    return rt, store


def test_governed_run_byte_identical_and_retrace_free(tmp_path):
    rt_g, store_g = _run_corpus(tmp_path, True, cycle=CYCLE)
    rt_u, store_u = _run_corpus(tmp_path, False)
    jrt, jstore = _run_corpus(tmp_path, True, cycle=CYCLE, jax=True)
    assert rt_g.runtimeinfo.compile.snapshot()["retraces_after_warmup"] == 0
    assert len(rt_g.governor.trail) >= 6
    assert len(store_g._tiles) > 0
    assert store_g._tiles == store_u._tiles == jstore._tiles
    assert store_g._positions == store_u._positions == jstore._positions
    assert rt_g.max_event_ts == rt_u.max_event_ts == jrt.max_event_ts
    for key in ("events_valid", "events_late", "events_invalid"):
        assert (rt_g.counters[key] == rt_u.counters[key]
                == jrt.metrics.counters.get(key, 0)), key
    # the flush-K changes forced flushes of their own
    assert rt_g.pulls["govern"] > 0 and rt_u.pulls["govern"] == 0


def test_governed_runtime_wiring(tmp_path):
    from heatmap_tpu_torch.serve.api import healthz_payload

    cfg = load_config({}, **_cfg_kw(tmp_path, True, "wiring-"))
    src = MemorySource(mk_exact_events(800))
    rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                           checkpoint_every=0)
    assert rt.governor.ladder == [64, 128, 256]
    # the ladder was warmed through the wrapped step, inside the widened
    # warmup, and nothing was folded or parked by it
    assert rt.runtimeinfo.compile.warmup == 4 + 3
    assert rt.epoch == 0 and len(rt._ring) == 0
    rt.step_once()
    rt.governor.force(batch_rows=64, flush_k=2, prefetch=0)
    rt.step_once()
    assert (rt._feed_batch, rt._ring.capacity, rt._prefetch_n) == (64, 2, 0)
    payload, _ = healthz_payload(rt)
    assert payload["checks"]["govern_frozen"]["ok"]
    assert "fastpath_pinned" not in payload["checks"]
    rt.governor.freeze("test-induced", bucket=64)
    payload, down = healthz_payload(rt)
    assert not down and payload["status"] == "degraded"
    chk = payload["checks"]["govern_frozen"]
    assert not chk["ok"] and "64" in str(chk["value"])
    src.finish()
    rt.close()


def test_governor_off_builds_nothing(tmp_path):
    src = MemorySource([])
    src.finish()
    rt = MicroBatchRuntime(load_config({}, **_cfg_kw(tmp_path, False,
                                                     "off-")),
                           src, MemoryStore(), device="cpu",
                           checkpoint_every=0)
    assert rt.governor is None
    assert not any(n.startswith("heatmap_govern_")
                   for n in rt.registry._families)
    assert "heatmap_fastpath_pinned" in rt.registry._families
    rt.close()


def test_slab_growth_does_not_freeze_the_port_governor(tmp_path):
    """In the port a post-warmup build is a kernel library built or
    loaded during a wrapped step; eager PyTorch keeps no per-shape
    program, so a slab grow builds nothing and the governor stays
    unfrozen (the reference retraces on the grown shapes and freezes)."""
    rng = np.random.default_rng(3)
    events = [{"provider": "p", "vehicleId": f"v{i}",
               "lat": float(rng.uniform(42.2, 42.6)),
               "lon": float(rng.uniform(-71.3, -70.9)),
               "speedKmh": 1.0, "ts": T0 + i % 60} for i in range(3000)]
    cfg = load_config({}, batch_size=512, state_capacity_log2=10,
                      state_max_log2=14, speed_hist_bins=4,
                      store="memory", govern=True, govern_min_batch=128,
                      checkpoint_dir=str(tmp_path / "grow"))
    src = MemorySource(events)
    src.finish()
    rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                           checkpoint_every=0)
    rt.run()
    assert rt.counters["state_grown"] >= 1
    assert rt.runtimeinfo.compile.snapshot()["retraces_after_warmup"] == 0
    assert not rt.governor.frozen and rt.governor.check_retrace() is False


# ------------------------------------------------------------- the ramp
class _VirtualTime:
    """The runtime module's ``time`` with a virtual monotonic clock."""

    def __init__(self, vclock):
        self._v = vclock

    def monotonic(self):
        return self._v.t

    def __getattr__(self, name):
        return getattr(time, name)


class _VClock:
    def __init__(self, base):
        self.base, self.t = base, 0.0

    def __call__(self):
        return self.base + self.t


SLO_VS = 3.0                       # virtual seconds
STEP_VS = 0.5                      # a step's service time
INTERVAL_VS = 10.0                 # the governor's interval
SCHEDULE = [(60.0, 50.0), (6000.0, 120.0), (60.0, 90.0)]


def _ramp_run(tmp_path, monkeypatch, tag):
    monkeypatch.setenv("HEATMAP_SLO_FRESHNESS_P50_MS",
                       str(int(SLO_VS * 1000)))
    vclock = _VClock(1_700_000_000.0)
    monkeypatch.setattr(truntime, "time", _VirtualTime(vclock))
    src = RampSource(SCHEDULE, clock=vclock)
    cfg = load_config(
        {}, batch_size=8192, state_capacity_log2=15, speed_hist_bins=4,
        store="memory", govern=True, govern_min_batch=512,
        govern_interval_s=INTERVAL_VS, emit_flush_k=8, query_view=False,
        checkpoint_dir=str(tmp_path / f"ramp-{tag}"))
    rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                           positions_enabled=False, checkpoint_every=0)
    rt.lineage.clock = vclock
    gov = rt.governor
    gov.clock = vclock
    gov._last_decide = vclock()
    assert gov.ladder == [512, 1024, 2048, 4096, 8192]
    gov.force(batch_rows=512, flush_k=1, prefetch=0,
              reason="low-load-converged")
    samples = []
    while True:
        progressed = rt.step_once()
        # every write handed over lands at this instant: the ages the
        # next control step reads are a function of the clock alone
        rt.writer.drain()
        now_v = vclock()
        ages = sorted(r["age_s"]["mean"] for r in rt.lineage.tail(64)
                      if "age_s" in r and r.get("t_sink", 0) >= now_v - 10.0)
        samples.append({"t_v": vclock.t,
                        "p50_v": ages[len(ages) // 2] if ages else None,
                        "batch": gov.batch_rows})
        if not progressed and src.exhausted:
            break
        vclock.t += STEP_VS
        assert vclock.t < 600.0, "the ramp never drained"
    rt.close()
    return rt, src, samples


def test_chaos_ramp_100x_recovers_on_a_virtual_clock(tmp_path, monkeypatch):
    rt, src, samples = _ramp_run(tmp_path, monkeypatch, "a")
    assert src.exhausted
    assert rt.runtimeinfo.compile.snapshot()["retraces_after_warmup"] == 0
    high_t0 = 50.0
    breaches = [s for s in samples if s["p50_v"] is not None
                and s["p50_v"] > SLO_VS and s["t_v"] >= high_t0]
    assert breaches, "the 100x ramp never breached the SLO"
    assert rt.governor.batch_rows >= 4096, rt.governor.snapshot()
    assert any(t.get("dir") == "up" and t["reason"] == "saturated"
               and t["batch_rows"] >= 4096 for t in rt.governor.trail)
    t_breach = breaches[0]["t_v"]
    recovered = [s for s in samples if s["p50_v"] is not None
                 and s["p50_v"] <= SLO_VS and s["t_v"] > t_breach]
    assert recovered, "p50 never re-entered the SLO after the breach"
    assert recovered[0]["t_v"] - t_breach <= 24 * INTERVAL_VS
    settled = [s for s in samples if s["p50_v"] is not None][-3:]
    assert settled and all(s["p50_v"] <= SLO_VS for s in settled)
    # deterministic: a second run on a fresh clock takes the same path
    rt2, _, samples2 = _ramp_run(tmp_path, monkeypatch, "b")
    assert samples2 == samples
    strip = lambda trail: [{k: v for k, v in t.items()} for t in trail]
    assert strip(rt2.governor.trail) == strip(rt.governor.trail)


# ------------------------------------------------------- obs_top rows
def _load_obs_top():
    spec = importlib.util.spec_from_file_location(
        "obs_top", os.path.join(REPO, "tools", "obs_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_obs_top_renders_the_port_governor_row(tmp_path):
    ot = _load_obs_top()
    cfg = load_config({}, **_cfg_kw(tmp_path, True, "top-"))
    src = MemorySource(mk_exact_events(600))
    src.finish()
    rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                           checkpoint_every=0)
    rt.governor.force(batch_rows=128, flush_k=2, reason="forced")
    rt.run()
    m = ot.parse_prom(rt.telemetry.expose_text())
    frame = ot.render_frame(m, None, 0.0, None)
    assert "governor" in frame and "128" in frame and "flush-K 2" in frame
    assert "FROZEN" not in frame
    rt.governor.freeze("test", bucket=128)
    assert "FROZEN" in ot.render_frame(
        ot.parse_prom(rt.telemetry.expose_text()), None, 0.0, None)


def test_obs_top_renders_a_port_fleet_governor_table(tmp_path,
                                                     monkeypatch):
    from heatmap_tpu_torch.obs.fleet import FleetAggregator

    ot = _load_obs_top()
    chan = str(tmp_path / "chan")
    monkeypatch.setenv("HEATMAP_SUPERVISOR_CHANNEL", chan)
    for i, bucket in enumerate((256, 64)):
        cfg = load_config({}, **_cfg_kw(tmp_path, True, f"fleet{i}-"),
                          shards=2, shard_index=i)
        src = MemorySource(copy.deepcopy(mk_exact_events(400)))
        src.finish()
        rt = MicroBatchRuntime(cfg, src, MemoryStore(), device="cpu",
                               checkpoint_every=0)
        rt.governor.force(batch_rows=bucket, reason="forced")
        if i:
            rt.governor.freeze("test", bucket=bucket)
        for _ in range(2):
            rt.step_once()
        rt._publish_member_snapshot(force=True)
    m = ot.parse_prom(FleetAggregator(chan).metrics_text())
    frame = ot.render_fleet_frame(m, None, 0.0, None)
    assert "governor" in frame and "256" in frame
    assert "FROZEN" in frame and "active" in frame
