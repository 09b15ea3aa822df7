"""The SLO burn-rate engine of the port (heatmap_tpu_torch/obs/slo.py)
against the JAX package's (heatmap_tpu/obs/slo.py), on the CPU.

Each case drives a recorder and an engine of each package over the same
scripted exposition and injected clock (the scheme of
``tests/test_slo.py``), and compares the two engines tick by tick: the
samples, the firing state, the budget ledgers, the recorded events, the
/healthz checks and the flight-record enrichment are equal, exactly (host
Python over the same text and clock).

- the burn rule fires at the same, predicted tick in both (budget 0.2 of
  100 s, one rule 4 s / 20 s at 2.5x: first firing at t=109, resolve at
  t=112), and its flight-record dump is enriched by the ``slo`` source;
- a blip warns and a sustained burn degrades, in both;
- a counter reset is read as the increase since the reset;
- a quantile objective with no traffic between ticks takes no sample;
- a seeded random script over every kind of objective and the default
  rules;
- the default specs and rules, and ``slo_stamp`` over one directory of
  ``slo-state.json`` files written by both engines;
- with a ``channel_path`` a firing alert claims one fleet episode on the
  channel and its recovery clears it, as in the reference.
"""

import dataclasses
import json

import numpy as np
import pytest

from heatmap_tpu.obs import slo as jslo
from heatmap_tpu.obs import tsdb as jtsdb
from heatmap_tpu.obs.flightrec import FlightRecorder as JaxFlightRecorder
from heatmap_tpu.obs.registry import Registry as JaxRegistry
from heatmap_tpu_torch.obs import slo as tslo
from heatmap_tpu_torch.obs import tsdb as ttsdb
from heatmap_tpu_torch.obs.flightrec import FlightRecorder
from heatmap_tpu_torch.obs.registry import Registry

PKGS = {"jax": (jslo, jtsdb, JaxRegistry, JaxFlightRecorder),
        "port": (tslo, ttsdb, Registry, FlightRecorder)}


class Pair:
    """The same recorder + engine in both packages over one exposition
    function of a shared state dict and one clock."""

    def __init__(self, expo, specs, rules, tmp_path=None, frac=0.2,
                 window=100.0, scrape_s=1.0, flightrec=False,
                 channel=False):
        self.state = {}
        self.clk = [0.0]
        self.side = {}
        for pkg, (slo, tsdb, reg_cls, fr_cls) in PKGS.items():
            reg = reg_cls()
            d = str(tmp_path / pkg) if tmp_path is not None else None
            rec = tsdb.TsdbRecorder(lambda: expo(self.state), tag="m0",
                                    dir_path=d, scrape_s=scrape_s,
                                    flush_s=1e9, clock=lambda: self.clk[0])
            fr = (fr_cls(str(tmp_path / pkg / "fr")) if flightrec else None)
            eng = slo.SloEngine(
                rec, registry=reg, tag="m0",
                specs=tuple(slo.SloSpec(**dataclasses.asdict(s))
                            for s in specs) if specs is not None else None,
                rules=tuple(slo.BurnRule(**dataclasses.asdict(r))
                            for r in rules) if rules is not None else None,
                budget_frac=frac, budget_window_s=window, flightrec=fr,
                channel_path=(str(tmp_path / pkg / "chan.json") if channel
                              else None))
            self.side[pkg] = (rec, eng, reg)

    def tick(self, t, **state):
        self.clk[0] = float(t)
        self.state.update(state)
        for rec, _eng, _reg in self.side.values():
            rec.scrape_once()

    def engine_state(self, pkg):
        rec, eng, reg = self.side[pkg]
        out = {}
        for name, st in eng._state.items():
            out[name] = {"samples": list(st.samples), "firing": st.firing,
                         "severity": st.severity, "last": st.last_value,
                         "bad": st.last_bad, "alerts": st.alerts_total,
                         "worst": st.worst_burn,
                         "prev_totals": dict(st.prev_totals),
                         "prev_buckets": dict(st.prev_buckets),
                         "budget": eng.budget(name)}
        fams = {n: {k: c.value for k, c in reg._families[n].children.items()}
                for n in ("heatmap_slo_bad_samples_total",
                          "heatmap_slo_alerts_total",
                          "heatmap_slo_alert_firing",
                          "heatmap_slo_burn_rate",
                          "heatmap_slo_budget_remaining_frac")}
        return {"specs": out, "events": list(rec._events),
                "checks": eng.healthz_checks(), "snapshot": eng.snapshot(),
                "families": fams}

    def assert_equal(self):
        mine, ref = self.engine_state("port"), self.engine_state("jax")
        assert mine == ref
        return mine


def gauge_expo(state):
    return ("# TYPE heatmap_repl_lag_seconds gauge\n"
            f"heatmap_repl_lag_seconds {state.get('v', 0.0)}\n")


REPL_LAG = jslo.SloSpec("repl_lag", "gauge", "heatmap_repl_lag_seconds",
                        10.0)
RULE = jslo.BurnRule("r", 4.0, 20.0, 2.5)


def test_burn_rule_fires_at_the_same_tick(tmp_path):
    pair = Pair(gauge_expo, [REPL_LAG], [RULE], tmp_path=tmp_path,
                flightrec=True)
    fired = {}
    for t in range(1, 115):
        pair.tick(t, v=99.0 if 100 <= t < 110 else 0.0)
        st = pair.assert_equal()["specs"]["repl_lag"]
        fired.setdefault(st["firing"], t)
    # the hand computation of tests/test_slo.py: fires at 109, resolves
    # at 112
    assert fired == {None: 1, "r": 109}
    st = pair.engine_state("port")
    assert st["specs"]["repl_lag"]["firing"] is None
    assert [e["kind"] for e in st["events"]] == ["slo_alert", "slo_resolve"]
    alert = st["events"][0]
    assert (alert["t"], alert["burn_short"], alert["burn_long"]) == \
        (109.0, 5.0, 2.5)
    assert alert["budget"]["consumed_s"] == 10.0
    # the alert flushed at once, and the dump carries the slo source
    for pkg in ("port", "jax"):
        (dump,) = (tmp_path / pkg / "fr").glob("flightrec-*.json")
        rec = json.loads(dump.read_text())
        assert rec["reason"] == "slo-burn:repl_lag:r"
        assert rec["slo"]["specs"]["repl_lag"]["firing"] == "r"
        assert list((tmp_path / pkg / "m0").glob("block-*.json"))
    mine = json.loads(next((tmp_path / "port" / "fr").glob("*.json"))
                      .read_text())["slo"]
    ref = json.loads(next((tmp_path / "jax" / "fr").glob("*.json"))
                     .read_text())["slo"]
    assert mine == ref


def test_blip_warns_burn_degrades():
    pair = Pair(gauge_expo, [REPL_LAG], [RULE])
    for t in range(1, 60):
        pair.tick(t, v=0.0)
    pair.tick(60, v=99.0)
    check = pair.assert_equal()["checks"]["slo_repl_lag"]
    assert check["ok"] is True and check["warn"] is True
    assert "momentary blip" in check["detail"]
    for t in range(61, 75):
        pair.tick(t, v=99.0)
    check = pair.assert_equal()["checks"]["slo_repl_lag"]
    assert check["ok"] is False
    assert "error budget burning fast" in check["detail"]


def test_counter_reset_is_read_as_the_increase():
    def expo(state):
        return ("# TYPE heatmap_audit_digest_mismatch_total counter\n"
                f"heatmap_audit_digest_mismatch_total {state['v']}\n")

    spec = jslo.SloSpec("mism", "counter",
                        "heatmap_audit_digest_mismatch_total", 0.0)
    pair = Pair(expo, [spec], [jslo.BurnRule("r", 4.0, 20.0, 1e9)])
    for t, v in [(1, 5.0), (2, 7.0), (3, 1.0), (4, 1.0)]:
        pair.tick(t, v=v)
    st = pair.assert_equal()["specs"]["mism"]
    assert st["samples"] == [(1.0, 0), (2.0, 1), (3.0, 1), (4.0, 0)]


def test_quantile_without_traffic_takes_no_sample():
    def expo(state):
        n = state["n"]
        return ("# TYPE heatmap_event_age_seconds histogram\n"
                f'heatmap_event_age_seconds_bucket{{le="0.1"}} {n}\n'
                f'heatmap_event_age_seconds_bucket{{le="+Inf"}} {n}\n')

    spec = jslo.SloSpec("fresh", "quantile", "heatmap_event_age_seconds",
                        10.0, q=0.5)
    pair = Pair(expo, [spec], [jslo.BurnRule("r", 4.0, 20.0, 1e9)])
    pair.tick(1, n=5.0)
    assert len(pair.assert_equal()["specs"]["fresh"]["samples"]) == 1
    pair.tick(2, n=5.0)
    assert len(pair.assert_equal()["specs"]["fresh"]["samples"]) == 1
    pair.tick(3, n=2.0)       # a restart: the new totals are the window
    assert len(pair.assert_equal()["specs"]["fresh"]["samples"]) == 2


def random_expo(state):
    """Every kind of objective the default specs read, from the state the
    script sets: labeled histograms, gauges, counters, a lower-is-worse
    gauge."""
    lines = ["# TYPE heatmap_event_age_seconds histogram"]
    for bound in ("mean", "max"):
        for le, n in zip(("1", "10", "100", "+Inf"), state[bound]):
            lines.append(f'heatmap_event_age_seconds_bucket{{bound='
                         f'"{bound}",le="{le}"}} {n}')
    lines += ["# TYPE heatmap_repl_lag_seconds gauge",
              f"heatmap_repl_lag_seconds {state['lag']}",
              "# TYPE heatmap_retrace_after_warmup_total counter",
              f"heatmap_retrace_after_warmup_total {state['retr']}",
              "# TYPE heatmap_quality_forecast_skill gauge"]
    for h, v in zip(("60", "120"), state["skill"]):
        lines.append(f'heatmap_quality_forecast_skill{{grid="h3r8",'
                     f'h="{h}"}} {v}')
    lines += ["# TYPE heatmap_quality_nis_band_error gauge",
              f"heatmap_quality_nis_band_error {state['band']}"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("seed", [3, 4])
def test_random_script_over_the_default_specs(seed, tmp_path):
    rng = np.random.default_rng(seed)
    pair = Pair(random_expo, None, None, tmp_path=tmp_path, frac=0.05,
                window=600.0, scrape_s=2.0)
    cums = {"mean": np.zeros(4), "max": np.zeros(4)}
    retr = 0.0
    burning = False
    for i in range(150):
        if rng.random() < 0.08:
            burning = not burning
        for bound in cums:
            ages = rng.exponential(40.0 if burning else 2.0,
                                   int(rng.integers(0, 6)))
            cums[bound] += [(ages <= 1).sum(), (ages <= 10).sum(),
                            (ages <= 100).sum(), len(ages)]
        if i == 90:
            cums = {b: np.zeros(4) for b in cums}      # a restart
        retr += float(rng.random() < 0.03)
        pair.tick(2.0 * i, mean=cums["mean"].tolist(),
                  max=cums["max"].tolist(),
                  lag=float(rng.exponential(20.0 if burning else 1.0)),
                  retr=retr, skill=rng.normal(0.1, 0.3, 2).round(4).tolist(),
                  band=float(max(0.0, rng.normal(-0.01, 0.02))))
        pair.assert_equal()
    final = pair.engine_state("port")
    assert sum(s["alerts"] for s in final["specs"].values()) >= 1
    assert len(final["specs"]) == 8
    for pkg in ("port", "jax"):
        assert (tmp_path / pkg / "m0" / "slo-state.json").exists()
    mine = json.loads((tmp_path / "port" / "m0" / "slo-state.json")
                      .read_text())
    ref = json.loads((tmp_path / "jax" / "m0" / "slo-state.json")
                     .read_text())
    assert mine == ref


@pytest.mark.parametrize("env", [
    {}, {"HEATMAP_SLO_REPL_LAG_S": "3", "HEATMAP_SLO_FRESHNESS_P50_MS": "250"},
    {"HEATMAP_SLO_SERVE_P99_MS": "bad", "HEATMAP_SLO_FORECAST_SKILL": "-0.5",
     "HEATMAP_SLO_DELIVERED_P99_MS": "100"}])
def test_default_specs_match_jax(env):
    mine = [dataclasses.astuple(s) for s in tslo.default_specs(env)]
    assert mine == [dataclasses.astuple(s) for s in jslo.default_specs(env)]


@pytest.mark.parametrize("window,scrape", [
    (30 * 86400.0, 5.0), (86400.0, 5.0), (20.0, 0.1), (7200.0, 1.0)])
def test_default_rules_match_jax(window, scrape):
    assert ([dataclasses.astuple(r) for r in tslo.default_rules(window,
                                                                  scrape)]
            == [dataclasses.astuple(r) for r in jslo.default_rules(window,
                                                                    scrape)])


def test_slo_stamp_reads_one_directory_equally(tmp_path):
    """slo-state.json files written by both engines in one directory:
    both packages' slo_stamp read the same aggregate; knob off, none."""
    pair = Pair(gauge_expo, [REPL_LAG], [RULE], tmp_path=tmp_path)
    for t in range(1, 40):
        pair.tick(t, v=99.0 if t > 20 else 0.0)
    d = tmp_path / "one"
    for pkg in ("port", "jax"):
        (d / pkg).mkdir(parents=True)
        (d / pkg / "slo-state.json").write_bytes(
            (tmp_path / pkg / "m0" / "slo-state.json").read_bytes())
    on = {"HEATMAP_TSDB": "1"}
    stamp = tslo.slo_stamp(dir_path=str(d), env=on)
    assert stamp == jslo.slo_stamp(dir_path=str(d), env=on)
    assert stamp["slo"]["members"] == 2 and stamp["slo"]["alerts_fired"] == 2
    assert tslo.slo_stamp(dir_path=str(d), env={}) == {}
    env = {"HEATMAP_TSDB": "1", "HEATMAP_TSDB_DIR": str(d)}
    assert tslo.slo_stamp(env=env) == jslo.slo_stamp(env=env) == stamp


def test_channel_path_raises_naming_the_fleet(tmp_path):
    """With a supervisor channel the engines of both packages claim one
    fleet episode when the rule fires (the alert event and the dump carry
    its id, the broadcast names the engine's tag) and clear it when the
    alert resolves, at the same ticks."""
    from heatmap_tpu.obs import xproc as jxproc
    from heatmap_tpu_torch.obs import xproc as txproc

    pair = Pair(gauge_expo, [REPL_LAG], [RULE], tmp_path=tmp_path,
                flightrec=True, channel=True)
    readers = {"jax": jxproc.read_episode, "port": txproc.read_episode}
    seen = {pkg: [] for pkg in PKGS}
    for t in range(1, 115):
        pair.tick(t, v=99.0 if 100 <= t < 110 else 0.0)
        for pkg, read in readers.items():
            ep = read(str(tmp_path / pkg / "chan.json"))
            if ep.get("episode_id") and (
                    not seen[pkg] or seen[pkg][-1][1] != ep["episode_id"]):
                seen[pkg].append((t, ep["episode_id"], ep["origin"]))
            if not ep and seen[pkg] and len(seen[pkg][-1]) == 3:
                seen[pkg][-1] += (t,)
    for pkg in PKGS:
        ((t_fire, eid, origin, t_clear),) = seen[pkg]
        assert (t_fire, origin, t_clear) == (109, "m0", 112)
        rec, eng, _reg = pair.side[pkg]
        alert, resolve = rec._events
        assert alert["episode"] == resolve["episode"] == eid
        (dump,) = (tmp_path / pkg / "fr").glob("flightrec-*.json")
        assert json.loads(dump.read_text())["episode_id"] == eid
        assert eng._state["repl_lag"].episode is None
