"""The port's SLO engine and sampler (nos_tpu_torch/obs/{slo,timeseries}.py)
against the JAX package's, following ``tests/test_slo.py``: the same
metric updates, made from a seed with numpy, fed into a registry of each
package on one virtual clock give the same verdicts, burns and budgets
after every tick, and the same journal records of each breach and
recovery.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import nos_tpu.exporter.metrics as jmetrics
import nos_tpu.obs as jobs
from nos_tpu.obs import journal as jjournal, slo as jslo
from nos_tpu.obs import timeseries as jts

import nos_tpu_torch.exporter.metrics as metrics
from nos_tpu_torch import obs
from nos_tpu_torch.obs import journal as pjournal, slo as pslo
from nos_tpu_torch.obs import timeseries as pts

LATENCY = "nos_tpu_schedule_latency_seconds"
GAUGE = "nos_t_utilization"
COUNTER = "nos_t_rebinds_total"
CLASSES = ("serving", "ts-24", "be-ts-10")


def objectives(mod) -> list:
    return [
        mod.SLOObjective(name="latency", kind=mod.LATENCY, metric=LATENCY,
                         target=0.5, each_label="class", min_events=3),
        mod.SLOObjective(name="floor", kind=mod.GAUGE_FLOOR, metric=GAUGE,
                         target=0.9),
        mod.SLOObjective(name="ceiling", kind=mod.RATE_CEILING,
                         metric=COUNTER, target=0.2),
    ]


class Twin:
    """An engine of each package over a registry of its own, the same
    objectives, windows and clock, each journal fresh."""

    def __init__(self, fast: float = 10.0, slow: float = 30.0) -> None:
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.regs = (metrics.Registry(), jmetrics.Registry())
        self.journals = (pjournal.DecisionJournal(clock=clock),
                         jjournal.DecisionJournal(clock=clock))
        self.engines = tuple(
            mod.SLOEngine(ts.TimeSeriesSampler(registry=reg, clock=clock),
                          objectives(mod), fast_window_s=fast,
                          slow_window_s=slow, clock=clock)
            for mod, ts, reg in ((pslo, pts, self.regs[0]),
                                 (jslo, jts, self.regs[1])))
        for reg in self.regs:
            reg.describe(LATENCY, "latency", buckets=(
                0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0))

    def both(self, fn) -> None:
        for reg in self.regs:
            fn(reg)

    def tick(self, dt: float = 1.0) -> list:
        self.now[0] += dt
        verdicts = []
        for mod, engine, journal in ((obs, self.engines[0],
                                      self.journals[0]),
                                     (jobs, self.engines[1],
                                      self.journals[1])):
            with mod.scoped(journal=journal):
                verdicts.append(engine.tick())
        assert verdicts[0] == verdicts[1]
        assert self.records(0) == self.records(1)
        return verdicts[0]

    def records(self, i: int) -> list:
        return [(r.category, r.subject, r.attrs)
                for r in self.journals[i].events()]


def drive(twin: Twin, seed: int, ticks: int = 90) -> list:
    """Random latency observations per class (a slow phase in the
    middle), a utilization gauge and a rebind counter; every verdict."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        slow = 30 <= t < 60
        for cls in CLASSES:
            for _ in range(int(rng.integers(0, 4))):
                lat = float(rng.exponential(2.0 if slow else 0.08))
                twin.both(lambda r, lat=lat, cls=cls: r.observe(
                    LATENCY, lat, labels={"class": cls}))
        util = float(rng.uniform(0.8, 1.0))
        twin.both(lambda r: r.set(GAUGE, util))
        n = float(rng.integers(0, 2 if not slow else 4))
        if n:
            twin.both(lambda r: r.inc(COUNTER, n))
        out.append(twin.tick(float(rng.choice([0.5, 1.0, 2.0]))))
    return out


class TestEngineParity:
    @pytest.mark.parametrize("seed", range(6))
    def test_verdicts_burns_and_records_are_jax_s(self, seed):
        twin = Twin()
        verdicts = drive(twin, seed)
        judged = [v for tick in verdicts for v in tick]
        assert any(v["burn_fast"] is not None for v in judged)
        assert {v["objective"] for v in judged} == {"latency", "floor",
                                                    "ceiling"}
        assert any(r[0] == pjournal.SLO_BREACH for r in twin.records(0))

    def test_breach_then_recovery_journal_with_the_class(self):
        twin = Twin()
        for phase, lat in ((40, 0.01), (40, 2.0), (80, 0.01)):
            for _ in range(phase):
                twin.both(lambda r, lat=lat: r.observe(
                    LATENCY, lat, labels={"class": "serving"}))
                twin.tick()
        cats = [(c, s) for c, s, _ in twin.records(0)
                if c in (pjournal.SLO_BREACH, pjournal.SLO_RECOVERED)]
        assert cats == [(pjournal.SLO_BREACH, "latency/serving"),
                        (pjournal.SLO_RECOVERED, "latency/serving")]
        assert twin.records(0)[0][2]["slo_class"] == "serving"

    def test_min_events_keeps_a_quiet_class_unjudged(self):
        twin = Twin()
        for _ in range(40):
            twin.tick()
        twin.both(lambda r: r.observe(LATENCY, 9.0,
                                      labels={"class": "ts-24"}))
        v = twin.tick()
        lat = [x for x in v if x["objective"] == "latency"]
        assert lat and lat[0]["burn_fast"] is None and not lat[0]["breached"]

    def test_a_vanished_breached_class_recovers(self):
        twin = Twin()
        for _ in range(40):
            twin.both(lambda r: r.observe(LATENCY, 3.0,
                                          labels={"class": "be-ts-10"}))
            twin.tick()
        assert twin.records(0)[-1][0] == pjournal.SLO_BREACH
        for reg in twin.regs:
            reg.reset()
        twin.tick()
        assert twin.records(0)[-1][0] == pjournal.SLO_RECOVERED

    def test_a_counter_reset_resyncs(self):
        twin = Twin()
        for _ in range(40):
            twin.both(lambda r: r.inc(COUNTER, 1.0))
            twin.tick()
        for reg in twin.regs:
            reg.reset()
        twin.both(lambda r: r.inc(COUNTER, 1.0))
        v = twin.tick()
        ceiling = [x for x in v if x["objective"] == "ceiling"][0]
        assert ceiling["value"] is not None and ceiling["value"] >= 0.0


class TestObjectives:
    def test_the_defaults_are_jax_s(self):
        got = [vars(o) for o in pslo.default_objectives()]
        want = [vars(o) for o in jslo.default_objectives()]
        assert got == want
        assert [o["name"] for o in got] == [
            "schedule-latency", "actuation-latency", "request-latency"]

    @pytest.mark.parametrize("kw,err", [
        ({"kind": "nope"}, "unknown SLO kind"),
        ({"compliance": 1.0}, "compliance"),
        ({"target": 0.0}, "target must be > 0")])
    def test_bad_objectives_are_refused_as_jax(self, kw, err):
        base = {"name": "x", "kind": "latency", "metric": LATENCY,
                "target": 1.0} | kw
        for mod in (pslo, jslo):
            with pytest.raises(ValueError, match=err):
                mod.SLOObjective(**base)

    def test_dict_labels_become_a_selector(self):
        o = pslo.SLOObjective(name="x", kind="latency", metric=LATENCY,
                              target=1.0, labels={"b": "2", "a": "1"})
        assert o.labels == (("a", "1"), ("b", "2"))

    def test_the_report_is_jax_s_and_json(self):
        twin = Twin()
        drive(twin, 0, ticks=20)
        got, want = (e.report() for e in twin.engines)
        assert got == want
        json.dumps(got, allow_nan=False)


class TestSampler:
    def test_bounded_with_eviction_counter(self):
        for mod, reg in ((pts, metrics.Registry()),
                         (jts, jmetrics.Registry())):
            now = [0.0]
            sampler = mod.TimeSeriesSampler(registry=reg, maxlen=4,
                                            clock=lambda: now[0])
            for _ in range(6):
                now[0] += 1.0
                sampler.tick()
            assert len(sampler) == 4 and sampler.dropped == 2
            assert reg.snapshot()[
                "nos_tpu_timeseries_points_dropped_total"][""] == 2

    def test_tick_rolls_the_max_window(self):
        reg = metrics.Registry()
        sampler = pts.TimeSeriesSampler(registry=reg, clock=lambda: 1.0)
        reg.observe("nos_t_seconds", 5.0)
        assert sampler.tick().get("nos_t_seconds_max") == 5.0
        assert sampler.tick().get("nos_t_seconds_max") == 0.0

    @pytest.mark.parametrize("seed", range(3))
    def test_brackets_are_jax_s(self, seed):
        rng = np.random.default_rng(seed)
        now = [0.0]
        samplers = [mod.TimeSeriesSampler(registry=reg, maxlen=16,
                                          clock=lambda: now[0])
                    for mod, reg in ((pts, metrics.Registry()),
                                     (jts, jmetrics.Registry()))]
        for _ in range(30):
            now[0] += float(rng.uniform(0.1, 3.0))
            for s in samplers:
                s.tick()
            for window in (1.0, 5.0, 20.0, 100.0):
                got, want = (s.bracket(window) for s in samplers)
                assert (got is None) == (want is None)
                if got is not None:
                    assert (got[0].ts, got[1].ts) == (want[0].ts,
                                                      want[1].ts)


class TestSurfaces:
    def test_flight_snapshot_carries_the_engine_s_report(self, monkeypatch):
        monkeypatch.setattr(pslo, "_engine", None)
        assert "slo" not in obs.flight_snapshot()
        twin = Twin()
        drive(twin, 1, ticks=5)
        monkeypatch.setattr(pslo, "_engine", twin.engines[0])
        snap = obs.flight_snapshot()
        assert snap["slo"] == twin.engines[0].report() | {
            "ts": snap["slo"]["ts"]}
        assert "waste" in snap

    def test_a_sick_flight_block_is_dropped_alone(self, caplog):
        def sick():
            raise RuntimeError("boom")

        prev = obs.set_flight_block("sick", sick)
        obs.set_flight_block("fine", lambda: {"x": 1})
        try:
            snap = obs.flight_snapshot()
        finally:
            obs.set_flight_block("sick", prev)
            obs.set_flight_block("fine", None)
        assert "sick" not in snap and snap["fine"] == {"x": 1}
        assert "waste" in snap and "journal" in snap
        assert any("'sick' raised" in r.getMessage()
                   for r in caplog.records)

    def test_obs_slo_renders_as_jax(self, capsys):
        """``obs slo`` on the same flight payload prints the lines the
        JAX CLI prints, the breach joined to the rejecting plugin."""
        from nos_tpu.obs.__main__ import cmd_slo as jax_cmd_slo
        from nos_tpu_torch.obs.__main__ import cmd_slo

        twin = Twin()
        for lat in [2.0] * 40:
            twin.both(lambda r, lat=lat: r.observe(
                LATENCY, lat, labels={"class": "ts-24"}))
            twin.tick()
        twin.journals[0].record(
            pjournal.POD_REJECTED, "default/p", reason="", message="no fit",
            plugin="", reason_counts={"NodeResourcesFit: insufficient": 2},
            **{"class": "ts-24"})
        payload = {"slo": twin.engines[0].report(),
                   "journal": twin.journals[0].dump()}
        assert cmd_slo(payload) == jax_cmd_slo(payload) == 0
        out = capsys.readouterr().out.splitlines()
        port, jax = out[:len(out) // 2], out[len(out) // 2:]
        assert port == jax
        assert any("rejecting plugin for class ts-24: NodeResourcesFit"
                   in ln for ln in port)
