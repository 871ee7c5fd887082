"""The port's simulator clock and sources (``nos_tpu_torch/sim/engine.py``,
``sim/trace.py``) against the JAX package's (``nos_tpu/sim``): each case
runs the same story through both packages and compares what fired,
exactly (times as floats, labels, order).

- ``tests/test_sim.py``'s engine cases: the ``(time, priority, label,
  seq)`` order, the past refused, ``run(until)`` landing the clock, the
  tick loop's float accumulation and its ``while_fn``;
- the tie-break contract: six sources installed in shuffled orders fire
  the same stream, in both packages alike;
- ``ArrivalSource``'s thinning as a pure function of its seed (numpy
  draws a rate curve), ``DiurnalLoadSource`` and ``NodeKillSource``.
"""

from __future__ import annotations

import json
import random

import numpy as np
import pytest

import nos_tpu.sim.engine as jax_engine
import nos_tpu.sim.trace as jax_trace

import nos_tpu_torch.sim as port_sim
from nos_tpu_torch.sim import engine as port_engine
from nos_tpu_torch.sim import trace as port_trace

PACKAGES = {"jax": (jax_engine, jax_trace), "port": (port_engine, port_trace)}


def both(story):
    """``story(engine module, trace module)`` on each package; the two
    results, which the caller compares."""
    return {name: story(*mods) for name, mods in PACKAGES.items()}


def _same(story):
    out = both(story)
    assert out["jax"] == out["port"]
    return out["port"]


class TestEngine:
    def test_orders_by_time_then_priority_then_label(self):
        def story(E, _T):
            eng = E.SimEngine()
            fired = []
            for when, prio, label in (
                    (2.0, E.PRIO_TICK, "tick"), (1.0, E.PRIO_FAULT, "zz"),
                    (2.0, E.PRIO_FAULT, "fault"), (1.0, E.PRIO_FAULT, "aa"),
                    (2.0, E.PRIO_SAMPLE, "sample"),
                    (2.0, E.PRIO_TRACE, "trace")):
                eng.at(when, lambda lab=label: fired.append(lab),
                       priority=prio, label=label)
            eng.run()
            return fired, eng.now(), eng.events_fired, eng.pending()

        fired, now, n, pending = _same(story)
        assert fired == ["aa", "zz", "fault", "trace", "tick", "sample"]
        assert (now, n, pending) == (2.0, 6, 0)

    def test_the_planes_are_the_jax_package_s(self):
        assert (port_sim.PRIO_FAULT, port_sim.PRIO_TRACE, port_sim.PRIO_TICK,
                port_sim.PRIO_SAMPLE) == (
            jax_engine.PRIO_FAULT, jax_engine.PRIO_TRACE,
            jax_engine.PRIO_TICK, jax_engine.PRIO_SAMPLE)

    def test_rejects_scheduling_into_the_past(self):
        def story(E, _T):
            eng = E.SimEngine()
            eng.at(1.0, lambda: None, label="a")
            eng.run()
            with pytest.raises(ValueError, match="monotonic"):
                eng.at(0.5, lambda: None, label="b")
            return eng.now()

        assert _same(story) == 1.0

    def test_run_until_lands_the_clock_on_the_boundary(self):
        def story(E, _T):
            eng = E.SimEngine()
            fired = []
            eng.at(1.0, lambda: fired.append(1.0), label="a")
            eng.at(5.0, lambda: fired.append(5.0), label="a")
            first = eng.run(until=3.0)
            mid = (list(fired), eng.now())
            eng.after(0.5, lambda: fired.append(eng.now()), label="b")
            eng.run()
            return first, mid, fired

        first, mid, fired = _same(story)
        assert first == 1 and mid == ([1.0], 3.0)
        assert fired == [1.0, 3.5, 5.0]

    @pytest.mark.parametrize("period,until", [(0.25, 10.0), (0.04, 7.0),
                                              (0.1, 3.3)])
    def test_tick_loop_keeps_the_while_loop_s_floats(self, period, until):
        expect = []
        now = 0.0
        while now < until:
            now += period
            expect.append(now)

        def story(E, _T):
            eng = E.SimEngine()
            got = []
            eng.tick_loop(period, lambda: got.append(eng.now()), until=until)
            eng.run()
            return got

        assert _same(story) == expect

    def test_tick_loop_while_fn_stops_like_a_while_loop(self):
        def story(E, _T):
            eng = E.SimEngine()
            count = [0]

            def body():
                count[0] += 1

            eng.tick_loop(1.0, body, until=100.0,
                          while_fn=lambda: count[0] < 7)
            eng.run()
            return count[0], eng.now()

        assert _same(story) == (7, 7.0)


def _sources(T, log):
    def mk(label, kind):
        if kind == "at":
            return T.AtSource([1.0, 2.0, 3.0],
                              lambda t, lab=label: log.append((t, lab)),
                              label=label)
        if kind == "window":
            return T.WindowSource(
                [(1.0, 2.0)],
                lambda t, lab=label: log.append((t, lab + "/open")),
                lambda t, lab=label: log.append((t, lab + "/close")),
                label=label)
        if kind == "tick":
            return T.TickSource(1.0,
                                lambda lab=label: log.append(("tick", lab)),
                                until=3.0, label=label)
        return T.SamplerSource(1.0,
                               lambda t, lab=label: log.append((t, lab)),
                               until=3.0, label=label)

    return [mk("kill", "at"), mk("storm", "window"), mk("ctl", "tick"),
            mk("slo", "sample"), mk("drain", "window"), mk("arrive", "at")]


class TestComposition:
    @pytest.mark.parametrize("trial", range(6))
    def test_shuffled_installation_fires_one_stream(self, trial):
        """Six sources installed in a shuffled order fire the stream of
        the sorted installation, byte for byte, in both packages."""
        def story(E, T):
            streams = []
            for order in (None, trial):
                log: list = []
                sources = _sources(T, log)
                if order is not None:
                    random.Random(order).shuffle(sources)
                eng = E.SimEngine()
                T.compose(*sources).install(eng)
                eng.run()
                streams.append(json.dumps(log))
            assert streams[0] == streams[1]
            return streams[0]

        _same(story)


class TestArrivals:
    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_arrivals_are_a_pure_function_of_the_seed(self, seed):
        """Thinning a numpy-drawn piecewise rate: the same arrival times
        in both packages, and again on a second run."""
        rates = np.random.default_rng(seed).uniform(0.1, 3.0, size=40)
        peak = float(rates.max())

        def rate(t: float) -> float:
            return float(rates[int(t // 5.0) % len(rates)])

        def story(E, T):
            runs = []
            for _ in range(2):
                times: list = []
                eng = E.SimEngine()
                T.ArrivalSource(seed, rate, times.append, peak_rate=peak,
                                until=200.0).install(eng)
                eng.run()
                runs.append(times)
            assert runs[0] == runs[1]
            return runs[0]

        assert len(_same(story)) > 50

    def test_a_non_positive_peak_is_refused(self):
        def story(E, T):
            with pytest.raises(ValueError, match="peak_rate"):
                T.ArrivalSource(0, lambda t: 1.0, lambda t: None,
                                peak_rate=0.0, until=1.0)
            return True

        _same(story)

    def test_diurnal_samples_and_node_kills(self):
        def story(E, T):
            log: list = []
            eng = E.SimEngine()
            T.compose(
                T.DiurnalLoadSource(lambda t: 2.0 * t,
                                    lambda t, load: log.append(
                                        ("load", t, load)),
                                    period=1.5, until=12.0),
                T.NodeKillSource(3, 0.4, lambda t: log.append(("kill", t)),
                                 until=12.0)).install(eng)
            eng.run()
            return log

        log = _same(story)
        assert any(e[0] == "kill" for e in log)
        assert [e[1] for e in log if e[0] == "load"] == \
            [1.5 * i for i in range(1, 9)]


class TestInjectors:
    def test_two_injectors_compose_on_one_run(self):
        """``tests/test_sim.py``'s case on both packages: an API chaos
        window and two stockout windows on one engine, probed at the same
        instants."""
        import nos_tpu.sim.injectors as jax_injectors
        import nos_tpu.testing.chaos as jax_chaos

        import nos_tpu_torch.sim.injectors as port_injectors
        import nos_tpu_torch.testing.chaos as port_chaos

        sides = {"jax": (jax_chaos, jax_injectors, "ChaosCloudTPUAPI",
                         "tpu-v5e"),
                 "port": (port_chaos, port_injectors, "ChaosCloudGPUAPI",
                          "nvidia-h100-80gb-hbm3")}

        def story(E, _T, chaos_mod, inj, cloud_cls, mc):
            api = chaos_mod.ChaosAPIServer(seed=5)
            eng = E.SimEngine()
            cloud = getattr(chaos_mod, cloud_cls)(5, clock=eng.now)
            api_chaos = inj.APIChaosInjector(
                api, [(2.0, 3.0)], conflict_rate=0.5, transient_rate=0.25)
            cloud_chaos = inj.CloudChaosInjector(
                cloud, [(2.0, 4.0), (8.0, 1.0)], machine_class=mc,
                zone="z0")
            inj.install_all(eng, [api_chaos, cloud_chaos])
            probes = {}

            def probe(t):
                probes[t] = (api._conflict_rate, api._transient_rate,
                             cloud._stockout_until.get((mc, "z0"), 0.0)
                             > eng.now())

            for t in (1.0, 2.5, 3.5, 4.5, 5.5, 8.5, 9.5):
                eng.at(t, (lambda when=t: probe(when)),
                       priority=E.PRIO_SAMPLE, label="probe")
            eng.run()
            return (probes, cloud_chaos.opened, cloud_chaos.closed,
                    api.stats, eng.events_fired)

        out = {name: story(*PACKAGES[name], *sides[name])
               for name in ("jax", "port")}
        assert out["jax"] == out["port"]
        probes, opened, closed, _, _ = out["port"]
        assert probes[1.0] == (0.0, 0.0, False)
        assert probes[2.5] == (0.5, 0.25, True)
        assert probes[3.5] == (0.5, 0.25, True)
        assert probes[4.5] == (0.5, 0.25, True)
        assert probes[5.5] == (0.0, 0.0, True)
        assert probes[8.5] == (0.0, 0.0, True)
        assert probes[9.5] == (0.0, 0.0, False)
        assert (opened, closed) == (2, 2)

    def test_the_injectors_are_exported(self):
        assert {"APIChaosInjector", "CloudChaosInjector",
                "install_all"} <= set(port_sim.__all__)
