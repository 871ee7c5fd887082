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

import contextlib
import copy
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


# ---------------------------------------------------------------------------
# The rest of the simulator: the scenario harness, the worst week with its
# what-if planner, the report contract and the CLI
# ---------------------------------------------------------------------------

# JAX strings in the port's names: a 2x4 slice (one v5e host, 128 GB) is
# eight 7g.80gb (one 8-GPU node, 640 GB), so GB scale by 5
HARNESS_MAPPED = (("nos.tpu/slice-2x4", "nvidia.com/mig-7g.80gb"),
                  ("slice-2x4", "slice-7g.80gb"))
WHAT_IFS = ("hosts=+120", "quota=train:0.6,serve:0.2,research:0.2")


@contextlib.contextmanager
def _kept_registries():
    """``WorstWeek.run`` resets its package's metrics registry: put each
    package's series back afterwards, so later tests in this process see
    what they would have."""
    from nos_tpu.exporter.metrics import REGISTRY as jax_registry
    from nos_tpu_torch.exporter.metrics import REGISTRY as port_registry

    kept = [(reg, {k: copy.deepcopy(getattr(reg, k))
                   for k in ("_counters", "_gauges", "_timers")})
            for reg in (jax_registry, port_registry)]
    try:
        yield
    finally:
        for reg, series in kept:
            for k, v in series.items():
                setattr(reg, k, v)


def _ww(pkg):
    if pkg == "jax":
        import nos_tpu.sim.worstweek as ww
    else:
        import nos_tpu_torch.sim.worstweek as ww
    return ww


def _no_wall(report: dict) -> dict:
    return {k: v for k, v in report.items()
            if k not in ("wall_s", "sim_speedup")}


@pytest.fixture(scope="module")
def weeks():
    """Every worst-week run the module compares, made once: the smoke day
    at seeds 0 and 1 and the two what-if forecasts, through each package
    (about 1.6 s a run on the CPU)."""
    out: dict = {}
    with _kept_registries():
        for pkg in PACKAGES:
            ww = _ww(pkg)
            for seed in (0, 1):
                cfg = ww.WorstWeekConfig(seed=seed).smoke()
                out[pkg, seed] = ww.WorstWeek(cfg).run(
                    wall_clock=lambda: 0.0)
            for spec in WHAT_IFS:
                out[pkg, spec] = ww.run_what_if(
                    ww.WorstWeekConfig(seed=0).smoke(), spec,
                    base_report=out[pkg, 0], wall_clock=lambda: 0.0)
    return out


class TestWorstWeek:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_reports_equal_jax_s(self, weeks, seed):
        assert _no_wall(weeks["port", seed]) == _no_wall(weeks["jax", seed])
        assert json.dumps(_no_wall(weeks["port", seed]), sort_keys=True) \
            == json.dumps(_no_wall(weeks["jax", seed]), sort_keys=True)

    def test_smoke_conserves_and_explains(self, weeks):
        report = weeks["port", 0]
        assert report["ledger"]["conservation_ok"]
        assert report["ledger"]["conservation_delta"] == 0.0
        judged = {v["objective"] for v in report["slo"]["verdicts"]}
        assert judged == {"sim_fleet_util_floor", "sim_serve_wait_p99",
                          "sim_train_wait_p99", "sim_research_wait_p99",
                          "sim_node_kill_rate"}
        assert report["unexplained_breaches"] == 0
        assert (report["hosts"], report["pools"], report["events"]) == (
            480, 8, 4529)
        assert report["jobs"] == {"completed": 1487, "evicted": 4,
                                  "pending_at_end": 0}
        assert report["kills"] == 7

    def test_seed_1_fails_the_gate_in_both_packages(self, weeks):
        """Seed 1's smoke day has two breaches no injected fault window
        explains, in JAX's run as in the port's."""
        for pkg in PACKAGES:
            assert weeks[pkg, 1]["unexplained_breaches"] == 2
            assert weeks[pkg, 1]["ledger"]["conservation_ok"]

    def test_is_deterministic_per_seed(self, weeks):
        ww = _ww("port")
        with _kept_registries():
            again = ww.WorstWeek(ww.WorstWeekConfig(seed=1).smoke()).run(
                wall_clock=lambda: 0.0)
        assert again == weeks["port", 1]

    @pytest.mark.parametrize("spec", WHAT_IFS)
    def test_what_if_forecasts_equal_jax_s(self, weeks, spec):
        out = weeks["port", spec]
        assert out == weeks["jax", spec]
        assert out["spec"] == spec
        assert set(out["delta"]["wait_p99_s"]) == {"train", "serve",
                                                   "research"}
        if spec.startswith("hosts"):
            assert out["delta"]["hosts"] == 120
            # demand stays pinned to the base fleet: more capacity, less
            # waiting
            assert out["delta"]["wait_p99_s"]["train"] < 0

    @pytest.mark.parametrize("spec", [
        "hosts=+120", "hosts=-60", " hosts =7",
        "quota=train:0.6,serve:0.2,research:0.2",
        "quota=train:0.9,serve:0.3", "chips=+8", "hosts=many", "quota=train",
        "quota=train:x", ""])
    def test_parse_what_if_answers_as_jax(self, spec):
        def parse(pkg):
            try:
                return ("ok", _ww(pkg).parse_what_if(spec))
            except Exception as e:  # noqa: BLE001 — compared, not hidden
                return (type(e).__name__, str(e))

        assert parse("port") == parse("jax")

    def test_apply_what_if_pins_demand(self):
        def story(pkg):
            ww = _ww(pkg)
            cfg = ww.WorstWeekConfig(seed=3).smoke()
            return [ww.apply_what_if(cfg, ww.parse_what_if(s)).__dict__
                    for s in WHAT_IFS]

        port, jax = story("port"), story("jax")
        assert port == jax
        assert port[0]["hosts"] == 600 and port[0]["demand_hosts"] == 480

    def test_config_and_helpers_are_jax_s(self):
        jw, pw = _ww("jax"), _ww("port")
        assert pw.WorstWeekConfig().__dict__ == jw.WorstWeekConfig().__dict__
        assert (pw.WorstWeekConfig(seed=4).smoke().__dict__
                == jw.WorstWeekConfig(seed=4).smoke().__dict__)
        assert pw._CLASSES == jw._CLASSES and pw.DAY_S == jw.DAY_S
        assert (pw.UTIL_GAUGE, pw.WAIT_HIST, pw.KILLS_TOTAL) == (
            jw.UTIL_GAUGE, jw.WAIT_HIST, jw.KILLS_TOTAL)
        from nos_tpu.exporter.metrics import REGISTRY as jreg
        from nos_tpu_torch.exporter.metrics import REGISTRY as preg

        for name in (pw.UTIL_GAUGE, pw.WAIT_HIST, pw.KILLS_TOTAL):
            assert preg._help[name] == jreg._help[name]
        rng = random.Random(11)
        for n in (0, 1, 7, 100):
            xs = [rng.random() for _ in range(n)]
            for q in (0.0, 0.5, 0.99, 1.0):
                assert pw._quantile(xs, q) == jw._quantile(xs, q)

    def test_pick_cycler_round_robins_per_zone(self):
        def story(pkg):
            ww = _ww(pkg)
            pools = {f"pool-{i:03d}": ww._Pool(f"pool-{i:03d}", f"z{i % 2}",
                                              8.0) for i in range(5)}
            pick = ww._pick_cycler(pools)
            return [pick(z) for z in ("", "z0", "", "z1", "z0", "z0", "z9")]

        assert story("port") == story("jax")


class TestReportContract:
    @pytest.mark.parametrize("pkg", sorted(PACKAGES))
    def test_stdout_contract_one_json_document(self, pkg, capsys):
        if pkg == "jax":
            from nos_tpu.sim.report import emit, stdout_to_stderr
        else:
            from nos_tpu_torch.sim import emit, stdout_to_stderr
        with stdout_to_stderr() as real_stdout:
            print("library noise")
            print("progress: 50%")
            emit({"ok": True, "n": 3}, real_stdout)
        captured = capsys.readouterr()
        assert "library noise" in captured.err
        assert "progress: 50%" in captured.err
        lines = [ln for ln in captured.out.splitlines() if ln.strip()]
        assert lines == ['{"ok": true, "n": 3}']

    def test_write_report_writes_the_artifact_as_jax(self, tmp_path,
                                                     capsys):
        from nos_tpu.sim.report import write_report as jax_write
        from nos_tpu_torch.sim import write_report

        payload = {"b": [1, 2.5], "a": {"x": None}}
        write_report(str(tmp_path / "p.json"), payload, note="sim report")
        jax_write(str(tmp_path / "j.json"), payload, note="sim report")
        write_report("", payload)           # no path: nothing written
        assert (tmp_path / "p.json").read_text() == \
            (tmp_path / "j.json").read_text()
        captured = capsys.readouterr()
        assert captured.out == ""
        assert f"sim report written to {tmp_path / 'p.json'}" in captured.err


def _main(pkg):
    if pkg == "jax":
        import nos_tpu.sim.__main__ as m
    else:
        import nos_tpu_torch.sim.__main__ as m
    return m


class TestCLI:
    # the smoke's first half day, at half the cost, the same on both
    # sides
    ARGV = ["--smoke", "--days", "0.5"]

    def _run(self, pkg, argv, capsys):
        with _kept_registries():
            rc = _main(pkg).main(argv, wall_clock=lambda: 0.0)
        captured = capsys.readouterr()
        return rc, captured.out, captured.err

    def test_emits_one_json_document_and_gates(self, capsys, tmp_path):
        out = {}
        for pkg in PACKAGES:
            path = tmp_path / f"{pkg}.json"
            rc, stdout, stderr = self._run(
                pkg, self.ARGV + ["--report", str(path)], capsys)
            lines = [ln for ln in stdout.splitlines() if ln.strip()]
            assert len(lines) == 1
            report = json.loads(lines[0])
            assert json.loads(path.read_text()) == report
            assert "worst-week: 480 hosts, 0.5 days, seed 0" in stderr
            out[pkg] = (rc, report)
        assert out["port"] == out["jax"]
        rc, report = out["port"]
        assert rc == 0 and report["hosts"] == 480 and report["pools"] == 8
        assert report["horizon_s"] == 43_200.0
        assert report["ledger"]["conservation_ok"]

    def test_report_path_from_the_environment(self, capsys, tmp_path,
                                              monkeypatch):
        path = tmp_path / "env.json"
        monkeypatch.setenv("SIM_REPORT_PATH", str(path))
        rc, stdout, _ = self._run("port", self.ARGV + ["--seed", "2"],
                                  capsys)
        assert json.loads(path.read_text()) == json.loads(stdout)

    @pytest.mark.parametrize("spec", ["quota=train:0.9,serve:0.3",
                                      "chips=+8"])
    def test_a_malformed_what_if_is_a_usage_error_before_the_run(
            self, spec, capsys, monkeypatch):
        errors = {}
        for pkg in PACKAGES:
            m = _main(pkg)

            def no_run(*a, **k):
                raise AssertionError("the base run started")

            monkeypatch.setattr(m.WorstWeek, "run", no_run)
            with pytest.raises(SystemExit) as exc:
                m.main(["--smoke", "--what-if", spec])
            assert exc.value.code == 2
            errors[pkg] = capsys.readouterr().err.splitlines()[-1]
        assert errors["port"] == errors["jax"].replace(
            "nos_tpu.sim", "nos_tpu_torch.sim")
        assert errors["port"].startswith("python -m nos_tpu_torch.sim: error:")

    def test_the_gate_fails_on_an_unexplained_breach(self, weeks, capsys,
                                                     monkeypatch):
        """Seed 1's smoke report through each main's gate: exit 1 and
        the failure on stderr, the report still the one stdout line."""
        for pkg in PACKAGES:
            m = _main(pkg)
            monkeypatch.setattr(m.WorstWeek, "run",
                                lambda self, wall_clock=None, r=weeks[
                                    pkg, 1]: dict(r))
            rc = m.main(["--smoke", "--seed", "1"])
            captured = capsys.readouterr()
            assert rc == 1
            assert "worst-week GATE FAILED" in captured.err
            assert "unexplained_breaches=2" in captured.err
            assert json.loads(captured.out) == json.loads(
                json.dumps(weeks[pkg, 1]))

    def test_build_config_is_jax_s(self):
        import argparse

        for argv in ([], ["--smoke"], ["--hosts", "100"],
                     ["--smoke", "--hosts", "1000", "--days", "2.5"],
                     ["--seed", "9", "--hosts", "3"]):
            ns = argparse.Namespace(smoke="--smoke" in argv, seed=0,
                                    hosts=None, days=None)
            for flag, attr, cast in (("--hosts", "hosts", int),
                                     ("--days", "days", float),
                                     ("--seed", "seed", int)):
                if flag in argv:
                    setattr(ns, attr, cast(argv[argv.index(flag) + 1]))
            assert (_main("port").build_config(ns).__dict__
                    == _main("jax").build_config(ns).__dict__)


# -- the scenario harness -----------------------------------------------------

def _small_scenario(pkg, name: str):
    """tests/test_sim.py's ``_small_scenario``: two 8-chip hosts of one
    pool and a quota; in the port two 8-GPU H100 MIG nodes, GB x 5."""
    if pkg == "jax":
        from nos_tpu.sim import PoolSpec, QuotaSpec, Scenario

        return Scenario(
            name=name, horizon_s=8.0, tick_s=0.25, seed=3,
            pools=(PoolSpec("pod-0", hosts=2),),
            quotas=(QuotaSpec("work", min_gb=256.0, max_gb=1024.0),))
    from nos_tpu_torch.sim import PoolSpec, QuotaSpec, Scenario

    return Scenario(
        name=name, horizon_s=8.0, tick_s=0.25, seed=3,
        pools=(PoolSpec("pod-0", hosts=2),),
        quotas=(QuotaSpec("work", min_gb=1280.0, max_gb=5120.0),))


def _jax_harness(style: str, scoped: bool = True) -> dict:
    """``chip_smoke._sim_harness``'s story on the JAX package, in the
    port's names: a 2x4 slice pod for eight 7g.80gb, the slice plan
    cycle for the MIG one.  ``scoped=False`` reads the plane's journal
    without installing it, as tests/test_sim.py does."""
    import nos_tpu.obs as jobs
    from nos_tpu.kube.client import KIND_POD
    from nos_tpu.sim import (
        PRIO_FAULT, SimEngine, assemble_control_plane, compose)
    from nos_tpu.testing.factory import make_slice_pod

    eng = SimEngine()
    plane = assemble_control_plane(_small_scenario("jax", style), eng)
    ctx = (jobs.scoped(journal=plane.journal, ledger=plane.ledger)
           if scoped else contextlib.nullcontext())
    with ctx:
        for i in range(2):
            plane.api.create(KIND_POD, make_slice_pod(
                "2x4", 1, name=f"job-{i}", namespace="work"))
        if style == "event":
            compose(*plane.sources()).install(eng)
            eng.at(4.0, lambda: plane.kill_host("pod-0-h1"),
                   priority=PRIO_FAULT, label="node-kill")
        else:
            killed = [False]

            def tick():
                if not killed[0] and eng.now() >= 4.0:
                    killed[0] = True
                    plane.kill_host("pod-0-h1")
                plane.tick()

            eng.tick_loop(0.25, tick, until=8.0, label="ctl-tick")
        eng.run(until=8.0)

    def mapped(v: str) -> str:
        for jax, port in HARNESS_MAPPED:
            v = v.replace(jax, port)
        return v

    journal = [[r.category,
                "mig" if (r.category, r.subject) == ("plan-cycle", "slice")
                else r.subject,
                sorted([k, mapped(str(v))] for k, v in r.attrs.items()
                       if k != "plan_id")]
               for r in plane.journal.events()]
    pods = sorted([p.metadata.name, p.status.phase, p.spec.node_name or ""]
                  for p in plane.api.list(KIND_POD))
    return {"journal": journal, "pods": pods}


class TestScenarioHarness:
    @pytest.mark.parametrize("style", ["event", "tick"])
    def test_journal_equals_jax_s(self, style):
        import chip_smoke

        port = chip_smoke._sim_harness(style)
        jax = _jax_harness(style)
        assert (port["journal"], port["pods"]) == (jax["journal"],
                                                   jax["pods"])
        assert chip_smoke.sim_harness_digest(jax) == \
            chip_smoke.SIM_HARNESS_DIGEST
        assert [r[0] for r in port["journal"]] == [
            "preemption-none", "pod-rejected", "preemption-none",
            "pod-rejected", "pod-bound", "pod-bound", "plan-cycle"]
        assert len(port["tick_ms"]) == 32

    def test_event_fault_equals_in_tick_fault_check(self):
        """The JAX test's equivalence on the port: a PRIO_FAULT one-shot
        at T fires before the same-timestamp tick, so both stylings
        journal alike and converge the same pods."""
        import chip_smoke

        ev, tk = (chip_smoke._sim_harness(s) for s in ("event", "tick"))
        assert ev["journal"] and ev["journal"] == tk["journal"]
        assert ev["pods"] == tk["pods"] == [
            ["job-0", "Running", "pod-0-h0"], ["job-1", "Running",
                                               "pod-0-h1"]]

    def test_unscoped_journal_is_empty_in_both(self):
        """JAX's test reads the plane's journal without installing it,
        so its trace is empty; the port's is too."""
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.sim import SimEngine, assemble_control_plane
        from nos_tpu_torch.testing.factory import make_mig_pod

        eng = SimEngine()
        plane = assemble_control_plane(_small_scenario("port", "basic"), eng)
        for i in range(2):
            plane.api.create(KIND_POD, make_mig_pod(
                "7g.80gb", 8, name=f"job-{i}", namespace="work"))
        compose_ = port_sim.compose(*plane.sources())
        compose_.install(eng)
        eng.run(until=8.0)
        assert plane.journal.events() == []
        assert _jax_harness("event", scoped=False)["journal"] == []
        pods = plane.api.list(KIND_POD)
        assert len(pods) == 2
        assert all(p.status.phase == "Running" and p.spec.node_name
                   for p in pods)

    def test_simulated_nodes_run_on_the_fake(self, monkeypatch):
        """A simulated node is not the card: the MIG agents get the fake
        runtime of the pool's model, even where NVML would answer."""
        import nos_tpu_torch.device as device
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.device.fake import FakeGpuRuntime
        from nos_tpu_torch.kube.client import KIND_NODE
        from nos_tpu_torch.sim import (
            PoolSpec, QuotaSpec, Scenario, assemble_control_plane)

        def no_nvml(*a, **k):
            raise AssertionError("a simulated node asked for the card")

        monkeypatch.setattr(device, "default_gpu_runtime", no_nvml)
        plane = assemble_control_plane(Scenario(
            name="layout", horizon_s=1.0,
            pools=(PoolSpec("nvl-a", hosts=2, zone="z1", spares=1),
                   PoolSpec("nvl-b", hosts=1, partitioning=C.MPS_KIND)),
            quotas=(QuotaSpec("team", 80.0, 160.0,
                              namespaces=("a", "b")),)))
        agents = plane.agents
        assert sorted(agents) == ["nvl-a-h0", "nvl-a-h1", "nvl-a-spare2",
                                  "nvl-b-h0"]
        for name in ("nvl-a-h0", "nvl-a-h1", "nvl-a-spare2"):
            runtime = agents[name].runtime
            assert isinstance(runtime, FakeGpuRuntime)
            assert runtime.topology() == ("nvidia-h100-80gb-hbm3",
                                          (True,) * 8)
        assert type(agents["nvl-b-h0"]).__name__ == "ChipAgent"
        assert plane.slice_ctl is not None and plane.ts_ctl is not None
        assert plane.ceq_reconciler is not None
        labels = {n.metadata.name: n.metadata.labels
                  for n in plane.api.list(KIND_NODE)}
        spare = labels["nvl-a-spare2"]
        assert spare[C.LABEL_NVLINK_DOMAIN] == "nvl-a"
        assert spare[C.LABEL_HOST_INDEX] == "2"
        assert spare[C.LABEL_SPARE] == C.SPARE_WARM
        assert spare[C.LABEL_ZONE] == "z1"
        assert labels["nvl-b-h0"][C.LABEL_PARTITIONING] == C.MPS_KIND
        assert C.LABEL_ZONE not in labels["nvl-b-h0"]
        plane.kill_host("nvl-a-h1")
        plane.kill_host("nvl-a-h1")          # idempotent
        assert "nvl-a-h1" not in plane.agents

    def test_the_simulator_is_exported_as_jax_s(self):
        import nos_tpu.sim as jax_sim

        assert sorted(port_sim.__all__) == sorted(jax_sim.__all__)
        for name in port_sim.__all__:
            assert hasattr(port_sim, name), name


def test_the_pinned_smoke_digests_are_jax_s(weeks):
    """chip_smoke's phase 18 holds each card run's report to these
    digests: the JAX package's runs (the week's, at 10,000 nodes, is
    pinned from JAX's ``python -m nos_tpu.sim`` and costs ~15 s a
    package here, so it is left to the card)."""
    import chip_smoke

    assert chip_smoke.sim_report_digest(weeks["jax", 0]) == \
        chip_smoke.SIM_DIGESTS["smoke"] == chip_smoke.SIM_DIGESTS[
            "smoke_again"]
    assert chip_smoke.sim_report_digest(weeks["jax", 1]) == \
        chip_smoke.SIM_DIGESTS["smoke_seed1"]
    with_what_if = dict(weeks["jax", 0], what_if=weeks["jax", "hosts=+120"])
    assert chip_smoke.sim_report_digest(with_what_if) == \
        chip_smoke.SIM_DIGESTS["smoke_what_if"]
    assert {name: rc for name, (_, rc) in chip_smoke.SIM_RUNS.items()} == {
        "smoke": 0, "smoke_again": 0, "smoke_seed1": 1,
        "smoke_what_if": 0, "week": 0}
