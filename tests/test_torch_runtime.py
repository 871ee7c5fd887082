"""The port's process runtime and metrics (nos_tpu_torch/cmd/_runtime.py,
exporter/metrics.py, obs.flight_snapshot) against the JAX package's:

- the Registry: one seeded sequence of describe, set, inc and observe
  calls (labels needing escapes among them) gives the same ``render()``,
  ``snapshot()`` and ``quantile()`` on both packages, exactly, and the
  same errors on a conflicting registration;
- ``RunLoop`` as ``tests/test_cmd.py`` checks JAX's: a raising tick is
  counted and the loop goes on and stops, a slow tick does not stretch
  the period, and a gate holds the ticks back until it is set;
- ``Main`` on ``127.0.0.1:0``: every endpoint's code and body against
  JAX's Main on the same registry state, the flight recorder with its
  waste report, ``/snapshot`` with an API attached and ``/debug/slo``
  after ``attach_slo`` against JAX's on the same state; leader election
  gating the loops, shutdown hooks, ``build_api``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import nos_tpu.cmd._runtime as jrt
import nos_tpu.exporter.metrics as jmetrics

import nos_tpu_torch.cmd._runtime as rt
import nos_tpu_torch.exporter.metrics as metrics
import nos_tpu_torch.obs as pobs
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.kube.rest import KubeClient


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


def _drive(reg, seed: int) -> None:
    """A seeded sequence of registry calls."""
    rng = np.random.default_rng(seed)
    reg.describe("nos_t_total", "a counter")
    reg.describe("nos_t_gauge", "a gauge")
    reg.describe("nos_t_seconds", "a histogram")
    reg.describe("nos_t_sized", "custom buckets", buckets=(1, 2, 4, 8))
    labels = [None, {"kind": "mps"}, {"kind": "mig", "pool": "p0"},
              {"v": 'a"b\\c\nd'}]
    for _ in range(60):
        op = int(rng.integers(4))
        lab = labels[int(rng.integers(len(labels)))]
        if op == 0:
            reg.inc("nos_t_total", float(rng.integers(1, 4)), labels=lab)
        elif op == 1:
            reg.set("nos_t_gauge", float(rng.normal()), labels=lab)
        elif op == 2:
            reg.observe("nos_t_seconds", float(rng.exponential(0.5)),
                        labels=lab)
        else:
            reg.observe("nos_t_sized", float(rng.uniform(0, 12)),
                        labels=lab)


class TestRegistry:
    @pytest.mark.parametrize("seed", range(4))
    def test_render_snapshot_quantile_are_jax_s(self, seed):
        reg, jreg = metrics.Registry(), jmetrics.Registry()
        _drive(reg, seed)
        _drive(jreg, seed)
        assert reg.render() == jreg.render()
        assert reg.snapshot() == jreg.snapshot()
        for name in ("nos_t_seconds", "nos_t_sized"):
            for lab in (None, {"kind": "mps"}, {"kind": "nope"}):
                for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                    assert reg.quantile(name, q, lab) == \
                        jreg.quantile(name, q, lab)
        reg.reset_window()
        jreg.reset_window()
        assert reg.render() == jreg.render()
        reg.reset()
        jreg.reset()
        assert reg.render() == jreg.render() == "\n"

    def test_value_and_summary_read_the_series_back(self):
        reg = metrics.Registry()
        assert reg.value("g") is None and reg.summary("h") is None
        reg.set("g", 2.5)
        reg.inc("c", 2.0, labels={"k": "a"})
        reg.observe("h", 0.25)
        reg.observe("h", 0.75)
        assert reg.value("g") == 2.5
        assert reg.value("c", {"k": "a"}) == 2.0
        assert reg.summary("h") == (2, 1.0, 0.75)
        reg.set("g", 1.0, labels={"class": "train"})
        assert reg.gauge_label_values("g", "class") == ["train"]

    @pytest.mark.parametrize("case", [
        "help", "scalar-after-histogram", "derived-name",
        "histogram-after-scalar", "buckets", "bad-buckets"])
    def test_conflicts_raise_as_in_jax(self, case):
        def run(reg):
            if case == "help":
                reg.describe("m", "one")
                reg.describe("m", "two")
            elif case == "scalar-after-histogram":
                reg.observe("m", 1.0)
                reg.set("m", 1.0)
            elif case == "derived-name":
                reg.observe("m", 1.0)
                reg.inc("m_count")
            elif case == "histogram-after-scalar":
                reg.inc("m_sum")
                reg.observe("m", 1.0)
            elif case == "buckets":
                reg.observe("m", 1.0, buckets=(1, 2))
                reg.observe("m", 1.0, buckets=(1, 3))
            else:
                reg.describe("m", "x", buckets=(2, 1))

        errors = []
        for mod in (metrics, jmetrics):
            with pytest.raises(ValueError) as e:
                run(mod.Registry())
            errors.append(str(e.value))
        # the JAX message adds a pointer to its docs
        assert errors[1].startswith(errors[0].split(" — ")[0])


# ---------------------------------------------------------------------------
# Run loops
# ---------------------------------------------------------------------------


class TestRunLoops:
    def test_loop_survives_exceptions_and_stops(self):
        main = rt.Main("t")
        calls = []

        def boom():
            calls.append(1)
            raise RuntimeError("tick failed")

        errors0 = metrics.REGISTRY.value("nos_tpu_runloop_errors_total",
                                         {"loop": "boom"}) or 0.0
        main.add_loop("boom", boom, 0.01)
        main.start()
        time.sleep(0.1)
        main.shutdown()
        assert len(calls) >= 2  # kept running after the exception
        n = len(calls)
        time.sleep(0.05)
        assert len(calls) == n  # stopped
        assert metrics.REGISTRY.value("nos_tpu_runloop_errors_total",
                                      {"loop": "boom"}) - errors0 == n

    @pytest.mark.parametrize("mod", [rt, jrt], ids=["port", "jax"])
    def test_slow_tick_does_not_stretch_the_period(self, mod):
        """A ~0.03 s tick against a 0.05 s interval waits what is left
        of the interval, never the whole interval (asserted on the wait
        the loop asks for, as tests/test_cmd.py does)."""
        waits: list[float] = []

        class _Stop(threading.Event):
            def wait(self, timeout=None):
                waits.append(timeout)
                return len(waits) >= 3

            def is_set(self):
                return len(waits) >= 3

        mod.RunLoop("t", lambda: time.sleep(0.03), 0.05, _Stop()).run()
        assert len(waits) == 3
        assert all(w < 0.045 for w in waits), waits

    def test_a_gate_holds_the_ticks_back(self):
        stop, gate = threading.Event(), threading.Event()
        calls = []
        loop = rt.RunLoop("gated", lambda: calls.append(1), 0.01, stop,
                          gate=gate)
        loop.start()
        time.sleep(0.1)
        assert calls == []
        gate.set()
        deadline = time.monotonic() + 5.0
        while not calls and time.monotonic() < deadline:
            time.sleep(0.01)
        stop.set()
        loop.join(5.0)
        assert calls and not loop.is_alive()

    def test_leader_election_gates_every_loop(self):
        class Elector:
            def __init__(self):
                self.is_leader = threading.Event()
                self.on_stopped_leading = None
                self.ran = threading.Event()

            def run(self, stop):
                self.ran.set()
                stop.wait()

        main = rt.Main("t")
        before, after = [], []
        main.add_loop("before", lambda: before.append(1), 0.01)
        elector = Elector()
        main.attach_leader_election(elector)
        main.add_loop("after", lambda: after.append(1), 0.01)
        main.start()
        try:
            assert elector.ran.wait(5.0)
            time.sleep(0.1)
            assert before == [] and after == []
            elector.is_leader.set()
            deadline = time.monotonic() + 5.0
            while not (before and after) and time.monotonic() < deadline:
                time.sleep(0.01)
            assert before and after
            # losing the lease stops the main
            elector.on_stopped_leading()
            assert main.stop.is_set()
        finally:
            main.shutdown()

    def test_shutdown_runs_the_hooks_and_survives_a_raising_one(self):
        main = rt.Main("t")
        ran = []
        main.add_shutdown_hook(lambda: 1 / 0)
        main.add_shutdown_hook(lambda: ran.append(1))
        main.start()
        main.shutdown()
        assert ran == [1] and not main.ready.is_set()

    def test_run_until_stopped_returns_on_stop(self, monkeypatch):
        main = rt.Main("t")
        monkeypatch.setattr(main, "install_signal_handlers", lambda: None)
        threading.Timer(0.1, main.stop.set).start()
        main.run_until_stopped()
        assert not main.ready.is_set()


# ---------------------------------------------------------------------------
# The health server
# ---------------------------------------------------------------------------


def _get(addr: str, path: str) -> tuple[int, str]:
    try:
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _fresh_obs(monkeypatch) -> None:
    """Both packages' ledgers fresh and their SLO engines uninstalled,
    for the test only."""
    import nos_tpu.obs.ledger as jledger
    import nos_tpu.obs.slo as jslo
    import nos_tpu_torch.obs.ledger as pledger
    import nos_tpu_torch.obs.slo as pslo

    monkeypatch.setattr(pledger, "_ledger", pledger.ChipSecondLedger())
    monkeypatch.setattr(jledger, "_ledger", jledger.ChipSecondLedger())
    monkeypatch.setattr(pslo, "_engine", None)
    monkeypatch.setattr(jslo, "_engine", None)


@pytest.fixture
def mains(monkeypatch):
    """A port Main and a JAX Main on 127.0.0.1:0, each over a fresh
    registry driven by the same sequence, and the same (empty) span ring,
    journal and waste ledger, no SLO engine installed."""
    import nos_tpu.obs.journal as jjournal
    import nos_tpu.obs.trace as jtrace
    import nos_tpu_torch.obs.journal as pjournal
    import nos_tpu_torch.obs.trace as ptrace

    _fresh_obs(monkeypatch)

    reg, jreg = metrics.Registry(), jmetrics.Registry()
    _drive(reg, 0)
    _drive(jreg, 0)
    monkeypatch.setattr(rt, "REGISTRY", reg)
    monkeypatch.setattr(jrt, "REGISTRY", jreg)
    monkeypatch.setattr(pjournal, "_journal", pjournal.DecisionJournal())
    monkeypatch.setattr(jjournal, "_journal", jjournal.DecisionJournal())
    monkeypatch.setattr(ptrace, "_tracer", ptrace.Tracer())
    monkeypatch.setattr(jtrace, "_tracer", jtrace.Tracer())
    port, jax = rt.Main("t", "127.0.0.1:0"), jrt.Main("t", "127.0.0.1:0")
    for m in (port, jax):
        m.start()
    yield port, jax
    for m in (port, jax):
        m.shutdown()


class TestHealthServer:
    @pytest.mark.parametrize("path", [
        "/healthz", "/readyz", "/metrics", "/debug/slo", "/snapshot",
        "/nope"])
    def test_endpoints_answer_as_jax(self, mains, path):
        port, jax = mains
        got, want = _get(port.health_address, path), \
            _get(jax.health_address, path)
        assert got == want
        assert got[0] == {"/healthz": 200, "/readyz": 200, "/metrics": 200,
                          "/debug/slo": 404, "/snapshot": 404,
                          "/nope": 404}[path]

    def test_the_flight_recorder_is_jax_s_without_the_ledger(self, mains):
        """Spans, journal and the chip-second ledger's waste report as
        JAX serves them (the name predates the port's ledger)."""
        import nos_tpu.obs.journal as jjournal
        import nos_tpu_torch.obs.journal as pjournal

        pjournal.record("pod-bound", "default/p", node="n0")
        jjournal.record("pod-bound", "default/p", node="n0")
        port, jax = mains
        code, body = _get(port.health_address, "/debug/flightrecorder")
        jcode, jbody = _get(jax.health_address, "/debug/flightrecorder")
        got, want = json.loads(body), json.loads(jbody)
        assert code == jcode == 200
        assert "slo" not in want and "slo" not in got
        assert got["waste"] == want["waste"]
        assert got["waste"]["categories"] == want["waste"]["categories"]
        for rec in got["journal"] + want["journal"]:
            rec.pop("ts")
        assert got == want
        assert got == json.loads(json.dumps(pobs.flight_snapshot())) \
            | {"journal": got["journal"]}

    def test_readyz_is_503_before_start(self):
        handler_main = rt.Main("t")
        handler = type("H", (rt._HealthHandler,), {"main": handler_main})
        sent = []
        h = handler.__new__(handler)
        h.path = "/readyz"
        h._respond = lambda code, body, **kw: sent.append((code, body))
        h.do_GET()
        assert sent == [(503, "not ready")]

    def test_the_snapshot_needs_the_ledger(self, monkeypatch):
        """With an API attached both packages serve the cluster, the
        metrics and the ledger's waste report (no ``slo`` without an
        engine), with the same keys; the port's state loads back and its
        waste report is the ledger's.  Before the ledger the port
        answered 501."""
        from nos_tpu.kube.client import APIServer as JaxAPIServer
        from nos_tpu.testing import factory as jfactory
        from nos_tpu_torch.kube.serialize import load_state
        from nos_tpu_torch.obs.ledger import get_ledger
        from nos_tpu_torch.testing.factory import make_gpu_node

        _fresh_obs(monkeypatch)
        api, japi = APIServer(), JaxAPIServer()
        api.create("Node", make_gpu_node("n-0", gpus=1))
        japi.create("Node", jfactory.make_node("n-0"))
        got = []
        for mod, a in ((rt, api), (jrt, japi)):
            m = mod.Main("t", "127.0.0.1:0", api=a)
            m.start()
            try:
                got.append(_get(m.health_address, "/snapshot"))
            finally:
                m.shutdown()
        (code, body), (jcode, jbody) = got
        assert code == jcode == 200
        payload, jpayload = json.loads(body), json.loads(jbody)
        assert sorted(payload) == sorted(jpayload) == \
            ["metrics", "state", "waste"]
        assert payload["waste"] == json.loads(json.dumps(
            get_ledger().report())) == jpayload["waste"]
        assert [n.metadata.name for n in
                load_state(payload["state"]).list("Node")] == ["n-0"]

    def test_attach_slo_raises(self, monkeypatch):
        """``attach_slo`` installs the engine over JAX's three default
        objectives and ticks it on the "slo-sampler" loop; /debug/slo
        then answers 200 with the report JAX's Main serves on the same
        state, timestamps aside (the name predates the port's engine,
        when the call raised)."""
        import nos_tpu.obs.slo as jslo
        import nos_tpu.obs.timeseries as jts
        import nos_tpu_torch.obs.slo as pslo
        import nos_tpu_torch.obs.timeseries as pts

        _fresh_obs(monkeypatch)
        # the engines sample registries of their own, on the same state
        for mod, reg in ((pts, metrics.Registry()),
                         (jts, jmetrics.Registry())):
            _drive(reg, 0)
            reg.observe("nos_tpu_schedule_latency_seconds", 0.2,
                        labels={"class": "ts-24"})
            monkeypatch.setattr(mod, "REGISTRY", reg)
        got = []
        for mod, slo in ((rt, pslo), (jrt, jslo)):
            m = mod.Main("t", "127.0.0.1:0")
            m.attach_slo(interval_s=0.02)
            assert slo.get_engine() is not None
            assert [loop.name for loop in m._loops] == ["slo-sampler"]
            m.start()
            try:
                deadline = time.monotonic() + 10.0
                while not slo.get_engine().sampler.points() \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
                code, body = _get(m.health_address, "/debug/slo")
            finally:
                m.shutdown()
            report = json.loads(body)
            report.pop("ts")
            got.append((code, report))
        assert got[0] == got[1]
        assert got[0][0] == 200
        assert [o["name"] for o in got[0][1]["objectives"]] == [
            "schedule-latency", "actuation-latency", "request-latency"]
        assert [(v["objective"], v["class"]) for v in
                got[0][1]["verdicts"]] == [("schedule-latency", "ts-24")]

    def test_respond_swallows_a_client_disconnect(self):
        h = rt._HealthHandler.__new__(rt._HealthHandler)
        h.request_version = "HTTP/1.1"
        h.requestline = "GET /metrics HTTP/1.1"

        class _BrokenPipe:
            def write(self, data):
                raise BrokenPipeError("client went away")

        h.wfile = _BrokenPipe()
        h._respond(200, "payload")

    def test_health_port_and_build_api(self, tmp_path):
        assert rt.health_port("") == jrt.health_port("") == 0
        assert rt.health_port("0.0.0.0:8081") == \
            jrt.health_port("0.0.0.0:8081") == 8081

        class Cfg:
            kubeconfig = ""

        assert isinstance(rt.build_api(Cfg()), APIServer)
        path = tmp_path / "kubeconfig"
        path.write_text(json.dumps({"clusters": [{"name": "c", "cluster": {
            "server": "http://127.0.0.1:1"}}]}))
        Cfg.kubeconfig = str(path)
        client = rt.build_api(Cfg())
        assert isinstance(client, KubeClient)
        assert client._cfg.server == "http://127.0.0.1:1"
