"""The port's ``obs.explain`` and ``python -m nos_tpu_torch.obs`` against
the JAX package's:

- ``explain_pod`` over both packages' flight snapshots of the gang
  twin's random clusters (``tests/test_torch_gang.py``) gives the same
  lines for every pod, JAX's resource names mapped to the port's;
- ``explain_plan`` over both packages' spans and journals of the MPS
  loop's plan cycle (``tests/test_torch_controller.py``'s twin, tracers
  on its virtual clock) gives the same lines, kinds and plan ids mapped,
  both native screens' fail counters among them;
- the CLI over a live ``Main``: ``--selftest`` as a process, ``dump``
  round-tripped through ``--snapshot``, ``explain pod`` naming the
  rejecting plugin per node, ``waste``, ``slo``, ``top`` and
  ``capacity`` (the JAX CLI's answer to a payload without the block).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import nos_tpu.obs as jobs
from nos_tpu.obs import journal as jjournal, ledger as jledger
from nos_tpu.obs import trace as jtrace

from nos_tpu_torch import obs
from nos_tpu_torch.obs import journal as pjournal, ledger as pledger
from nos_tpu_torch.obs import slo as pslo, trace as ptrace
from nos_tpu_torch.obs.__main__ import main as obs_main

from test_torch_controller import PlanMask, Twin as LoopTwin
from test_torch_planner import build_jax_shim
from test_torch_gang import gang_cluster_spec
from test_torch_quota import QuotaTwin, mapped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _explain_all(twin: QuotaTwin, spec: dict) -> tuple[list, list]:
    pods = sorted({f"{p['namespace']}/{p['name']}"
                   for wave in spec["waves"] for p in wave}
                  | {f"{p['namespace']}/{p['name']}"
                     for p in spec.get("late", ())})
    snap = {"journal": twin.journal.dump(), "spans": []}
    jsnap = {"journal": twin.jax_journal.dump(), "spans": []}
    got = [obs.explain_pod(snap, k) for k in pods]
    want = [[mapped(ln) for ln in jobs.explain_pod(jsnap, k)] for k in pods]
    return got, want


class TestExplainParity:
    @pytest.mark.parametrize("seed", range(4))
    def test_explain_pod_lines_are_jax_s(self, monkeypatch, seed):
        spec = gang_cluster_spec(seed)
        twin = QuotaTwin(monkeypatch, spec, jax_native=False)
        twin.submit(spec["waves"][0])
        twin.step()
        twin.submit(spec["waves"][1])
        twin.step()
        got, want = _explain_all(twin, spec)
        assert got == want
        text = "\n".join(ln for lines in got for ln in lines)
        assert "BOUND to node" in text and "rejected by" in text

    def test_explain_plan_lines_are_jax_s(self, monkeypatch):
        """The MPS loop's plan cycle on both packages, each traced on the
        twin's clock: the span tree, its counters (both native screens'
        fails among them) and the cycle's decisions read alike."""
        assert build_jax_shim(monkeypatch), \
            "the JAX package's native shim did not build"
        tracers = {}

        def install(t):
            clock = lambda: t.now[0]  # noqa: E731
            tracers["port"] = ptrace.Tracer(clock=clock)
            tracers["jax"] = jtrace.Tracer(clock=clock)
            monkeypatch.setattr(ptrace, "_tracer", tracers["port"])
            monkeypatch.setattr(jtrace, "_tracer", tracers["jax"])

        t = LoopTwin(monkeypatch)
        install(t)
        for i in range(3):
            t.create(f"infer-{i}", 8)
        t.schedule()
        assert t.plan_cycle()
        snap = {"spans": tracers["port"].ring.dump(),
                "journal": t.journal.dump()}
        jsnap = {"spans": tracers["jax"].ring.dump(),
                 "journal": t.jax_journal.dump()}
        got = obs.explain_plan(snap)
        mask, jmask = PlanMask(), PlanMask()
        for m, j in ((mask, t.journal), (jmask, t.jax_journal)):
            for r in j.events():
                m.learn(str(r.attrs.get("plan_id", "")))
        want = [jmask(ln).replace("timeshare", "mps")
                for ln in jobs.explain_plan(jsnap)]
        assert [mask(ln) for ln in got] == want
        assert got[0].startswith("partitioner.plan_cycle")
        assert any("node-actuated ts-0" in ln for ln in got)
        assert obs.explain_plan(snap, kind="mig") == [
            "no completed plan cycle in the span ring for kind 'mig'"]

    def test_no_records_reads_as_jax(self):
        for mod in (obs, jobs):
            assert mod.explain_pod({"journal": []}, "ns/p") == [
                "pod ns/p: no journaled decisions — either it never "
                "reached the scheduler, or the journal has since evicted "
                "them (bounded ring)"]


@pytest.fixture
def live(monkeypatch):
    """A port Main serving an API with one GPU node and a scheduler that
    rejected a pod too big for it, on fresh observability state."""
    from nos_tpu_torch.cmd._runtime import Main
    from nos_tpu_torch.cmd.assembly import build_scheduler
    from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
    from nos_tpu_torch.testing import factory

    now = [100.0]
    monkeypatch.setattr(pjournal, "_journal", pjournal.DecisionJournal())
    monkeypatch.setattr(ptrace, "_tracer", ptrace.Tracer())
    monkeypatch.setattr(pledger, "_ledger", pledger.ChipSecondLedger(
        clock=lambda: now[0]))
    monkeypatch.setattr(pslo, "_engine", None)
    api = APIServer()
    api.create(KIND_NODE, factory.make_gpu_node(
        "gpu-0", gpus=1, domain="nvl-0", status_geometry={
            0: {"free": {"24gb": 2}}}))
    api.create(KIND_POD, factory.make_timeshare_pod(24, 1, name="fits"))
    api.create(KIND_POD, factory.make_timeshare_pod(80, 1, name="big"))
    sched = build_scheduler(api, clock=lambda: now[0])
    sched.run_cycle()
    now[0] += 4.0
    sched.run_cycle()
    main = Main("t", "127.0.0.1:0", api=api)
    main.start()
    yield main, f"http://{main.health_address}"
    main.shutdown()
    sched.close()


class TestCLI:
    def test_selftest_as_a_process(self):
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run(
            [sys.executable, "-m", "nos_tpu_torch.obs", "--selftest"],
            capture_output=True, text=True, cwd="/", env=env, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip() == (
            "obs selftest: ok (spans, journal, explain, timeseries, slo, "
            "ledger)")

    def test_explain_pod_names_the_plugin_per_node(self, live, capsys):
        _, url = live
        assert obs_main(["explain", "pod", "default/big", "--url", url]) == 0
        out = capsys.readouterr().out
        assert "node gpu-0: rejected by NodeResourcesFit" in out
        assert obs_main(["explain", "pod", "default/fits",
                         "--url", url]) == 0
        assert "BOUND to node gpu-0" in capsys.readouterr().out
        assert obs_main(["explain", "pod", "nokey", "--url", url]) == 2

    def test_dump_round_trips_through_snapshot(self, live, tmp_path,
                                               capsys):
        _, url = live
        assert obs_main(["dump", "--url", url]) == 0
        dumped = capsys.readouterr().out
        path = tmp_path / "flight.json"
        path.write_text(dumped)
        assert json.loads(dumped)["waste"]["pools"]["nvl-0"][
            "capacity_chips"] == 1.0
        outs = []
        for args in (["--url", url], ["--snapshot", str(path)]):
            assert obs_main(["explain", "pod", "default/big", *args]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "rejected by" in outs[0]

    def test_waste_over_a_live_main(self, live, capsys):
        _, url = live
        assert obs_main(["waste", "--url", url]) == 0
        out = capsys.readouterr().out
        assert "GPU-second waste waterfall (conservation: ok)" in out
        assert "pool nvl-0: 1 GPUs x 4.0s = 4.0 GPU-s" in out
        # 24 GB held of 80: productive 0.3; the rest stranded by "big"
        assert "productive" in out and "frag_stranded" in out
        assert "culprit class ts-80" in out

    def test_slo_and_top_over_a_live_main(self, live, capsys):
        main, url = live
        assert obs_main(["slo", "--url", url]) == 1
        assert "no SLO report" in capsys.readouterr().err
        main.attach_slo(interval_s=0.01)
        assert obs_main(["top", "--url", url]) == 0
        out = capsys.readouterr().out
        assert "fleet: 1 host(s), 1 GPUs" in out
        assert "pending by class:" in out and "ts-80" in out
        assert "waste waterfall (GPU-seconds" in out

    def test_capacity_answers_as_jax_without_the_block(self, live,
                                                       tmp_path, capsys):
        """The capacity plane comes with ROADMAP item 9 part 2: on a
        payload without its block both CLIs answer alike."""
        from nos_tpu.obs.__main__ import main as jax_main

        _, url = live
        assert obs_main(["dump", "--url", url]) == 0
        path = tmp_path / "flight.json"
        path.write_text(capsys.readouterr().out)
        assert obs_main(["capacity", "--snapshot", str(path)]) == 1
        port_err = capsys.readouterr().err
        assert jax_main(["capacity", "--snapshot", str(path)]) == 1
        assert port_err == capsys.readouterr().err
        assert "no capacity block" in port_err

    def test_unreadable_sources_exit_1(self, tmp_path, capsys):
        bad = tmp_path / "bad.json"
        bad.write_text("{nope")
        assert obs_main(["waste", "--snapshot", str(bad)]) == 1
        assert obs_main(["waste", "--snapshot",
                         str(tmp_path / "missing.json")]) == 1
        assert obs_main([]) == 2
