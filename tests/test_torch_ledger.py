"""The port's chip-second waste ledger (nos_tpu_torch/obs/ledger.py and
the scheduler's ``attribute_free_chips``) against the JAX package's, on
the same inputs, following ``tests/test_ledger.py``'s classes:

- conservation under random waterfalls, holds and verdicts
  (hypothesis), both ledgers to the same report;
- holds and evidence, from the owning call sites on both packages;
- the shared stranded definition and ``pod_chip_equiv`` for every H100
  MIG profile, MPS share and whole GPU (the whole GPU by JAX's rule for
  a whole chip, shown on the twins' ``whole`` pods);
- ``obs waste`` and ``obs top`` over the port's payloads.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from nos_tpu.obs import ledger as jledger
from nos_tpu.scheduler.scheduler import (
    attribute_free_chips as jax_attribute,
)

from nos_tpu_torch import obs
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.obs import ledger as L
from nos_tpu_torch.scheduler.scheduler import attribute_free_chips
from nos_tpu_torch.testing import factory
from nos_tpu_torch.topology import H100_80GB

from test_torch_quota import Side, assert_same_waste

POOLS = ("nvl-0", "nvl-1", "-")


def both_ledgers(clock):
    return (L.ChipSecondLedger(clock=lambda: clock[0]),
            jledger.ChipSecondLedger(clock=lambda: clock[0]))


# a waterfall sample: per pool a capacity and GPUs per category (sums may
# under- or over-commit: the ledger normalises)
_SAMPLE = st.dictionaries(
    st.sampled_from(POOLS),
    st.tuples(st.sampled_from([1.0, 8.0, 64.0, 256.0]),
              st.dictionaries(st.sampled_from(L.CATEGORIES),
                              st.floats(0.0, 300.0), max_size=5)),
    max_size=3)


class TestConservationProperty:
    @settings(max_examples=60, deadline=None)
    @given(steps=st.lists(st.tuples(st.floats(0.0, 30.0), _SAMPLE),
                          min_size=1, max_size=25))
    def test_random_waterfalls_conserve_as_jax(self, steps):
        """Whatever the caller reports, each pool's categories sum to its
        capacity's integral, and the port's report is JAX's."""
        clock = [0.0]
        port, jax = both_ledgers(clock)
        for dt, sample in steps:
            clock[0] += dt
            pools = {p: {"capacity": cap, "categories": dict(cats),
                         "evidence": {L.GANG_WAIT: {"gang": f"ns/{p}"}}}
                     for p, (cap, cats) in sample.items()}
            port.observe(pools)
            jax.observe(pools)
        clock[0] += 1.0
        port.observe({})
        jax.observe({})
        report, jreport = port.report(), jax.report()
        assert L.conservation_ok(report), report["pools"]
        assert_same_waste(report, jreport)
        assert report["overcommit_events"] == jreport["overcommit_events"]
        assert report["fleet"]["chip_seconds"] == pytest.approx(
            jreport["fleet"]["chip_seconds"])

    @settings(max_examples=200, deadline=None)
    @given(free=st.floats(0.0, 8.0),
           holds=st.lists(st.sampled_from(L.HOLD_PRECEDENCE), max_size=3),
           reserved=st.booleans(), demand=st.booleans(),
           rejected=st.booleans(), quota=st.floats(0.0, 12.0),
           gang=st.floats(0.0, 12.0))
    def test_free_gpus_land_in_one_bucket_as_jax(self, free, holds,
                                                 reserved, demand,
                                                 rejected, quota, gang):
        """``attribute_free_chips`` takes what JAX's takes, never more
        than the node's free GPUs, and spends the budgets alike."""
        hold = {h: {"node": "n"} for h in holds} or None
        got = attribute_free_chips(free, hold, reserved, demand, rejected,
                                   quota, gang)
        want = jax_attribute(free, hold, reserved, demand, rejected,
                             quota, gang)
        assert got == want
        cat, take, q_left, g_left = got
        assert cat in L.CATEGORIES and 0.0 <= take <= free
        assert q_left <= quota and g_left <= gang
        if holds:
            assert cat == min(holds, key=L.HOLD_PRECEDENCE.index)

    def test_exact_accrual_and_elapsed(self):
        clock = [0.0]
        for led in both_ledgers(clock):
            clock[0] = 0.0
            led.observe({"p": {"capacity": 8.0, "categories": {
                L.PRODUCTIVE: 6.0, L.FRAG_STRANDED: 2.0}}})
            clock[0] = 10.0
            led.observe({"p": {"capacity": 8.0,
                               "categories": {L.PRODUCTIVE: 8.0}}})
            clock[0] = 15.0
            led.observe({"p": {"capacity": 8.0, "categories": {}}})
            block = led.report()["pools"]["p"]
            assert block["chip_seconds"] == {L.PRODUCTIVE: 100.0,
                                             L.FRAG_STRANDED: 20.0}
            assert block["elapsed_s"] == 15.0
            assert block["capacity_chip_seconds"] == 120.0
            assert block["conservation_delta"] == 0.0

    def test_vanished_pool_stops_accruing_but_keeps_totals(self):
        clock = [0.0]
        led = L.ChipSecondLedger(clock=lambda: clock[0])
        led.observe({"gone": {"capacity": 4.0,
                              "categories": {L.PRODUCTIVE: 4.0}}})
        clock[0] = 2.0
        led.observe({})
        clock[0] = 50.0
        led.observe({})
        block = led.report()["pools"]["gone"]
        assert block["chip_seconds"] == {L.PRODUCTIVE: 8.0}
        assert block["capacity_chip_seconds"] == 8.0

    def test_a_waterfall_that_does_not_add_up_raises(self):
        report = {"pools": {"p": {"capacity_chip_seconds": 10.0,
                                  "conservation_delta": 1.0}}}
        with pytest.raises(RuntimeError, match="does not conserve"):
            L.check_conservation(report, "a run")
        report["pools"]["p"]["conservation_delta"] = 1e-6
        assert L.check_conservation(report, "a run") is report


class TestHoldsAndEvidence:
    def test_hold_lifecycle_and_owner_merge(self):
        for led in both_ledgers([0.0]):
            led.set_hold("n1", L.ACTUATION, owner="mig", plan_id="abc")
            led.set_hold("n1", L.ACTUATION, owner="mps", plan_id="xyz")
            assert led.hold_count() == 2
            assert led.holds() == {"n1": {L.ACTUATION: {"plan_id": "abc"}}}
            led.clear_hold("n1", L.ACTUATION, owner="mig")
            assert L.ACTUATION in led.holds()["n1"]
            led.clear_hold("n1", L.ACTUATION, owner="mps")
            assert led.holds() == {} and led.hold_count() == 0

    @pytest.mark.parametrize("release", ["unquarantine", "probe",
                                         "success"])
    def test_quarantine_list_stamps_and_clears_holds(self, release):
        """The owning call site on both packages: a quarantine stamps the
        hold with its reason, every release path clears it."""
        from nos_tpu.partitioning.core.quarantine import (
            QuarantineList as JaxQuarantineList)
        from nos_tpu_torch.partitioning.core.quarantine import (
            QuarantineList, REASON_ACTUATION)
        import nos_tpu.obs as jobs

        seen = []
        for mod, qcls, kind in ((obs, QuarantineList, "mps"),
                                (jobs, JaxQuarantineList, "timeshare")):
            led = (L if mod is obs else jledger).ChipSecondLedger()
            with mod.scoped(ledger=led):
                q = qcls(kind=kind)
                q.quarantine("h-9", REASON_ACTUATION)
                held = led.holds()["h-9"][L.QUARANTINE]
                if release == "unquarantine":
                    q.unquarantine("h-9")
                elif release == "probe":
                    q.release_for_probe("h-9", 5.0)
                else:
                    q.record_success("h-9")
                seen.append((held["reason"], led.holds()))
        assert seen[0] == seen[1] == (REASON_ACTUATION, {})

    def test_quota_flips_note_the_ledger_as_jax(self):
        """The quota reconcilers' borrow and reclaim flips: the newest is
        the report's ``quota_last_flip`` on both packages."""
        import nos_tpu.obs as jobs
        from test_torch_quota import QuotaTwin  # noqa: F401 (the harness)

        spec = {"nodes": [{"name": "n0", "shares": {40: 2}, "count": 1}],
                "quotas": [{"kind": "eq", "name": "eq-a", "namespace": "a",
                            "namespaces": ["a"], "min": 40, "max": 0}],
                "bound": [{"name": f"b{i}", "namespace": "a", "gb": 40,
                           "qty": 1, "priority": 0, "tier": "",
                           "app": "job", "created": float(i + 1),
                           "node": "n0"} for i in range(2)],
                "waves": [[], []]}
        flips = []
        for jax in (False, True):
            led = (jledger if jax else L).ChipSecondLedger()
            with (jobs if jax else obs).scoped(ledger=led):
                Side(spec, jax, clock=lambda: 10.0)
            flips.append(led.report()["quota_last_flip"])
        assert flips[0] == flips[1] == {"pod": "a/b1", "namespace": "a",
                                        "borrowed": True}

    def test_evidence_persists_after_the_window(self):
        clock = [0.0]
        led = L.ChipSecondLedger(clock=lambda: clock[0])
        led.observe({"p": {"capacity": 8.0,
                           "categories": {L.GANG_WAIT: 8.0},
                           "evidence": {L.GANG_WAIT: {"gang": "ns/j"}}}})
        clock[0] = 1.0
        led.observe({"p": {"capacity": 8.0,
                           "categories": {L.PRODUCTIVE: 8.0}}})
        assert led.report()["pools"]["p"]["evidence"] == {
            L.GANG_WAIT: {"gang": "ns/j"}}

    def test_chip_seconds_counter_exported(self):
        clock = [0.0]
        led = L.ChipSecondLedger(clock=lambda: clock[0])
        before = REGISTRY.value("nos_tpu_chip_seconds_total",
                                {"category": "productive",
                                 "pool": "ctr-pool"}) or 0.0
        led.observe({"ctr-pool": {"capacity": 4.0,
                                  "categories": {L.PRODUCTIVE: 4.0}}})
        clock[0] = 3.0
        led.observe({"ctr-pool": {"capacity": 4.0, "categories": {}}})
        after = REGISTRY.value("nos_tpu_chip_seconds_total",
                               {"category": "productive",
                                "pool": "ctr-pool"})
        assert after - before == pytest.approx(12.0)
        assert "nos_tpu_chip_seconds_total" in REGISTRY.render()

    def test_the_schema_is_jax_s(self):
        assert L.CATEGORIES == jledger.CATEGORIES
        assert L.WASTE_CATEGORIES == jledger.WASTE_CATEGORIES
        assert L.HOLD_PRECEDENCE == jledger.HOLD_PRECEDENCE


class TestSharedStrandedDefinition:
    @pytest.mark.parametrize("seed", range(4))
    def test_helper_arithmetic_is_jax_s(self, seed):
        rng = np.random.default_rng(seed)
        free = {f"h{i}": float(rng.choice([0.0, 0.5, 3.0, 8.0]))
                for i in range(6)}
        flagged = {h for h in free if rng.random() < 0.5}
        assert L.stranded_free(free, flagged) == \
            jledger.stranded_free(free, flagged)
        assert L.stranded_fraction(free, flagged) == \
            jledger.stranded_fraction(free, flagged)
        assert L.stranded_fraction({}, {"a"}) == 0.0

    @pytest.mark.parametrize("row", H100_80GB.mig_profiles,
                             ids=lambda r: r.name)
    def test_a_mig_instance_counts_its_compute_slices(self, row):
        """g/7 of a GPU, the weight snapshot.py's ``_gpu_sevenths``
        gives a MIG instance (JAX's slice at its chips)."""
        from nos_tpu_torch.partitioning.core.snapshot import _gpu_sevenths
        from nos_tpu_torch.topology.profile import slice_resource_name

        for qty in (1, 2):
            pod = factory.make_mig_pod(row.name, qty)
            req = pod_request(pod)
            got = L.pod_chip_equiv(req, 8.0, 80.0)
            assert got == pytest.approx(
                _gpu_sevenths(slice_resource_name(row.name), qty) / 7.0)
            assert got == pytest.approx(row.compute_slices * qty / 7.0)

    @pytest.mark.parametrize("gb", [5, 8, 10, 16, 20, 24, 40, 80])
    def test_an_mps_share_counts_its_gb_as_jax_s_share(self, gb):
        """GB over the GB per GPU: JAX's ``tpu-<N>gb`` share at the
        twins' 80 GB a chip gives the same."""
        from nos_tpu.kube.resources import pod_request as jax_request
        from nos_tpu.testing import factory as jfactory

        for qty in (1, 3):
            got = L.pod_chip_equiv(pod_request(
                factory.make_timeshare_pod(gb, qty)), 8.0, 80.0)
            want = jledger.pod_chip_equiv(jax_request(
                jfactory.make_timeshare_pod(gb, qty)), 8.0, 80.0)
            assert got == want == gb * qty / 80.0

    @pytest.mark.parametrize("gpus", [1, 2, 8])
    def test_a_whole_gpu_follows_jax_s_whole_chip_rule(self, gpus):
        """JAX counts slice and timeshare requests only
        (``extract_slice_requests`` matches ``nos.tpu/slice-*``, never
        ``google.com/tpu``), so a whole chip counts 0; the port's whole
        ``nvidia.com/gpu`` does too.  Shown on the twins' ``whole``
        pods."""
        for jax in (False, True):
            side = Side.__new__(Side)
            side.jax = jax
            req = side.whole(gpus)
            mod = jledger if jax else L
            assert mod.pod_chip_equiv(req, 8.0, 80.0) == 0.0

    def test_a_mixed_request_sums_its_parts(self):
        req = {"nvidia.com/mig-3g.40gb": 2, "nvidia.com/gpu-20gb": 1,
               C.RESOURCE_GPU: 1, "cpu": 4.0}
        assert L.pod_chip_equiv(req, 8.0, 80.0) == pytest.approx(
            6 / 7 + 0.25)
        # a MIG instance is capped at the host's GPUs, as JAX caps a
        # slice at the host shard
        assert L.pod_chip_equiv({"nvidia.com/mig-7g.80gb": 1}, 0.5,
                                80.0) == 0.5


def _demo_payload():
    """A flight-style payload: a waterfall and the journal records its
    culprits join to."""
    clock = [0.0]
    led = L.ChipSecondLedger(clock=lambda: clock[0])
    led.observe({"nvl-0": {
        "capacity": 16.0,
        "categories": {L.PRODUCTIVE: 8.0, L.GANG_WAIT: 5.0,
                       L.FRAG_STRANDED: 2.0, L.QUARANTINE: 1.0},
        "evidence": {
            L.GANG_WAIT: {"gang": "team-a/job-7"},
            L.FRAG_STRANDED: {"class": "ts-80", "rejected_nodes": 3},
            L.QUARANTINE: {"node": "gpu-node-3",
                           "reason": "plan-deadline"}}}})
    clock[0] = 10.0
    led.observe({"nvl-0": {"capacity": 16.0, "categories": {}}})
    journal = obs.DecisionJournal(maxlen=64, clock=lambda: clock[0])
    journal.record("pod-rejected", "team-a/job-7-0", reason="",
                   message="no fit",
                   nodes={"gpu-node-1": "NodeResourcesFit: insufficient "
                                        "nvidia.com/gpu-80gb"},
                   reason_counts={"NodeResourcesFit: insufficient "
                                  "nvidia.com/gpu-80gb": 3},
                   **{"class": "ts-80"})
    journal.record("gang-rejected", "team-a/job-7",
                   message="gang does not fit as a whole",
                   members=["team-a/job-7-0"], members_total=2)
    journal.record("quarantined", "gpu-node-3", kind="mps",
                   reason="plan-deadline")
    return {"waste": led.report(), "journal": journal.dump()}


class TestWasteCLI:
    def test_golden_path_names_journal_joined_culprits(self, capsys):
        from nos_tpu_torch.obs.__main__ import cmd_waste

        assert cmd_waste(_demo_payload()) == 0
        out = capsys.readouterr().out
        assert "conservation: ok" in out
        assert out.index("1. gang_wait") < out.index("2. frag_stranded")
        assert "culprit gang team-a/job-7" in out
        assert "gang does not fit as a whole" in out
        assert "culprit class ts-80" in out
        assert "insufficient nvidia.com/gpu-80gb" in out
        assert "culprit node gpu-node-3" in out

    def test_the_lines_are_jax_s_on_the_same_payload(self, capsys):
        """The JAX CLI renders the port's payload to the same lines, but
        for the units (GPU for chip) and the defrag hint's item."""
        from nos_tpu.obs.__main__ import cmd_waste as jax_cmd_waste
        from nos_tpu_torch.obs.__main__ import cmd_waste

        payload = _demo_payload()
        assert cmd_waste(payload) == jax_cmd_waste(payload) == 0
        out = capsys.readouterr().out.splitlines()
        port, jax = out[:len(out) // 2], out[len(out) // 2:]
        assert [ln for ln in port if "defrag" not in ln] == \
            [ln.replace("chip", "GPU") for ln in jax if "defrag" not in ln]

    def test_conservation_violation_is_loud_and_nonzero(self, capsys):
        from nos_tpu_torch.obs.__main__ import cmd_waste

        payload = _demo_payload()
        payload["waste"]["pools"]["nvl-0"]["conservation_delta"] = 5.0
        assert cmd_waste(payload) == 1
        assert "VIOLATED" in capsys.readouterr().out

    def test_no_block_is_a_clean_error(self, capsys):
        from nos_tpu_torch.obs.__main__ import cmd_waste

        assert cmd_waste({"spans": []}) == 1
        assert "no waste waterfall" in capsys.readouterr().err

    def test_waste_ranking_is_jax_s(self):
        report = _demo_payload()["waste"]
        assert L.waste_ranking(report) == jledger.waste_ranking(report)
        assert [r["category"] for r in L.waste_ranking(report)] == [
            L.GANG_WAIT, L.FRAG_STRANDED, L.QUARANTINE]


class TestTop:
    def _state(self):
        from nos_tpu_torch.kube.serialize import dump_state

        api = APIServer()
        api.create(KIND_NODE, factory.make_gpu_node(
            "h-0", gpus=2, domain="nvl-0", host_index=0))
        api.create(KIND_NODE, factory.make_gpu_node(
            "h-1", gpus=2, domain="nvl-0", host_index=1))
        pod = factory.make_timeshare_pod(40, 1, name="busy")
        pod.spec.node_name = "h-0"
        api.create(KIND_POD, pod)
        api.create(KIND_POD, factory.make_timeshare_pod(24, 1, name="wait"))
        return dump_state(api)

    def test_the_frag_column_is_the_shared_helper(self, capsys):
        from nos_tpu_torch.obs.__main__ import cmd_top

        assert cmd_top({"state": self._state(),
                        "waste": _demo_payload()["waste"]}) == 0
        out = capsys.readouterr().out
        assert "fleet: 2 host(s), 4 GPUs" in out
        row = next(ln for ln in out.splitlines() if ln.startswith("nvl-0"))
        want = L.stranded_fraction({"h-0": 1.0, "h-1": 2.0}, {"h-0"})
        assert row.split()[-1] == f"{want:.2f}"
        assert "ts-24" in out and "waste waterfall (GPU-seconds" in out

    def test_watch_renders_frames(self, tmp_path, capsys):
        from types import SimpleNamespace

        from nos_tpu_torch.obs.__main__ import _watch_top

        path = tmp_path / "snap.json"
        path.write_text(json.dumps({"state": self._state()}))
        sleeps: list[float] = []
        args = SimpleNamespace(snapshot=str(path), url="", watch=2.5,
                               frames=2)
        assert _watch_top(args, "/snapshot", sleep=sleeps.append) == 0
        out = capsys.readouterr().out
        assert out.count("\x1b[2J") == 2 and sleeps == [2.5]
