"""The port's chaos substrate (nos_tpu_torch/testing/chaos.py) against the
JAX package's ``ChaosAPIServer``, and a seeded chaos soak of the port's
MPS loop: the partitioner controller, the chip agents and the test
binder over 2 to 4 nodes, with conflicts, transient write errors and
dropped watch events injected on every update and patch.  Each soak run
must converge, with every pod bound and Running and every node's status
plan id equal to its spec plan id, and no exception may escape a tick.
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import nos_tpu.kube.objects as jax_objects
from nos_tpu.testing.chaos import ChaosAPIServer as JaxChaosAPIServer

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.controllers.chipagent import ChipAgent
from nos_tpu_torch.controllers.node_controller import NodeController
from nos_tpu_torch.controllers.pod_controller import PodController
from nos_tpu_torch.kube import objects
from nos_tpu_torch.kube.client import KIND_NODE, KIND_POD
from nos_tpu_torch.kube.objects import RUNNING
from nos_tpu_torch.partitioning.state import ClusterState
from nos_tpu_torch.partitioning.timeshare import (
    new_timeshare_partitioner_controller,
)
from nos_tpu_torch.scheduler.framework import Framework
from nos_tpu_torch.testing import factory
from nos_tpu_torch.testing.bind import bind_pending
from nos_tpu_torch.testing.chaos import ChaosAPIServer
from nos_tpu_torch.topology.annotations import spec_plan_id, status_plan_id
from nos_tpu_torch.utils import retry

BATCH_TIMEOUT_S = 60.0
RATES = {"conflict_rate": 0.15, "transient_rate": 0.10,
         "drop_watch_rate": 0.10}


@pytest.fixture(autouse=True)
def fast_retry(monkeypatch):
    """Injected faults retry at once: the soak exercises the retry
    logic, not its backoff sleeps."""
    monkeypatch.setattr(retry, "sleep", lambda s: None)


# ---------------------------------------------------------------------------
# The same seed draws the same faults
# ---------------------------------------------------------------------------


def _fault_log(api, mod) -> dict:
    """A fixed sequence of creates, patches, updates and deletes over
    ConfigMaps, with two watchers; each operation's outcome, each
    watcher's deliveries, and the substrate's stats."""
    outcomes, seen = [], {0: [], 1: []}
    for i in (0, 1):
        api.watch("ConfigMap", lambda ev, cm, i=i: seen[i].append(
            (ev, cm.metadata.name, dict(cm.data))))
    for step in range(120):
        name = f"cm-{step % 5}"
        op = ("create", "patch", "patch", "update", "patch", "delete")[
            step % 6]
        try:
            if op == "create":
                api.create("ConfigMap", mod.ConfigMap(
                    metadata=mod.ObjectMeta(name=name, namespace="ns")))
            elif op == "patch":
                api.patch("ConfigMap", name, "ns", mutate=lambda cm, s=step:
                          cm.data.__setitem__("k", str(s)))
            elif op == "update":
                cm = api.get("ConfigMap", name, "ns")
                cm.data["u"] = str(step)
                api.update("ConfigMap", cm)
            else:
                api.delete("ConfigMap", name, "ns")
            outcomes.append("ok")
        except Exception as e:  # noqa: BLE001 — the outcome is compared
            outcomes.append(type(e).__name__)
        if step % 17 == 0:
            api.replay_dropped()
    return {"outcomes": outcomes, "seen": seen, "stats": dict(api.stats)}


class TestSameFaults:
    @pytest.mark.parametrize("seed", range(4))
    def test_same_seed_same_faults_as_jax(self, seed):
        got = _fault_log(ChaosAPIServer(seed, **RATES), objects)
        want = _fault_log(JaxChaosAPIServer(seed, **RATES), jax_objects)
        assert got == want
        assert got["stats"]["conflicts"] and got["stats"]["transients"] \
            and got["stats"]["drops"]

    def test_replay_mid_delivery_is_deferred(self):
        api = ChaosAPIServer(0, drop_watch_rate=1.0, replay_after_ops=1000)
        seen = []
        api.watch(KIND_NODE, lambda ev, obj: seen.append(ev))
        api.create(KIND_NODE, factory.make_gpu_node("h0"))   # dropped
        assert api._dropped and not seen
        api._delivering = True           # a delivery in progress
        api.replay_dropped()
        assert api._dropped and not seen
        api._delivering = False
        api.replay_dropped()
        assert not api._dropped and seen == ["MODIFIED"]


# ---------------------------------------------------------------------------
# The soak
# ---------------------------------------------------------------------------


def run_mps_soak(seed: int, nodes: int, shares: tuple[int, ...],
                 max_rounds: int = 60) -> SimpleNamespace:
    """One seeded chaos run of the MPS loop, on one thread under an
    injected clock: deterministic per seed."""
    api = ChaosAPIServer(seed, **RATES, replay_after_ops=5)
    state = ClusterState()
    clock = [0.0]
    errors: list[str] = []
    round_no = -1

    def tick(name, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the failure hunted
            errors.append(f"seed={seed} round={round_no} {name}: {e!r}")

    NodeController(api, state).bind()
    PodController(api, state).bind()
    partitioner = new_timeshare_partitioner_controller(
        api, state, batch_timeout_s=BATCH_TIMEOUT_S, batch_idle_s=10.0,
        clock=lambda: clock[0])
    partitioner.bind()
    agents = []
    for i in range(nodes):
        api.create(KIND_NODE, factory.make_gpu_node(f"gpu-{i}", gpus=2))
        agent = ChipAgent(api, f"gpu-{i}")
        tick(f"agent-{i}-start", agent.start)
        agents.append(agent)
    framework = Framework()
    for i, gb in enumerate(shares):
        api.create(KIND_POD, factory.make_timeshare_pod(gb, name=f"soak-{i}"))

    def converged() -> bool:
        if any(not p.spec.node_name or p.status.phase != RUNNING
               for p in api.list(KIND_POD)):
            return False
        return all(
            status_plan_id(n.metadata.annotations, family=C.MPS_KIND)
            == spec_plan_id(n.metadata.annotations, family=C.MPS_KIND)
            for n in api.list(KIND_NODE))

    done = False
    for round_no in range(max_rounds):
        clock[0] += BATCH_TIMEOUT_S + 1.0
        tick("bind", lambda: bind_pending(api, framework))
        tick("partitioner", partitioner.process_if_ready)
        for i, agent in enumerate(agents):
            tick(f"agent-{i}", agent.tick)
        api.replay_dropped()             # the round's reconnect
        if converged():
            done = True
            break
    return SimpleNamespace(api=api, errors=errors, converged=done,
                           rounds=round_no + 1,
                           quarantined=partitioner.quarantine.names())


class TestSoak:
    @pytest.mark.parametrize("seed,nodes,shares", [
        (0, 2, (24, 24, 24, 40)),
        (1, 2, (10, 10, 20, 40, 80)),
        (2, 3, (24, 24, 24, 24, 40, 8)),
        (3, 3, (80, 80, 40, 40, 10)),
        (4, 4, (24, 40, 10, 20, 8, 8, 80)),
        (5, 4, (24, 24, 24, 24, 24, 24, 24, 24)),
    ])
    def test_soak_converges(self, seed, nodes, shares):
        result = run_mps_soak(seed, nodes, shares)
        assert not result.errors, result.errors[:3]
        assert result.converged, (
            f"seed {seed}: not converged in {result.rounds} rounds "
            f"(stats {result.api.stats}, quarantined {result.quarantined})")
        stats = result.api.stats
        # the run was chaotic, not a lucky walk without faults
        assert stats["conflicts"] + stats["transients"] + stats["drops"] > 0

    def test_same_seed_same_run(self):
        a = run_mps_soak(7, 2, (24, 24, 40))
        b = run_mps_soak(7, 2, (24, 24, 40))
        assert (a.api.stats, a.rounds) == (b.api.stats, b.rounds)
