"""The port's capacity plane (``nos_tpu_torch/capacity``, ``ProvisionerConfig``,
``ChaosCloudGPUAPI``, ``build_provisioner_main``) against the JAX
package's, on the same seeded inputs, compared exactly.

Each case of ``tests/test_capacity.py`` is a story written once and run
on both packages through a ``Side``: the same clock, the same pools,
zones, names and seeds.  A JAX ``tpu-v5e`` host (8 chips, two free 2x2)
is an 8-GPU H100 node in MIG mode whose GPUs each hold a free 7g.80gb;
a JAX pod of one 2x2 (4 chips) asks for four 7g.80gb (4 GPUs), one 2x4
for eight.  Pools keep the JAX names ("pod-0" is an NVLink domain on the
port).  After each story the journal, the provisioner's report and
counters, the cloud's operations and nodes and the nodes' labels are
compared with the JAX machine class (``tpu-v5e`` <->
``nvidia-h100-80gb-hbm3``), label keys and resource names mapped.  Both
schedulers score with their window terms (the aligned block windows of
a domain's MIG nodes, the JAX package's multi-host windows).

Then the capacity fleets (``testing/fleet.py``: bench_capacity.py's
swing, storm and quiescent runs on H100 nodes) against a JAX
``bench_capacity.Sim`` on the same seed, to the digests that
``chip_smoke.py`` pins, with seed 0's figures and the gates, and the
quiescent armed run's journal byte-identical to the plane-off run's.
"""

from __future__ import annotations

import json
import random
from types import SimpleNamespace

import pytest

import bench_capacity as jax_bench
import nos_tpu.api.constants as JC
import nos_tpu.capacity as jax_cap
import nos_tpu.capacity.cloudapi as jax_cloudapi
import nos_tpu.obs as jax_obs
import nos_tpu.obs.journal as jax_journal
import nos_tpu.obs.ledger as jax_ledger
import nos_tpu.testing.chaos as jax_chaos
import nos_tpu.testing.factory as jax_factory
import nos_tpu.testing.lockcheck as jax_lockcheck
import nos_tpu.utils.retry as jax_retry
from nos_tpu.api.config import ConfigError as JaxConfigError
from nos_tpu.api.config import ProvisionerConfig as JaxProvisionerConfig
from nos_tpu.cmd.assembly import build_provisioner_main as jax_build_main
from nos_tpu.cmd.assembly import build_scheduler as jax_build_scheduler
from nos_tpu.kube.client import APIServer as JaxAPIServer
from nos_tpu.scheduler import scheduler as jax_scheduler

import chip_smoke
import nos_tpu_torch.capacity as cap
import nos_tpu_torch.capacity.cloudapi as cloudapi
import nos_tpu_torch.obs as obs
import nos_tpu_torch.obs.journal as journal
import nos_tpu_torch.obs.ledger as ledger
import nos_tpu_torch.testing.chaos as chaos
import nos_tpu_torch.testing.factory as factory
import nos_tpu_torch.testing.lockcheck as lockcheck
import nos_tpu_torch.utils.retry as retry
from nos_tpu_torch.api import constants as C
from nos_tpu_torch.api.config import ConfigError, ProvisionerConfig
from nos_tpu_torch.cmd.assembly import build_provisioner_main, build_scheduler
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.scheduler.scheduler import attribute_free_chips
from nos_tpu_torch.testing import fleet
from nos_tpu_torch.topology.known import H100_80GB

MC = {"jax": "tpu-v5e", "port": H100_80GB.name}
# JAX strings in the port's names, longest first
MAPPED = (
    ("nos.tpu/slice-2x4", "nvidia.com/mig-7g.80gb"),
    ("nos.tpu/slice-2x2", "nvidia.com/mig-7g.80gb"),
    ("slice-2x4", "slice-7g.80gb"),
    ("slice-2x2", "slice-7g.80gb"),
    ("tpu-v5e", H100_80GB.name),
    (JC.LABEL_POD_ID, C.LABEL_NVLINK_DOMAIN),
    (JC.LABEL_CHIP_COUNT, C.LABEL_GPU_COUNT),
    (JC.GROUP + "/", C.GROUP + "/"),
)


def mapped(value):
    """A JAX value (string, or a structure of them) in the port's names."""
    if isinstance(value, str):
        for jax, port in MAPPED:
            value = value.replace(jax, port)
        return value
    if isinstance(value, dict):
        return {mapped(k): mapped(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [mapped(v) for v in value]
    return value


@pytest.fixture(autouse=True)
def fast_retry(monkeypatch):
    """Cloud 429s and conflicts retry at once on both sides."""
    monkeypatch.setattr(jax_retry, "sleep", lambda s: None)
    monkeypatch.setattr(retry, "sleep", lambda s: None)


class Side:
    """One package's rig, the JAX test's ``Harness``: an API server, a
    cloud with the join wired, a journal and a ledger on one virtual
    clock, and a provisioner.  ``name`` is "jax" or "port"."""

    def __init__(self, name: str) -> None:
        self.name = name
        jax = name == "jax"
        self.jax = jax
        self.C = JC if jax else C
        self.J = jax_journal if jax else journal
        self.L = jax_ledger if jax else ledger
        self.cap = jax_cap if jax else cap
        self.cloudapi = jax_cloudapi if jax else cloudapi
        self.MC = MC[name]
        self.POOL = JC.LABEL_POD_ID if jax else C.LABEL_NVLINK_DOMAIN
        self.clock = [0.0]
        self.now = lambda: self.clock[0]
        self.api = self.new_api()
        self.journal = self.J.DecisionJournal(maxlen=8192, clock=self.now)
        self.ledger = self.L.ChipSecondLedger(clock=self.now)
        self.cloud = None
        self.prov = None

    # -- construction -------------------------------------------------------
    def new_api(self):
        return JaxAPIServer() if self.jax else APIServer()

    def chaos_api(self, seed: int, **kw):
        mod = jax_chaos if self.jax else chaos
        return mod.ChaosAPIServer(seed, **kw)

    def plain_cloud(self, **kw):
        kw.setdefault("clock", self.now)
        return (jax_cap.CloudTPUAPI if self.jax else cap.CloudGPUAPI)(**kw)

    def chaos_cloud(self, seed: int, **kw):
        kw.setdefault("clock", self.now)
        cls = (jax_chaos.ChaosCloudTPUAPI if self.jax
               else chaos.ChaosCloudGPUAPI)
        return cls(seed, **kw)

    def wire(self, cloud=None, provision_delay_s: float = 5.0,
             **prov_kw) -> "Side":
        self.cloud = cloud if cloud is not None else self.plain_cloud(
            provision_delay_s=provision_delay_s)
        self.cloud.set_joiner(self.joiner(self.api))
        self.prov = self.new_prov(**prov_kw)
        return self

    def new_prov(self, api=None, cloud=None, **kw):
        return self.cap.CapacityProvisioner(
            api if api is not None else self.api,
            cloud if cloud is not None else self.cloud,
            clock=self.now, **kw)

    def scheduler(self, api=None):
        api = api if api is not None else self.api
        if self.jax:
            return jax_build_scheduler(api, 16, clock=self.now)
        return build_scheduler(api, clock=self.now)

    # -- objects --------------------------------------------------------------
    def node(self, name: str, pool: str, idx: int, extra: dict):
        if self.jax:
            return jax_factory.make_tpu_node(
                name, pod_id=pool, host_index=idx,
                status_geometry={"free": {"2x2": 2}}, extra_labels=extra)
        return factory.make_gpu_node(
            name, gpus=8, partitioning=C.MIG_KIND,
            status_geometry={g: {"free": {"7g.80gb": 1}} for g in range(8)},
            domain=pool, host_index=idx, extra_labels=extra)

    def joiner(self, api):
        """The JAX test's ``make_joiner``: a landed cloud node becomes a
        Node with the create's labels and free geometry reported."""
        def join(cloud_node):
            labels = dict(cloud_node.labels)
            pool = labels.pop(self.POOL, "pod-0")
            idx = int(labels.pop(self.C.LABEL_HOST_INDEX, "0"))
            for managed in (self.C.LABEL_ACCELERATOR,
                            self.C.LABEL_PARTITIONING,
                            JC.LABEL_CHIP_COUNT if self.jax
                            else C.LABEL_GPU_COUNT):
                labels.pop(managed, None)
            api.create("Node", self.node(cloud_node.name, pool, idx, labels))
        return join

    def add_host(self, pool: str, idx: int, zone: str = "-",
                 spare: bool = False, park: int | None = None,
                 api=None) -> str:
        extra = {self.C.LABEL_ZONE: zone}
        if spare:
            extra[self.C.LABEL_SPARE] = self.C.SPARE_WARM
        name = f"{pool}-h{idx}" if not spare else f"{pool}-sp{idx}"
        (api if api is not None else self.api).create("Node", self.node(
            name, pool, park if park is not None else idx, extra))
        return name

    def pod(self, chips: int, **kw):
        """A pod of ``chips`` chips (JAX: one 2x2 or 2x4 slice) or GPUs
        (the port: that many 7g.80gb)."""
        if self.jax:
            return jax_factory.make_slice_pod(
                {4: "2x2", 8: "2x4"}[chips], 1, **kw)
        return factory.make_mig_pod("7g.80gb", chips, **kw)

    def add_pods(self, n: int, chips: int = 4, prefix: str = "p",
                 api=None) -> None:
        for i in range(n):
            (api if api is not None else self.api).create(
                "Pod", self.pod(chips, name=f"{prefix}{i}"))

    def admit_all(self, api) -> int:
        return (jax_factory.admit_all if self.jax else factory.admit_all)(api)

    # -- reading --------------------------------------------------------------
    def scoped(self, journal_=None, ledger_=None):
        mod = jax_obs if self.jax else obs
        return mod.scoped(journal=journal_ or self.journal,
                          ledger=ledger_ or self.ledger)

    def events(self, category, journal_=None):
        return (journal_ or self.journal).events(category)

    def pump(self, until: float, step: float = 1.0) -> None:
        while self.clock[0] < until:
            self.clock[0] = min(until, self.clock[0] + step)
            self.prov.reconcile()

    def records(self, journal_=None) -> list:
        out = [[r.category, r.subject, dict(sorted(r.attrs.items()))]
               for r in (journal_ or self.journal).events()]
        return mapped(out) if self.jax else out

    def snapshot(self) -> dict:
        """What the story left, in the port's names."""
        nodes = {n.metadata.name: dict(sorted(
            (k, v) for k, v in n.metadata.labels.items()
            if k in (self.POOL, self.C.LABEL_HOST_INDEX,
                     self.C.LABEL_SPARE, self.C.LABEL_ZONE)))
            | {"drain": n.metadata.annotations.get(
                self.C.ANNOT_DEFRAG_DRAIN, "")}
            for n in self.api.list("Node")}
        out = {"journal": self.records(), "nodes": nodes,
               "holds": {k: sorted(v) for k, v in
                         sorted(self.ledger.holds().items())}}
        if self.cloud is not None:
            out["ops"] = self.cloud.list_operations()
            out["cloud_nodes"] = self.cloud.list_nodes()
        if self.prov is not None:
            out["report"] = self.prov.report()
        return mapped(out) if self.jax else out


def both(story) -> dict:
    """``story(side)`` on each package; each side's snapshot after it and
    what the story returned, both in the port's names."""
    out = {}
    for name in ("jax", "port"):
        side = Side(name)
        got = story(side)
        out[name] = {"snapshot": side.snapshot(),
                     "returned": mapped(got) if side.jax else got}
    return out


def same(story):
    out = both(story)
    assert json.dumps(out["jax"]["returned"], sort_keys=True) \
        == json.dumps(out["port"]["returned"], sort_keys=True)
    assert json.dumps(out["jax"]["snapshot"], sort_keys=True) \
        == json.dumps(out["port"]["snapshot"], sort_keys=True)
    return out["port"]["returned"]


# ---------------------------------------------------------------------------
# The cloud API contract
# ---------------------------------------------------------------------------


def cloud_create_lands_async_and_joins(h):
    h.wire(provision_delay_s=10.0)
    op = h.cloud.create_node("pod-0-h2", h.MC, "us-a",
                             {h.POOL: "pod-0", h.C.LABEL_HOST_INDEX: "2"})
    assert h.cloud.get_operation(op)["status"] == h.cloudapi.OP_PENDING
    assert h.api.try_get("Node", "pod-0-h2") is None
    h.clock[0] = 11.0
    assert h.cloud.get_operation(op)["status"] == h.cloudapi.OP_DONE
    node = h.api.try_get("Node", "pod-0-h2")
    assert node.metadata.labels[h.C.LABEL_HOST_INDEX] == "2"
    return [n["name"] for n in h.cloud.list_nodes()]


def cloud_duplicate_create_is_already_exists(h):
    h.wire()
    h.cloud.create_node("n1", h.MC)
    with pytest.raises(h.cap.AlreadyExistsError):
        h.cloud.create_node("n1", h.MC)
    h.clock[0] = 6.0
    h.cloud.list_nodes()
    with pytest.raises(h.cap.AlreadyExistsError):
        h.cloud.create_node("n1", h.MC)


def cloud_delete_cancels_pending_create(h):
    h.wire()
    op = h.cloud.create_node("n1", h.MC)
    h.cloud.delete_node("n1")
    assert h.cloud.get_operation(op)["status"] == "FAILED"
    h.clock[0] = 60.0
    assert h.cloud.list_nodes() == []
    with pytest.raises(h.cap.CloudNotFoundError):
        h.cloud.delete_node("n1")


def cloud_ack_gc_and_quota(h):
    h.cloud = h.plain_cloud(provision_delay_s=1.0, quota_nodes=1)
    h.cloud.create_node("n1", h.MC)
    with pytest.raises(h.cap.QuotaExceededError):
        h.cloud.create_node("n2", h.MC)
    h.clock[0] = 2.0
    ops = h.cloud.list_operations()
    assert len(ops) == 1 and ops[0]["status"] == h.cloudapi.OP_DONE
    h.cloud.ack_operation(str(ops[0]["op_id"]))
    assert h.cloud.list_operations() == []


def cloud_chaos_zombie_never_joins(h):
    h.cloud = h.chaos_cloud(7, zombie_rate=1.0, provision_delay_s=1.0)
    h.cloud.set_joiner(h.joiner(h.api))
    h.cloud.create_node("z1", h.MC)
    h.clock[0] = 5.0
    assert [n["name"] for n in h.cloud.list_nodes()] == ["z1"]
    assert h.api.try_get("Node", "z1") is None
    return h.cloud.cloud_stats


def cloud_chaos_stockout_window_is_a_state(h):
    h.cloud = h.chaos_cloud(1, stockout_window_s=30.0)
    h.cloud.inject_stockout(h.MC, "us-a")
    for _ in range(3):
        with pytest.raises(h.cap.StockoutError):
            h.cloud.create_node("x", h.MC, "us-a")
    h.cloud.create_node("y", h.MC, "us-b")
    h.clock[0] = 31.0
    h.cloud.create_node("x", h.MC, "us-a")
    return h.cloud.cloud_stats


# ---------------------------------------------------------------------------
# The stockout breaker
# ---------------------------------------------------------------------------


def breaker_threshold_opens_and_half_open_probe(h):
    b = h.cap.StockoutBreaker(threshold=3, open_s=60.0, clock=h.now)
    key, seen = (h.MC, "us-a"), []
    seen += [b.record_stockout(key), b.record_stockout(key), b.state(key),
             b.allow(key), b.record_stockout(key), b.state(key),
             b.allow(key)]
    h.clock[0] = 61.0
    seen += [b.state(key), b.allow(key), b.allow(key),
             b.record_stockout(key), b.allow(key)]
    h.clock[0] = 122.0
    seen += [b.allow(key), b.record_success(key), b.state(key),
             b.allow(key), b.open_count()]
    assert seen == [None, None, "closed", True, "open", "open", False,
                    "half-open", True, False, "open", False, True,
                    "closed", "closed", True, 0]
    return seen


def breaker_keys_are_independent(h):
    b = h.cap.StockoutBreaker(threshold=1, open_s=10.0, clock=lambda: 0.0)
    seen = [b.record_stockout((h.MC, "us-a")), b.allow((h.MC, "us-a")),
            b.allow((h.MC, "us-b")), b.allow(("other", "us-a"))]
    assert seen == ["open", False, True, True] and b.open_count() == 1
    return seen, b.snapshot()


def breaker_success_resets_streak(h):
    b = h.cap.StockoutBreaker(threshold=2, open_s=10.0, clock=lambda: 0.0)
    key = (h.MC, "-")
    seen = [b.record_stockout(key), b.record_success(key),
            b.record_stockout(key), b.record_stockout(key)]
    assert seen == [None, None, None, "open"]
    return seen


# ---------------------------------------------------------------------------
# The provisioner's reconcile
# ---------------------------------------------------------------------------


def scale_up_sustained_deficit_provisions_and_lands(h):
    h.wire(scale_up_after_s=3.0, scale_up_cooldown_s=1.0,
           vacancy_grace_s=1.0)
    h.add_host("pod-0", 0, zone="us-a")
    h.add_host("pod-0", 1, zone="us-a")
    h.add_pods(7)           # 28 chips of demand against 16 free
    with h.scoped():
        h.prov.reconcile()
        assert h.events(h.J.PROVISION_REQUESTED) == []
        h.pump(4.0)
        name = h.events(h.J.PROVISION_REQUESTED)[0].subject
        assert h.L.PROVISIONING in h.ledger.holds()[name]
        h.pump(12.0)
        assert [r.subject for r in h.events(h.J.PROVISION_LANDED)][:1] \
            == [name]
        assert name not in h.ledger.holds()
    report = h.prov.report()
    assert report["counters"]["landed"] >= 1
    assert report["pools"]["pod-0"]["recorded_size"] >= 3


def scale_up_no_demand_no_action(h):
    h.wire()
    h.add_host("pod-0", 0)
    with h.scoped():
        h.pump(30.0)
    assert h.cloud.list_operations() == [] and h.journal.events() == []
    assert h.prov.report()["deficit_chips"] <= 0.0


def scale_up_arriving_capacity_damps_further_creates(h):
    h.wire(scale_up_after_s=1.0, scale_up_cooldown_s=0.0,
           provision_delay_s=100.0, max_pending_creates=8)
    h.add_host("pod-0", 0)
    h.add_pods(4)
    with h.scoped():
        h.pump(10.0)
    assert len(h.cloud.list_operations()) == 1


def scale_up_restart_is_idempotent(h):
    h.wire(scale_up_after_s=1.0, scale_up_cooldown_s=0.0,
           provision_delay_s=100.0)
    h.add_host("pod-0", 0)
    h.add_pods(4)
    with h.scoped():
        h.pump(5.0)
        assert len(h.cloud.list_operations()) == 1
        fresh = h.new_prov(scale_up_after_s=1.0, scale_up_cooldown_s=0.0)
        for _ in range(6):
            h.clock[0] += 1.0
            fresh.reconcile()
    assert len(h.cloud.list_operations()) == 1
    cm = h.api.try_get("ConfigMap", "nos-tpu-capacity-inventory",
                       "nos-tpu-system")
    assert '"pod-0": 2' in cm.data["pools"]
    return cm.data


def vacancy_dead_top_index_closed_from_durable_record(h):
    """The regression: the top-index node dies while no controller
    watches; the durable record sees what observation cannot."""
    h.wire(vacancy_grace_s=2.0)
    for i in range(3):
        h.add_host("pod-0", i)
    spare = h.add_host("pod-0", 0, spare=True, park=100)
    with h.scoped():
        h.prov.reconcile()
    h.api.delete("Node", "pod-0-h2")
    fresh = h.new_prov(vacancy_grace_s=2.0)
    with h.scoped():
        h.clock[0] += 1.0
        fresh.reconcile()
        assert h.C.LABEL_SPARE in h.api.get("Node", spare).metadata.labels
        h.clock[0] += 3.0
        fresh.reconcile()
    node = h.api.get("Node", spare)
    assert h.C.LABEL_SPARE not in node.metadata.labels
    assert node.metadata.labels[h.C.LABEL_HOST_INDEX] == "2"
    assert [r.subject for r in h.events(h.J.SPARE_PROMOTED)] == [spare]


def vacancy_without_spare_provisions(h):
    h.wire(vacancy_grace_s=1.0, provision_delay_s=2.0)
    for i in range(2):
        h.add_host("pod-0", i, zone="us-a")
    with h.scoped():
        h.prov.reconcile()
        h.api.delete("Node", "pod-0-h1")
        h.pump(10.0)
    assert h.api.try_get("Node", "pod-0-h1") is not None
    assert h.events(h.J.PROVISION_LANDED)


def _stockout_rig(h, **kw):
    h.wire(cloud=h.chaos_cloud(3, provision_delay_s=5.0),
           scale_up_after_s=1.0, scale_up_cooldown_s=0.0,
           breaker_threshold=2, breaker_open_s=50.0, **kw)


def stockout_breaker_opens_then_borrowing_covers(h):
    _stockout_rig(h)
    h.add_host("pod-0", 0, zone="us-a")
    h.add_host("pod-1", 0, zone="us-b")
    h.add_host("pod-1", 1, zone="us-b")
    borrowable = h.add_host("pod-1", 0, spare=True, park=100)
    h.cloud.inject_stockout(h.MC, "us-a", duration_s=1000.0)
    h.add_pods(12)
    with h.scoped():
        h.pump(8.0)
    assert any(r.attrs.get("state") == "open"
               for r in h.events(h.J.PROVISION_STOCKOUT))
    assert h.prov.breaker.state((h.MC, "us-a")) == "open"
    assert [r.subject for r in h.events(h.J.SPARE_BORROWED)] == [borrowable]
    node = h.api.get("Node", borrowable)
    assert node.metadata.labels[h.POOL] == "pod-0"
    assert h.C.LABEL_SPARE not in node.metadata.labels
    assert h.prov.report()["counters"]["borrows"] == 1


def stockout_half_open_probe_recloses_after_recovery(h):
    _stockout_rig(h)
    h.add_host("pod-0", 0, zone="us-a")
    h.cloud.inject_stockout(h.MC, "us-a", duration_s=20.0)
    h.add_pods(6)
    with h.scoped():
        h.pump(8.0)
        assert h.prov.breaker.state((h.MC, "us-a")) == "open"
        h.pump(80.0)
    assert h.prov.breaker.state((h.MC, "us-a")) == "closed"
    assert "closed" in [r.attrs.get("state")
                        for r in h.events(h.J.PROVISION_STOCKOUT)]


def zombie_reaped_after_deadline(h):
    h.wire(cloud=h.chaos_cloud(5, zombie_rate=1.0, provision_delay_s=2.0),
           scale_up_after_s=1.0, scale_up_cooldown_s=0.0,
           provision_deadline_s=10.0)
    h.add_host("pod-0", 0)
    h.add_pods(4)
    with h.scoped():
        h.pump(5.0)
        name = h.events(h.J.PROVISION_REQUESTED)[0].subject
        assert h.L.PROVISIONING in h.ledger.holds().get(name, {})
        h.pump(30.0)
    assert any(r.attrs.get("reason") == "zombie"
               for r in h.events(h.J.PROVISION_FAILED))
    assert name not in h.ledger.holds()
    assert name not in [n["name"] for n in h.cloud.list_nodes()]
    assert not [op for op in h.cloud.list_operations()
                if op["status"] != h.cloudapi.OP_PENDING]


def zombie_stuck_pending_create_cancelled_at_deadline(h):
    h.wire(cloud=h.chaos_cloud(5, slow_rate=1.0, slow_extra_s=500.0,
                               provision_delay_s=2.0),
           scale_up_after_s=1.0, scale_up_cooldown_s=1000.0,
           provision_deadline_s=10.0)
    h.add_host("pod-0", 0)
    h.add_pods(4)
    with h.scoped():
        h.pump(30.0)
    assert any(r.attrs.get("reason") in ("deadline", "cancelled")
               for r in h.events(h.J.PROVISION_FAILED))


def _scale_down_rig(h):
    h.wire(scale_down_idle_s=5.0, scale_down_cooldown_s=0.0,
           min_hosts_per_pool=1)
    h.add_host("pod-0", 0)
    h.add_host("pod-0", 1)


def _resident(h, name="r0"):
    h.api.create("Pod", h.pod(4, name=name, node_name="pod-0-h1",
                              phase="Running"))


def scale_down_never_deletes_host_with_residents(h):
    _scale_down_rig(h)
    _resident(h)
    with h.scoped():
        h.pump(60.0)
    assert h.api.try_get("Node", "pod-0-h1") is not None


def scale_down_never_deletes_held_host(h):
    _scale_down_rig(h)
    with h.scoped():
        h.ledger.set_hold("pod-0-h1", h.L.DRAIN, owner="t", gang="g1")
        h.pump(60.0)
    assert h.api.try_get("Node", "pod-0-h1") is not None
    assert h.events(h.J.SCALE_DOWN) == []


def scale_down_never_deletes_while_demand_needs_the_host(h):
    _scale_down_rig(h)
    h.add_pods(2, chips=8, prefix="q")
    with h.scoped():
        h.pump(60.0)
    assert h.api.try_get("Node", "pod-0-h1") is not None
    assert h.events(h.J.SCALE_DOWN) == []


def scale_down_absorbable_pending_demand_does_not_block_release(h):
    _scale_down_rig(h)
    h.add_pods(1, prefix="q")
    with h.scoped():
        h.pump(60.0)
    assert h.api.try_get("Node", "pod-0-h1") is None
    assert [r.subject for r in h.events(h.J.SCALE_DOWN)] == ["pod-0-h1"]


def scale_down_busy_candidate_is_cordoned_then_released(h):
    _scale_down_rig(h)
    _resident(h)
    with h.scoped():
        h.pump(30.0)
        node = h.api.get("Node", "pod-0-h1")
        assert node.metadata.annotations.get(h.C.ANNOT_DEFRAG_DRAIN) \
            == h.C.migration_drain_value("capacity", "scale-down")
        assert h.prov.report()["counters"]["cordons"] == 1
        h.api.delete("Pod", "r0", "default")
        h.pump(60.0)
    assert h.api.try_get("Node", "pod-0-h1") is None
    assert [r.subject for r in h.events(h.J.SCALE_DOWN)] == ["pod-0-h1"]


def scale_down_cordon_retracted_when_demand_returns(h):
    _scale_down_rig(h)
    _resident(h)
    with h.scoped():
        h.pump(30.0)
        assert h.C.ANNOT_DEFRAG_DRAIN in h.api.get(
            "Node", "pod-0-h1").metadata.annotations
        h.add_pods(3, prefix="q")
        h.pump(40.0)
    assert h.C.ANNOT_DEFRAG_DRAIN not in h.api.get(
        "Node", "pod-0-h1").metadata.annotations
    assert h.events(h.J.SCALE_DOWN) == []


def scale_down_cordon_never_touches_foreign_drains(h):
    _scale_down_rig(h)
    foreign = h.C.migration_drain_value("defrag", "plan-7")
    h.api.patch("Node", "pod-0-h1", mutate=lambda n: n.metadata
                .annotations.__setitem__(h.C.ANNOT_DEFRAG_DRAIN, foreign))
    _resident(h)
    with h.scoped():
        h.pump(30.0)
    assert h.api.get("Node", "pod-0-h1").metadata.annotations[
        h.C.ANNOT_DEFRAG_DRAIN] == foreign
    assert h.prov.report()["counters"]["cordons"] == 0


def scale_down_sustained_surplus_releases_top_index_only(h):
    _scale_down_rig(h)
    with h.scoped():
        h.pump(60.0)
    assert h.api.try_get("Node", "pod-0-h1") is None
    assert h.api.try_get("Node", "pod-0-h0") is not None
    assert [r.subject for r in h.events(h.J.SCALE_DOWN)] == ["pod-0-h1"]
    cm = h.api.try_get("ConfigMap", "nos-tpu-capacity-inventory",
                       "nos-tpu-system")
    assert '"pod-0": 1' in cm.data["pools"]


def _spares(h) -> list[str]:
    return sorted(n.metadata.name for n in h.api.list("Node")
                  if h.C.LABEL_SPARE in n.metadata.labels)


def spare_dead_spare_is_replaced(h):
    h.wire(spare_target_per_pool=1, provision_delay_s=2.0,
           provision_deadline_s=6.0, join_grace_s=1.0)
    h.add_host("pod-0", 0)
    with h.scoped():
        h.pump(10.0)
    first = _spares(h)
    assert len(first) == 1
    with h.scoped():
        h.api.delete("Node", first[0])
        h.pump(20.0)
    assert len(_spares(h)) == 1
    return first, _spares(h)


def spare_quarantined_spare_not_counted_healthy(h):
    h.wire(spare_target_per_pool=1, provision_delay_s=2.0)
    h.add_host("pod-0", 0)
    sick = h.add_host("pod-0", 0, spare=True, park=100)
    with h.scoped():
        h.ledger.set_hold(sick, h.L.QUARANTINE, owner="t",
                          reason="plan-deadline")
        h.pump(10.0)
    assert len(_spares(h)) == 2
    return _spares(h)


def waste_conservation_holds_with_provisioning(h):
    h.wire(scale_up_after_s=1.0, scale_up_cooldown_s=0.0,
           provision_delay_s=50.0)
    h.add_host("pod-0", 0)
    h.add_pods(4)
    sched = h.scheduler()
    with h.scoped():
        for _ in range(6):
            h.clock[0] += 2.0
            sched.run_cycle()
            h.prov.reconcile()
        report = h.ledger.report()
    assert h.L.conservation_ok(report)
    assert h.events(h.J.PROVISION_REQUESTED)
    return report["fleet"]["chip_seconds"]


STORIES = [
    cloud_create_lands_async_and_joins,
    cloud_duplicate_create_is_already_exists,
    cloud_delete_cancels_pending_create,
    cloud_ack_gc_and_quota,
    cloud_chaos_zombie_never_joins,
    cloud_chaos_stockout_window_is_a_state,
    breaker_threshold_opens_and_half_open_probe,
    breaker_keys_are_independent,
    breaker_success_resets_streak,
    scale_up_sustained_deficit_provisions_and_lands,
    scale_up_no_demand_no_action,
    scale_up_arriving_capacity_damps_further_creates,
    scale_up_restart_is_idempotent,
    vacancy_dead_top_index_closed_from_durable_record,
    vacancy_without_spare_provisions,
    stockout_breaker_opens_then_borrowing_covers,
    stockout_half_open_probe_recloses_after_recovery,
    zombie_reaped_after_deadline,
    zombie_stuck_pending_create_cancelled_at_deadline,
    scale_down_never_deletes_host_with_residents,
    scale_down_never_deletes_held_host,
    scale_down_never_deletes_while_demand_needs_the_host,
    scale_down_absorbable_pending_demand_does_not_block_release,
    scale_down_busy_candidate_is_cordoned_then_released,
    scale_down_cordon_retracted_when_demand_returns,
    scale_down_cordon_never_touches_foreign_drains,
    scale_down_sustained_surplus_releases_top_index_only,
    spare_dead_spare_is_replaced,
    spare_quarantined_spare_not_counted_healthy,
    waste_conservation_holds_with_provisioning,
]


@pytest.mark.parametrize("story", STORIES, ids=lambda s: s.__name__)
def test_story_decides_as_the_jax_package(story):
    same(story)


def test_provisioning_hold_is_not_idle_no_demand():
    jax = jax_scheduler.attribute_free_chips(
        4.0, {jax_ledger.PROVISIONING: {"pool": "pod-0"}}, False, 0.0, {},
        0.0, 0.0)
    port = attribute_free_chips(
        4.0, {ledger.PROVISIONING: {"pool": "pod-0"}}, False, False, False,
        0.0, 0.0)
    assert port[:2] == jax[:2] == (ledger.PROVISIONING, 4.0)


class TestRetryPath:
    @staticmethod
    def _call(h, fn, slept, cloud_attempts=4):
        h.wire(cloud_attempts=cloud_attempts)
        return h.prov._call_cloud("create", fn)

    def test_rate_limits_are_retried_with_backoff(self, monkeypatch):
        out = {}
        for name in ("jax", "port"):
            h = Side(name)
            calls, slept = {"n": 0}, []
            monkeypatch.setattr(jax_retry if h.jax else retry, "sleep",
                                slept.append)

            def flaky(h=h, calls=calls):
                calls["n"] += 1
                if calls["n"] < 3:
                    raise h.cap.RateLimitedError("429")
                return "op-1"

            assert self._call(h, flaky, slept) == "op-1"
            out[name] = (calls["n"], slept)
        assert out["jax"] == out["port"]
        n, slept = out["port"]
        assert n == 3 and len(slept) == 2 and all(s > 0.0 for s in slept)

    def test_exhausted_retries_raise(self):
        for name in ("jax", "port"):
            h = Side(name)

            def always(h=h):
                raise h.cap.RateLimitedError("429")

            with pytest.raises(h.cap.RateLimitedError):
                self._call(h, always, [], cloud_attempts=2)


# ---------------------------------------------------------------------------
# The config and the main's assembly
# ---------------------------------------------------------------------------


class TestProvisionerConfig:
    def test_defaults_validate_and_are_off(self):
        cfg = ProvisionerConfig()
        cfg.validate()
        assert cfg.enabled is False
        jax = JaxProvisionerConfig()
        # the JAX defaults but for an H100's memory a GPU
        ours = {f: getattr(cfg, f) for f in vars(jax)}
        theirs = dict(vars(jax)) | {"hbm_gb_per_chip": 80.0}
        assert ours == theirs

    @pytest.mark.parametrize("field,value", [
        ("poll_interval_s", 0.0),
        ("scale_up_deficit_chips", -1.0),
        ("max_pending_creates", 0),
        ("provision_deadline_s", 0.0),
        ("breaker_threshold", 0),
        ("spare_target_per_pool", -1),
        ("inventory_configmap", ""),
        ("chips_per_host_cap", 0.0),
        ("hbm_gb_per_chip", 0.0),
        ("cloud_attempts", 0),
        ("quota_nodes", -1),
        ("breaker_open_s", -1.0),
    ])
    def test_rejects_bad_values_as_the_jax_package(self, field, value):
        messages = []
        for cls, err in ((JaxProvisionerConfig, JaxConfigError),
                         (ProvisionerConfig, ConfigError)):
            cfg = cls(enabled=True)
            setattr(cfg, field, value)
            with pytest.raises(err) as info:
                cfg.validate()
            messages.append(str(info.value))
        assert messages[0] == messages[1]

    def test_disabled_build_refuses_construction(self):
        with pytest.raises(ValueError):
            jax_build_main(JaxAPIServer(), JaxProvisionerConfig())
        with pytest.raises(ValueError):
            build_provisioner_main(APIServer(), ProvisionerConfig())


def test_a_tpu_machine_class_is_refused():
    """A node labelled with a TPU class joins no pool: pending demand
    makes no create, and the stand-in cloud refuses the class."""
    h = Side("port").wire(scale_up_after_s=0.0, scale_up_cooldown_s=0.0)
    node = factory.make_gpu_node("tpu-0", domain="pod-0", host_index=0,
                                 partitioning=C.MIG_KIND)
    node.metadata.labels[C.LABEL_ACCELERATOR] = "tpu-v5e"
    h.api.create("Node", node)
    h.add_pods(4)
    with h.scoped():
        h.pump(10.0)
    assert h.prov.report()["pools"] == {}
    assert h.cloud.list_operations() == [] and h.journal.events() == []
    with pytest.raises(ValueError, match="TPU"):
        h.cloud.create_node("x", "tpu-v5e")


# ---------------------------------------------------------------------------
# The chaos soak: provisioner and scheduler under cloud and API server
# faults, lock-checked
# ---------------------------------------------------------------------------


SOAK_KNOBS = dict(scale_up_after_s=2.0, scale_up_cooldown_s=4.0,
                  scale_down_idle_s=20.0, scale_down_cooldown_s=10.0,
                  provision_deadline_s=15.0, vacancy_grace_s=2.0,
                  breaker_threshold=2, breaker_open_s=15.0,
                  spare_target_per_pool=1)


def run_capacity_soak(h, seed: int, rounds: int = 60):
    """``tests/test_capacity.py``'s soak on one side: 2 nodes, 6 pods at
    round 5, a node killed at 20, the provisioner restarted at 30."""
    lk = jax_lockcheck if h.jax else lockcheck
    graph = lk.LockGraph(name=f"capacity-soak-{h.name}-{seed}")
    errors: list[str] = []
    with graph.install():
        api = h.chaos_api(seed, conflict_rate=0.10, transient_rate=0.05,
                          replay_after_ops=7)
        cloud = h.chaos_cloud(seed, stockout_rate=0.15,
                              stockout_window_s=20.0, rate_limit_rate=0.15,
                              slow_rate=0.3, slow_extra_s=10.0,
                              zombie_rate=0.2, delete_fail_rate=0.3,
                              provision_delay_s=4.0)
        cloud.set_joiner(h.joiner(api))
        prov = h.new_prov(api, cloud, **SOAK_KNOBS)
        sched = h.scheduler(api)
        jnl = h.J.DecisionJournal(maxlen=8192, clock=h.now)
        ldg = h.L.ChipSecondLedger(clock=h.now)
        lk.guard_state(jnl, graph, name="obs.DecisionJournal")
        lk.guard_state(ldg, graph, name="obs.ChipSecondLedger")
        lk.guard_state(prov, graph, name="capacity.CapacityProvisioner")
        lk.guard_state(prov.breaker, graph, name="capacity.StockoutBreaker")
        lk.guard_state(cloud, graph, name="capacity.CloudAPI")
    for i in range(2):
        h.add_host("pod-0", i, zone="us-a", api=api)

    def tick(what, fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — recorded, then asserted
            errors.append(f"seed={seed} round={rnd} {what}: {e!r}")

    rng = random.Random(seed)
    with h.scoped(jnl, ldg):
        for rnd in range(rounds):
            h.clock[0] += 2.0
            if rnd == 5:
                h.add_pods(6, prefix=f"soak-{seed}-", api=api)
            if rnd == 20:
                names = sorted(n.metadata.name for n in api.list("Node"))
                tick("kill", lambda: api.delete("Node", rng.choice(names)))
            if rnd == 30:
                prov = h.new_prov(api, cloud, **SOAK_KNOBS)
                with graph.install():
                    lk.guard_state(prov, graph,
                                   name="capacity.CapacityProvisioner-2")
            tick("scheduler", sched.run_cycle)
            tick("provisioner", prov.reconcile)
            tick("admit", lambda: h.admit_all(api))
            api.replay_dropped()
        h.clock[0] += 2.0
        tick("scheduler-final", sched.run_cycle)
    return SimpleNamespace(errors=errors, api=api, cloud=cloud, prov=prov,
                           journal=jnl, ledger=ldg, graph=graph, lk=lk)


@pytest.mark.parametrize("seed", range(4))
def test_soak_converges_clean_as_the_jax_package(seed):
    outs = {}
    for name in ("jax", "port"):
        h = Side(name)
        r = run_capacity_soak(h, seed)
        try:
            assert not r.errors, r.errors[:3]
            r.graph.assert_clean()
        finally:
            r.graph.close()
            r.lk.unguard_all()
        assert h.L.conservation_ok(r.ledger.report())
        for op in r.cloud.list_operations():
            assert op["status"] in ("PENDING", "DONE")
        provision = [rec for rec in h.records(r.journal)
                     if rec[0].startswith("provision-")
                     or rec[0] in ("spare-borrowed", "spare-promoted",
                                   "scale-down")]
        out = {"provision": provision,
               "counters": r.prov.report()["counters"],
               "cloud_stats": r.cloud.cloud_stats,
               "api_stats": r.api.stats}
        outs[name] = mapped(out) if h.jax else out
    assert outs["jax"] == outs["port"]


# ---------------------------------------------------------------------------
# The capacity fleets against bench_capacity.py's runs
# ---------------------------------------------------------------------------


def jax_capacity_run(scenario: str, seed: int = 0,
                     plane: bool = True) -> dict:
    """A JAX ``bench_capacity.Sim`` run's ``capacity_summary``, in the
    port's names (pools nvl-0 and nvl-1 for pod-0 and pod-1)."""
    sim = jax_bench.Sim(seed=seed, plane=plane, scenario=scenario)
    result = sim.run()

    def name(s):
        s = mapped(s)
        for i, pool in enumerate(fleet.CAPACITY_POOLS):
            s = s.replace(f"pod-{i}", pool)
        return s

    trace = [[c, name(sub), [[k, name(v)] for k, v in attrs]]
             for c, sub, attrs in sim.decision_trace()]
    return fleet.capacity_summary(result, trace)


@pytest.mark.parametrize("scenario", fleet.CAPACITY_SCENARIOS)
def test_capacity_fleet_is_the_jax_bench_run(scenario):
    port = fleet.run_capacity_fleet(scenario)
    jax = jax_capacity_run(scenario)
    assert port["summary"] == jax
    assert fleet.plan_digest(port["summary"]) \
        == chip_smoke.CAPACITY_FLEET_DIGESTS[scenario]
    assert port["reconcile_ms"]


def test_capacity_fleets_hold_the_bench_gates_at_seed_0():
    runs = {s: fleet.run_capacity_fleet(s)["summary"]["result"]
            for s in ("swing", "storm")}
    swing, storm = runs["swing"], runs["storm"]
    assert fleet.capacity_gates(swing, storm) == []
    assert (swing["jobs_completed"], swing["provision_landed"],
            swing["scale_downs"], swing["hosts_final"],
            swing["provisioning_chip_seconds"]) == (150, 4, 4, 4, 176.0)
    assert (storm["jobs_completed"], storm["breaker_opens"],
            storm["borrows"], storm["never_bound"],
            storm["outstanding_ops"]) == (146, 1, 2, 0, 0)


def test_quiescent_armed_plane_journals_as_the_plane_off():
    off = fleet.run_capacity_fleet("quiet", plane=False)["summary"]
    on = fleet.run_capacity_fleet("quiet", plane=True)["summary"]
    assert on["result"]["provision_landed"] == 0
    assert on["result"]["scale_downs"] == 0
    assert json.dumps(on["journal"]) == json.dumps(off["journal"])
    assert off == jax_capacity_run("quiet", plane=False)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 17 (b) on the host, without the card's child
# ---------------------------------------------------------------------------

_CAPACITY_SCRIPT = """
import json, sys, tempfile
sys.path[:0] = [{root!r}, {tests!r}]
import chip_smoke
from k8s_stub import StubApiServer

device = {{"model": "nvidia-h100-80gb-hbm3", "memory_bytes": 85_000_000_000,
           "uuids": ["GPU-0"]}}
with StubApiServer() as stub, tempfile.TemporaryDirectory() as tmp:
    fields = chip_smoke._capacity_host(stub, tmp, device,
                                       "nvidia-h100-80gb-hbm3")
print(json.dumps(fields))
"""
CAPACITY_TIMEOUT_S = 150.0


class TestSmokeCapacity:
    def test_the_card_s_node_is_provisioned_used_and_released(self):
        """chip_smoke.py's phase 17 (b) without its child: a partitioner,
        a scheduler, an operator and the provisioner main as processes
        against the REST stub; the pending 40 GB pod makes the deficit,
        the provisioner requests the pool's index 1, the smoke joins it
        (the Node, a chip agent main), the agent's report lands it, the
        pod binds there, and once the pod is deleted the node is released
        with SCALE_DOWN; ``obs capacity`` renders 1/1, 2/2, 1/1 and every
        main exits 0 (``_capacity_host`` fails otherwise).  The run (one
        process group) is killed at CAPACITY_TIMEOUT_S."""
        import os
        import pathlib
        import signal
        import subprocess
        import sys

        root = pathlib.Path(chip_smoke.__file__).resolve().parent
        script = _CAPACITY_SCRIPT.format(root=str(root),
                                         tests=str(root / "tests"))
        proc = subprocess.Popen([sys.executable, "-c", script], cwd=root,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True,
                                start_new_session=True)
        try:
            out, err = proc.communicate(timeout=CAPACITY_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, err = proc.communicate()
            pytest.fail(f"the capacity story took over {CAPACITY_TIMEOUT_S} "
                        f"s:\n{err[-4000:]}")
        finally:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        assert proc.returncode == 0, (out[-4000:], err[-4000:])
        fields = json.loads(out.strip().splitlines()[-1])
        assert fields["obs_capacity"] == {
            "before": {"nvl-card": "1/1"}, "during": {"nvl-card": "2/2"},
            "after": {"nvl-card": "1/1"}}
        assert fields["counters"]["requested"] == 1
        assert fields["counters"]["landed"] == 1
        assert fields["counters"]["scale_downs"] == 1
        assert set(fields["main_exits"]) == {
            *chip_smoke.CAPACITY_MAINS, chip_smoke.CAPACITY_AGENT}
        # the holds live in the provisioner's process: the scheduler
        # main's waterfall books none of them
        assert fields["provisioning_gpu_seconds"]["scheduler_at_end"] == 0.0
