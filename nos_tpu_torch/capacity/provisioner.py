"""The capacity provisioner, ``nos_tpu/capacity/provisioner.py`` for the
port: a level-triggered reconcile of the node fleet against demand, with
stockout degradation.

Every poll re-derives everything from three observable sources, the API
server's nodes and pods, the cloud's operation list and a durable size
record per pool (a ConfigMap), so a crash, a restart or a leader
failover changes nothing: the next reconcile reaches the same
conclusions from the same evidence.  No decision depends on memory
surviving (timers restart as "not yet sustained", which delays a
scale-up by one sustain window at most).  Deterministic node names
(``{pool}-h{idx}``) make a re-issued create collide with its earlier
self (AlreadyExistsError) instead of doubling a node.

On GPUs:

- a **pool** is an NVLink domain (``nos.nebuly.com/nvlink-domain``, as
  ``partitioning/core/failure.py``'s ``_pool_of`` reads it), where the
  JAX package keys on ``nos.tpu/pod-id``;
- a **machine class** is the ``nos.nebuly.com/accelerator`` value, the
  GPU model's name (``nvidia-h100-80gb-hbm3``).  A TPU class (``tpu-*``)
  is refused: its nodes join no pool, so nothing grows, releases or
  borrows them, and the cloud refuses to create one;
- the **GPUs a node** are its ``nvidia.com/gpu.count`` label (the JAX
  package's ``nos.tpu/chip-count``);
- demand and supply are counted in GPUs through the ledger's
  ``pod_chip_equiv``: a MIG instance counts g/7 of a GPU, an MPS share
  its GB over ``hbm_gb_per_chip`` (80, an H100's), and a whole
  ``nvidia.com/gpu`` counts nothing, exactly as the JAX package's rule
  counts nothing for a whole ``google.com/tpu``: whole-GPU pods neither
  make a deficit nor hold supply here;
- ``chips_per_host_cap`` is the GPUs a node (8) a created node gets when
  its pool's nodes name none.

The config, the report block and the journal's fields keep the JAX
package's names, so each ``*_chips`` value (``pending_demand_chips``,
``free_chips``, ``arriving_chips``, ``deficit_chips``, a pool's
``chips_per_host``) counts GPUs; the metrics keep the names
``nos_tpu_provision_*`` and ``nos_tpu_capacity_*``.

The reconcile's passes, in order:

1. **Operations**: land and acknowledge finished creates (journal
   PROVISION_LANDED and clear the ``provisioning`` hold once the node is
   usable: its agent reported, a pod is resident, or the deadline and
   the join grace passed), and reap creates past the provisioning
   deadline, still pending (cancelled) or landed but never joined
   (**zombies**: the cloud says DONE, the node never appears; deleted,
   journalled PROVISION_FAILED).  Then orphans: cloud nodes whose Node
   vanished after their create was acknowledged.
2. **Vacancies**: ``host_index_vacancies(live, recorded_size)`` against
   the durable size record, which also shows a dead highest index (the
   blind spot of the recovery plane's purely observational spare
   policy).  Filled by a warm spare of the same pool (at once), else a
   cloud create, else, while the breaker holds the class and zone
   stocked out, a compatible spare borrowed from a sibling pool
   (``promote_spare(..., cross_pool=True)``).
3. **Scale-up**: a GPU deficit (pending demand less free less arriving
   capacity) sustained past a threshold grows the fullest pool, up to
   ``max_pending_creates`` in flight; on a stockout the breaker opens
   and borrowing covers what it can.
4. **Spare replacement**: dead or quarantined warm spares leave the
   healthy count short of its target; replacements are created.
5. **Scale-down**: a pool's highest index only (the contiguous index
   window), only when the fleet could serve all pending demand with a
   whole node to spare (a transient pod must not restart the idle timer:
   that ratchets the fleet up), and only once the surplus was
   sustained.  A busy candidate is **cordoned** with a capacity-owned
   migration drain (drain-then-release: the scheduler's scoring would
   otherwise refill it for ever); once empty and free of holds it is
   released, cloud delete first, then the Node, then the size record,
   so a crash at any point converges again.  Cordons are
   level-triggered: a capacity cordon on a node that is no longer the
   candidate is retracted in the same poll (``_heal_cordons``).
6. The size record is written when it changed, and the report
   (``report()``, the ``capacity`` flight block) published.

The **stockout breaker** is per (machine class, zone): repeated
stockouts open it (creates stop spending the rate limit on an empty
warehouse); after ``open_s`` one half-open probe create goes through,
whose success closes it and whose stockout opens it for a full window.
While it is open the provisioner borrows warm spares across pools
rather than go dark.

Every cloud call backs off, jittered and exponential, on 429s and
transient faults, through the ``nos_tpu_torch.utils.retry.sleep`` seam
(tests and virtual-clock fleets control time through it); stockouts and
quota errors are never retried in line: they are states of capacity,
not glitches.  The ``provisioning`` holds go on this process's waste
ledger (``obs/ledger.py``), where a scheduler in the same process books
them.
"""

from __future__ import annotations

import json
import logging
import math
import random
import threading
import time
from typing import Callable, Mapping

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import (
    APIServer, Conflict, KIND_CONFIGMAP, KIND_NODE, KIND_POD, NotFound,
    TransientAPIError,
)
from nos_tpu_torch.kube.objects import ConfigMap, Node, ObjectMeta, PENDING, Pod
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import record as journal_record
from nos_tpu_torch.obs.ledger import (
    PROVISIONING as LEDGER_PROVISIONING, get_ledger, pod_chip_equiv,
)
from nos_tpu_torch.partitioning.core.failure import (
    healthy_spares_by_pool, host_index_vacancies, promote_spare,
)
from nos_tpu_torch.utils import retry as retry_mod
from nos_tpu_torch.utils.guards import guarded_by
from nos_tpu_torch.utils.retry import Backoff, RETRYABLE, retry_on_conflict

from .cloudapi import (
    AlreadyExistsError, CloudError, CloudNotFoundError, CloudGPUAPI,
    OP_DONE, OP_PENDING, QuotaExceededError, StockoutError, is_tpu_class,
)

logger = logging.getLogger(__name__)

REGISTRY.describe("nos_tpu_provision_requests_total",
                  "Cloud node creates requested, per pool")
REGISTRY.describe("nos_tpu_provision_landed_total",
                  "Provisioned nodes that joined and became usable")
REGISTRY.describe("nos_tpu_provision_failed_total",
                  "Provisioning attempts abandoned, per reason")
REGISTRY.describe("nos_tpu_provision_stockouts_total",
                  "Stockout errors from the cloud, per machine-class/zone")
REGISTRY.describe("nos_tpu_provision_latency_seconds",
                  "Create request to node-usable latency")
REGISTRY.describe("nos_tpu_provision_pending",
                  "Creates currently in flight (requested, not landed)")
REGISTRY.describe("nos_tpu_capacity_breakers_open",
                  "Stockout circuit breakers currently open or half-open")
REGISTRY.describe("nos_tpu_capacity_spare_borrows_total",
                  "Cross-pool spare promotions under stockout, per pool")
REGISTRY.describe("nos_tpu_capacity_scale_downs_total",
                  "Empty top-index hosts released back to the cloud")

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half-open"

# Warm spares provisioned by the capacity plane park OUTSIDE the active
# host-index window, same convention the recovery benches use.
SPARE_PARK_BASE = 100

# Capacity-owned migration drain stamped on a busy shrink candidate so
# the scheduler stops refilling it (drain-then-release).  The owner
# segment ("capacity") keeps the other planes' stray-drain healers off
# it; _heal_cordons is the only retraction path.
CORDON_VALUE = C.migration_drain_value("capacity", "scale-down")


@guarded_by("_lock", "_streak", "_open_until", "_probing")
class StockoutBreaker:
    """Per-(machine class, zone) stockout circuit breaker.

    Closed → repeated stockouts reach `threshold` → open for `open_s` →
    half-open lets exactly ONE probe create through → success closes,
    another stockout re-opens for a full window.  Mirrors the actuation
    quarantine's streak/half-open shape (partitioning/core/quarantine)
    so operators debug one state machine, not two."""

    def __init__(self, threshold: int = 3, open_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._threshold = max(1, threshold)
        self._open_s = open_s
        self._clock = clock
        self._lock = threading.Lock()
        self._streak: dict[tuple[str, str], int] = {}
        self._open_until: dict[tuple[str, str], float] = {}
        self._probing: dict[tuple[str, str], bool] = {}

    def allow(self, key: tuple[str, str]) -> bool:
        """May a create for this class/zone be attempted now?  Crossing
        an expired open window claims the single half-open probe slot."""
        now = self._clock()
        with self._lock:
            until = self._open_until.get(key)
            if until is None:
                return True
            if now < until:
                return False
            if self._probing.get(key, False):
                return False        # a probe is already in flight
            self._probing[key] = True
            return True

    def record_stockout(self, key: tuple[str, str]) -> str | None:
        """Count one stockout; returns the NEW state iff it changed
        (the caller journals transitions, not every error)."""
        now = self._clock()
        with self._lock:
            if self._probing.pop(key, False):
                # failed half-open probe: full window again
                self._open_until[key] = now + self._open_s
                return BREAKER_OPEN
            if key in self._open_until:
                return None         # already open; nothing new
            streak = self._streak.get(key, 0) + 1
            self._streak[key] = streak
            if streak >= self._threshold:
                self._open_until[key] = now + self._open_s
                return BREAKER_OPEN
            return None

    def record_success(self, key: tuple[str, str]) -> str | None:
        """A create was accepted: clear everything.  Returns "closed"
        iff the breaker was open/half-open before."""
        with self._lock:
            was_open = key in self._open_until
            self._streak.pop(key, None)
            self._open_until.pop(key, None)
            self._probing.pop(key, None)
            return BREAKER_CLOSED if was_open else None

    def state(self, key: tuple[str, str]) -> str:
        now = self._clock()
        with self._lock:
            until = self._open_until.get(key)
            if until is None:
                return BREAKER_CLOSED
            if self._probing.get(key, False) or now >= until:
                return BREAKER_HALF_OPEN
            return BREAKER_OPEN

    def snapshot(self) -> dict[str, dict[str, object]]:
        """`"class/zone" -> {state, streak, retry_in_s}` for `obs
        capacity` and the capacity report."""
        now = self._clock()
        with self._lock:
            keys = set(self._streak) | set(self._open_until)
            out: dict[str, dict[str, object]] = {}
            for key in sorted(keys):
                until = self._open_until.get(key)
                if until is None:
                    state = BREAKER_CLOSED
                elif self._probing.get(key, False) or now >= until:
                    state = BREAKER_HALF_OPEN
                else:
                    state = BREAKER_OPEN
                out["/".join(key)] = {
                    "state": state,
                    "streak": self._streak.get(key, self._threshold
                                               if until is not None else 0),
                    "retry_in_s": max(0.0, (until or now) - now),
                }
            return out

    def open_count(self) -> int:
        with self._lock:
            return len(self._open_until)


class PoolState:
    """One pool's observed inventory for a single reconcile pass."""

    __slots__ = ("name", "machine_class", "zone", "chips_per_host",
                 "active", "spares", "free_chips", "held")

    def __init__(self, name: str) -> None:
        self.name = name
        self.machine_class = ""
        self.zone = "-"
        self.chips_per_host = 0.0
        self.active: dict[int, str] = {}
        self.spares: list[str] = []
        self.free_chips = 0.0
        self.held: set[str] = set()


class _Inflight:
    """Creates requested but not yet usable, per reconcile pass."""

    __slots__ = ("names", "count", "chips", "spares_by_pool", "pending")

    def __init__(self) -> None:
        self.names: set[str] = set()
        self.count = 0
        self.chips = 0.0
        self.spares_by_pool: dict[str, int] = {}
        self.pending: list[dict[str, object]] = []


@guarded_by("_lock", "_deficit_since", "_surplus_since", "_last_scale_up",
            "_last_scale_down", "_vacancy_since", "_quota_until",
            "_counters", "_report", "_refused")
class CapacityProvisioner:
    """See the module docstring for the reconcile model."""

    def __init__(self, api: APIServer, cloud: CloudGPUAPI, *,
                 scale_up_deficit_chips: float = 8.0,
                 scale_up_after_s: float = 6.0,
                 scale_up_cooldown_s: float = 15.0,
                 max_pending_creates: int = 4,
                 scale_down_idle_s: float = 120.0,
                 scale_down_cooldown_s: float = 60.0,
                 min_hosts_per_pool: int = 1,
                 provision_deadline_s: float = 120.0,
                 join_grace_s: float = 10.0,
                 vacancy_grace_s: float = 4.0,
                 breaker_threshold: int = 3,
                 breaker_open_s: float = 60.0,
                 spare_target_per_pool: int = 0,
                 inventory_configmap: str = "nos-tpu-capacity-inventory",
                 inventory_namespace: str = "nos-tpu-system",
                 chips_per_host_cap: float = 8.0,
                 hbm_gb_per_chip: float = 80.0,
                 cloud_attempts: int = 4,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._api = api
        self._cloud = cloud
        self._clock = clock
        self._scale_up_deficit_chips = scale_up_deficit_chips
        self._scale_up_after_s = scale_up_after_s
        self._scale_up_cooldown_s = scale_up_cooldown_s
        self._max_pending_creates = max_pending_creates
        self._scale_down_idle_s = scale_down_idle_s
        self._scale_down_cooldown_s = scale_down_cooldown_s
        self._min_hosts_per_pool = min_hosts_per_pool
        self._provision_deadline_s = provision_deadline_s
        self._join_grace_s = join_grace_s
        self._vacancy_grace_s = vacancy_grace_s
        self._spare_target_per_pool = spare_target_per_pool
        self._inventory_cm = inventory_configmap
        self._inventory_ns = inventory_namespace
        self._chip_cap = chips_per_host_cap
        self._hbm_gb_per_chip = hbm_gb_per_chip
        self._cloud_attempts = max(1, cloud_attempts)
        self.breaker = StockoutBreaker(breaker_threshold, breaker_open_s,
                                       clock)
        # jitter source for cloud-call backoff: seeded so a chaos seed
        # reproduces the same retry schedule (noslint N002 spirit — no
        # wall-clock or global-rng dependence in the decision path)
        self._retry_rng = random.Random(0xCA9AC17)
        self._lock = threading.Lock()
        self._deficit_since: float | None = None
        self._surplus_since: dict[str, float] = {}
        self._last_scale_up = float("-inf")
        self._last_scale_down = float("-inf")
        self._vacancy_since: dict[tuple[str, int], float] = {}
        self._quota_until = float("-inf")
        self._counters: dict[str, int] = {
            "requested": 0, "landed": 0, "failed": 0, "stockouts": 0,
            "borrows": 0, "scale_downs": 0, "zombie_reaps": 0,
            "orphan_reaps": 0, "cordons": 0,
        }
        self._report: dict[str, object] = {"pools": {}, "breakers": {},
                                           "pending_creates": []}
        self._refused: set[str] = set()

    # -- cloud call wrapper -------------------------------------------------
    def _call_cloud(self, what: str, fn: Callable[[], object]) -> object:
        """429s/transients get jittered exponential backoff through the
        `nos_tpu_torch.utils.retry.sleep` seam; capacity errors (stockout,
        quota) propagate untouched on the first throw."""
        backoff = Backoff(base_s=0.2, cap_s=5.0, rng=self._retry_rng)
        attempt = 0
        while True:
            try:
                return fn()
            except TransientAPIError:
                attempt += 1
                if attempt >= self._cloud_attempts:
                    raise
                retry_mod.sleep(backoff.next_delay())

    # -- the reconcile ------------------------------------------------------
    def reconcile(self) -> None:
        """One level-triggered pass.  Never raises: a cloud or apiserver
        failure logs, skips the dependent pass, and the next poll
        retries from scratch."""
        now = self._clock()
        try:
            ops_obj = self._call_cloud("list-operations",
                                       self._cloud.list_operations)
        except (CloudError, TransientAPIError):
            logger.warning("capacity: cloud operation list unavailable; "
                           "skipping reconcile")
            return
        ops = list(ops_obj) if isinstance(ops_obj, list) else []
        nodes = {n.metadata.name: n for n in self._api.list(KIND_NODE)}
        holds = get_ledger().holds()
        pools, pending_chips, pods_by_node = self._observe(nodes, holds)
        inventory, loaded = self._load_inventory(pools)
        inflight = self._process_operations(ops, nodes, pods_by_node, now)
        self._reap_orphans(nodes, inflight, now)
        self._fill_vacancies(pools, inventory, nodes, inflight, now)
        self._scale_up(pools, inventory, inflight, pending_chips, now)
        self._replace_spares(pools, inventory, nodes, inflight, now)
        self._scale_down(pools, inventory, holds, pods_by_node, nodes,
                         pending_chips, now)
        self._store_inventory(inventory, loaded)
        self._publish(pools, inventory, inflight, pending_chips, now)

    # -- observation --------------------------------------------------------
    def _observe(self, nodes: Mapping[str, Node],
                 holds: Mapping[str, Mapping[str, Mapping[str, object]]],
                 ) -> tuple[dict[str, PoolState], float,
                            dict[str, list[Pod]]]:
        pods_by_node: dict[str, list[Pod]] = {}
        pending_chips = 0.0
        for pod in self._api.list(KIND_POD):
            if pod.spec.node_name:
                pods_by_node.setdefault(pod.spec.node_name, []).append(pod)
            elif pod.status.phase == PENDING:
                pending_chips += pod_chip_equiv(
                    pod_request(pod), self._chip_cap, self._hbm_gb_per_chip)

        pools: dict[str, PoolState] = {}
        spares = healthy_spares_by_pool(nodes)
        for name, node in nodes.items():
            labels = node.metadata.labels
            pool = labels.get(C.LABEL_NVLINK_DOMAIN, "")
            if not pool or C.LABEL_ACCELERATOR not in labels:
                continue
            if is_tpu_class(labels[C.LABEL_ACCELERATOR]):
                self._refuse(name, labels[C.LABEL_ACCELERATOR])
                continue
            st = pools.setdefault(pool, PoolState(pool))
            st.machine_class = labels.get(C.LABEL_ACCELERATOR, "")
            st.zone = labels.get(C.LABEL_ZONE, "-")
            chips = float(labels.get(C.LABEL_GPU_COUNT, "0") or "0")
            st.chips_per_host = max(st.chips_per_host, chips)
            if C.LABEL_SPARE in labels:
                continue            # healthy spares collected below
            try:
                idx = int(labels.get(C.LABEL_HOST_INDEX, ""))
            except ValueError:
                continue
            st.active[idx] = name
            if self._disqualifying_hold(holds, name):
                st.held.add(name)
                continue            # held chips are never free supply
            used = sum(pod_chip_equiv(pod_request(p), chips,
                                      self._hbm_gb_per_chip)
                       for p in pods_by_node.get(name, ()))
            st.free_chips += max(0.0, chips - used)
        for pool, names in spares.items():
            if pool in pools:
                # a spare under a quarantine/drain-class hold is not
                # promotable — and not counted toward the healthy
                # target, so replacement provisioning kicks in
                pools[pool].spares = [
                    n for n in names
                    if not self._disqualifying_hold(holds, n)
                    and not is_tpu_class(nodes[n].metadata.labels.get(
                        C.LABEL_ACCELERATOR, ""))]
        return pools, pending_chips, pods_by_node

    def _refuse(self, name: str, machine_class: str) -> None:
        """A TPU node joins no pool; warned once a node."""
        with self._lock:
            if name in self._refused:
                return
            self._refused.add(name)
        logger.warning("capacity: node %s has the TPU machine class %s; "
                       "the GPU capacity plane refuses it (no pool, no "
                       "create, no release)", name, machine_class)

    @staticmethod
    def _disqualifying_hold(
            holds: Mapping[str, Mapping[str, Mapping[str, object]]],
            name: str) -> bool:
        """A PROVISIONING hold alone does not disqualify a node that has
        already joined: the holds snapshot is taken before this pass's
        operation processing clears landed holds, so a host landing this
        very poll still carries one.  Treating it as quarantine-class
        would double-provision for one poll (the landed node is invisible
        as supply while its in-flight op is already acked)."""
        return bool(set(holds.get(name, ())) - {LEDGER_PROVISIONING})

    # -- durable inventory --------------------------------------------------
    def _load_inventory(self, pools: Mapping[str, PoolState],
                        ) -> tuple[dict[str, int], dict[str, int]]:
        """Recorded pool sizes; unknown pools are seeded from the live
        window (``max(live)+1`` — all one snapshot can prove).  Returns
        (working copy, loaded snapshot) so the store step only writes on
        change."""
        recorded: dict[str, int] = {}
        cm = self._api.try_get(KIND_CONFIGMAP, self._inventory_cm,
                               self._inventory_ns)
        if cm is not None:
            try:
                raw = json.loads(cm.data.get("pools", "{}"))
                recorded = {str(k): int(v) for k, v in raw.items()}
            except (ValueError, TypeError, AttributeError):
                logger.warning("capacity: inventory configmap %s/%s is "
                               "unparseable; reseeding from observation",
                               self._inventory_ns, self._inventory_cm)
        loaded = dict(recorded)
        for pool, st in pools.items():
            if pool not in recorded and st.active:
                recorded[pool] = max(st.active) + 1
        return recorded, loaded

    def _store_inventory(self, inventory: dict[str, int],
                         loaded: dict[str, int]) -> None:
        if inventory == loaded:
            return
        payload = json.dumps(inventory, sort_keys=True)

        def mutate(cm: ConfigMap) -> None:
            cm.data["pools"] = payload

        try:
            retry_on_conflict(self._api, KIND_CONFIGMAP, self._inventory_cm,
                              mutate, self._inventory_ns,
                              component="capacity-inventory")
        except NotFound:
            cm = ConfigMap(metadata=ObjectMeta(name=self._inventory_cm,
                                               namespace=self._inventory_ns),
                           data={"pools": payload})
            try:
                self._api.create(KIND_CONFIGMAP, cm)
            except Conflict:
                pass        # racing leader wrote it; next poll merges
        except RETRYABLE:
            logger.warning("capacity: inventory write failed after "
                           "retries; next reconcile re-derives and "
                           "re-writes")

    # -- operation lifecycle ------------------------------------------------
    def _process_operations(self, ops: list[dict[str, object]],
                            nodes: Mapping[str, Node],
                            pods_by_node: Mapping[str, list[Pod]],
                            now: float) -> _Inflight:
        inflight = _Inflight()
        for op in ops:
            op_id = str(op["op_id"])
            name = str(op["name"])
            status = str(op["status"])
            labels_obj = op.get("labels")
            labels: dict[str, str] = (dict(labels_obj)
                                      if isinstance(labels_obj, dict) else {})
            pool = labels.get(C.LABEL_NVLINK_DOMAIN, "")
            created_at = float(op.get("created_at", now) or now)
            age = now - created_at
            if status == OP_DONE and name in nodes:
                if self._node_usable(nodes[name], pods_by_node, created_at,
                                     now):
                    self._landed(op_id, name, pool, op, age)
                    continue
                self._track_inflight(inflight, name, pool, labels, op, now)
            elif status == OP_DONE:
                # landed in the cloud, never joined: a zombie once past
                # the provisioning deadline
                if age > self._provision_deadline_s:
                    self._reap(op_id, name, pool, "zombie", now)
                else:
                    self._track_inflight(inflight, name, pool, labels, op,
                                         now)
            elif status == OP_PENDING:
                if age > self._provision_deadline_s:
                    self._reap(op_id, name, pool, "deadline", now)
                else:
                    self._track_inflight(inflight, name, pool, labels, op,
                                         now)
            else:
                # FAILED (a cancel we crashed before acking): close out
                self._failed(op_id, name, pool,
                             str(op.get("error", "")) or "failed")
        return inflight

    def _node_usable(self, node: Node, pods_by_node: Mapping[str, list[Pod]],
                     created_at: float, now: float) -> bool:
        """Usable = the agent reported geometry, or it already hosts a
        resident, or the join grace elapsed (an agentless test node)."""
        name = node.metadata.name
        if any(k.startswith(C.ANNOT_STATUS_PREFIX)
               for k in node.metadata.annotations):
            return True
        if pods_by_node.get(name):
            return True
        return (now - created_at) > (self._provision_deadline_s
                                     + self._join_grace_s)

    def _track_inflight(self, inflight: _Inflight, name: str, pool: str,
                        labels: Mapping[str, str], op: dict[str, object],
                        now: float) -> None:
        inflight.names.add(name)
        inflight.count += 1
        chips = float(labels.get(C.LABEL_GPU_COUNT, "0") or "0")
        if C.LABEL_SPARE in labels:
            inflight.spares_by_pool[pool] = (
                inflight.spares_by_pool.get(pool, 0) + 1)
        else:
            inflight.chips += chips
        inflight.pending.append({
            "name": name, "pool": pool,
            "machine_class": str(op.get("machine_class", "")),
            "zone": str(op.get("zone", "-")),
            "age_s": round(now - float(op.get("created_at", now) or now), 3),
            "status": str(op.get("status", "")),
        })

    def _landed(self, op_id: str, name: str, pool: str,
                op: dict[str, object], age: float) -> None:
        get_ledger().clear_hold(name, LEDGER_PROVISIONING,
                                owner="provisioner")
        journal_record(J.PROVISION_LANDED, name, pool=pool,
                       machine_class=str(op.get("machine_class", "")),
                       zone=str(op.get("zone", "-")),
                       latency_s=round(age, 3))
        REGISTRY.inc("nos_tpu_provision_landed_total",
                     labels={"pool": pool})
        REGISTRY.observe("nos_tpu_provision_latency_seconds", age)
        self._count("landed")
        self._cloud.ack_operation(op_id)

    def _reap(self, op_id: str, name: str, pool: str, reason: str,
              now: float) -> None:
        try:
            self._call_cloud("delete",
                             lambda: self._cloud.delete_node(name))
        except CloudNotFoundError:
            pass
        except (CloudError, TransientAPIError):
            logger.warning("capacity: reap of %s (%s) failed; next poll "
                           "retries", name, reason)
            return              # keep the op; retry next reconcile
        get_ledger().clear_hold(name, LEDGER_PROVISIONING,
                                owner="provisioner")
        journal_record(J.PROVISION_FAILED, name, pool=pool, reason=reason)
        REGISTRY.inc("nos_tpu_provision_failed_total",
                     labels={"reason": reason})
        self._count("failed")
        if reason == "zombie":
            self._count("zombie_reaps")
        self._cloud.ack_operation(op_id)

    def _reap_orphans(self, nodes: Mapping[str, Node],
                      inflight: _Inflight, now: float) -> None:
        """Delete cloud nodes whose kube node vanished AFTER the create
        op was acked (out-of-band node deletion, a host that died
        post-join).  Without this the name is wedged: every re-create of
        the vacant slot hits AlreadyExists against the stale cloud
        record.  A node still covered by an unacked op is in-flight, not
        an orphan; fresh landings get the same deadline+grace the join
        path gets before we declare them gone."""
        try:
            cloud_nodes = self._call_cloud("list-nodes",
                                           self._cloud.list_nodes)
        except (CloudError, TransientAPIError):
            logger.warning("capacity: cloud node list unavailable; "
                           "skipping orphan reaping")
            return
        for cn in cloud_nodes:
            name = str(cn["name"])
            if name in nodes or name in inflight.names:
                continue
            age = now - float(cn.get("created_at", now))
            if age <= self._provision_deadline_s + self._join_grace_s:
                continue
            try:
                self._call_cloud("delete",
                                 lambda n=name: self._cloud.delete_node(n))
            except CloudNotFoundError:
                pass
            except (CloudError, TransientAPIError):
                logger.warning("capacity: orphan reap of %s failed; "
                               "next poll retries", name)
                continue
            journal_record(J.PROVISION_FAILED, name, reason="orphan")
            REGISTRY.inc("nos_tpu_provision_failed_total",
                         labels={"reason": "orphan"})
            self._count("orphan_reaps")

    def _failed(self, op_id: str, name: str, pool: str,
                reason: str) -> None:
        get_ledger().clear_hold(name, LEDGER_PROVISIONING,
                                owner="provisioner")
        journal_record(J.PROVISION_FAILED, name, pool=pool, reason=reason)
        REGISTRY.inc("nos_tpu_provision_failed_total",
                     labels={"reason": reason})
        self._count("failed")
        self._cloud.ack_operation(op_id)

    # -- vacancy closure ----------------------------------------------------
    def _fill_vacancies(self, pools: dict[str, PoolState],
                        inventory: dict[str, int],
                        nodes: Mapping[str, Node], inflight: _Inflight,
                        now: float) -> None:
        open_vacancies: set[tuple[str, int]] = set()
        for pool in sorted(pools):
            st = pools[pool]
            recorded = inventory.get(pool, 0)
            for idx in host_index_vacancies(st.active, recorded):
                name = f"{pool}-h{idx}"
                if name in nodes or name in inflight.names:
                    continue
                key = (pool, idx)
                open_vacancies.add(key)
                with self._lock:
                    since = self._vacancy_since.setdefault(key, now)
                if now - since < self._vacancy_grace_s:
                    continue    # the watching spare policy gets first claim
                if st.spares:
                    spare = st.spares.pop(0)
                    if promote_spare(self._api, spare, pool, idx,
                                     kind="capacity"):
                        open_vacancies.discard(key)
                    continue
                if self._create(st, name, idx, inflight, now, spare=False):
                    open_vacancies.discard(key)
                    continue
                if self._borrow(pools, st, idx, now):
                    open_vacancies.discard(key)
        with self._lock:
            self._vacancy_since = {k: v for k, v in
                                   self._vacancy_since.items()
                                   if k in open_vacancies}

    # -- scale-up -----------------------------------------------------------
    def _scale_up(self, pools: dict[str, PoolState],
                  inventory: dict[str, int], inflight: _Inflight,
                  pending_chips: float, now: float) -> None:
        free = sum(st.free_chips for st in pools.values())
        deficit = pending_chips - free - inflight.chips
        with self._lock:
            if deficit < self._scale_up_deficit_chips:
                self._deficit_since = None
                return
            if self._deficit_since is None:
                self._deficit_since = now
            sustained = now - self._deficit_since
            ready = (sustained >= self._scale_up_after_s
                     and now - self._last_scale_up
                     >= self._scale_up_cooldown_s
                     and now >= self._quota_until)
        if not ready or not pools:
            return
        # grow the fullest pool: demand concentrates where it fits
        target = min(pools.values(), key=lambda s: (s.free_chips, s.name))
        if target.chips_per_host <= 0:
            return
        want = math.ceil(deficit / target.chips_per_host)
        slots = self._max_pending_creates - inflight.count
        acted = False
        for _ in range(max(0, min(want, slots))):
            idx = inventory.get(target.name, 0)
            name = f"{target.name}-h{idx}"
            if self._create(target, name, idx, inflight, now, spare=False):
                inventory[target.name] = idx + 1
                acted = True
            elif self._borrow(pools, target, idx, now):
                # stocked out: a borrowed spare becomes the new index
                inventory[target.name] = idx + 1
                acted = True
            else:
                break
        if acted:
            with self._lock:
                self._last_scale_up = now
                self._deficit_since = None

    # -- warm-spare replacement ---------------------------------------------
    def _replace_spares(self, pools: dict[str, PoolState],
                        inventory: dict[str, int],
                        nodes: Mapping[str, Node], inflight: _Inflight,
                        now: float) -> None:
        if self._spare_target_per_pool <= 0:
            return
        for pool in sorted(pools):
            st = pools[pool]
            have = (len(st.spares)
                    + inflight.spares_by_pool.get(pool, 0))
            seq = 0
            while have < self._spare_target_per_pool:
                name = f"{pool}-s{seq}"
                seq += 1
                if name in nodes or name in inflight.names:
                    continue
                if not self._create(st, name, SPARE_PARK_BASE + seq,
                                    inflight, now, spare=True):
                    break       # stocked out / quota / slots exhausted
                have += 1

    # -- scale-down ---------------------------------------------------------
    def _scale_down(self, pools: dict[str, PoolState],
                    inventory: dict[str, int],
                    holds: Mapping[str, Mapping[str, Mapping[str, object]]],
                    pods_by_node: Mapping[str, list[Pod]],
                    nodes: Mapping[str, Node],
                    pending_chips: float, now: float) -> None:
        total_free = sum(st.free_chips for st in pools.values())
        live_surplus: set[str] = set()
        desired_cordons: set[str] = set()
        released = False
        for pool in sorted(pools):
            st = pools[pool]
            recorded = inventory.get(pool, 0)
            if recorded <= self._min_hosts_per_pool:
                continue
            top = recorded - 1
            name = st.active.get(top)
            if name is None:
                continue        # top index is a vacancy, not a surplus
            # surplus = the fleet can serve all pending demand AND still
            # has this whole host's worth of slack to give back.  A
            # churn-transient pod that fits the slack must NOT reset the
            # timer (every bind gap would restart the clock and the
            # surplus never drains — a ratchet); demand that genuinely
            # needs the host fails this test and blocks the release.
            if total_free < pending_chips + st.chips_per_host:
                continue        # not surplus; timer pruned below
            live_surplus.add(pool)
            with self._lock:
                since = self._surplus_since.setdefault(pool, now)
                sustained = now - since >= self._scale_down_idle_s
                ready = (sustained and now - self._last_scale_down
                         >= self._scale_down_cooldown_s)
            if not sustained:
                continue
            if pods_by_node.get(name):
                # drain-then-release: the scheduler's fragmentation-
                # aware score key can refill the top host forever (it
                # prefers hosts whose windows are already broken — and
                # the release candidate is exactly the window it churns
                # on).  Cordon it with a capacity-owned migration drain
                # (hard placement rejection, planner snapshot exclusion,
                # never healed by the other planes) and let residents
                # finish; the release happens once it is empty.
                desired_cordons.add(name)
                self._cordon(nodes, name)
                continue
            if name in holds or released or not ready:
                continue
            try:
                self._call_cloud("delete",
                                 lambda n=name: self._cloud.delete_node(n))
            except CloudNotFoundError:
                pass            # a pre-capacity host the cloud never knew
            except (CloudError, TransientAPIError):
                logger.warning("capacity: cloud release of %s failed; "
                               "next poll retries", name)
                continue
            try:
                self._api.delete(KIND_NODE, name)
            except NotFound:
                pass
            inventory[pool] = top
            journal_record(J.SCALE_DOWN, name, pool=pool, host_index=top,
                           idle_s=round(now - since, 3))
            REGISTRY.inc("nos_tpu_capacity_scale_downs_total",
                         labels={"pool": pool})
            self._count("scale_downs")
            with self._lock:
                self._last_scale_down = now
                self._surplus_since.pop(pool, None)
            released = True     # one release per poll: gentle by design
        with self._lock:
            self._surplus_since = {p: t for p, t in
                                   self._surplus_since.items()
                                   if p in live_surplus}
        self._heal_cordons(nodes, desired_cordons)

    def _cordon(self, nodes: Mapping[str, Node], name: str) -> None:
        node = nodes.get(name)
        if node is None \
                or node.metadata.annotations.get(C.ANNOT_DEFRAG_DRAIN):
            return              # gone, or another plane already drains it

        def mutate(n: Node) -> None:
            n.metadata.annotations.setdefault(C.ANNOT_DEFRAG_DRAIN,
                                              CORDON_VALUE)

        try:
            retry_on_conflict(self._api, KIND_NODE, name, mutate,
                              component="capacity-cordon")
        except NotFound:
            return
        except RETRYABLE:
            logger.warning("capacity: cordon of %s failed; next poll "
                           "retries", name)
            return
        self._count("cordons")

    def _heal_cordons(self, nodes: Mapping[str, Node],
                      desired: set[str]) -> None:
        """Level-triggered retraction: any capacity-owned cordon on a
        host that is no longer the shrink candidate (demand returned,
        the pool shrank past it, a predecessor died mid-shrink) is
        retracted this poll — a stray cordon must never deprioritize a
        healthy host forever."""
        for name, node in nodes.items():
            if name in desired:
                continue
            if node.metadata.annotations.get(C.ANNOT_DEFRAG_DRAIN) \
                    != CORDON_VALUE:
                continue

            def mutate(n: Node) -> None:
                if n.metadata.annotations.get(C.ANNOT_DEFRAG_DRAIN) \
                        == CORDON_VALUE:
                    n.metadata.annotations.pop(C.ANNOT_DEFRAG_DRAIN)

            try:
                retry_on_conflict(self._api, KIND_NODE, name, mutate,
                                  component="capacity-cordon")
            except NotFound:
                pass
            except RETRYABLE:
                logger.warning("capacity: cordon retraction on %s "
                               "failed; next poll retries", name)

    # -- create / borrow primitives -----------------------------------------
    def _create(self, st: PoolState, name: str, idx: int,
                inflight: _Inflight, now: float, *, spare: bool) -> bool:
        """One cloud create, breaker-gated.  True iff the request was
        accepted (or already in flight from a previous incarnation)."""
        if inflight.count >= self._max_pending_creates:
            return False
        key = (st.machine_class, st.zone)
        if not self.breaker.allow(key):
            return False
        labels = {
            C.LABEL_ACCELERATOR: st.machine_class,
            C.LABEL_NVLINK_DOMAIN: st.name,
            C.LABEL_HOST_INDEX: str(idx),
            C.LABEL_GPU_COUNT: str(int(st.chips_per_host or
                                        self._chip_cap)),
            C.LABEL_ZONE: st.zone,
        }
        if spare:
            labels[C.LABEL_SPARE] = C.SPARE_WARM
        try:
            op_obj = self._call_cloud(
                "create", lambda: self._cloud.create_node(
                    name, st.machine_class, st.zone, labels))
        except AlreadyExistsError:
            return True         # our earlier incarnation asked already
        except StockoutError:
            self._count("stockouts")
            REGISTRY.inc("nos_tpu_provision_stockouts_total",
                         labels={"key": "/".join(key)})
            transition = self.breaker.record_stockout(key)
            if transition is not None:
                journal_record(J.PROVISION_STOCKOUT, "/".join(key),
                               state=transition, pool=st.name)
            journal_record(J.PROVISION_FAILED, name, pool=st.name,
                           reason="stockout")
            REGISTRY.inc("nos_tpu_provision_failed_total",
                         labels={"reason": "stockout"})
            self._count("failed")
            return False
        except QuotaExceededError:
            journal_record(J.PROVISION_FAILED, name, pool=st.name,
                           reason="quota")
            REGISTRY.inc("nos_tpu_provision_failed_total",
                         labels={"reason": "quota"})
            self._count("failed")
            with self._lock:
                self._quota_until = now + self._scale_up_cooldown_s
            return False
        except (CloudError, TransientAPIError):
            logger.warning("capacity: create of %s failed after retries",
                           name)
            return False
        transition = self.breaker.record_success(key)
        if transition is not None:
            journal_record(J.PROVISION_STOCKOUT, "/".join(key),
                           state=transition, pool=st.name)
        op_id = str(op_obj)
        journal_record(J.PROVISION_REQUESTED, name, pool=st.name,
                       machine_class=st.machine_class, zone=st.zone,
                       host_index=idx, op=op_id, spare=spare)
        REGISTRY.inc("nos_tpu_provision_requests_total",
                     labels={"pool": st.name})
        self._count("requested")
        get_ledger().set_hold(name, LEDGER_PROVISIONING,
                              owner="provisioner", pool=st.name,
                              machine_class=st.machine_class, zone=st.zone,
                              op=op_id)
        self._track_inflight(inflight, name, st.name, labels,
                             {"op_id": op_id, "name": name,
                              "machine_class": st.machine_class,
                              "zone": st.zone, "status": OP_PENDING,
                              "created_at": now}, now)
        return True

    def _borrow(self, pools: dict[str, PoolState], target: PoolState,
                idx: int, now: float) -> bool:
        """Cross-pool degradation: promote a compatible (same machine
        class) warm spare from a sibling pool into the target's index.
        Last resort — it spends another pool's recovery headroom."""
        for other in sorted(pools):
            st = pools[other]
            if other == target.name:
                continue
            if st.machine_class != target.machine_class:
                continue
            while st.spares:
                spare = st.spares.pop(0)
                if promote_spare(self._api, spare, target.name, idx,
                                 kind="capacity", cross_pool=True):
                    REGISTRY.inc("nos_tpu_capacity_spare_borrows_total",
                                 labels={"pool": target.name})
                    self._count("borrows")
                    return True
        return False

    # -- reporting ----------------------------------------------------------
    def _count(self, key: str) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + 1

    def _publish(self, pools: dict[str, PoolState],
                 inventory: dict[str, int], inflight: _Inflight,
                 pending_chips: float, now: float) -> None:
        breakers = self.breaker.snapshot()
        pool_rows = {
            pool: {
                "recorded_size": inventory.get(pool, 0),
                "active": len(st.active),
                "spares": len(st.spares),
                "machine_class": st.machine_class,
                "zone": st.zone,
                "chips_per_host": st.chips_per_host,
                "free_chips": round(st.free_chips, 3),
                "held": sorted(st.held),
            }
            for pool, st in sorted(pools.items())
        }
        free = sum(st.free_chips for st in pools.values())
        with self._lock:
            counters = dict(self._counters)
            self._report = {
                "pools": pool_rows,
                "breakers": breakers,
                "pending_creates": list(inflight.pending),
                "pending_demand_chips": round(pending_chips, 3),
                "free_chips": round(free, 3),
                "arriving_chips": round(inflight.chips, 3),
                "deficit_chips": round(
                    pending_chips - free - inflight.chips, 3),
                "counters": counters,
            }
        REGISTRY.set("nos_tpu_provision_pending", float(inflight.count))
        REGISTRY.set("nos_tpu_capacity_breakers_open",
                     float(self.breaker.open_count()))

    def report(self) -> dict[str, object]:
        """The `obs capacity` surface: last reconcile's view — pools,
        breakers, in-flight creates, demand/supply balance, counters."""
        with self._lock:
            return dict(self._report)
