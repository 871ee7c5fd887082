"""A stand-in cloud node-pool API, ``nos_tpu/capacity/cloudapi.py`` for
the port: the provider the capacity plane reconciles against, with the
JAX package's ``CloudTPUAPI`` named ``CloudGPUAPI`` (as
``device/tpuclient.py`` became ``device/gpuclient.py``).  A machine class
is a GPU model name (the ``nos.nebuly.com/accelerator`` value, e.g.
``nvidia-h100-80gb-hbm3``), a node an 8-GPU (or smaller) GPU node.

It is shaped after a real cloud's node API in the three ways that
matter to a controller, and in nothing else:

- **Creates are asynchronous.**  ``create_node`` returns an operation
  id at once; the node appears only after a provisioning delay, seen on
  the next read.  A controller must be level-triggered: it can never
  assume that a create it issued last poll has landed, or ever will.
- **Capacity errors are typed.**  ``StockoutError`` (the class has no
  machines in the zone) and ``QuotaExceededError`` are not retried in
  line, since retrying a stockout loops hot against an empty warehouse;
  they feed the provisioner's breaker.  ``RateLimitedError`` (HTTP 429)
  subclasses the kube client's ``TransientAPIError``, so the jittered
  backoff covers it.
- **Joining is a step of its own.**  A landed cloud node becomes a node
  the scheduler sees only when the ``joiner`` callback fires (a test
  wires it to create the API server's Node and start an agent; in a
  deployment the VM's kubelet does it).  A "zombie" is a create the
  cloud reports DONE whose joiner never fires: the node exists, holds
  quota and never takes work, and only deadline reaping clears it.

Faults come through the ``_pre_call``, ``_draw_create_fault`` and
``_draw_delete_fault`` seams, inert here;
``nos_tpu_torch.testing.chaos.ChaosCloudGPUAPI`` overrides them with
seeded draws, so the provider stays fault-free and the chaos lives in
``testing/``.

One leaf lock guards the operation and node tables.  The joiner runs
outside it: it creates API server objects, which takes the API server's
lock, and calling it under ours would add a lock-order edge.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from nos_tpu_torch.kube.client import TransientAPIError
from nos_tpu_torch.utils.guards import guarded_by

OP_PENDING = "PENDING"
OP_DONE = "DONE"
OP_FAILED = "FAILED"


def is_tpu_class(machine_class: str) -> bool:
    """A TPU machine class (``tpu-v5e`` and the like), which the GPU
    capacity plane refuses."""
    return machine_class.startswith("tpu-")


class CloudError(Exception):
    """Base class for cloud node-pool API errors."""


class CloudNotFoundError(CloudError):
    """The named node/operation does not exist."""


class AlreadyExistsError(CloudError):
    """A node or in-flight create with this name already exists.  The
    idempotency backstop: a provisioner that crashed after issuing a
    create and re-issues it on restart gets this, not a duplicate."""


class StockoutError(CloudError):
    """No machines of this class available in this zone right now.
    NOT retryable inline — feed the stockout circuit breaker."""

    def __init__(self, machine_class: str, zone: str) -> None:
        super().__init__(f"stockout: {machine_class} in {zone}")
        self.machine_class = machine_class
        self.zone = zone


class QuotaExceededError(CloudError):
    """The project's node quota is exhausted.  NOT retryable inline —
    only a scale-down or a quota bump clears it."""


class RateLimitedError(CloudError, TransientAPIError):
    """HTTP 429.  Subclasses TransientAPIError so the standard
    utils/retry jittered-backoff path retries it."""


class DeleteFailedError(CloudError, TransientAPIError):
    """A delete the cloud accepted but failed to execute.  Transient:
    the level-triggered reconcile simply retries next poll."""


class CloudOperation:
    """One asynchronous create.  ``lands_at`` is when the create
    settles against the clock; ``zombie`` (sim-internal) marks a create
    whose node will land in the cloud but never invoke the joiner."""

    __slots__ = ("op_id", "name", "machine_class", "zone", "labels",
                 "status", "error", "created_at", "lands_at", "zombie")

    def __init__(self, op_id: str, name: str, machine_class: str,
                 zone: str, labels: dict[str, str], created_at: float,
                 lands_at: float, zombie: bool) -> None:
        self.op_id = op_id
        self.name = name
        self.machine_class = machine_class
        self.zone = zone
        self.labels = labels
        self.status = OP_PENDING
        self.error = ""
        self.created_at = created_at
        self.lands_at = lands_at
        self.zombie = zombie

    def to_dict(self) -> dict[str, object]:
        return {
            "op_id": self.op_id,
            "name": self.name,
            "machine_class": self.machine_class,
            "zone": self.zone,
            "labels": dict(self.labels),
            "status": self.status,
            "error": self.error,
            "created_at": self.created_at,
            "lands_at": self.lands_at,
        }


class CloudNode:
    """A node the cloud believes exists (landed create, not deleted)."""

    __slots__ = ("name", "machine_class", "zone", "labels", "created_at")

    def __init__(self, name: str, machine_class: str, zone: str,
                 labels: dict[str, str], created_at: float) -> None:
        self.name = name
        self.machine_class = machine_class
        self.zone = zone
        self.labels = labels
        self.created_at = created_at

    def to_dict(self) -> dict[str, object]:
        return {
            "name": self.name,
            "machine_class": self.machine_class,
            "zone": self.zone,
            "labels": dict(self.labels),
            "created_at": self.created_at,
        }


@guarded_by("_lock", "_ops", "_nodes", "_seq")
class CloudGPUAPI:
    """The fault-free provider.  Operations settle lazily: every read
    first lands any due creates against the clock, invoking ``joiner``
    for each non-zombie landing (outside the lock)."""

    def __init__(self, *,
                 clock: Callable[[], float] = time.monotonic,
                 provision_delay_s: float = 1.0,
                 quota_nodes: int = 0,
                 joiner: Callable[[CloudNode], None] | None = None) -> None:
        self._clock = clock
        self._provision_delay_s = provision_delay_s
        # 0 = unlimited.  Quota counts landed nodes plus in-flight
        # creates: a pending create reserves its machine.
        self._quota_nodes = quota_nodes
        self._joiner = joiner
        self._lock = threading.Lock()
        self._ops: dict[str, CloudOperation] = {}
        self._nodes: dict[str, CloudNode] = {}
        self._seq = 0

    def set_joiner(self, joiner: Callable[[CloudNode], None]) -> None:
        self._joiner = joiner

    # -- fault seams (inert here; ChaosCloudGPUAPI overrides) ---------------
    def _pre_call(self, verb: str) -> None:
        """Raise RateLimitedError to 429 a call before it executes."""

    def _draw_create_fault(self, machine_class: str,
                           zone: str) -> tuple[float, bool]:
        """Return (extra provisioning delay, zombie?) for one create, or
        raise StockoutError / QuotaExceededError."""
        return 0.0, False

    def _draw_delete_fault(self, name: str) -> None:
        """Raise DeleteFailedError to fail one delete."""

    # -- write side ---------------------------------------------------------
    def create_node(self, name: str, machine_class: str, zone: str = "-",
                    labels: dict[str, str] | None = None) -> str:
        """Start an asynchronous node create; returns the operation id.

        Raises AlreadyExistsError for a duplicate name (landed or in
        flight), QuotaExceededError / StockoutError / RateLimitedError
        per the provider's state and the chaos seams; ValueError for a
        TPU machine class."""
        if is_tpu_class(machine_class):
            raise ValueError(f"{machine_class} is a TPU machine class; "
                             f"the stand-in provider creates GPU nodes")
        self._pre_call("create")
        now = self._clock()
        with self._lock:
            if name in self._nodes or any(
                    op.name == name and op.status == OP_PENDING
                    for op in self._ops.values()):
                raise AlreadyExistsError(name)
            if self._quota_nodes > 0:
                in_use = len(self._nodes) + sum(
                    1 for op in self._ops.values()
                    if op.status == OP_PENDING)
                if in_use >= self._quota_nodes:
                    raise QuotaExceededError(
                        f"quota: {in_use}/{self._quota_nodes} nodes")
        # the fault draw takes its own (chaos) lock; never ours
        extra, zombie = self._draw_create_fault(machine_class, zone)
        with self._lock:
            self._seq += 1
            op = CloudOperation(
                f"op-{self._seq}", name, machine_class, zone,
                dict(labels or {}), now,
                now + self._provision_delay_s + extra, zombie)
            self._ops[op.op_id] = op
            return op.op_id

    def delete_node(self, name: str) -> None:
        """Delete a landed node, or cancel its in-flight create.  Raises
        CloudNotFoundError if the cloud has no record of the name, and
        DeleteFailedError (transient) under chaos."""
        self._pre_call("delete")
        self._settle()
        self._draw_delete_fault(name)
        with self._lock:
            if name in self._nodes:
                del self._nodes[name]
                return
            for op in self._ops.values():
                if op.name == name and op.status == OP_PENDING:
                    op.status = OP_FAILED
                    op.error = "cancelled"
                    return
        raise CloudNotFoundError(name)

    def ack_operation(self, op_id: str) -> None:
        """Drop a settled operation record: the controller's GC after it
        has journalled the outcome.  Unknown ids are a no-op (crash
        between ack and journal is at-least-once, never lost)."""
        with self._lock:
            op = self._ops.get(op_id)
            if op is not None and op.status != OP_PENDING:
                del self._ops[op_id]

    # -- read side ----------------------------------------------------------
    def get_operation(self, op_id: str) -> dict[str, object]:
        self._settle()
        with self._lock:
            op = self._ops.get(op_id)
            if op is None:
                raise CloudNotFoundError(op_id)
            return op.to_dict()

    def list_operations(self) -> list[dict[str, object]]:
        """All unacked operations, oldest first."""
        self._settle()
        with self._lock:
            return [op.to_dict() for op in
                    sorted(self._ops.values(), key=lambda o: o.op_id)]

    def list_nodes(self) -> list[dict[str, object]]:
        self._settle()
        with self._lock:
            return [self._nodes[k].to_dict()
                    for k in sorted(self._nodes)]

    # -- settlement ---------------------------------------------------------
    def _settle(self) -> None:
        """Land every due create.  Joiner callbacks fire after the lock
        is released (they take the API-server lock; N004)."""
        now = self._clock()
        joined: list[CloudNode] = []
        with self._lock:
            for op in self._ops.values():
                if op.status != OP_PENDING or now < op.lands_at:
                    continue
                op.status = OP_DONE
                node = CloudNode(op.name, op.machine_class, op.zone,
                                 dict(op.labels), now)
                self._nodes[op.name] = node
                if not op.zombie:
                    joined.append(node)
        if self._joiner is not None:
            for node in joined:
                self._joiner(node)
