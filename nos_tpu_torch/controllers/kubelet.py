"""The kubelet's admission, ``nos_tpu/controllers/kubelet.py`` for the
port.

In Kubernetes the scheduler writes only the binding; the kubelet sees
it, calls the device plugin's Allocate for each extended resource the
pod asks for, starts the containers and reports
``status.phase=Running``.  The reference's "used" MIG devices are
exactly the kubelet's pod-resources allocations
(pkg/resource/lister.go:28): that is what keeps the MIG agent from
deleting a device under a freshly bound pod.  The in-memory
``APIServer`` has no kubelet, so the node agents run one of two
stand-ins:

- ``admit_bound_pods`` moves bound pods to Running: the MPS node's;
- ``KubeletSim`` admits a pod only once every MIG instance it asks for
  is matched to a FREE carved device, and records the match in the
  pod-resources fake, so the MIG agent's plan sees bound pods' devices
  as used: the MIG node's.  Allocation runs in a pod watch, at the
  bind, with an idempotent sweep per tick as its retry path.

Against any other substrate ``admit_bound_pods`` does nothing: the real
kubelet owns admission and allocation there.  ``KubeletSim`` is built
only on the in-memory ``APIServer``.
"""

from __future__ import annotations

import logging
import threading

from nos_tpu_torch.kube.client import APIServer, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import PENDING, RUNNING
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.topology import FREE
from nos_tpu_torch.topology.profile import (
    extract_slice_requests, slice_resource_name,
)
from nos_tpu_torch.utils.retry import retry_on_conflict

logger = logging.getLogger(__name__)


def admit_bound_pods(api, node_name: str, *, mig_pods: bool = False) -> int:
    """Move the Pending pods bound to ``node_name`` to Running; returns
    how many were admitted.  Pods that ask for MIG devices are left to
    the MIG node's admission, which admits one only once each device it
    asks for is free (the JAX package's ``skip_slice_pods=True``, the
    MPS node agent's call), unless ``mig_pods`` (an agentless rig's
    admission, ``testing/factory.admit_all``)."""
    if not isinstance(api, APIServer):
        return 0
    admitted = 0
    for pod in api.list(
            KIND_POD,
            filter_fn=lambda p: (p.spec.node_name == node_name
                                 and p.status.phase == PENDING)):
        if not mig_pods and extract_slice_requests(pod_request(pod)):
            continue

        def mutate(p):
            if p.spec.node_name == node_name and p.status.phase == PENDING:
                p.status.phase = RUNNING
        try:
            retry_on_conflict(api, KIND_POD, pod.metadata.name, mutate,
                              pod.metadata.namespace, component="kubelet")
        except NotFound:
            continue       # deleted between the list and the patch
        admitted += 1
    return admitted


class KubeletSim:
    """Device-backed admission for one MIG node (see the module
    docstring).  ``device_client`` is a ``SliceDeviceClient``;
    ``pod_resources`` must offer ``allocate`` and ``release`` (the
    stateful fake)."""

    def __init__(self, api: APIServer, node_name: str, device_client,
                 pod_resources) -> None:
        self._api = api
        self._node = node_name
        self._client = device_client
        self._res = pod_resources
        self._unsub = None
        # the watch callback runs on the binder's thread, the sweep on
        # the agent's: read devices, pick and allocate must be atomic,
        # or two pods get the same device.  Reentrant: _try_admit's own
        # phase patch notifies this watcher on the same thread.
        self._lock = threading.RLock()

    # -- wiring -------------------------------------------------------------
    def bind(self) -> None:
        """Watch this node's pods: allocation and admission run with the
        binder's notification, so the actuator never sees a just-bound
        pod's device as free."""
        if self._unsub is None:
            node = self._node
            self._unsub = self._api.watch(
                KIND_POD, self._on_event,
                selector=lambda pod: pod.spec.node_name == node)

    def unbind(self) -> None:
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    def _on_event(self, event: str, pod) -> None:
        if pod.spec.node_name != self._node:
            return
        with self._lock:
            if event == "DELETED":
                self._res.release(pod.key)
            elif pod.status.phase == PENDING:
                self._try_admit(pod)

    # -- per-tick retry and collection --------------------------------------
    def sweep(self) -> int:
        """Admit the bound Pending pods (the retry after a failed
        allocation), record again the allocations of Running pods that
        have none (an agent restart rebuilds the pod-resources view, as
        the kubelet recovers its checkpoint), release the allocations of
        pods that are gone; returns how many pods were admitted."""
        # the event path holds the API server's lock when it takes ours
        # (watch callbacks run under it): take them in that order
        with self._api.locked(), self._lock:
            pods = self._api.list(
                KIND_POD, filter_fn=lambda p: p.spec.node_name == self._node)
            live = {p.key for p in pods}
            allocated = set(self._res.allocated_pod_keys())
            for key in allocated - live:
                self._res.release(key)
            for pod in pods:
                if pod.status.phase == RUNNING and pod.key not in allocated:
                    self._try_admit(pod)
            return sum(self._try_admit(pod) for pod in pods
                       if pod.status.phase == PENDING)

    # -- admission ----------------------------------------------------------
    def _try_admit(self, pod) -> int:
        requests = extract_slice_requests(pod_request(pod))
        if requests:
            by_resource: dict[str, list[str]] = {}
            for d in self._client.get_devices():
                if d.status == FREE:
                    by_resource.setdefault(d.resource_name,
                                           []).append(d.device_id)
            picked: set[str] = set()
            for profile, qty in requests.items():
                pool = by_resource.get(slice_resource_name(profile), [])
                if len(pool) < qty:
                    logger.debug("kubelet sim: %s waits for %s x%d on %s",
                                 pod.key, profile, qty, self._node)
                    return 0           # retried by a later sweep
                picked |= set(pool[:qty])
                del pool[:qty]
            self._res.allocate(pod.key, picked)
        if pod.status.phase != PENDING:
            return 0
        node = self._node

        def mutate(p):
            if p.spec.node_name == node and p.status.phase == PENDING:
                p.status.phase = RUNNING
        retry_on_conflict(self._api, KIND_POD, pod.metadata.name, mutate,
                          pod.metadata.namespace, component="kubelet-sim")
        return 1
