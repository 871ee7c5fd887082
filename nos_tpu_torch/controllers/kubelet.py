"""The kubelet's admission, ``nos_tpu/controllers/kubelet.py`` for the
port: the part the MPS node side runs.

In Kubernetes the scheduler writes only the binding; the kubelet sees
it, starts the containers and reports ``status.phase=Running``.  The
in-memory ``APIServer`` has no kubelet, so the node agent runs
``admit_bound_pods`` in its place.  Against any other substrate it does
nothing: the real kubelet owns admission there.  ``KubeletSim``, the
MIG node's admission that waits for a free device per slice, comes with
the MIG node side (ROADMAP item 5).
"""

from __future__ import annotations

from nos_tpu_torch.kube.client import APIServer, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import PENDING, RUNNING
from nos_tpu_torch.kube.resources import pod_request
from nos_tpu_torch.topology.profile import extract_slice_requests
from nos_tpu_torch.utils.retry import retry_on_conflict


def admit_bound_pods(api, node_name: str) -> int:
    """Move the Pending pods bound to ``node_name`` to Running; returns
    how many were admitted.  Pods that ask for MIG devices are left to
    the MIG node's admission, which admits one only once each device it
    asks for is free (the JAX package's ``skip_slice_pods=True``, the
    MPS node agent's call)."""
    if not isinstance(api, APIServer):
        return 0
    admitted = 0
    for pod in api.list(
            KIND_POD,
            filter_fn=lambda p: (p.spec.node_name == node_name
                                 and p.status.phase == PENDING)):
        if extract_slice_requests(pod_request(pod)):
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
