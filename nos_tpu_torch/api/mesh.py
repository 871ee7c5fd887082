"""Mesh-aware block request normalization, ``nos_tpu/api/mesh.py`` for
the port.

A training job that thinks in GPUs can ask for them generically, as
``nvidia.com/gpu: N*G`` with the annotation ``nos.nebuly.com/mesh: NxG``
naming the mesh it will build: N nodes of G GPUs.  Admission rewrites
the request into one member of an NVLink block,
``nos.nebuly.com/nvlink-block-NxG: 1``, so the partitioner carves the
block over an aligned window of whole nodes in one NVLink domain
(``partitioning/slicepart/group.py``) and the gang scheduler places the
job there (``scheduler/gang.py``).  This is the JAX package's rewrite of
``google.com/tpu`` plus a mesh into a multi-host slice, on the card's
resources; the mesh's dims are not sorted, since N counts nodes and G
GPUs per node.

Two entry points for the two substrates:

- ``normalize_mesh_request(pod)`` mutates a Pod object in place, the
  in-process admission hook of the in-memory API server
  (``install_mesh_normalization``, registered by ``cmd/operator.py``);
- ``mesh_patch_ops(raw_pod)`` returns RFC 6902 JSON-patch ops on the raw
  Kubernetes pod JSON, served by the operator's mutating webhook
  (``kube/webhook.py``).  It works on the raw object, so fields the
  codec does not model are never touched.

The rules, on both paths (JAX's ``api/mesh.py:25-36``):

- the annotation must parse as two dims "NxG" with N >= 2 and G >= 1,
  and N*G must equal the pod's total ``nvidia.com/gpu`` request;
  anything else is left alone and logged (the workload said two
  different things, and admission must not guess);
- a pod already asking for a MIG instance or a block is left alone
  (explicit wins);
- every container that asks for GPUs must ask for the whole count (a
  split across containers is ambiguous), and a GPU request in an init
  container disqualifies the pod (rewriting the main containers alone
  would leave it asking for both resources).  The block replaces
  ``nvidia.com/gpu`` in limits and requests wherever it stood.
"""

from __future__ import annotations

import logging

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.topology.profile import (
    block_dims, is_slice_resource, slice_resource_name,
)

logger = logging.getLogger(__name__)


def _mesh_block(annotations, total_gpus: float) -> str | None:
    """The block profile "NxG" to carve, or None where the pod is not
    eligible."""
    mesh = (annotations or {}).get(C.ANNOT_MESH, "")
    if not mesh or total_gpus <= 0:
        return None
    profile = mesh.lower()
    dims = block_dims(profile)
    if dims is None:
        logger.warning("ignoring %s=%r: not a block of N >= 2 nodes of G "
                       "GPUs (NxG)", C.ANNOT_MESH, mesh)
        return None
    if dims[0] * dims[1] != int(total_gpus):
        logger.warning(
            "%s=%s names %d GPUs but the pod requests %s %s: not "
            "normalizing", C.ANNOT_MESH, mesh, dims[0] * dims[1],
            C.RESOURCE_GPU, total_gpus)
        return None
    return profile


# -- the object path (in-memory substrate) ------------------------------------

def normalize_mesh_request(pod) -> bool:
    """Rewrite a generic GPU request into the mesh's block member; True
    when the pod was changed."""
    from nos_tpu_torch.kube.resources import pod_request

    req = pod_request(pod)
    if any(is_slice_resource(r) for r in req):
        return False
    for c in getattr(pod.spec, "init_containers", None) or []:
        if c.resources.get(C.RESOURCE_GPU, 0):
            return False    # GPUs in an init container: ambiguous
    total = req.get(C.RESOURCE_GPU, 0)
    profile = _mesh_block(pod.metadata.annotations, total)
    if profile is None:
        return False
    for c in pod.spec.containers:
        qty = c.resources.get(C.RESOURCE_GPU, 0)
        if qty and qty != total:
            return False        # split across containers: ambiguous
    res = slice_resource_name(profile)
    changed = False
    for c in pod.spec.containers:
        if c.resources.pop(C.RESOURCE_GPU, None) is not None:
            c.resources[res] = 1
            changed = True
    if changed:
        logger.info("mesh normalization: %s/%s -> %s",
                    pod.metadata.namespace, pod.metadata.name, res)
    return changed


def install_mesh_normalization(api) -> None:
    """Register the mutating admission hook on the in-memory substrate;
    on the REST substrate the same rule runs behind the operator's
    mutating webhook (``mesh_patch_ops``)."""
    def admit(_api, pod) -> None:
        normalize_mesh_request(pod)

    api.register_admission("Pod", admit)


# -- the raw-JSON path (mutating webhook) -------------------------------------

def _esc(token: str) -> str:
    """RFC 6901 pointer-token escaping."""
    return token.replace("~", "~0").replace("/", "~1")


def mesh_patch_ops(raw_pod: dict) -> list[dict] | None:
    """JSON-patch ops normalizing a raw pod, or None for no change.  The
    ops touch only the GPU keys, never whole stanzas."""
    meta = raw_pod.get("metadata") or {}
    spec = raw_pod.get("spec") or {}
    containers = spec.get("containers") or []

    def qty(v) -> float:
        try:
            return float(v)
        except (TypeError, ValueError):
            return 0.0

    for c in spec.get("initContainers") or []:
        res = c.get("resources") or {}
        for section in ("limits", "requests"):
            if C.RESOURCE_GPU in (res.get(section) or {}):
                return None          # GPUs in an init container
    total = 0.0
    for c in containers:
        res = c.get("resources") or {}
        for section in ("limits", "requests"):
            for name in (res.get(section) or {}):
                if is_slice_resource(name):
                    return None          # an explicit instance wins
        total += qty((res.get("limits") or {}).get(C.RESOURCE_GPU, 0))
    profile = _mesh_block(meta.get("annotations"), total)
    if profile is None:
        return None
    block_res = slice_resource_name(profile)
    ops: list[dict] = []
    for i, c in enumerate(containers):
        res = c.get("resources") or {}
        for section in ("limits", "requests"):
            sec = res.get(section) or {}
            if C.RESOURCE_GPU not in sec:
                continue
            if qty(sec[C.RESOURCE_GPU]) != total:
                return None              # split across containers
            base = f"/spec/containers/{i}/resources/{section}"
            ops.append({"op": "remove",
                        "path": f"{base}/{_esc(C.RESOURCE_GPU)}"})
            ops.append({"op": "add",
                        "path": f"{base}/{_esc(block_res)}",
                        "value": "1"})
    return ops or None
