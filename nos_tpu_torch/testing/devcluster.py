"""The dev cluster's control plane in memory: the nodes that
``hack/kind/cluster-torch.yaml``'s workers register, the example pods of
``deploy/config-torch/``, and one loop that plans and binds them.

``tests/test_torch_deploy.py`` and ``chip_smoke.py``'s host work run
it, so the files a contributor applies to a kind cluster are the files
the port's partitioner and scheduler are shown to place: a kind worker
has no GPU, and its labels are all the control plane reads of one.
"""

from __future__ import annotations

import pathlib

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.kube.objects import Node, Pod

ROOT = pathlib.Path(__file__).resolve().parents[2]
KIND_CONFIG = ROOT / "hack/kind/cluster-torch.yaml"
EXAMPLES = ROOT / "deploy/config-torch"
EXAMPLE_PODS = ("train-pod-example.yaml", "serving-pod-example.yaml")
# kind's node names: <cluster>-worker, <cluster>-worker2, ...
KIND_CLUSTER = "nos-tpu-torch-dev"
# the loop's clock step and its most ticks: a plan waits out the
# partitioner's idle window, its agent's report, then a cycle binds
TICK_S = 0.25
MAX_TICKS = 200


def kind_worker_labels(path: pathlib.Path = KIND_CONFIG
                       ) -> list[dict[str, str]]:
    """Each worker's ``node-labels`` (kubeletExtraArgs of its
    JoinConfiguration patch), in the config's order."""
    import yaml

    out = []
    for node in yaml.safe_load(path.read_text())["nodes"]:
        if node.get("role") != "worker":
            continue
        labels: dict[str, str] = {}
        for patch in node.get("kubeadmConfigPatches", []):
            join = yaml.safe_load(patch)
            extra = join["nodeRegistration"]["kubeletExtraArgs"]
            for pair in extra.get("node-labels", "").split(","):
                key, _, value = pair.partition("=")
                labels[key] = value
        out.append(labels)
    return out


def kind_nodes(path: pathlib.Path = KIND_CONFIG,
               model: str | None = None) -> list[Node]:
    """The workers as ``make_gpu_node`` builds them from their labels;
    ``model`` (a registry name, e.g. from the card's discovery) replaces
    the accelerator label's."""
    from nos_tpu_torch.testing.factory import make_gpu_node
    from nos_tpu_torch.topology import DEFAULT_REGISTRY

    nodes = []
    for i, labels in enumerate(kind_worker_labels(path)):
        name = f"{KIND_CLUSTER}-worker{i + 1 if i else ''}"
        index = labels.get(C.LABEL_HOST_INDEX)
        nodes.append(make_gpu_node(
            name, model=DEFAULT_REGISTRY.get(
                model or labels[C.LABEL_ACCELERATOR]),
            gpus=int(labels[C.LABEL_GPU_COUNT]),
            partitioning=labels[C.LABEL_PARTITIONING],
            domain=labels.get(C.LABEL_NVLINK_DOMAIN, ""),
            host_index=int(index) if index is not None else None))
    return nodes


def example_pods(directory: pathlib.Path = EXAMPLES) -> list[Pod]:
    """The example pods, decoded as the REST client decodes a pod."""
    import yaml

    from nos_tpu_torch.kube.k8s_codec import from_k8s

    pods = []
    for name in EXAMPLE_PODS:
        doc = yaml.safe_load((directory / name).read_text())
        doc["metadata"].setdefault("namespace", "default")
        pods.append(from_k8s("Pod", doc))
    return pods


def plan_and_bind(nodes: list[Node], pods: list[Pod],
                  max_ticks: int = MAX_TICKS) -> dict:
    """The port's control plane on an in-memory API over ``nodes``: the
    node and pod controllers, a MIG and an MPS partitioner, each node's
    agent (the MIG agent on the fake runtime), the scheduler, all on one
    clock stepped TICK_S a tick.  Creates ``pods`` and ticks until each
    is bound or ``max_ticks`` pass.  Returns {"bound": {pod: node},
    "ticks": n, "geometry": {node: the resources it advertises}}."""
    from nos_tpu_torch.cmd.assembly import build_scheduler
    from nos_tpu_torch.controllers.chipagent import ChipAgent
    from nos_tpu_torch.controllers.node_controller import NodeController
    from nos_tpu_torch.controllers.pod_controller import PodController
    from nos_tpu_torch.controllers.sliceagent.agent import SliceAgent
    from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources
    from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
    from nos_tpu_torch.partitioning.slicepart import SliceNodeInitializer
    from nos_tpu_torch.partitioning.slicepart.factory import (
        new_slice_partitioner_controller)
    from nos_tpu_torch.partitioning.state import ClusterState
    from nos_tpu_torch.partitioning.timeshare.factory import (
        new_timeshare_partitioner_controller)
    from nos_tpu_torch.topology import DEFAULT_REGISTRY

    now = [0.0]

    def clock() -> float:
        return now[0]

    api = APIServer()
    state = ClusterState()
    NodeController(api, state, SliceNodeInitializer(api)).bind()
    PodController(api, state).bind()
    controllers = [
        new_slice_partitioner_controller(api, state, clock=clock),
        new_timeshare_partitioner_controller(api, state, clock=clock)]
    for ctl in controllers:
        ctl.bind()
    agents: dict = {}
    for node in nodes:
        api.create(KIND_NODE, node)
        name = node.metadata.name
        labels = node.metadata.labels
        if labels[C.LABEL_PARTITIONING] == C.MPS_KIND:
            agents[name] = ChipAgent(api, name)
        else:
            agents[name] = SliceAgent(
                api, name, FakeGpuRuntime(
                    DEFAULT_REGISTRY.get(labels[C.LABEL_ACCELERATOR]),
                    int(labels[C.LABEL_GPU_COUNT])),
                FakePodResources())
        agents[name].start()
    scheduler = build_scheduler(api, clock=clock)
    for pod in pods:
        api.create(KIND_POD, pod)
    keys = {(p.metadata.namespace, p.metadata.name) for p in pods}
    bound: dict[str, str] = {}
    ticks = 0
    try:
        while len(bound) < len(keys) and ticks < max_ticks:
            ticks += 1
            now[0] += TICK_S
            scheduler.run_cycle()
            for ctl in controllers:
                ctl.process_if_ready()
            for name in sorted(agents):
                agents[name].tick()
            bound = {p.metadata.name: p.spec.node_name
                     for p in api.list(KIND_POD)
                     if (p.metadata.namespace, p.metadata.name) in keys
                     and p.spec.node_name}
    finally:
        scheduler.close()
    geometry = {}
    for node in api.list(KIND_NODE):
        geometry[node.metadata.name] = {
            res: qty for res, qty in sorted(node.status.allocatable.items())
            if res.startswith(("nvidia.com/mig-", "nvidia.com/gpu-"))
            and qty > 0}
    return {"bound": bound, "ticks": ticks, "geometry": geometry}
