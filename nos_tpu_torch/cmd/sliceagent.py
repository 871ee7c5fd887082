"""The MIG node agent's main, ``nos_tpu/cmd/sliceagent.py`` for the port
(reference cmd/migagent/migagent.go:56-199): the per-node agent's
startup cleanup of carved devices no pod holds, then its reporter and
actuator on a report-interval run loop.

    python -m nos_tpu_torch.cmd.sliceagent --config sliceagent.json
    python -m nos_tpu_torch.cmd.sliceagent --node h100-mig-0 --device cpu

``--device`` picks the GPU runtime, as the port's entry points do:
``cuda`` (the default) is NVML on the card (``NvmlGpuRuntime``, which
creates MIG devices only on a GPU in MIG mode and keeps NVLink block
shards of GPUs with MIG mode off in memory), ``cpu`` the stateful fake
(``FakeGpuRuntime``).  ``model: auto``
takes the model and the GPU count from that runtime.  On the in-memory
API the agent registers its own node; over a kubeconfig a missing node
is a ``ConfigError``.  Over a kubeconfig the used devices come from
the kubelet's pod-resources socket (``KubeletPodResourcesClient``,
``device/podresources``): without the socket the agent refuses to start
(an empty used set would make the startup cleanup delete instances that
back running pods).  Where the kubelet's device-plugin directory exists
a ``DevicePluginManager`` (``device/deviceplugin``) advertises the
carved MIG devices to the kubelet, synced on every actuation's refresh,
and a shutdown hook stops it; where it is missing the agent warns and
runs without it.  Both need ``grpcio`` and ``protobuf``, which are
imported only then.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from nos_tpu_torch.api.config import (
    AgentConfig, ConfigError, MIG_KIND, load_agent_config,
)
from nos_tpu_torch.cmd._runtime import Main, build_api
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, NotFound

logger = logging.getLogger(__name__)


def build_agent_main(api: APIServer, cfg: AgentConfig,
                     main: Main | None = None,
                     device: str = "cuda") -> Main:
    from nos_tpu_torch.controllers.sliceagent import SliceAgent
    from nos_tpu_torch.device import default_gpu_runtime, plugin
    from nos_tpu_torch.device.fake import FakePodResources
    from nos_tpu_torch.topology import DEFAULT_REGISTRY

    if cfg.model == "auto":
        # the node advertises the GPUs observed, not a default count
        runtime = default_gpu_runtime(None, device=device)
        name, mig_modes = runtime.topology()
        model, gpus = DEFAULT_REGISTRY.get(name), len(mig_modes)
    else:
        model = DEFAULT_REGISTRY.get(cfg.model)
        runtime, gpus = default_gpu_runtime(model, device=device), None
    try:
        api.get(KIND_NODE, cfg.node_name)
    except NotFound:
        if not isinstance(api, APIServer):
            # never make up a node in a cluster: a mistyped --node would
            # have the planner carve hardware that is not there
            raise ConfigError(
                f"node {cfg.node_name!r} not found in the cluster "
                f"(kubelet not registered yet, or --node is wrong)")
        from nos_tpu_torch.testing.factory import make_gpu_node

        kw = {} if gpus is None else {"gpus": gpus}
        api.create(KIND_NODE, make_gpu_node(
            cfg.node_name, model=model, partitioning=MIG_KIND, **kw))
    # the used devices follow the same switch as the API (kubeconfig):
    # the kubelet's pod-resources socket on a cluster, the fake in memory
    plugin_manager = None
    if cfg.kubeconfig:
        if not os.path.exists(plugin.POD_RESOURCES_SOCKET):
            raise ConfigError(
                f"kubeconfig is set but the kubelet pod-resources socket "
                f"{plugin.POD_RESOURCES_SOCKET} does not exist — mount "
                f"/var/lib/kubelet/pod-resources into the agent pod")
        from nos_tpu_torch.device.podresources import (
            KubeletPodResourcesClient)

        pod_resources = KubeletPodResourcesClient(plugin.POD_RESOURCES_SOCKET)
        if os.path.isdir(plugin.PLUGINS_DIR):
            from nos_tpu_torch.device.deviceplugin import DevicePluginManager

            plugin_manager = DevicePluginManager(
                runtime, plugins_dir=plugin.PLUGINS_DIR,
                kubelet_socket=os.path.join(plugin.PLUGINS_DIR,
                                            "kubelet.sock"))
        else:
            logger.warning(
                "kubelet device-plugins dir %s missing: MIG devices will "
                "not be advertised to the kubelet", plugin.PLUGINS_DIR)
    else:
        pod_resources = FakePodResources()
    main = main or Main(f"nos-tpu-sliceagent-{cfg.node_name}",
                        cfg.health_probe_addr, api=api)
    agent = SliceAgent(api, cfg.node_name, runtime, pod_resources,
                       plugin_manager=plugin_manager,
                       heartbeat=cfg.heartbeat)
    if plugin_manager is not None:
        main.add_shutdown_hook(plugin_manager.stop)
    # startup cleanup and a first report (migagent.go:190-199)
    doomed = agent.start()
    logger.info("startup cleanup deleted %d devices: %s", len(doomed),
                sorted(doomed))
    main.agent = agent
    main.add_loop("sliceagent", agent.tick, cfg.report_interval_s)
    return main


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON AgentConfig file")
    ap.add_argument("--node", default=None, help="node name override")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the GPU runtime: NVML on the card, or the fake")
    args = ap.parse_args(argv)

    try:
        cfg = load_agent_config(args.config, args.node)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    build_agent_main(build_api(cfg), cfg,
                     device=args.device).run_until_stopped()
    return 0


if __name__ == "__main__":
    sys.exit(main())
