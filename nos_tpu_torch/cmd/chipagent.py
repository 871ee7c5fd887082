"""The MPS node agent's main, ``nos_tpu/cmd/chipagent.py`` for the port
(reference cmd/gpuagent/gpuagent.go:54-152): the timeshare plugin and
the reporter of one node as a run loop (no actuator), refusing a node
that is not ``mps`` or ``hybrid`` as gpuagent refuses a MIG node
(gpuagent.go:106-114).

    python -m nos_tpu_torch.cmd.chipagent --config chipagent.json
    python -m nos_tpu_torch.cmd.chipagent --node h100-node-0

``model: auto`` discovers the card through NVML with no CUDA context
(``device/discovery.discover(allow_cuda=False)``), so the agent holds no
card memory beside the workloads.  On the in-memory API the agent
registers its own node, with the GPUs it observed; over a kubeconfig a
missing node is a ``ConfigError`` (the kubelet has not registered it,
or ``--node`` is wrong).  Over a kubeconfig, where the kubelet's
device-plugin directory exists, the main also runs a
``TimesharePluginManager`` (``device/deviceplugin``) on the report
interval: one gRPC device plugin per MPS share size, whose replicas
follow the node's allocatable and whose Allocate hands a pod its memory
grant; a shutdown hook stops them.  Where the directory is missing the
agent warns and runs without them, as the JAX main does.  The plugins
need ``grpcio`` and ``protobuf``, which are imported only then.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from nos_tpu_torch.api.config import (
    AgentConfig, ConfigError, MPS_KIND, load_agent_config,
)
from nos_tpu_torch.cmd._runtime import Main, build_api
from nos_tpu_torch.kube.client import APIServer, KIND_NODE, NotFound

logger = logging.getLogger(__name__)


def build_chipagent_main(api: APIServer, cfg: AgentConfig,
                         main: Main | None = None) -> Main:
    from nos_tpu_torch.controllers.chipagent import ChipAgent
    from nos_tpu_torch.device import plugin
    from nos_tpu_torch.topology import DEFAULT_REGISTRY

    if cfg.model == "auto":
        # observe, do not assert, and keep the observed GPU count so the
        # node advertises what is there
        from nos_tpu_torch.device import discovery

        found = discovery.discover(allow_cuda=False)
        model, gpus = found.model, found.num_local_gpus
        logger.info("chipagent: discovered %d x %s (%s)", gpus, model.name,
                    found.source)
    else:
        model, gpus = DEFAULT_REGISTRY.get(cfg.model), None
    try:
        api.get(KIND_NODE, cfg.node_name)
    except NotFound:
        if not isinstance(api, APIServer):
            raise ConfigError(
                f"node {cfg.node_name!r} not found in the cluster "
                f"(kubelet not registered yet, or --node is wrong)")
        from nos_tpu_torch.testing.factory import make_gpu_node

        kw = {} if gpus is None else {"gpus": gpus}
        api.create(KIND_NODE, make_gpu_node(
            cfg.node_name, model=model, partitioning=MPS_KIND, **kw))
    main = main or Main(f"nos-tpu-chipagent-{cfg.node_name}",
                        cfg.health_probe_addr, api=api)
    agent = ChipAgent(api, cfg.node_name, heartbeat=cfg.heartbeat)
    agent.start()  # raises on a MIG node (the gpuagent guard)
    main.agent = agent
    main.add_loop("chipagent", agent.tick, cfg.report_interval_s)
    if cfg.kubeconfig:
        # on a node: advertise the MPS shares to the kubelet as device
        # plugin replicas whose Allocate hands each pod its memory grant
        # (device/workload_env.py enforces it)
        if os.path.isdir(plugin.PLUGINS_DIR):
            from nos_tpu_torch.device.deviceplugin import (
                TimesharePluginManager)

            manager = TimesharePluginManager(
                api, cfg.node_name, plugins_dir=plugin.PLUGINS_DIR,
                kubelet_socket=os.path.join(plugin.PLUGINS_DIR,
                                            "kubelet.sock"))
            main.add_loop("timeshare-plugins", manager.sync,
                          cfg.report_interval_s)
            main.add_shutdown_hook(manager.stop)
        else:
            logger.warning(
                "kubelet device-plugins dir %s missing: timeshare "
                "profiles will not be advertised", plugin.PLUGINS_DIR)
    return main


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON AgentConfig file")
    ap.add_argument("--node", default=None, help="node name override")
    args = ap.parse_args(argv)

    try:
        cfg = load_agent_config(args.config, args.node)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    build_chipagent_main(build_api(cfg), cfg).run_until_stopped()
    return 0


if __name__ == "__main__":
    sys.exit(main())
