"""The partitioner main, ``nos_tpu/cmd/partitioner.py`` for the port
(reference cmd/gpupartitioner/gpupartitioner.go:72-268): the node and
pod state controllers and the batching partitioner controller of each
configured kind, as run loops with graceful shutdown.

    python -m nos_tpu_torch.cmd.partitioner --config partitioner.json
    python -m nos_tpu_torch.cmd.partitioner --sim 4      # demo cluster

With a ``kubeconfig`` in the config it runs against that cluster's
kube-apiserver, otherwise against an in-memory API that holds nothing
until ``--sim N`` fills it: N one-GPU H100 nodes in MIG mode, each with
a MIG node agent on a fake GPU runtime (a simulation asked for by the
flag: ``default_gpu_runtime(device="cpu")``), a scheduler and a 3g.40gb
pod a node; the main logs when every pod is bound and Running.
"""

from __future__ import annotations

import argparse
import logging
import sys

from nos_tpu_torch.api.config import ConfigError, PartitionerConfig, load_config
from nos_tpu_torch.cmd._runtime import build_api
from nos_tpu_torch.cmd.assembly import build_partitioner_main, build_scheduler
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.partitioning.state import ClusterState

logger = logging.getLogger("nos_tpu_torch.cmd.partitioner")

SIM_PROFILE = "3g.40gb"


def add_sim(main, api: APIServer, hosts: int) -> None:
    """The demo cluster: nodes, their agents and a scheduler as run
    loops, and one pod a node."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.controllers.sliceagent import SliceAgent
    from nos_tpu_torch.device import default_gpu_runtime
    from nos_tpu_torch.device.fake import FakePodResources
    from nos_tpu_torch.kube.client import KIND_NODE, KIND_POD
    from nos_tpu_torch.kube.objects import RUNNING
    from nos_tpu_torch.testing.factory import make_gpu_node, make_mig_pod
    from nos_tpu_torch.topology import H100_80GB

    for i in range(hosts):
        name = f"host-{i}"
        api.create(KIND_NODE, make_gpu_node(
            name, model=H100_80GB, gpus=1, partitioning=C.MIG_KIND,
            domain="nvl-0", host_index=i))
        agent = SliceAgent(api, name,
                           default_gpu_runtime(H100_80GB, device="cpu"),
                           FakePodResources())
        agent.start()
        main.add_loop(f"sliceagent-{name}", agent.tick, 0.05)
    scheduler = build_scheduler(api)
    main.add_loop("scheduler", scheduler.run_cycle, 0.05)

    demand = [make_mig_pod(SIM_PROFILE, name=f"sim-{i}")
              for i in range(hosts)]
    state = {"submitted": False, "done": False}

    def submit_and_watch() -> None:
        if not state["submitted"]:
            for p in demand:
                api.create(KIND_POD, p)
            state["submitted"] = True
            logger.info("sim: submitted %d pods", len(demand))
            return
        if state["done"]:
            return
        bound = sum(1 for p in api.list(KIND_POD)
                    if p.spec.node_name and p.status.phase == RUNNING)
        if bound == len(demand):
            state["done"] = True
            logger.info("sim: all %d pods bound — demo converged", bound)

    main.add_loop("sim-workload", submit_and_watch, 0.2)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON PartitionerConfig file")
    ap.add_argument("--sim", type=int, default=0, metavar="HOSTS",
                    help="bootstrap an in-process demo cluster")
    args = ap.parse_args(argv)

    try:
        cfg = load_config(args.config, PartitionerConfig)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    api = build_api(cfg)
    m, _ = build_partitioner_main(api, ClusterState(), cfg)
    if args.sim:
        add_sim(m, api, args.sim)
    m.run_until_stopped()
    return 0


if __name__ == "__main__":
    sys.exit(main())
