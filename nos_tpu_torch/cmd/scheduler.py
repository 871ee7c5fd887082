"""The scheduler main, ``nos_tpu/cmd/scheduler.py`` for the port
(reference cmd/scheduler/scheduler.go:43-59, the kube-scheduler rebuilt
with CapacityScheduling): the scheduling cycle as a run loop over the
framework of ``cmd/assembly.build_scheduler``, under an optional lease.

    python -m nos_tpu_torch.cmd.scheduler --config scheduler.json
"""

from __future__ import annotations

import argparse
import logging
import sys

from nos_tpu_torch.api.config import ConfigError, SchedulerConfig, load_config
from nos_tpu_torch.cmd._runtime import Main, build_api
from nos_tpu_torch.cmd.assembly import build_scheduler, log_missing_planes


def build_scheduler_main(api, cfg: SchedulerConfig,
                         main: Main | None = None) -> Main:
    """The scheduler's cycle as a run loop on ``main``; with leader
    election the loop runs only while this replica holds the lease."""
    main = main or Main("nos-tpu-scheduler", cfg.health_probe_addr, api=api)
    log_missing_planes(main.name, cfg)
    scheduler = build_scheduler(
        api, cfg.gpu_memory_gb_per_gpu,
        preempt_budget_per_cycle=cfg.preempt_budget_per_cycle,
        displaced_age_cap_s=cfg.displaced_age_cap_s)
    main.scheduler = scheduler
    if cfg.leader_election:
        from nos_tpu_torch.kube.leaderelection import LeaderElector

        main.attach_leader_election(
            LeaderElector(api, "nos-tpu-scheduler-leader"))
    main.add_loop("scheduler", scheduler.run_cycle, cfg.cycle_interval_s)
    return main


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON SchedulerConfig file")
    args = ap.parse_args(argv)

    try:
        cfg = load_config(args.config, SchedulerConfig)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    build_scheduler_main(build_api(cfg), cfg).run_until_stopped()
    return 0


if __name__ == "__main__":
    sys.exit(main())
