"""The serving replica autoscaler main, ``nos_tpu/cmd/autoscaler.py`` for
the port: the horizontal scaling controller of the inference tier
(``serving/autoscaler.py``) as a leader-elected run loop on the runtime
every other main uses.

    python -m nos_tpu_torch.cmd.autoscaler --config autoscaler.json
"""

from __future__ import annotations

import argparse
import logging
import sys

from nos_tpu_torch.api.config import (
    AutoscalerConfig, ConfigError, load_config,
)
from nos_tpu_torch.cmd._runtime import Main, build_api
from nos_tpu_torch.kube.client import APIServer

logger = logging.getLogger(__name__)


def build_autoscaler_main(api: APIServer, cfg: AutoscalerConfig,
                          main: Main | None = None) -> Main:
    """The autoscaler wired as a leader-gated run loop; returns the Main
    (``main.autoscaler`` is the reconciler, for tests)."""
    from nos_tpu_torch.serving.autoscaler import (
        ReplicaAutoscaler, ServingService,
    )

    main = main or Main("nos-tpu-autoscaler", cfg.health_probe_addr,
                        api=api)
    autoscaler = ReplicaAutoscaler(
        api,
        services=[ServingService.from_mapping(raw)
                  for raw in cfg.services],
        status_configmap=cfg.status_configmap,
        status_namespace=cfg.status_namespace)
    main.autoscaler = autoscaler

    def bind() -> None:
        """The reconcile loop writes (replica create and delete, the
        status ConfigMap), so under leader election it binds only on
        gaining the lease: a standby must not scale."""
        main.add_loop("autoscaler", autoscaler.reconcile,
                      cfg.reconcile_interval_s)

    if cfg.leader_election:
        from nos_tpu_torch.kube.leaderelection import LeaderElector

        main.attach_leader_election(LeaderElector(
            api, "nos-tpu-autoscaler-leader", on_started_leading=bind))
    else:
        bind()
    if cfg.slo_interval_s > 0:
        main.attach_slo(interval_s=cfg.slo_interval_s)
    return main


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON AutoscalerConfig file")
    args = ap.parse_args(argv)

    try:
        cfg = load_config(args.config, AutoscalerConfig)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    build_autoscaler_main(build_api(cfg), cfg).run_until_stopped()
    return 0


if __name__ == "__main__":
    sys.exit(main())
