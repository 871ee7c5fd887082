"""The operator main, ``nos_tpu/cmd/operator.py`` for the port (reference
cmd/operator/operator.go:50-126): the ElasticQuota and
CompositeElasticQuota reconcilers, watch-driven plus a periodic resync,
with their validating webhooks registered and, when ``webhook_port`` is
set, served over HTTPS (``kube/webhook.WebhookServer``).

    python -m nos_tpu_torch.cmd.operator --config operator.json

Left out: the JAX operator's mesh normalization (``api/mesh.py``, its
in-process hook and its mutating webhook), which rewrites TPU chip
counts into ICI slice shapes; it comes with ROADMAP item 7.2.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from nos_tpu_torch.api.config import ConfigError, OperatorConfig, load_config
from nos_tpu_torch.api.elasticquota import install_quota_webhooks
from nos_tpu_torch.cmd._runtime import Main, build_api
from nos_tpu_torch.cmd.assembly import log_missing_planes
from nos_tpu_torch.controllers.elasticquota import (
    CompositeElasticQuotaReconciler, ElasticQuotaReconciler,
)
from nos_tpu_torch.kube.client import APIServer
from nos_tpu_torch.quota import GPUResourceCalculator

logger = logging.getLogger(__name__)


def _serve_admission_webhook(api, cfg: OperatorConfig):
    """Start the AdmissionReview endpoint with the validators
    ``install_quota_webhooks`` registered: on the REST substrate the
    ``KubeClient`` collected them (``api.admission``); the in-memory
    substrate enforces them in-process, so serving there builds a
    handler of its own (parity and tests)."""
    from nos_tpu_torch.api.elasticquota import (
        validate_composite_elastic_quota, validate_elastic_quota,
    )
    from nos_tpu_torch.kube.client import (
        KIND_COMPOSITE_ELASTIC_QUOTA, KIND_ELASTIC_QUOTA,
    )
    from nos_tpu_torch.kube.webhook import AdmissionHandler, WebhookServer

    handler = getattr(api, "admission", None)
    if handler is None:
        handler = AdmissionHandler(api)
        handler.register(KIND_ELASTIC_QUOTA, validate_elastic_quota)
        handler.register(KIND_COMPOSITE_ELASTIC_QUOTA,
                         validate_composite_elastic_quota)
    cert = key = None
    if cfg.webhook_cert_dir:
        cert = os.path.join(cfg.webhook_cert_dir, "tls.crt")
        key = os.path.join(cfg.webhook_cert_dir, "tls.key")
    # OperatorConfig.validate refuses webhook_port > 0 without a cert
    # dir, so only a test driving this helper reaches the insecure path
    server = WebhookServer(handler, port=cfg.webhook_port,
                           cert_file=cert, key_file=key,
                           allow_insecure=not cfg.webhook_cert_dir)
    server.start()
    return server


def build_operator_main(api: APIServer, cfg: OperatorConfig,
                        main: Main | None = None) -> Main:
    main = main or Main("nos-tpu-operator", cfg.health_probe_addr, api=api)
    log_missing_planes(main.name, cfg)
    install_quota_webhooks(api)
    if cfg.webhook_port > 0:
        main.webhook = _serve_admission_webhook(api, cfg)
        main.add_shutdown_hook(main.webhook.stop)
    elif hasattr(api, "admission"):
        # REST with webhook_port 0: the validators were collected but
        # nothing serves them, so the kube-apiserver cannot consult us
        # and duplicate or overlapping quotas go in unchecked
        logger.warning(
            "admission validators registered for %s but webhook_port=0: "
            "no AdmissionReview endpoint is serving them — quota "
            "admission is UNENFORCED on the REST substrate (set "
            "webhook_port and webhook_cert_dir, and install the chart's "
            "ValidatingWebhookConfiguration)",
            api.admission.kinds)
    calc = GPUResourceCalculator(cfg.gpu_memory_gb_per_gpu)

    def bind_reconcilers() -> None:
        """The reconcilers write (quota status, overlap deletion), so
        under leader election they bind only on gaining the lease."""
        eq = ElasticQuotaReconciler(api, calc)
        ceq = CompositeElasticQuotaReconciler(api, calc)
        eq.bind()
        ceq.bind()

        def resync() -> None:
            eq.reconcile_all()
            ceq.reconcile_all()

        main.add_loop("quota-resync", resync, cfg.resync_interval_s)

    if cfg.leader_election:
        from nos_tpu_torch.kube.leaderelection import LeaderElector

        main.attach_leader_election(LeaderElector(
            api, "nos-tpu-operator-leader",
            on_started_leading=bind_reconcilers))
    else:
        bind_reconcilers()
    return main


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON OperatorConfig file")
    args = ap.parse_args(argv)

    try:
        cfg = load_config(args.config, OperatorConfig)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    build_operator_main(build_api(cfg), cfg).run_until_stopped()
    return 0


if __name__ == "__main__":
    sys.exit(main())
