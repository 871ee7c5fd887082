"""The capacity provisioner main, ``nos_tpu/cmd/provisioner.py`` for the
port: the cloud node-pool controller (``capacity/``) on the run loop and
leader election every other main uses.

    python -m nos_tpu_torch.cmd.provisioner --config provisioner.json

Off means off: with ``enabled: false`` (the default) the main exits 0
without constructing the capacity plane: no cloud client, no reconcile
loop, no journal record, and a decision journal byte-identical to a
build without the plane.
"""

from __future__ import annotations

import argparse
import logging
import sys

from nos_tpu_torch.api.config import (
    ConfigError, ProvisionerConfig, load_config,
)
from nos_tpu_torch.cmd._runtime import build_api

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML/JSON ProvisionerConfig file")
    args = ap.parse_args(argv)

    try:
        cfg = load_config(args.config, ProvisionerConfig)
    except ConfigError as e:
        print(f"invalid config: {e}", file=sys.stderr)
        return 2
    if not cfg.enabled:
        logger.info("capacity provisioner disabled (enabled: false); "
                    "exiting without constructing the plane")
        return 0
    from nos_tpu_torch.cmd.assembly import build_provisioner_main

    build_provisioner_main(build_api(cfg), cfg).run_until_stopped()
    return 0


if __name__ == "__main__":
    sys.exit(main())
