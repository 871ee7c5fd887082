"""The metrics exporter main, ``nos_tpu/cmd/metricsexporter.py`` for the
port (reference cmd/metricsexporter/metricsexporter.go:33-91): one shot.
It reads a cluster's state from a dumped state file or from a main's
``/snapshot`` endpoint, collects the payload (``exporter.collect``:
nodes and GPUs by partitioning kind, components, metric series), then
posts it to an endpoint and/or writes it to a file, and exits.

    python -m nos_tpu_torch.cmd.metricsexporter --source state.json \\
        --out /tmp/metrics.json
    python -m nos_tpu_torch.cmd.metricsexporter --source http://127.0.0.1:8080
    python -m nos_tpu_torch.cmd.metricsexporter --endpoint http://host/ingest

A state file is ``kube/serialize.dump_state``'s (or a full ``/snapshot``
payload).  The port's mains answer ``/snapshot`` with 501 until the
chip-second ledger lands (ROADMAP item 9 part 1): against them
``--source http://...`` exits 1 and logs the 501, never an empty
payload.  With no SLO engine in the port the payload has no ``slo`` key
unless the source carried one.  Without ``--source`` the payload
describes an empty cluster.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import urllib.error
import urllib.request

from nos_tpu_torch.exporter import collect
from nos_tpu_torch.kube.client import APIServer

logger = logging.getLogger("nos_tpu_torch.cmd.metricsexporter")


def load_source(source: str) -> tuple[APIServer, dict | None, dict | None]:
    """(APIServer, metric series, SLO report) from a main's /snapshot URL
    or a dumped state file."""
    from nos_tpu_torch.kube.serialize import load_state

    if source.startswith(("http://", "https://")):
        url = source.rstrip("/")
        if not url.endswith("/snapshot"):
            url += "/snapshot"
        with urllib.request.urlopen(url, timeout=10) as resp:
            data = json.load(resp)
        if not isinstance(data, dict):
            raise ValueError(f"snapshot payload is {type(data).__name__}, "
                             f"expected object")
        return (load_state(data.get("state", {})), data.get("metrics"),
                data.get("slo"))
    with open(source) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"state file holds {type(data).__name__}, "
                         f"expected object")
    # a bare dump_state file or a full /snapshot payload
    state = data.get("state", data)
    return load_state(state), data.get("metrics"), data.get("slo")


def export(payload: dict, endpoint: str = "", out: str = "") -> int:
    if out:
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
        logger.info("wrote %s", out)
    if endpoint:
        req = urllib.request.Request(
            endpoint, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                logger.info("POST %s -> %d", endpoint, resp.status)
        except OSError as e:
            logger.error("POST %s failed: %s", endpoint, e)
            return 1
    if not out and not endpoint:
        json.dump(payload, sys.stdout, indent=2)
        print()
    return 0


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", default="",
                    help="a main's /snapshot URL (http://host:port) or a "
                         "dumped state file")
    ap.add_argument("--endpoint", default="", help="POST target URL")
    ap.add_argument("--out", default="", help="write payload to this file")
    args = ap.parse_args(argv)

    metrics_override = None
    slo_report = None
    if args.source:
        try:
            api, metrics_override, slo_report = load_source(args.source)
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            logger.error("cannot read --source %s: HTTP %d: %s",
                         args.source, e.code, body)
            return 1
        except (OSError, ValueError) as e:
            logger.error("cannot read --source %s: %s", args.source, e)
            return 1
    else:
        api = APIServer()
        logger.warning("no --source: exporting an empty cluster snapshot")

    payload = collect(api, components={
        "partitioner": True, "scheduler": True, "operator": True,
    })
    if metrics_override is not None:
        # the observed process's series, not this one-shot's registry
        payload["metrics"] = metrics_override
    if slo_report is not None:
        payload["slo"] = slo_report
    return export(payload, endpoint=args.endpoint, out=args.out)


if __name__ == "__main__":
    sys.exit(main())
