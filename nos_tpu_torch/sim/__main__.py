"""``python -m nos_tpu_torch.sim``: replay the composed worst-week
scenario, ``nos_tpu/sim/__main__.py`` for the port.

Default: the full week at 10,000 nodes of 8 GPUs.  ``--smoke`` is the
CI-sized day (480 nodes) that exercises every fault class in seconds.
The process exits non-zero if the chip-second ledger breaks
conservation or any SLO breach lacks an injected-fault explanation:
that is the gate.  The simulator runs in virtual time on the host and
never touches a GPU, so it takes no ``--device``.

``--what-if hosts=+N`` / ``--what-if quota=ns:frac,...`` replays the
identical seeded week against the modified fleet and adds a
``what_if`` forecast block (utilisation, SLO and waste deltas) to the
report.

stdout is ONE JSON document (the ``sim/report.py`` contract); progress
and diagnostics go to stderr.  ``--report`` (or ``SIM_REPORT_PATH``)
also writes the pretty-printed artifact.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace
from typing import Callable, Optional, Sequence

from .report import emit, stdout_to_stderr, write_report
from .worstweek import (
    DAY_S, WorstWeek, WorstWeekConfig, parse_what_if, run_what_if)


def build_config(args: argparse.Namespace) -> WorstWeekConfig:
    cfg = WorstWeekConfig(seed=args.seed)
    if args.smoke:
        cfg = cfg.smoke()
    if args.hosts is not None:
        per_pool = min(cfg.hosts_per_pool, max(1, args.hosts // 4))
        cfg = replace(cfg, hosts=args.hosts, hosts_per_pool=per_pool)
    if args.days is not None:
        cfg = replace(cfg, horizon_s=args.days * DAY_S)
    return cfg


def main(argv: Optional[Sequence[str]] = None,
         wall_clock: Callable[[], float] = time.perf_counter) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m nos_tpu_torch.sim",
        description="event-driven worst-week fleet scenario + "
                    "what-if capacity planner")
    parser.add_argument("--smoke", action="store_true",
                        help="CI-sized scenario (one day, ~500 hosts)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--hosts", type=int, default=None,
                        help="override fleet size (default 10000, "
                             "smoke 480)")
    parser.add_argument("--days", type=float, default=None,
                        help="override horizon in days")
    parser.add_argument("--what-if", dest="what_if", default="",
                        help="hosts=+N | quota=ns:frac,... — forecast "
                             "deltas against the same seeded week")
    parser.add_argument("--report", default=os.environ.get(
        "SIM_REPORT_PATH", ""),
        help="also write the pretty JSON artifact here "
             "(default: $SIM_REPORT_PATH)")
    args = parser.parse_args(argv)
    if args.what_if:
        # Reject a malformed spec before the (expensive) base run, with
        # a usage error instead of a post-run traceback.
        try:
            parse_what_if(args.what_if)
        except ValueError as e:
            parser.error(str(e))

    cfg = build_config(args)
    with stdout_to_stderr() as real_stdout:
        print(f"worst-week: {cfg.hosts} hosts, "
              f"{cfg.horizon_s / DAY_S:g} days, seed {cfg.seed}",
              file=sys.stderr)
        report = WorstWeek(cfg).run(wall_clock=wall_clock)
        if args.what_if:
            report["what_if"] = run_what_if(
                cfg, args.what_if, base_report=report,
                wall_clock=wall_clock)
        write_report(args.report, report, note="sim report")
        emit(report, real_stdout)

    ok = (report["ledger"]["conservation_ok"]
          and report["unexplained_breaches"] == 0)
    if not ok:
        print("worst-week GATE FAILED: "
              f"conservation_ok={report['ledger']['conservation_ok']} "
              f"unexplained_breaches={report['unexplained_breaches']}",
              file=sys.stderr)
    else:
        print(f"worst-week ok: {report['events']} events in "
              f"{report['wall_s']}s wall "
              f"({report['sim_speedup']}x real time), "
              f"conservation delta "
              f"{report['ledger']['conservation_delta']}, "
              f"{len(report['breaches'])} explained breaches",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
