"""Time the scheduler's chip-second waste waterfall on the host: the quota
and gang fleets of ``nos_tpu_torch/testing/fleet.py`` (the runs
chip_smoke.py's quota (a) and gang (a) make) with the waterfall on and
off in turns, in one process.

    python3 scripts/time_waste_waterfall.py [--pairs 8]

Off replaces ``Scheduler._observe_waste`` and the three ``_note_*``
hooks that feed it with no-ops; every other step of ``run_cycle`` runs
as it does.  Each run is one ``fleet.run_quota_fleet``; a pair is one
run each way, the first way alternating between pairs.  One JSON line a
fleet: the median of each run's ``run_cycle`` host ms, per way, the
medians over the runs and the pairs the waterfall lost, after the
card's ``name, power.limit`` from nvidia-smi when it is there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HOOKS = ("_observe_waste", "_note_no_fit", "_note_quota_blocked",
         "_note_stuck_gang")


def main() -> int:
    from nos_tpu_torch.scheduler.scheduler import Scheduler
    from nos_tpu_torch.testing import fleet

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        smi = "no nvidia-smi: host only"
    print(smi)
    hooks = {name: getattr(Scheduler, name) for name in HOOKS}

    def waterfall(on: bool) -> None:
        for name, fn in hooks.items():
            setattr(Scheduler, name,
                    fn if on else (lambda self, *a, **k: None))

    try:
        for spec_of in (fleet.quota_fleet_spec, fleet.gang_fleet_spec):
            spec = spec_of(0)
            runs: dict[str, list[float]] = {"on": [], "off": []}
            lost = 0
            for i in range(args.pairs):
                pair = {}
                for way in (("on", "off") if i % 2 else ("off", "on")):
                    waterfall(way == "on")
                    out = fleet.run_quota_fleet(spec)
                    pair[way] = statistics.median(out["cycle_ms"])
                    runs[way].append(pair[way])
                lost += pair["on"] > pair["off"]
            print(json.dumps({
                "fleet": spec_of.__name__, "pairs": args.pairs,
                "cycle_ms_median": {w: statistics.median(v)
                                    for w, v in runs.items()},
                "cycle_ms_runs": runs, "pairs_slower_with_waterfall": lost}))
    finally:
        waterfall(True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
