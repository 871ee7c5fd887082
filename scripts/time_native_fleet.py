"""Time chip_smoke.py's phase 19 with the native scheduling paths and
without them in turns, in one process: the 1024-node plan
(``_scale_fleet_plans``: the parallel planner at 1 and 4 workers, the native
fit screen on and off) and the 1024-node scheduler cycle
(``_fleet_cycle_run``: the screen and the native choose on and off).

    python3 scripts/time_native_fleet.py [--pairs 10]

A pair is one run each way, the first way alternating between pairs.
Host only: no GPU is touched.  One JSON line a pair (each way's plan
median per worker count, and its cycle's cold, steady p50 and p99 and
backstop ms), then one line of medians over the pairs, the pairs each
way lost and a verdict per metric, after the card's ``name,
power.limit`` from nvidia-smi when it is there.  A metric's verdict is
"on faster" or "on slower" only where that way won at least nine tenths
of the pairs (ties count for neither) and the medians lie further apart
than the interquartile spread of the runs without the native paths;
else it is "unresolved".
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CYCLE_KEYS = ("cold_ms", "steady_p50_ms", "steady_p99_ms", "backstop_ms")


def _iqr(xs: list[float]) -> float:
    if len(xs) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(xs, n=4)
    return q3 - q1


def _verdict(pairs: int, faster: int, slower: int, delta: float,
             spread: float) -> str:
    if abs(delta) <= spread:
        return "unresolved"
    if delta < 0 and faster * 10 >= pairs * 9:
        return "on faster"
    if delta > 0 and slower * 10 >= pairs * 9:
        return "on slower"
    return "unresolved"


def main() -> int:
    import chip_smoke
    from nos_tpu_torch.testing import fleet

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        smi = "no nvidia-smi: host only"
    print(smi, flush=True)
    nodes = fleet.SCALE_DOMAINS * fleet.SCALE_HOSTS_PER_DOMAIN
    # the process's first cycles pay its first-use costs, both ways
    for native in (True, False):
        chip_smoke._fleet_cycle_run(native, fleet.SCALE_HOSTS_PER_DOMAIN,
                                    fleet.SCALE_HOSTS_PER_DOMAIN * 8, 1)
    rows: dict[str, list[dict]] = {"on": [], "off": []}
    for i in range(args.pairs):
        ways = (True, False) if i % 2 == 0 else (False, True)
        plans = chip_smoke._scale_fleet_plans(ways=ways)
        pair = {}
        for native in ways:
            way = "on" if native else "off"
            cycle = chip_smoke._fleet_cycle_run(
                native, nodes, fleet.SCALE_BOUND,
                chip_smoke.FLEET_CYCLE_STEADY)
            pair[way] = {
                **{f"plan_ms_median_workers_{w}":
                   plans[f"{way}_workers_{w}"]["plan_ms_median"]
                   for w in chip_smoke.FLEET_PLAN_WORKERS},
                **{k: cycle[k] for k in CYCLE_KEYS}}
            rows[way].append(pair[way])
        print(json.dumps({"pair": i, "first": "on" if ways[0] else "off",
                          "digest": plans["digest"], **pair}), flush=True)
    keys = list(rows["on"][0])
    median = {way: {k: statistics.median(r[k] for r in runs)
                    for k in keys} for way, runs in rows.items()}
    slower = {k: sum(a[k] > b[k] for a, b in zip(rows["on"], rows["off"]))
              for k in keys}
    faster = {k: sum(a[k] < b[k] for a, b in zip(rows["on"], rows["off"]))
              for k in keys}
    print(json.dumps({
        "pairs": args.pairs, "median": median,
        "pairs_slower_on": slower, "pairs_faster_on": faster,
        "off_iqr": {k: _iqr([r[k] for r in rows["off"]]) for k in keys},
        "verdict": {k: _verdict(args.pairs, faster[k], slower[k],
                                median["on"][k] - median["off"][k],
                                _iqr([r[k] for r in rows["off"]]))
                    for k in keys}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
