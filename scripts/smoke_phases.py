"""Some of ``chip_smoke.py``'s phases alone on the card, each timed.

    python3 scripts/smoke_phases.py [--root DIR] [--out DIR] PHASE...

PHASE is one of ``elastic`` (the elastic phase: the defrag fleet on the
host, the card's elastic gang), ``fleet`` (phase 19's line: the scale
fleet's plans and cycles) and ``mig_fleet`` (the mig phase's part (a):
the MIG fleet's plans).  The script runs the smoke's environment,
device and kernel-build phases first, then the phases named, in order;
the elastic phase's step-0 loss is not held to the train_main phase's,
which does not run here.  ``--root`` imports ``chip_smoke.py`` from
another checkout (say, the parent commit unpacked with ``git archive``),
so two trees can be timed in one call.  Each phase's whole line goes to
``--out`` (``chiprun_out/phases`` by default) as ``<label>_<phase>.json``,
the label being the root's directory name; stdout gets one JSON line
with the card's ``name, power.limit`` and each phase's seconds.
"""
import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "phases"))
    ap.add_argument("phases", nargs="+",
                    choices=("elastic", "fleet", "mig_fleet"))
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs

    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    label = root.name
    cs.MAIN_LOSS0_RTOL = float("inf")
    t0 = time.perf_counter()
    smi = cs.phase_env()
    device = cs.phase_device()
    cs.phase_build()
    seconds = {"setup": time.perf_counter() - t0}
    runs = {"elastic": lambda: cs.phase_elastic(1.0, device, smi),
            "fleet": lambda: cs._fleet_line(smi),
            "mig_fleet": cs._mig_fleet_plans}
    for phase in args.phases:
        t = time.perf_counter()
        line = runs[phase]()
        seconds[phase] = time.perf_counter() - t
        (out / f"{label}_{phase}.json").write_text(
            json.dumps(line, default=str, indent=1))
    print(json.dumps({"root": label, "smi": smi, "seconds": seconds}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
