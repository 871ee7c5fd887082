"""What the JAX package's own defrag bench decides for its 2-host gang
class: ``bench_defrag.py``'s trace at its own 0.25 s tick and 24 hosts,
one seed, with defrag and grow on and with both off (the bench's
baseline).  Prints one JSON line a run: the gang class's
``gang-admitted`` and ``gang-rejected`` journal records (the elastic
sponges' admissions apart), its jobs, those bound whole, the pods of
its jobs ever bound, and the run's utilisation floor, frag-stranded
and drain chip-seconds.  It reads decisions only and times nothing.

    JAX_PLATFORMS=cpu python scripts/jax_defrag_gangs.py [--seed N]

The port's defrag fleet (``nos_tpu_torch/testing/fleet.py``) runs the
same trace on a 1 s tick; its CPU twin is ``tests/test_torch_defrag.py``.
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench_defrag  # noqa: E402
from nos_tpu.obs import journal as J  # noqa: E402


def gang_figures(seed: int, defrag: bool) -> dict:
    sim = bench_defrag.Sim(seed=seed, defrag=defrag)
    out = sim.run()
    gangs = [j for j in sim.jobs.values() if j.kind == "gang"]
    names = {f"work/{j.name}" for j in gangs}
    ever_bound = {r.subject.rsplit("/", 1)[-1] for r in sim.journal.events(
        category=J.POD_BOUND)}
    admitted = sim.journal.events(category=J.GANG_ADMITTED)
    return {"seed": seed, "defrag_and_grow": defrag,
            "gang_admitted_records": sum(r.subject in names
                                         for r in admitted),
            "gang_rejected_records": sum(
                r.subject in names
                for r in sim.journal.events(category=J.GANG_REJECTED)),
            "sponge_admitted_records": sum(r.subject not in names
                                           for r in admitted),
            "gang_jobs": len(gangs),
            "gang_jobs_bound_whole": sum(j.bound_at is not None
                                         for j in gangs),
            "gang_pods_ever_bound": sum(
                p in ever_bound for j in gangs for p in j.pods),
            "utilization_min": out["utilization_min"],
            "frag_stranded_chip_seconds": out["frag_stranded_chip_seconds"],
            "drain_chip_seconds": out["drain_chip_seconds"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for defrag in (True, False):
        print(json.dumps(gang_figures(args.seed, defrag)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
