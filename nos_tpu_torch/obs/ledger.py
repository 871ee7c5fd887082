"""The chip-second waste ledger, ``nos_tpu/obs/ledger.py`` for the port:
utilization accounting whose categories always add up.

A utilization of 0.95 says that five percent of the fleet's GPU time
went somewhere; the ledger says where.  It integrates each pool's
capacity over time and books every second of every GPU to exactly one
category, each step joined to its evidence in the journal (the gang
whose assembly stalled, the class whose rejections strand capacity, the
plan id of an actuation window).  A pool is an NVLink domain ("-" for
the unlabelled nodes).

In the port a "chip" is one GPU: capacity is a node's
``nvidia.com/gpu.count`` and a second of one GPU is one chip-second.
The metric keeps the JAX package's name, ``nos_tpu_chip_seconds_total``,
since the SLO objectives and the dashboards read it.

Categories (``CATEGORIES``):

- ``productive``: GPUs held by bound pods (``pod_chip_equiv``);
- ``frag_stranded``: free GPUs on nodes every pending class was
  rejected on this cycle (the scheduler's own Filter verdicts);
- ``gang_wait``: free GPUs a stuck gang could use, capped at its
  demand;
- ``actuation``: free GPUs on a node between a plan and its status
  catching up (the partitioner controller's hold);
- ``quarantine``: free GPUs on a quarantined node;
- ``quota_stranded``: free GPUs over-quota demand could use but the
  quotas forbid, capped at that demand;
- ``drain``: free GPUs on a node a migration drains;
- ``provisioning``: free GPUs on a node the capacity plane is still
  landing (the provisioner's hold, ``capacity/provisioner.py``);
- ``idle_no_demand``: the rest.

Per pool, the sum over categories equals the integral of capacity:
``observe`` installs a waterfall normalised to the capacity, and both
sides integrate the same sample over the same interval.

As the journal: memory is bounded by the cluster (per-pool sums and a
hold map per node), the lock is a leaf (held for the update only; the
metric is bumped after it is released), and the clock is injectable,
so virtual-clock runs give the same waterfall every time.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Collection, Mapping

from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.utils.guards import guarded_by

REGISTRY.describe("nos_tpu_chip_seconds_total",
                  "GPU-seconds attributed per waste category and pool "
                  "(conservation: sum over categories == capacity x time)")

PRODUCTIVE = "productive"
FRAG_STRANDED = "frag_stranded"
GANG_WAIT = "gang_wait"
ACTUATION = "actuation"
QUARANTINE = "quarantine"
QUOTA_STRANDED = "quota_stranded"
DRAIN = "drain"
PROVISIONING = "provisioning"
IDLE_NO_DEMAND = "idle_no_demand"

CATEGORIES: tuple[str, ...] = (
    PRODUCTIVE, FRAG_STRANDED, GANG_WAIT, ACTUATION, QUARANTINE,
    QUOTA_STRANDED, DRAIN, PROVISIONING, IDLE_NO_DEMAND,
)

#: every category but productive; idle with no demand last by convention
WASTE_CATEGORIES: tuple[str, ...] = tuple(
    c for c in CATEGORIES if c != PRODUCTIVE)

#: the holds an owning subsystem stamps on a node, strongest first: they
#: attribute the node's free GPUs before the scheduler's verdicts do
HOLD_PRECEDENCE: tuple[str, ...] = (QUARANTINE, ACTUATION, DRAIN,
                                    PROVISIONING)

# a whole GPU's compute slices: a MIG instance <g>g.<N>gb is g of them
_COMPUTE_SLICES = 7


def stranded_free(free_by_host: Mapping[str, float],
                  stranded_hosts: Collection[str]) -> float:
    """Free GPUs summed over the hosts flagged stranded: the one
    stranded-free sum, shared by ``obs top``'s frag column and the
    ledger, which differ only in how the flags are derived."""
    return sum(f for h, f in free_by_host.items()
               if f > 0.0 and h in stranded_hosts)


def stranded_fraction(free_by_host: Mapping[str, float],
                      stranded_hosts: Collection[str]) -> float:
    """The stranded share of the free capacity (0.0 with none free)."""
    free = sum(f for f in free_by_host.values() if f > 0.0)
    if free <= 0.0:
        return 0.0
    return stranded_free(free_by_host, stranded_hosts) / free


def pod_chip_equiv(request: Mapping[str, float], gpus_per_host: float,
                   gb_per_gpu: float) -> float:
    """The GPUs one request occupies on its node: a MIG instance its
    compute slices (g/7 of a GPU, each capped at ``gpus_per_host``, as
    the JAX package caps a slice at the host shard), an NVLink block
    member its node's G GPUs (a member asks for the whole NxG block but
    owns one node of it), an MPS share its GB over ``gb_per_gpu``.  A whole ``nvidia.com/gpu`` counts nothing, as
    the JAX package's ``google.com/tpu`` does: its rule reads slice and
    timeshare resources only.  The scheduler's productive accounting and
    the fleets share this currency."""
    from nos_tpu_torch.topology.profile import (
        PROFILE_RE, block_dims, extract_slice_requests,
        extract_timeshare_requests,
    )

    gpus = 0.0
    for profile, qty in extract_slice_requests(request).items():
        m = PROFILE_RE.match(profile)
        if m is None:
            gpus += float(block_dims(profile)[1]) * qty
            continue
        g = int(m.group("g"))
        gpus += min(g / _COMPUTE_SLICES, gpus_per_host) * qty
    gb = sum(float(g) * q
             for g, q in extract_timeshare_requests(request).items())
    if gb_per_gpu > 0.0:
        gpus += gb / gb_per_gpu
    return gpus


@guarded_by("_lock", "_holds", "_cur", "_cap", "_since", "_elapsed",
            "_totals", "_cap_seconds", "_evidence", "_overcommit",
            "_last_quota_flip")
class ChipSecondLedger:
    """Per-pool GPU-second accounting with exact conservation.

    ``observe(pools)`` is the one accrual entry point (the scheduler
    calls it at cycle end): the previous waterfall accrues over the
    elapsed interval, then the new one is installed.  Owning call sites
    stamp per-node holds (actuation windows, quarantine, drains) between
    observes; the scheduler reads them when it attributes.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic
                 ) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        # (node, hold kind, owner) -> detail: the owner tells the MIG and
        # MPS planes apart on one hybrid node
        self._holds: dict[tuple[str, str, str], dict[str, object]] = {}
        # each pool's current waterfall (GPUs), capacity and accrual stamp
        self._cur: dict[str, dict[str, float]] = {}
        self._cap: dict[str, float] = {}
        self._since: dict[str, float] = {}
        # integrals
        self._elapsed: dict[str, float] = {}
        self._totals: dict[str, dict[str, float]] = {}
        self._cap_seconds: dict[str, float] = {}
        # the newest evidence per pool and category, kept after its
        # window passes, so the report can always name the culprit
        self._evidence: dict[str, dict[str, dict[str, object]]] = {}
        self._overcommit = 0
        self._last_quota_flip: dict[str, object] | None = None

    # -- holds (owning call sites) ------------------------------------------
    def set_hold(self, node: str, category: str, owner: str = "",
                 **detail: object) -> None:
        """Stamp a hold on ``node``'s free GPUs; idempotent per (node,
        category, owner).  ``detail`` is the evidence (plan id,
        quarantine reason, drain cause)."""
        with self._lock:
            self._holds[(node, category, owner)] = dict(detail)

    def clear_hold(self, node: str, category: str,
                   owner: str = "") -> None:
        with self._lock:
            self._holds.pop((node, category, owner), None)

    def holds(self) -> dict[str, dict[str, dict[str, object]]]:
        """node -> hold kind -> detail (a node held by any owner reads
        held)."""
        with self._lock:
            items = list(self._holds.items())
        out: dict[str, dict[str, dict[str, object]]] = {}
        for (node, kind, _owner), detail in items:
            out.setdefault(node, {}).setdefault(kind, detail)
        return out

    def hold_count(self) -> int:
        with self._lock:
            return len(self._holds)

    # -- quota evidence ------------------------------------------------------
    def note_quota_flip(self, pod_key: str, namespace: str,
                        borrowed: bool) -> None:
        """A quota reconciler's borrow or reclaim label flip: the newest
        one is ``quota_stranded``'s hint (whose borrowing last moved)."""
        with self._lock:
            self._last_quota_flip = {
                "pod": pod_key, "namespace": namespace,
                "borrowed": borrowed,
            }

    # -- accrual -------------------------------------------------------------
    def observe(self, pools: Mapping[str, Mapping[str, object]]) -> None:
        """Accrue the previous waterfall up to now, then install this
        one.  ``pools[pool]`` carries ``capacity`` (GPUs),
        ``categories`` ({category: GPUs}) and optionally ``evidence``
        ({category: {...}}).  The categories are normalised to sum to
        the capacity: a positive residual is ``idle_no_demand``; a sum
        over the capacity (a caller's fault) is scaled down and counted.
        A pool missing from the call stops accruing (its nodes left);
        its integrals are kept."""
        now = self._clock()
        incs: list[tuple[str, str, float]] = []
        with self._lock:
            for pool in list(self._cur):
                self._accrue_pool_locked(pool, now, incs)
            self._cur = {}
            self._cap = {}
            for pool, sample in pools.items():
                capacity = float(sample.get("capacity", 0.0))  # type: ignore[arg-type]
                raw = sample.get("categories") or {}
                cats = {c: float(v) for c, v in raw.items()  # type: ignore[union-attr]
                        if c in CATEGORIES and float(v) > 0.0}
                assigned = sum(cats.values())
                residual = capacity - assigned
                if residual > 0.0:
                    cats[IDLE_NO_DEMAND] = \
                        cats.get(IDLE_NO_DEMAND, 0.0) + residual
                elif residual < -1e-9 and assigned > 0.0:
                    scale = capacity / assigned
                    cats = {c: v * scale for c, v in cats.items()}
                    self._overcommit += 1
                self._cur[pool] = cats
                self._cap[pool] = capacity
                self._since[pool] = now
                evidence = sample.get("evidence") or {}
                if evidence:
                    pool_ev = self._evidence.setdefault(pool, {})
                    for cat, why in evidence.items():  # type: ignore[union-attr]
                        if cat in CATEGORIES and isinstance(why, dict):
                            pool_ev[cat] = dict(why)
        for pool, cat, delta in incs:
            REGISTRY.inc("nos_tpu_chip_seconds_total", delta,
                         labels={"category": cat, "pool": pool})

    def _accrue_pool_locked(self, pool: str, now: float,
                            incs: list[tuple[str, str, float]]) -> None:
        since = self._since.get(pool)
        if since is None or now <= since:
            return
        dt = now - since
        self._since[pool] = now
        totals = self._totals.setdefault(pool, {})
        for cat, gpus in self._cur.get(pool, {}).items():
            if gpus <= 0.0:
                continue
            totals[cat] = totals.get(cat, 0.0) + gpus * dt
            incs.append((pool, cat, gpus * dt))
        self._cap_seconds[pool] = self._cap_seconds.get(pool, 0.0) \
            + self._cap.get(pool, 0.0) * dt
        self._elapsed[pool] = self._elapsed.get(pool, 0.0) + dt

    # -- reads ---------------------------------------------------------------
    def conservation(self) -> dict[str, dict[str, float]]:
        """Per pool: the categories' GPU-seconds against the capacity's
        integral, and their delta."""
        with self._lock:
            out: dict[str, dict[str, float]] = {}
            for pool, cap_s in self._cap_seconds.items():
                total = sum(self._totals.get(pool, {}).values())
                out[pool] = {
                    "sum_chip_seconds": total,
                    "capacity_chip_seconds": cap_s,
                    "delta": total - cap_s,
                }
            return out

    def report(self) -> dict:
        """The waterfall served in ``/snapshot`` and
        ``/debug/flightrecorder`` and rendered by ``obs waste``: per
        pool the GPU-second totals, their fractions of capacity, the
        conservation delta and the culprits' evidence, and a fleet
        rollup.  The keys are the JAX package's."""
        with self._lock:
            pools: dict[str, dict] = {}
            fleet_totals: dict[str, float] = {}
            fleet_cap_s = 0.0
            for pool in sorted(set(self._cap_seconds) | set(self._cur)):
                totals = dict(self._totals.get(pool, {}))
                cap_s = self._cap_seconds.get(pool, 0.0)
                fleet_cap_s += cap_s
                for cat, v in totals.items():
                    fleet_totals[cat] = fleet_totals.get(cat, 0.0) + v
                pools[pool] = {
                    "capacity_chips": self._cap.get(pool, 0.0),
                    "elapsed_s": self._elapsed.get(pool, 0.0),
                    "capacity_chip_seconds": cap_s,
                    "chip_seconds": totals,
                    "fractions": {
                        cat: (v / cap_s if cap_s > 0.0 else 0.0)
                        for cat, v in totals.items()},
                    "conservation_delta":
                        sum(totals.values()) - cap_s,
                    "evidence": {
                        cat: dict(why) for cat, why
                        in self._evidence.get(pool, {}).items()},
                }
            flip = (dict(self._last_quota_flip)
                    if self._last_quota_flip else None)
            overcommit = self._overcommit
        return {
            "categories": list(CATEGORIES),
            "pools": pools,
            "fleet": {
                "capacity_chip_seconds": fleet_cap_s,
                "chip_seconds": fleet_totals,
                "fractions": {
                    cat: (v / fleet_cap_s if fleet_cap_s > 0.0 else 0.0)
                    for cat, v in fleet_totals.items()},
                "conservation_delta":
                    sum(fleet_totals.values()) - fleet_cap_s,
            },
            "overcommit_events": overcommit,
            "quota_last_flip": flip,
        }


def conservation_ok(report: dict, epsilon: float = 1e-6) -> bool:
    """True when every pool of a ``report()`` conserves GPU-seconds
    within ``epsilon``, relative to the pool's capacity integral with an
    absolute floor for a near-empty pool."""
    for pool in report.get("pools", {}).values():
        cap_s = pool.get("capacity_chip_seconds", 0.0)
        tol = max(epsilon, epsilon * cap_s)
        if abs(pool.get("conservation_delta", 0.0)) > tol:
            return False
    return True


def check_conservation(report: dict, what: str,
                       epsilon: float = 1e-6) -> dict:
    """``report`` itself when it conserves, else RuntimeError naming
    ``what`` and each pool's delta: a run whose waterfall does not add
    up fails, never reports."""
    if not conservation_ok(report, epsilon):
        deltas = {p: v.get("conservation_delta")
                  for p, v in report.get("pools", {}).items()}
        raise RuntimeError(f"{what}: the waste waterfall does not "
                           f"conserve GPU-seconds: {deltas}")
    return report


def waste_ranking(report: dict) -> list[dict]:
    """The waste categories by fleet GPU-seconds, largest first (zero
    rows dropped): ``obs waste``'s top sources."""
    fleet = report.get("fleet", {})
    totals = fleet.get("chip_seconds", {})
    fractions = fleet.get("fractions", {})
    rows = [
        {"category": cat, "chip_seconds": totals.get(cat, 0.0),
         "fraction": fractions.get(cat, 0.0)}
        for cat in WASTE_CATEGORIES if totals.get(cat, 0.0) > 0.0
    ]
    rows.sort(key=lambda r: -float(r["chip_seconds"]))  # type: ignore[arg-type]
    return rows


# The process ledger, swappable like the journal: always present, so a
# call site needs no None check; runs on a virtual clock install their
# own (``obs.scoped``).
_ledger = ChipSecondLedger()


def get_ledger() -> ChipSecondLedger:
    return _ledger


def set_ledger(ledger: ChipSecondLedger) -> ChipSecondLedger:
    global _ledger
    prev = _ledger
    _ledger = ledger
    return prev
