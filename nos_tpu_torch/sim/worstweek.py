"""The composed worst-week scenario and the what-if capacity planner,
``nos_tpu/sim/worstweek.py`` for the port.

One simulated week at 10,000 nodes where every fault class the fleets
exercise separately lands on the same fleet: background node loss all
week, a kill **storm** inside a zonal **stockout** (replacements cannot
land), rolling **maintenance drains**, a **quota storm** re-splitting
team shares mid-week, all under a **diurnal serving load**; in seconds
of wall time, because the engine only pays for events that happen.

In the port a chip is one GPU and a host is an 8-GPU node, so the
default fleet is 10,000 nodes of 8 GPUs (80,000 GPUs) in 25 pools.  The
fleet is modelled at pool granularity: a pool is a capacity counter (a
placement and failure pool of one zone), not the API-object fleet the
scenario harness (``scenario.py``) assembles, since a week of full
scheduling cycles over 10,000 nodes is exactly the tick-loop cost the
event engine exists to avoid.  A 400-node pool is not an NVLink domain:
no H100 NVLink domain is that large.  The model holds no hardware
figure, so every number is the JAX package's: the job classes' sizes
(64, 128 and 256 GPUs for training), the rates, the windows, the SLO
targets and the seeds, and a run reproduces JAX's report exactly, less
its wall time.  No GPU is touched.

What stays real is the observation plane: the ``ChipSecondLedger``
(conservation asserted on its own accrual math), the ``SLOEngine``
judging registry metrics over burn-rate windows, and the
``DecisionJournal`` receiving its breach and recovery records, so the
gates this scenario enforces are the production invariants.

Conservation is exact by construction: the ledger normalizes every
waterfall sample to capacity, so the categories sum to the integral of
capacity at any observe cadence; samples land every ``sample_period_s``
and at every fault transition, so attribution is sharp where it
matters.  An SLO breach is **explained** when its onset lies within an
injected fault window (plus the judging lag of the slow burn window);
the gate is zero *unexplained* breaches, not zero breaches.

What-if planning replays the identical seeded event stream against a
modified fleet (``hosts=+N``) or a re-split quota table
(``quota=ns:frac,...``); demand is pinned to the *base* fleet, so the
forecast isolates the capacity decision, and reports utilisation, SLO
and waste deltas.  The report's keys and the ``nos_tpu_sim_*`` metric
names are the JAX package's, byte for byte, so reports compare.
"""

from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.obs import scoped as obs_scoped
from nos_tpu_torch.obs.journal import DecisionJournal
from nos_tpu_torch.obs.ledger import (
    ChipSecondLedger, DRAIN, FRAG_STRANDED, PRODUCTIVE, PROVISIONING,
    QUOTA_STRANDED, conservation_ok)
from nos_tpu_torch.obs.slo import (
    GAUGE_FLOOR, LATENCY, RATE_CEILING, SLOEngine, SLOObjective)
from nos_tpu_torch.obs.timeseries import TimeSeriesSampler
from nos_tpu_torch.serving.trace import DiurnalTrace

from .engine import PRIO_FAULT, SimEngine
from .trace import (
    ArrivalSource, AtSource, NodeKillSource, SamplerSource, TraceSource,
    WindowSource, compose)

DAY_S = 86_400.0

UTIL_GAUGE = "nos_tpu_sim_fleet_utilization"
WAIT_HIST = "nos_tpu_sim_job_wait_seconds"
KILLS_TOTAL = "nos_tpu_sim_node_kills_total"

REGISTRY.describe("nos_tpu_sim_fleet_utilization",
                  "Busy fraction of live chips across the simulated fleet")
REGISTRY.describe("nos_tpu_sim_job_wait_seconds",
                  "Arrival-to-start wait per simulated job, by class")
REGISTRY.describe("nos_tpu_sim_node_kills_total",
                  "Simulated node kills (background churn + storms)")

#: (size choices, weights, mean duration s) per workload class — sized
#: so a ~0.85 target utilization costs a few hundred thousand events a
#: week, not millions.
_CLASSES: dict[str, tuple[tuple[int, ...], tuple[float, ...], float]] = {
    "train": ((64, 128, 256), (0.5, 0.3, 0.2), 7200.0),
    "serve": ((16, 32), (0.6, 0.4), 3600.0),
    "research": ((32, 64), (0.5, 0.5), 5400.0),
}
_NAMESPACES = ("train", "serve", "research")


@dataclass(frozen=True)
class WorstWeekConfig:
    """The declarative worst-week knobs.  ``demand_hosts`` pins the
    demand level (defaults to ``hosts``); what-if runs change ``hosts``
    only, so forecasts isolate the capacity decision."""

    seed: int = 0
    hosts: int = 10_000
    demand_hosts: int = 0               # 0 => hosts
    hosts_per_pool: int = 400
    chips_per_host: int = 8
    zones: int = 4
    horizon_s: float = 7 * DAY_S
    sample_period_s: float = 600.0
    util_target: float = 0.85
    # quota shares (min fraction of fleet; borrow headroom x1.5)
    quota_fracs: tuple[tuple[str, float], ...] = (
        ("train", 0.50), ("serve", 0.30), ("research", 0.20))
    borrow_factor: float = 1.5
    # faults
    kill_rate_per_host_week: float = 0.003
    provision_delay_s: float = 600.0
    storm_t: float = 2 * DAY_S
    storm_kills: int = 20
    storm_spacing_s: float = 30.0
    stockout_window: tuple[float, float] = (2 * DAY_S, 6 * 3600.0)
    stockout_zone: str = "z0"
    maintenance_t: float = 3 * DAY_S
    maintenance_pools: int = 4
    maintenance_window_s: float = 2 * 3600.0
    maintenance_stagger_s: float = 3 * 3600.0
    quota_storm_window: tuple[float, float] = (4 * DAY_S, 12 * 3600.0)
    quota_storm_fracs: tuple[tuple[str, float], ...] = (
        ("train", 0.65), ("serve", 0.15), ("research", 0.20))
    # SLOs
    slo_fast_window_s: float = 1800.0
    slo_slow_window_s: float = 7200.0
    wait_p99_target_s: float = 1800.0       # interactive classes
    train_wait_p99_target_s: float = 4 * 3600.0  # gangs queue for hours
    util_floor: float = 0.35
    kill_rate_ceiling_per_s: float = 0.005

    def smoke(self) -> "WorstWeekConfig":
        """The CI-sized week: one day, ~500 hosts, same composition —
        every fault class still fires, minutes become seconds."""
        return replace(
            self, hosts=480, hosts_per_pool=60, horizon_s=DAY_S,
            sample_period_s=60.0,
            kill_rate_per_host_week=0.02,
            storm_t=0.3 * DAY_S, storm_kills=6, storm_spacing_s=20.0,
            stockout_window=(0.3 * DAY_S, 3600.0),
            maintenance_t=0.5 * DAY_S, maintenance_pools=2,
            maintenance_window_s=1800.0, maintenance_stagger_s=2700.0,
            quota_storm_window=(0.7 * DAY_S, 3 * 3600.0),
            slo_fast_window_s=600.0, slo_slow_window_s=1800.0)


@dataclass
class _Job:
    name: str
    namespace: str
    chips: int
    duration: float
    arrived: float
    pool: str = ""
    started: float = -1.0
    state: str = "pending"          # pending | running | done


@dataclass
class _Pool:
    name: str
    zone: str
    live_chips: float
    busy_chips: float = 0.0
    provisioning_chips: float = 0.0
    draining: bool = False
    running: dict[str, _Job] = field(default_factory=dict)


class WorstWeek:
    """One seeded worst-week run: the fleet model plus the composed
    trace.  ``run()`` drains the engine and returns the report dict."""

    def __init__(self, cfg: WorstWeekConfig) -> None:
        self.cfg = cfg
        self.engine = SimEngine()
        clock = self.engine.now
        self.ledger = ChipSecondLedger(clock=clock)
        self.journal = DecisionJournal(maxlen=100_000, clock=clock)
        self.slo_engine = SLOEngine(
            TimeSeriesSampler(clock=clock, maxlen=4096),
            self._objectives(),
            fast_window_s=cfg.slo_fast_window_s,
            slow_window_s=cfg.slo_slow_window_s, clock=clock)

        n_pools = max(1, cfg.hosts // cfg.hosts_per_pool)
        per_pool = cfg.hosts / n_pools * cfg.chips_per_host
        self.pools: dict[str, _Pool] = {}
        for i in range(n_pools):
            name = f"pool-{i:03d}"
            self.pools[name] = _Pool(
                name=name, zone=f"z{i % cfg.zones}", live_chips=per_pool)
        self.total_chips = sum(
            p.live_chips for p in self.pools.values())
        demand_hosts = cfg.demand_hosts or cfg.hosts
        self.demand_chips = float(
            demand_hosts * cfg.chips_per_host)

        self.quota_fracs: dict[str, float] = dict(cfg.quota_fracs)
        self.usage: dict[str, float] = {ns: 0.0 for ns in _NAMESPACES}
        self.pending: dict[str, deque[_Job]] = {
            ns: deque() for ns in _NAMESPACES}
        self._job_seq = 0
        self._stalled_joins: dict[str, list[str]] = {}   # zone -> pools
        self._stockout_zones: set[str] = set()
        self._fault_windows: list[tuple[str, float, float]] = []
        self._breach_state: dict[tuple[str, str], bool] = {}
        self.breaches: list[dict] = []
        self.kills = 0
        self.completed = 0
        self.evicted = 0
        self.waits: dict[str, list[float]] = {ns: [] for ns in _NAMESPACES}
        self._util_samples: list[float] = []
        self._rng_kill_pool = _pick_cycler(self.pools)
        self._class_rngs: dict[str, random.Random] = {
            ns: random.Random(cfg.seed * 100 + i)
            for i, ns in enumerate(_NAMESPACES)}

        base_users, peak_users = 200_000.0, 1_000_000.0
        self.diurnal = DiurnalTrace(
            seed=cfg.seed + 7, period_s=DAY_S,
            base_users=base_users, peak_users=peak_users,
            burst_rate_per_s=1.0 / 3600.0, burst_multiplier=2.0,
            burst_duration_s=600.0, horizon_s=cfg.horizon_s)
        # mean in-flight load over a day (burst-free): normalizes the
        # serving arrival-rate curve so its MEAN hits the quota share
        self._diurnal_mean_load = (
            0.5 * (base_users + peak_users) * 2e-5 * 0.5)

    # -- SLOs ---------------------------------------------------------------
    def _objectives(self) -> list[SLOObjective]:
        """Every registered SLO: interactive classes promise sub-30-min
        p99 queue waits, train gangs get an hours-scale bar (queueing a
        256-chip gang is capacity planning, not an incident), the fleet
        promises a utilization floor and a node-loss rate ceiling."""
        cfg = self.cfg
        return [
            SLOObjective(
                name="sim_fleet_util_floor", kind=GAUGE_FLOOR,
                metric=UTIL_GAUGE, target=cfg.util_floor),
            SLOObjective(
                name="sim_serve_wait_p99", kind=LATENCY,
                metric=WAIT_HIST, target=cfg.wait_p99_target_s,
                labels=(("class", "serve"),)),
            SLOObjective(
                name="sim_research_wait_p99", kind=LATENCY,
                metric=WAIT_HIST, target=cfg.wait_p99_target_s,
                labels=(("class", "research"),)),
            SLOObjective(
                name="sim_train_wait_p99", kind=LATENCY,
                metric=WAIT_HIST,
                target=cfg.train_wait_p99_target_s,
                labels=(("class", "train"),)),
            SLOObjective(
                name="sim_node_kill_rate", kind=RATE_CEILING,
                metric=KILLS_TOTAL,
                target=cfg.kill_rate_ceiling_per_s),
        ]

    # -- trace composition ---------------------------------------------------
    def sources(self) -> list[TraceSource]:
        cfg = self.cfg
        out: list[TraceSource] = []
        # cold-start: the fleet fills from empty, so early floor/wait
        # verdicts are the ramp, not an incident — an explained window
        self._note_window("warmup", 0.0, cfg.slo_slow_window_s)
        for i, ns in enumerate(_NAMESPACES):
            sizes, weights, mean_dur = _CLASSES[ns]
            mean_size = sum(s * w for s, w in zip(sizes, weights))
            share = self.quota_fracs[ns]
            base_rate = (cfg.util_target * self.demand_chips * share
                         / (mean_size * mean_dur))
            if ns == "serve":
                ref = self._diurnal_mean_load
                peak = base_rate * 4.0
                rate_fn: Callable[[float], float] = (
                    lambda t, b=base_rate, r=ref:
                    b * self.diurnal.load_at(t) / r)
            else:
                peak = base_rate
                rate_fn = lambda _t, b=base_rate: b  # noqa: E731
            out.append(ArrivalSource(
                cfg.seed * 1000 + i, rate_fn,
                (lambda t, n=ns: self._arrive(n, t)),
                peak_rate=peak, until=cfg.horizon_s,
                label=f"arrival/{ns}"))
        # background node loss, all week
        bg_rate = (cfg.hosts * cfg.kill_rate_per_host_week
                   / (7 * DAY_S))
        out.append(NodeKillSource(
            cfg.seed * 1000 + 17, bg_rate, self._kill_host,
            until=cfg.horizon_s))
        # the storm: a burst of kills inside the stockout zone …
        storm_times = [cfg.storm_t + k * cfg.storm_spacing_s
                       for k in range(cfg.storm_kills)]
        out.append(AtSource(
            storm_times,
            (lambda t: self._kill_host(t, zone=cfg.stockout_zone)),
            label="kill-storm"))
        self._note_window("kill-storm", storm_times[0],
                          storm_times[-1] - storm_times[0]
                          + cfg.provision_delay_s)
        # … while that zone is stocked out (replacements cannot land)
        out.append(WindowSource(
            [cfg.stockout_window],
            (lambda _t: self._stockout_open(cfg.stockout_zone)),
            (lambda _t: self._stockout_close(cfg.stockout_zone)),
            label="stockout"))
        self._note_window("stockout", *cfg.stockout_window,
                          extra=cfg.provision_delay_s)
        # rolling maintenance drains
        pool_names = sorted(self.pools)
        for k in range(min(cfg.maintenance_pools, len(pool_names))):
            pool = pool_names[-(k + 1)]    # drain from the tail pools
            start = cfg.maintenance_t + k * cfg.maintenance_stagger_s
            out.append(WindowSource(
                [(start, cfg.maintenance_window_s)],
                (lambda _t, p=pool: self._drain(p, True)),
                (lambda _t, p=pool: self._drain(p, False)),
                label=f"maintenance/{pool}"))
            self._note_window(f"maintenance/{pool}", start,
                              cfg.maintenance_window_s)
        # the quota storm: a mid-week re-split of team shares
        out.append(WindowSource(
            [cfg.quota_storm_window],
            (lambda _t: self._requota(dict(cfg.quota_storm_fracs))),
            (lambda _t: self._requota(dict(cfg.quota_fracs))),
            label="quota-storm"))
        self._note_window("quota-storm", *cfg.quota_storm_window)
        # observation: ledger + registry + SLO judgement
        out.append(SamplerSource(
            cfg.sample_period_s, self._sample,
            until=cfg.horizon_s, label="obs"))
        return out

    def _note_window(self, label: str, start: float, duration: float,
                     extra: float = 0.0) -> None:
        grace = (self.cfg.slo_slow_window_s
                 + 2 * self.cfg.sample_period_s + extra)
        self._fault_windows.append((label, start,
                                    start + duration + grace))

    # -- fleet model ---------------------------------------------------------
    def _arrive(self, ns: str, t: float) -> None:
        sizes, weights, mean_dur = _CLASSES[ns]
        rng = self._class_rngs[ns]
        size = rng.choices(sizes, weights=weights, k=1)[0]
        duration = mean_dur * (0.5 + rng.random())
        self._job_seq += 1
        job = _Job(name=f"{ns}-{self._job_seq}", namespace=ns,
                   chips=size, duration=duration, arrived=t)
        self.pending[ns].append(job)
        self._try_schedule(t)

    def _quota_allows(self, ns: str, chips: float) -> bool:
        cap = (self.quota_fracs[ns] * self.cfg.borrow_factor
               * self.total_chips)
        return self.usage[ns] + chips <= cap

    def _find_pool(self, chips: float) -> Optional[_Pool]:
        """Deterministic first-fit: the fullest pool that still fits
        (best-fit packs domains; ties break by name)."""
        best: Optional[_Pool] = None
        for name in sorted(self.pools):
            p = self.pools[name]
            if p.draining:
                continue
            free = p.live_chips - p.busy_chips
            if free >= chips and (
                    best is None
                    or free < best.live_chips - best.busy_chips):
                best = p
        return best

    def _try_schedule(self, t: float) -> None:
        progressed = True
        while progressed:
            progressed = False
            for ns in _NAMESPACES:
                q = self.pending[ns]
                if not q:
                    continue
                job = q[0]
                if not self._quota_allows(ns, job.chips):
                    continue
                pool = self._find_pool(job.chips)
                if pool is None:
                    continue
                q.popleft()
                self._start(job, pool, t)
                progressed = True

    def _start(self, job: _Job, pool: _Pool, t: float) -> None:
        job.state = "running"
        job.pool = pool.name
        job.started = t
        pool.busy_chips += job.chips
        pool.running[job.name] = job
        self.usage[job.namespace] += job.chips
        wait = t - job.arrived
        self.waits[job.namespace].append(wait)
        REGISTRY.observe("nos_tpu_sim_job_wait_seconds", wait,
                         labels={"class": job.namespace},
                         buckets=(30.0, 60.0, 120.0, 300.0, 600.0,
                                  1200.0, 1800.0, 3600.0, 7200.0,
                                  14_400.0, 28_800.0))
        self.engine.after(job.duration,
                          (lambda j=job: self._complete(j)),
                          priority=PRIO_FAULT, label="complete")

    def _complete(self, job: _Job) -> None:
        if job.state != "running":
            return                      # evicted before finishing
        self._release(job)
        job.state = "done"
        self.completed += 1
        self._try_schedule(self.engine.now())

    def _release(self, job: _Job) -> None:
        pool = self.pools[job.pool]
        pool.busy_chips -= job.chips
        pool.running.pop(job.name, None)
        self.usage[job.namespace] -= job.chips

    def _kill_host(self, t: float, zone: str = "") -> None:
        """One host dies: capacity shrinks by a host's chips, any work
        it carried restarts from the queue, and a replacement is
        ordered (landing only when its zone is not stocked out)."""
        name = self._rng_kill_pool(zone)
        if name is None:
            return
        pool = self.pools[name]
        cph = float(self.cfg.chips_per_host)
        if pool.live_chips < cph:
            return                      # pool already fully dark
        pool.live_chips -= cph
        self.kills += 1
        REGISTRY.inc("nos_tpu_sim_node_kills_total")
        # evict youngest-first until the survivors fit
        for jname in sorted(pool.running,
                            key=lambda n: (-pool.running[n].started, n)):
            if pool.busy_chips <= pool.live_chips:
                break
            job = pool.running[jname]
            self._release(job)
            job.state = "pending"
            job.pool = ""
            self.evicted += 1
            self.pending[job.namespace].appendleft(job)
        pool.provisioning_chips += cph
        self.engine.after(self.cfg.provision_delay_s,
                          (lambda p=name: self._join(p)),
                          priority=PRIO_FAULT, label="replacement")
        self._observe_ledger()
        self._try_schedule(t)

    def _join(self, pool_name: str) -> None:
        pool = self.pools[pool_name]
        if pool.zone in self._stockout_zones:
            # the cloud has no capacity in this zone: the create stalls
            # until the stockout clears, then re-provisions
            self._stalled_joins.setdefault(pool.zone, []).append(
                pool_name)
            return
        cph = float(self.cfg.chips_per_host)
        pool.provisioning_chips -= cph
        pool.live_chips += cph
        self._observe_ledger()
        self._try_schedule(self.engine.now())

    def _stockout_open(self, zone: str) -> None:
        self._stockout_zones.add(zone)
        self._observe_ledger()

    def _stockout_close(self, zone: str) -> None:
        self._stockout_zones.discard(zone)
        for pool_name in self._stalled_joins.pop(zone, []):
            self.engine.after(self.cfg.provision_delay_s,
                              (lambda p=pool_name: self._join(p)),
                              priority=PRIO_FAULT, label="replacement")
        self._observe_ledger()

    def _drain(self, pool_name: str, draining: bool) -> None:
        self.pools[pool_name].draining = draining
        self._observe_ledger()
        if not draining:
            self._try_schedule(self.engine.now())

    def _requota(self, fracs: dict[str, float]) -> None:
        self.quota_fracs = fracs
        self._observe_ledger()
        self._try_schedule(self.engine.now())

    # -- observation ---------------------------------------------------------
    def _observe_ledger(self) -> None:
        """Install the current waterfall.  Attribution per pool:
        productive = busy; drain = idle chips of a draining pool;
        provisioning = ordered-but-not-joined replacements;
        quota_stranded / frag_stranded = idle chips explained by a
        blocked head-of-line job; the ledger normalizes the residual
        into idle_no_demand and keeps Σ ≡ capacity exactly."""
        quota_blocked = 0.0
        frag_blocked = False
        for ns in _NAMESPACES:
            q = self.pending[ns]
            if not q:
                continue
            head = q[0]
            if not self._quota_allows(ns, head.chips):
                quota_blocked += head.chips
            elif self._find_pool(head.chips) is None:
                frag_blocked = True
        sample: dict[str, dict[str, object]] = {}
        for name in sorted(self.pools):
            p = self.pools[name]
            free = max(0.0, p.live_chips - p.busy_chips)
            cats: dict[str, float] = {PRODUCTIVE: p.busy_chips}
            if p.provisioning_chips > 0.0:
                cats[PROVISIONING] = p.provisioning_chips
            if p.draining and free > 0.0:
                cats[DRAIN] = free
            elif frag_blocked and free > 0.0:
                cats[FRAG_STRANDED] = free
            elif quota_blocked > 0.0 and free > 0.0:
                grab = min(free, quota_blocked)
                cats[QUOTA_STRANDED] = grab
                quota_blocked -= grab
            sample[name] = {
                "capacity": p.live_chips + p.provisioning_chips,
                "categories": cats,
            }
        self.ledger.observe(sample)

    def _sample(self, t: float) -> None:
        live = sum(p.live_chips for p in self.pools.values())
        busy = sum(p.busy_chips for p in self.pools.values())
        util = busy / live if live > 0.0 else 0.0
        self._util_samples.append(util)
        REGISTRY.set("nos_tpu_sim_fleet_utilization", util)
        self._observe_ledger()
        for verdict in self.slo_engine.tick():
            key = (str(verdict["objective"]), str(verdict["class"]))
            was = self._breach_state.get(key, False)
            now_breached = bool(verdict["breached"])
            if now_breached and not was:
                self.breaches.append(self._episode(key, t, verdict))
            self._breach_state[key] = now_breached

    def _episode(self, key: tuple[str, str], t: float,
                 verdict: dict) -> dict:
        causes = sorted(label for label, start, end
                        in self._fault_windows if start <= t <= end)
        return {
            "objective": key[0], "class": key[1], "t": t,
            "value": verdict["value"],
            "explained": bool(causes), "explained_by": causes,
        }

    # -- run ----------------------------------------------------------------
    def run(self, wall_clock: Callable[[], float] = time.perf_counter
            ) -> dict:
        REGISTRY.reset()
        wall_0 = wall_clock()
        with obs_scoped(journal=self.journal, engine=self.slo_engine,
                        ledger=self.ledger):
            for src in compose(*self.sources()).sources:
                src.install(self.engine)
            # deterministic install: compose() sorts by label
            events = self.engine.run(until=self.cfg.horizon_s)
            self._observe_ledger()      # close the final accrual span
        wall_s = wall_clock() - wall_0
        ledger_report = self.ledger.report()
        unexplained = [b for b in self.breaches if not b["explained"]]
        return {
            "scenario": "worst-week",
            "seed": self.cfg.seed,
            "hosts": self.cfg.hosts,
            "pools": len(self.pools),
            "horizon_s": self.cfg.horizon_s,
            "events": events,
            "wall_s": round(wall_s, 3),
            "sim_speedup": round(self.cfg.horizon_s / wall_s, 1)
            if wall_s > 0 else None,
            "jobs": {
                "completed": self.completed,
                "evicted": self.evicted,
                "pending_at_end": sum(
                    len(q) for q in self.pending.values()),
            },
            "kills": self.kills,
            "utilization": {
                "mean": (sum(self._util_samples)
                         / len(self._util_samples)
                         if self._util_samples else 0.0),
                "min": (min(self._util_samples)
                        if self._util_samples else 0.0),
            },
            "wait_p99_s": {ns: _quantile(self.waits[ns], 0.99)
                           for ns in _NAMESPACES},
            "ledger": {
                "conservation_ok": conservation_ok(ledger_report),
                "conservation_delta": ledger_report["fleet"][
                    "conservation_delta"],
                "fractions": ledger_report["fleet"]["fractions"],
            },
            "slo": self.slo_engine.report(),
            "breaches": self.breaches,
            "unexplained_breaches": len(unexplained),
            "journal_entries": len(self.journal.events()),
        }


def _pick_cycler(pools: dict[str, _Pool]
                 ) -> Callable[[str], Optional[str]]:
    """Deterministic victim picker: round-robins pool names, with its
    own cursor per zone filter so a storm targeting one zone never
    perturbs the background-kill sequence."""
    state: dict[str, int] = {}

    def pick(zone: str = "") -> Optional[str]:
        names = sorted(n for n, p in pools.items()
                       if not zone or p.zone == zone)
        if not names:
            return None
        i = state.get(zone, 0)
        state[zone] = i + 1
        return names[i % len(names)]

    return pick


def _quantile(values: list[float], q: float) -> Optional[float]:
    if not values:
        return None
    xs = sorted(values)
    idx = min(len(xs) - 1, int(q * len(xs)))
    return xs[idx]


# -- what-if capacity planning ----------------------------------------------

def parse_what_if(spec: str) -> dict:
    """``hosts=+400`` / ``hosts=-200`` / ``quota=train:0.6,serve:0.2,
    research:0.2`` → a patch dict for ``run_what_if``."""
    key, _, value = spec.partition("=")
    key = key.strip()
    if key == "hosts":
        return {"hosts_delta": int(value)}
    if key == "quota":
        fracs: list[tuple[str, float]] = []
        for part in value.split(","):
            ns, _, frac = part.partition(":")
            fracs.append((ns.strip(), float(frac)))
        total = sum(f for _, f in fracs)
        if abs(total - 1.0) > 1e-6:
            raise ValueError(
                f"quota re-split must sum to 1.0 (got {total})")
        return {"quota_fracs": tuple(fracs)}
    raise ValueError(f"unknown what-if spec {spec!r} "
                     "(want hosts=+N or quota=ns:frac,...)")


def apply_what_if(cfg: WorstWeekConfig, patch: dict) -> WorstWeekConfig:
    """The modified config: demand stays pinned to the base fleet."""
    base_demand = cfg.demand_hosts or cfg.hosts
    out = replace(cfg, demand_hosts=base_demand)
    if "hosts_delta" in patch:
        out = replace(out, hosts=cfg.hosts + int(patch["hosts_delta"]))
    if "quota_fracs" in patch:
        out = replace(out, quota_fracs=patch["quota_fracs"])
    return out


def run_what_if(cfg: WorstWeekConfig, spec: str,
                base_report: Optional[dict] = None,
                wall_clock: Callable[[], float] = time.perf_counter
                ) -> dict:
    """Replay the identical seeded week against the modified fleet and
    report the forecast deltas — the capacity-planner answer to "what
    would +N hosts (or this re-split) have bought us last week?"."""
    patch = parse_what_if(spec)
    if base_report is None:
        base_report = WorstWeek(cfg).run(wall_clock=wall_clock)
    forecast = WorstWeek(apply_what_if(cfg, patch)).run(
        wall_clock=wall_clock)

    def _summary(r: dict) -> dict:
        return {
            "hosts": r["hosts"],
            "util_mean": r["utilization"]["mean"],
            "wait_p99_s": r["wait_p99_s"],
            "breaches": len(r["breaches"]),
            "unexplained_breaches": r["unexplained_breaches"],
            "productive_fraction": r["ledger"]["fractions"].get(
                "productive", 0.0),
        }

    base_s, fc_s = _summary(base_report), _summary(forecast)
    return {
        "spec": spec,
        "base": base_s,
        "forecast": fc_s,
        "delta": {
            "hosts": fc_s["hosts"] - base_s["hosts"],
            "util_mean": fc_s["util_mean"] - base_s["util_mean"],
            "breaches": fc_s["breaches"] - base_s["breaches"],
            "productive_fraction": (fc_s["productive_fraction"]
                                    - base_s["productive_fraction"]),
            "wait_p99_s": {
                ns: ((fc_s["wait_p99_s"][ns] or 0.0)
                     - (base_s["wait_p99_s"][ns] or 0.0))
                for ns in _NAMESPACES},
        },
    }
