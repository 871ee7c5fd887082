"""ParallelGeometryPlanner: planning sharded over independent plan pools,
``nos_tpu/partitioning/core/parallel.py`` for the port.

The sequential planner replans the whole cluster for every pending
batch.  This planner splits the snapshot into plan pools (GPU model +
NVLink domain, ``pools.py``), plans every pool on a worker pool over its
own copy-on-write sub-snapshot, and merges the pools' desired states in
pool-key order (shards own disjoint node sets, so the merge is a union
without conflicts).

- **One pool is the sequential planner**: with one pool, or fewer nodes
  than ``min_shard_hosts``, the plan is delegated whole to one
  sequential planner; no shard runs.
- **Shards share nothing mutable**: each has its own planner (its own
  ``Framework``, whose plugin lock would otherwise serialise them) and
  its own sub-snapshot sharing node objects only across disjoint name
  sets.  The journal, the span ring and the metrics registry are reached
  through their own locks.
- **Observability**: each shard runs in a ``plan_shard`` span parented
  under the caller's span (the submitting thread's context is copied
  into the worker through ``contextvars``), observes
  ``nos_tpu_plan_shard_seconds{pool}``, and the merge journals one
  PLAN_SHARD_MERGED record.
- **Journal determinism**: a shard records its decisions into a
  ``JournalCapture`` of its own, and the merge replays them in pool-key
  order, so the journal is a function of the inputs, never of thread
  timing: it is the same at every ``plan_workers``.

Python threads hold the GIL while they plan, so shards overlap only
inside the native fit screen's calls (``scheduler/native_filter.py``:
ctypes releases the GIL for each), one a candidate node;
``chip_smoke.py``'s recovery phase (a) and fleet phase (a) measure what
sharding costs on the card's host.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable

from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.objects import Pod
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import (
    JournalCapture, MAX_JOURNAL_NODES, capture_records,
    record as journal_record,
)
from nos_tpu_torch.obs.trace import span as obs_span
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY, GpuModelRegistry

from ..state import PartitioningState
from .interfaces import Planner, SliceCalculator
from .pools import PlanPool, partition_pools, split_pods
from .snapshot import ClusterSnapshot

REGISTRY.describe("nos_tpu_plan_shard_seconds",
                  "Per-pool shard planning time within one parallel plan")
REGISTRY.describe("nos_tpu_plan_shards_total",
                  "Plan shards executed by the parallel planner")

# Below this many snapshot nodes the planner stays sequential by
# default: sharding pays at fleet scale, and the sequential path is what
# small clusters are held to.
PLAN_SHARD_MIN_HOSTS = 128


def default_plan_workers() -> int:
    """The worker pool's size when not configured: bounded by the host."""
    return max(2, min(16, os.cpu_count() or 4))


class ParallelGeometryPlanner(Planner):
    def __init__(self, planner_factory: Callable[[], Planner],
                 calculator: SliceCalculator,
                 kind: str = "",
                 registry: GpuModelRegistry = DEFAULT_REGISTRY,
                 max_workers: int = 0,
                 min_shard_hosts: int = 0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        """``planner_factory`` builds one sequential planner per shard
        slot, each on a fresh Framework.  Sharding engages when the
        snapshot holds more than one pool and at least
        ``min_shard_hosts`` nodes (0: whenever there are two pools)."""
        self._factory = planner_factory
        self._calculator = calculator
        self._kind = kind
        self._registry = registry
        self._max_workers = max_workers or default_plan_workers()
        self._min_shard_hosts = min_shard_hosts
        self._clock = clock
        self._sequential = planner_factory()
        self._pool_lock = threading.Lock()
        self._executor: ThreadPoolExecutor | None = None
        # one reused planner per shard slot: the sequential planners
        # keep no state between plans, and plan() is not reentrant (the
        # controller's loop is its one caller), so slot i belongs to
        # shard i of the running plan
        self._shard_planners: list[Planner] = []
        # the last plan's seconds per pool key, replaced whole per plan
        self.last_shard_seconds: dict[str, float] = {}

    # -- worker pool --------------------------------------------------------
    def _pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="nos-plan-shard")
            return self._executor

    def close(self) -> None:
        """Shut the worker pool down (idempotent); a later plan makes a
        new one."""
        with self._pool_lock:
            executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=True)

    # -- Planner ------------------------------------------------------------
    def plan(self, snapshot: ClusterSnapshot,
             pending_pods: list[Pod]) -> PartitioningState:
        pools = partition_pools(snapshot)
        n_nodes = sum(len(p.nodes) for p in pools)
        if len(pools) <= 1 or (self._min_shard_hosts
                               and n_nodes < self._min_shard_hosts):
            return self._sequential.plan(snapshot, pending_pods)
        by_pool, infeasible = split_pods(
            pools, pending_pods, self._calculator, self._registry)
        with obs_span("planner.plan", pods=len(pending_pods),
                      shards=len(pools)) as sp:
            t0 = self._clock()
            futures: list[tuple[PlanPool, Future]] = []
            executor = self._pool()
            while len(self._shard_planners) < len(pools):
                self._shard_planners.append(self._factory())
            for i, pool in enumerate(pools):     # sorted by key
                ctx = contextvars.copy_context()
                futures.append((pool, executor.submit(
                    ctx.run, self._run_shard, self._shard_planners[i],
                    pool, snapshot.subset(pool.nodes),
                    by_pool.get(pool.key, []))))
            # merge in pool-key order, never completion order.  On a
            # shard's failure every other future is still waited for
            # before the error propagates: the slots' planners are
            # reused, and a retry must never reach one still running
            merged = PartitioningState()
            shard_seconds: dict[str, float] = {}
            first_exc: BaseException | None = None
            captures: list[JournalCapture] = []
            for pool, future in futures:
                try:
                    shard_state, seconds, capture = future.result()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    if first_exc is None:
                        first_exc = e
                    continue
                if first_exc is None:
                    merged.update(shard_state)
                    shard_seconds[pool.key] = seconds
                    captures.append(capture)
            if first_exc is not None:
                raise first_exc
            for capture in captures:
                capture.replay()
            self.last_shard_seconds = shard_seconds
            wall = self._clock() - t0
            if sp is not None:
                sp.set("infeasible", len(infeasible))
        journal_record(
            J.PLAN_SHARD_MERGED, self._kind or "plan",
            shards=len(pools), nodes=n_nodes,
            pods=len(pending_pods), infeasible=len(infeasible),
            pools=[p.key for p in pools][:MAX_JOURNAL_NODES],
            wall_ms=round(wall * 1e3, 3))
        return merged

    # -- a shard (worker thread) --------------------------------------------
    def _run_shard(self, planner: Planner, pool: PlanPool,
                   shard_snapshot: ClusterSnapshot,
                   shard_pods: list[Pod]
                   ) -> tuple[PartitioningState, float, JournalCapture]:
        capture = JournalCapture()
        with obs_span("plan_shard", pool=pool.key, nodes=len(pool.nodes),
                      pods=len(shard_pods)):
            t0 = self._clock()
            with capture_records(capture):
                state = planner.plan(shard_snapshot, shard_pods)
            seconds = self._clock() - t0
        REGISTRY.observe("nos_tpu_plan_shard_seconds", seconds,
                         labels={"pool": pool.key})
        REGISTRY.inc("nos_tpu_plan_shards_total",
                     labels={"kind": self._kind or "plan"})
        return state, seconds, capture
