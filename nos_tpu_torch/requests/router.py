"""ServingRouter, ``nos_tpu/requests/router.py`` for the port: the request
path from user to replica pod.

The router watches each service's replica pods (the LABEL_SERVICE label
the replica autoscaler manages), keeps a ``ContinuousBatchingReplica``
model per live pod, and routes every arriving request:

- **session affinity**: a session's requests land on the replica
  already holding its KV prefix; new sessions go to the replica with
  the lowest ``(kv occupancy, queue depth, name)``;
- **bounded admission + shed-with-retry**: a full admission queue
  spills to the next-best replica; when every replica is full the
  request parks in the retry buffer with backoff, and only after
  ``max_retries`` failed passes is it shed (journaled REQUEST_SHED: the
  decision to drop is journaled, the routine routes are not);
- **prefill/decode disaggregation**: a service may name distinct
  prefill and decode pools (two per-role ``ServingService`` entries on
  different MIG profiles); prefills run on the compute pool, finished
  prefills hand off to a KV-affine decode replica;
- **the downward-API loop**: every publish interval the router stamps
  each replica pod with its load signal (ANNOT_SERVING_LOAD) and its
  active sessions (ANNOT_SERVING_SESSIONS) through
  ``retry_on_conflict``, so the replica autoscaler scales on KV pressure
  and its scale-down prefers drained replicas;
- **vanished replicas**: a scaled-down or lost replica's requests are
  re-routed and each live session's move is journaled SESSION_MIGRATED.

It lists replica pods through the API interface alone, so it runs the
same on the in-memory ``APIServer`` and on ``kube/rest.py``'s
``KubeClient``: a pod gone before its stamp (NotFound) is dropped at the
next refresh, and a stamp whose retries are spent (Conflict or a
transient error) is logged and made again at the next publish.

Completions are observed into ``nos_tpu_request_latency_seconds
{service,phase}`` (prefill: created to first token, decode: first to
last token, total: created to finished), which the SLO engine judges.

Single-driver contract: one loop calls ``tick()`` and ``submit()``.
``workers > 1`` steps the replicas on a thread pool, each replica on
one worker, with its journal records captured (``JournalCapture``) and
replayed in replica order, so the journal is byte-identical at any
worker count (``tests/test_torch_requests.py``).  Time is an argument
everywhere.
"""

from __future__ import annotations

import concurrent.futures
import contextvars
import dataclasses
import logging
from typing import Any, Callable, Mapping

from nos_tpu_torch.api import constants as C
from nos_tpu_torch.exporter.metrics import REGISTRY
from nos_tpu_torch.kube.client import APIServer, KIND_POD, NotFound
from nos_tpu_torch.kube.objects import Pod, RUNNING
from nos_tpu_torch.obs import journal as J
from nos_tpu_torch.obs.journal import JournalCapture, capture_records
from nos_tpu_torch.obs.journal import record as journal_record
from nos_tpu_torch.utils.retry import RETRYABLE, retry_on_conflict

from .costs import ModelProfile, RequestCostModel
from .replica import ContinuousBatchingReplica, Request

logger = logging.getLogger(__name__)

# Request-latency bounds: 10 ms (a queue-only embed hit) through 60 s
# (a decode stream crawling under KV pressure).
REGISTRY.describe("nos_tpu_request_latency_seconds",
                  "Per-request latency by service and phase "
                  "(prefill = time to first token, decode = stream "
                  "time, total = end to end)",
                  buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                           2.0, 4.0, 8.0, 15.0, 30.0, 60.0))
REGISTRY.describe("nos_tpu_requests_total",
                  "Requests finished per service and outcome "
                  "(completed | shed)")
REGISTRY.describe("nos_tpu_request_retries_total",
                  "Admission retries after a full-queue routing pass")
REGISTRY.describe("nos_tpu_request_kv_occupancy",
                  "Mean reserved KV fraction across a pool's replicas")
REGISTRY.describe("nos_tpu_request_sessions",
                  "Live sessions tracked per service")
REGISTRY.describe("nos_tpu_request_queue_depth",
                  "Waiting requests across a pool's admission queues")

PHASE_PREFILL = "prefill"
PHASE_DECODE = "decode"
PHASE_TOTAL = "total"

ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"


@dataclasses.dataclass(frozen=True)
class RouterService:
    """One routed inference service.  ``prefill_service`` /
    ``decode_service`` are ``nos.tpu/service`` label values — the
    per-role ServingService entries the autoscaler manages.  An empty
    ``decode_service`` means aggregated continuous batching: one pool
    prefills and decodes."""

    name: str
    model: ModelProfile
    prefill_costs: RequestCostModel
    namespace: str = "serve"
    prefill_service: str = ""       # "" = self.name
    decode_service: str = ""        # "" = aggregated
    decode_costs: RequestCostModel | None = None
    max_queue_per_replica: int = 16
    max_retries: int = 3
    retry_backoff_s: float = 0.25
    session_idle_s: float = 120.0
    prefill_share: float = 0.5

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("router service needs a name")
        if self.max_queue_per_replica < 1:
            raise ValueError(
                f"service {self.name}: max_queue_per_replica must be "
                f">= 1")
        if self.max_retries < 0:
            raise ValueError(f"service {self.name}: max_retries < 0")
        if self.retry_backoff_s < 0 or self.session_idle_s <= 0:
            raise ValueError(
                f"service {self.name}: retry_backoff_s must be >= 0 "
                f"and session_idle_s > 0")
        if self.decode_service and self.decode_costs is None:
            raise ValueError(
                f"service {self.name}: a disaggregated decode pool "
                f"needs its own decode_costs")

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def prefill_label(self) -> str:
        return self.prefill_service or self.name

    @property
    def disaggregated(self) -> bool:
        return bool(self.decode_service)

    @classmethod
    def from_mapping(cls, raw: Mapping[str, Any]) -> "RouterService":
        """Build from a config-file mapping (api/config.py
        RouterConfig.services).  ``model`` is a nested ModelProfile
        mapping; ``prefill`` / ``decode`` nest the cost-model knobs
        (device_kind, chips, hbm_gb, mfu, hbm_efficiency,
        mig_profile: ``costs.py``).  Unknown keys anywhere are an error,
        so a typoed knob fails the config load, not the burst."""
        fields = {f.name for f in dataclasses.fields(cls)} \
            - {"model", "prefill_costs", "decode_costs"} \
            | {"model", "prefill", "decode"}
        unknown = set(raw) - fields
        if unknown:
            raise ValueError(
                f"unknown router service key(s): {sorted(unknown)}")
        out = {k: v for k, v in raw.items()
               if k not in ("model", "prefill", "decode")}
        model_raw = raw.get("model")
        if not isinstance(model_raw, Mapping):
            raise ValueError("router service needs a `model:` mapping")
        model = ModelProfile(**dict(model_raw))
        prefill_raw = raw.get("prefill", {})
        if not isinstance(prefill_raw, Mapping):
            raise ValueError("`prefill:` must be a mapping")
        prefill = RequestCostModel(profile=model, **dict(prefill_raw))
        decode: RequestCostModel | None = None
        decode_raw = raw.get("decode")
        if decode_raw is not None:
            if not isinstance(decode_raw, Mapping):
                raise ValueError("`decode:` must be a mapping")
            decode = RequestCostModel(profile=model, **dict(decode_raw))
        return cls(model=model, prefill_costs=prefill,
                   decode_costs=decode, **out)


class _Pool:
    """One role's replica set: the live ``ContinuousBatchingReplica``
    models keyed by pod name."""

    def __init__(self, svc: RouterService, role: str) -> None:
        self.svc = svc
        self.role = role
        self.label = (svc.decode_service if role == ROLE_DECODE
                      and svc.disaggregated else svc.prefill_label)
        self.costs = (svc.decode_costs if role == ROLE_DECODE
                      and svc.decode_costs is not None
                      else svc.prefill_costs)
        self.replicas: dict[str, ContinuousBatchingReplica] = {}

    def make_replica(self, name: str) -> ContinuousBatchingReplica:
        return ContinuousBatchingReplica(
            name, self.costs,
            max_queue=self.svc.max_queue_per_replica,
            prefill_share=self.svc.prefill_share,
            prefill_only=(self.role == ROLE_PREFILL
                          and self.svc.disaggregated))

    def ordered(self) -> list[ContinuousBatchingReplica]:
        """Placement order: lowest KV pressure first, queue depth and
        name break ties, so the order is deterministic."""
        return sorted(self.replicas.values(),
                      key=lambda r: (r.kv_occupancy(), r.queue_depth(),
                                     r.name))


class _ServiceState:
    def __init__(self, svc: RouterService) -> None:
        self.svc = svc
        self.prefill = _Pool(svc, ROLE_PREFILL)
        # aggregated: ONE pool plays both roles
        self.decode = (_Pool(svc, ROLE_DECODE) if svc.disaggregated
                       else self.prefill)
        # session -> [replica name on the decode/affine pool, last use]
        self.sessions: dict[str, list] = {}
        # (ready time, seq, request) awaiting a retry pass
        self.retryq: list[tuple[float, int, Request]] = []
        self.counters = {"submitted": 0, "completed": 0, "shed": 0,
                         "retried": 0, "migrated": 0}
        self.completed: list[Request] = []

    def pools(self) -> list[_Pool]:
        if self.svc.disaggregated:
            return [self.prefill, self.decode]
        return [self.prefill]


class ServingRouter:
    """Route requests to replica pods (module docstring)."""

    def __init__(self, api: APIServer,
                 services: tuple[RouterService, ...] | list[RouterService],
                 *, clock: Callable[[], float],
                 workers: int = 0,
                 publish_every_ticks: int = 5,
                 keep_completed: bool = False) -> None:
        if publish_every_ticks < 1:
            raise ValueError("publish_every_ticks must be >= 1")
        self._api = api
        self._clock = clock
        self._workers = max(0, workers)
        self._publish_every = publish_every_ticks
        self._keep_completed = keep_completed
        self._states: dict[str, _ServiceState] = {}
        for svc in services:
            if svc.key in self._states:
                raise ValueError(f"duplicate router service {svc.key}")
            self._states[svc.key] = _ServiceState(svc)
        self._tick_no = 0
        self._retry_seq = 0

    # -- intake --------------------------------------------------------------
    def submit(self, service_key: str, req: Request) -> None:
        """Route one arriving request (the ArrivalSource callback)."""
        state = self._states[service_key]
        state.counters["submitted"] += 1
        self._route(state, req, self._clock())

    # -- the tick ------------------------------------------------------------
    def tick(self, dt: float) -> None:
        """Advance every replica ``dt`` seconds, process completions
        and handoffs, drain due retries, publish the downward-API
        signals on the publish cadence."""
        now = self._clock()
        self._tick_no += 1
        self._refresh_replicas(now)
        for key in sorted(self._states):
            state = self._states[key]
            results = self._step_pools(state, now, dt)
            for pool, handoffs, completed in results:
                for req in handoffs:
                    self._route(state, req, now)
                for req in completed:
                    self._complete(state, req)
            self._drain_retries(state, now)
            self._expire_sessions(state, now)
        if self._tick_no % self._publish_every == 1 \
                or self._publish_every == 1:
            self.publish(now)

    # -- replica lifecycle ---------------------------------------------------
    def _live_pods(self, pool: _Pool) -> list[Pod]:
        return self._api.list(
            KIND_POD, namespace=pool.svc.namespace,
            label_selector={C.LABEL_SERVICE: pool.label},
            filter_fn=lambda p: (p.status.phase == RUNNING
                                 and bool(p.spec.node_name)))

    def _refresh_replicas(self, now: float) -> None:
        for key in sorted(self._states):
            state = self._states[key]
            for pool in state.pools():
                live = {p.metadata.name for p in self._live_pods(pool)}
                for name in sorted(live - pool.replicas.keys()):
                    pool.replicas[name] = pool.make_replica(name)
                gone = sorted(pool.replicas.keys() - live)
                for name in gone:
                    self._drop_replica(state, pool, name, now)

    def _drop_replica(self, state: _ServiceState, pool: _Pool,
                      name: str, now: float) -> None:
        """A replica pod vanished (scale-down, node loss): re-route its
        requests and journal every live session it carried."""
        replica = pool.replicas.pop(name)
        orphans = replica.drain()
        moved: dict[str, None] = {}
        for req in orphans:
            moved[req.session] = None
        for session in moved:
            entry = state.sessions.pop(session, None)
            journal_record(
                J.SESSION_MIGRATED, state.svc.key, session=session,
                from_replica=name,
                was_affine=bool(entry and entry[0] == name))
            state.counters["migrated"] += 1
        for req in orphans:
            # drained work restarts from scratch; the re-route passes
            # through the same bounded-admission/shed policy
            self._route(state, req, now)

    # -- stepping ------------------------------------------------------------
    def _step_pools(self, state: _ServiceState, now: float, dt: float
                    ) -> list[tuple[_Pool, list[Request], list[Request]]]:
        """Step every replica of every pool; with workers, each replica
        steps on one worker under a JournalCapture replayed in replica
        order — byte-identical journals across worker counts."""
        flat: list[tuple[_Pool, ContinuousBatchingReplica]] = []
        for pool in state.pools():
            for name in sorted(pool.replicas):
                flat.append((pool, pool.replicas[name]))
        out: list[tuple[_Pool, list[Request], list[Request]]] = []
        if self._workers <= 1 or len(flat) < 2:
            for pool, replica in flat:
                handoffs, completed = replica.step(now, dt)
                out.append((pool, handoffs, completed))
            return out
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=self._workers) as executor:
            futures = []
            for pool, replica in flat:
                capture = JournalCapture()
                ctx = contextvars.copy_context()

                def work(replica: ContinuousBatchingReplica = replica,
                         capture: JournalCapture = capture
                         ) -> tuple[list[Request], list[Request]]:
                    with capture_records(capture):
                        return replica.step(now, dt)

                futures.append((pool, capture,
                                executor.submit(ctx.run, work)))
            for pool, capture, future in futures:
                handoffs, completed = future.result()
                capture.replay()
                out.append((pool, handoffs, completed))
        return out

    # -- routing -------------------------------------------------------------
    def _route(self, state: _ServiceState, req: Request,
               now: float) -> None:
        svc = state.svc
        if req.needs_prefill:
            pool = state.prefill
            affine = not svc.disaggregated
        else:
            pool = state.decode
            affine = True
        candidates = pool.ordered()
        if affine:
            entry = state.sessions.get(req.session)
            if entry is not None and entry[0] in pool.replicas:
                sticky = pool.replicas[entry[0]]
                candidates = [sticky] + [r for r in candidates
                                         if r.name != sticky.name]
        for replica in candidates:
            admitted = (replica.admit(req, now) if req.needs_prefill
                        else replica.admit_decode(req, now))
            if admitted:
                if affine:
                    state.sessions[req.session] = [replica.name, now]
                return
        self._retry_or_shed(state, req, now)

    def _retry_or_shed(self, state: _ServiceState, req: Request,
                       now: float) -> None:
        svc = state.svc
        req.retries += 1
        if req.retries > svc.max_retries:
            state.counters["shed"] += 1
            REGISTRY.inc("nos_tpu_requests_total",
                         labels={"service": svc.name, "outcome": "shed"})
            journal_record(J.REQUEST_SHED, svc.key, rid=req.rid,
                           session=req.session, retries=req.retries - 1,
                           phase=(PHASE_PREFILL if req.needs_prefill
                                  else PHASE_DECODE))
            return
        state.counters["retried"] += 1
        REGISTRY.inc("nos_tpu_request_retries_total",
                     labels={"service": svc.name})
        self._retry_seq += 1
        state.retryq.append(
            (now + svc.retry_backoff_s * req.retries, self._retry_seq,
             req))

    def _drain_retries(self, state: _ServiceState, now: float) -> None:
        if not state.retryq:
            return
        due = [e for e in state.retryq if e[0] <= now]
        if not due:
            return
        state.retryq = [e for e in state.retryq if e[0] > now]
        for _, _, req in sorted(due, key=lambda e: (e[0], e[1])):
            self._route(state, req, now)

    def _expire_sessions(self, state: _ServiceState, now: float) -> None:
        idle = state.svc.session_idle_s
        dead = [s for s, entry in state.sessions.items()
                if now - entry[1] > idle]
        for session in dead:
            del state.sessions[session]

    # -- completion ----------------------------------------------------------
    def _complete(self, state: _ServiceState, req: Request) -> None:
        svc = state.svc
        state.counters["completed"] += 1
        if self._keep_completed:
            state.completed.append(req)
        REGISTRY.inc("nos_tpu_requests_total",
                     labels={"service": svc.name,
                             "outcome": "completed"})
        assert req.finished is not None
        if req.prefill_done is not None:
            REGISTRY.observe(
                "nos_tpu_request_latency_seconds",
                req.prefill_done - req.created,
                labels={"service": svc.name, "phase": PHASE_PREFILL})
            REGISTRY.observe(
                "nos_tpu_request_latency_seconds",
                req.finished - req.prefill_done,
                labels={"service": svc.name, "phase": PHASE_DECODE})
        REGISTRY.observe(
            "nos_tpu_request_latency_seconds",
            req.finished - req.created,
            labels={"service": svc.name, "phase": PHASE_TOTAL})
        if req.session in state.sessions:
            state.sessions[req.session][1] = req.finished

    # -- the downward-API loop ----------------------------------------------
    def publish(self, now: float) -> None:
        """Stamp every replica pod with KV occupancy + session count
        (retry-wrapped writes, the downward-API pattern) and refresh
        the per-service gauges."""
        for key in sorted(self._states):
            state = self._states[key]
            svc = state.svc
            # distinct sessions per replica on the affine pool
            by_replica: dict[str, dict[str, None]] = {}
            for session, (rname, _) in sorted(state.sessions.items()):
                by_replica.setdefault(rname, {})[session] = None
            for pool in state.pools():
                occs = []
                depth = 0
                for name in sorted(pool.replicas):
                    replica = pool.replicas[name]
                    occs.append(replica.kv_occupancy())
                    depth += replica.queue_depth()
                    sessions = (len(by_replica.get(name, {}))
                                if pool is state.decode
                                else replica.active_sessions())
                    self._stamp(svc.namespace, name,
                                replica.load_signal(), sessions)
                labels = {"service": svc.name, "role": pool.role}
                REGISTRY.set("nos_tpu_request_kv_occupancy",
                             (sum(occs) / len(occs)) if occs else 0.0,
                             labels=labels)
                REGISTRY.set("nos_tpu_request_queue_depth",
                             float(depth), labels=labels)
            REGISTRY.set("nos_tpu_request_sessions",
                         float(len(state.sessions)),
                         labels={"service": svc.name})

    def _stamp(self, namespace: str, pod_name: str, occupancy: float,
               sessions: int) -> None:
        def mutate(p: Pod) -> None:
            p.metadata.annotations[C.ANNOT_SERVING_LOAD] = \
                f"{occupancy:.3f}"
            p.metadata.annotations[C.ANNOT_SERVING_SESSIONS] = \
                str(sessions)

        try:
            retry_on_conflict(self._api, KIND_POD, pod_name, mutate,
                              namespace, component="request-router")
        except NotFound:
            pass        # scaled down mid-stamp; next refresh drops it
        except RETRYABLE:
            # the signal is advisory and refreshed next publish; an
            # apiserver having a bad moment must not kill the router
            logger.warning("router: load stamp on %s/%s failed after "
                           "retries", namespace, pod_name)

    # -- surfaces ------------------------------------------------------------
    def stats(self) -> dict[str, dict[str, int]]:
        """Per-service counters (the fleets' report surface)."""
        return {key: dict(state.counters)
                for key, state in sorted(self._states.items())}

    def completed_requests(self, service_key: str) -> list[Request]:
        """Completed requests (only populated with keep_completed)."""
        return list(self._states[service_key].completed)

    def kv_occupancies(self, service_key: str) -> dict[str, float]:
        """Per-replica reserved-KV fraction, by pod name."""
        state = self._states[service_key]
        out: dict[str, float] = {}
        for pool in state.pools():
            for name in sorted(pool.replicas):
                out[name] = pool.replicas[name].kv_occupancy()
        return out

    def pool_occupancies(self, service_key: str
                         ) -> dict[str, list[float]]:
        """Reserved-KV fractions grouped by pool role (the fleets'
        surface — the ceiling the KV-pressure autoscaler must hold)."""
        state = self._states[service_key]
        out: dict[str, list[float]] = {}
        for pool in state.pools():
            out[pool.role] = [pool.replicas[n].kv_occupancy()
                              for n in sorted(pool.replicas)]
        return out

    def session_count(self, service_key: str) -> int:
        return len(self._states[service_key].sessions)
