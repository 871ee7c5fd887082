"""Continuous-batching replica model, ``nos_tpu/requests/replica.py`` for
the port (the same state machine): bounded admission, KV occupancy.

One ``ContinuousBatchingReplica`` models one serving replica pod the
way a vLLM-style engine behaves from the router's seat:

- **bounded admission queue** — ``admit`` refuses beyond
  ``max_queue`` waiting requests; the router's shed-with-retry policy
  (router.py) owns what happens next, the replica never drops silently;
- **reserve-ahead KV** — a request enters prefill only when its WHOLE
  footprint (prompt + max output tokens) fits the remaining KV
  capacity, so decode never evicts mid-stream; the reserved fraction is
  the occupancy signal the autoscaler scales on;
- **prefill/decode split** — prefill burns compute serially
  (``costs.prefill_seconds``); decode advances ALL active requests one
  token per memory-bound step (``costs.decode_step_seconds``).  When
  both have work, prefill is capped at ``prefill_share`` of the tick so
  a prompt storm degrades time-per-token instead of stalling every
  in-flight stream;
- **disaggregation seam** — a ``prefill_only`` replica returns finished
  prefills for the router to hand to a decode-pool replica (its KV
  reservation is released on handoff) instead of decoding in place.

``step(now, dt)`` is a pure function of prior state and its arguments —
no clock calls, no randomness, no unordered iteration — so a seeded
request stream reproduces byte-identical journals regardless of how
ticks are batched (``tests/test_torch_requests.py`` pins the property
through the router, against the JAX package's replica).
"""

from __future__ import annotations

from collections import deque

from .costs import RequestCostModel


class Request:
    """One inference request as the data plane sees it.  Timestamps are
    stamped by the replica/router from the injected virtual clock;
    ``retries`` counts re-submissions after full admission queues."""

    __slots__ = ("service", "rid", "session", "prompt_tokens",
                 "output_tokens", "created", "admitted", "prefill_done",
                 "finished", "generated", "retries", "needs_prefill")

    def __init__(self, service: str, rid: str, session: str,
                 prompt_tokens: int, output_tokens: int,
                 created: float) -> None:
        if prompt_tokens <= 0 or output_tokens <= 0:
            raise ValueError("prompt_tokens and output_tokens must be > 0")
        self.service = service
        self.rid = rid
        self.session = session
        self.prompt_tokens = prompt_tokens
        self.output_tokens = output_tokens
        self.created = created
        self.admitted: float | None = None
        self.prefill_done: float | None = None
        self.finished: float | None = None
        self.generated = 0
        self.retries = 0
        self.needs_prefill = True

    @property
    def kv_tokens(self) -> int:
        """Reserve-ahead KV footprint: prompt plus every token the
        request may still generate."""
        return self.prompt_tokens + self.output_tokens


class ContinuousBatchingReplica:
    """One replica's request state (module docstring).  Single-driver
    contract like the SLO engine: exactly one loop calls ``step``; the
    router may farm replicas out to worker threads, but each replica is
    stepped by exactly one worker per tick."""

    def __init__(self, name: str, costs: RequestCostModel, *,
                 max_queue: int = 16, prefill_share: float = 0.5,
                 prefill_only: bool = False) -> None:
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if not 0.0 < prefill_share <= 1.0:
            raise ValueError("prefill_share must be in (0, 1]")
        self.name = name
        self.costs = costs
        self.max_queue = max_queue
        self.prefill_share = prefill_share
        self.prefill_only = prefill_only
        self.kv_capacity = costs.kv_capacity_tokens()
        self._queue: deque[Request] = deque()
        self._prefilling: Request | None = None
        self._prefill_left = 0.0
        self._active: list[Request] = []
        self._kv_reserved = 0           # prompt+output of admitted-to-KV
        self._kv_resident = 0           # prompt+generated actually held
        self._decode_accum = 0.0

    # -- admission -----------------------------------------------------------
    def admit(self, req: Request, now: float) -> bool:
        """Queue the request; False when the admission queue is full
        (the router sheds or retries — never this replica)."""
        if len(self._queue) >= self.max_queue:
            return False
        req.admitted = now
        self._queue.append(req)
        return True

    def admit_decode(self, req: Request, now: float) -> bool:
        """Admit a request already prefilled elsewhere (disaggregated
        handoff): it needs KV room immediately, not queue room."""
        if self._kv_reserved + req.kv_tokens > self.kv_capacity:
            return False
        req.admitted = req.admitted if req.admitted is not None else now
        self._kv_reserved += req.kv_tokens
        self._kv_resident += req.prompt_tokens + req.generated
        self._active.append(req)
        return True

    # -- signals -------------------------------------------------------------
    def queue_depth(self) -> int:
        return len(self._queue)

    def in_flight(self) -> int:
        return (len(self._queue) + len(self._active)
                + (1 if self._prefilling is not None else 0))

    def kv_occupancy(self) -> float:
        """Reserved KV fraction — the real load signal: a replica with
        a short queue but full KV cannot take another stream."""
        if self.kv_capacity <= 0:
            return 1.0
        return min(1.0, self._kv_reserved / self.kv_capacity)

    def load_signal(self) -> float:
        """What the router publishes as ANNOT_SERVING_LOAD: KV
        occupancy for decode/aggregated replicas (the real constraint),
        queue saturation for prefill-only replicas (their KV is
        transient prompt scratch — admission backlog is what says
        \"more compute\")."""
        if self.prefill_only:
            depth = (len(self._queue)
                     + (1 if self._prefilling is not None else 0))
            return min(1.0, depth / self.max_queue)
        return self.kv_occupancy()

    def active_sessions(self) -> int:
        sessions: dict[str, None] = {}
        for req in self._queue:
            sessions[req.session] = None
        if self._prefilling is not None:
            sessions[self._prefilling.session] = None
        for req in self._active:
            sessions[req.session] = None
        return len(sessions)

    def drain(self) -> list[Request]:
        """Remove and return every held request (replica vanished: the
        router re-routes them and journals the migrated sessions)."""
        orphans = list(self._queue)
        self._queue.clear()
        if self._prefilling is not None:
            orphans.append(self._prefilling)
            self._prefilling = None
            self._prefill_left = 0.0
        orphans.extend(self._active)
        self._active = []
        self._kv_reserved = 0
        self._kv_resident = 0
        self._decode_accum = 0.0
        for req in orphans:
            # a drained request restarts from scratch elsewhere
            req.needs_prefill = True
            req.generated = 0
            req.prefill_done = None
        return orphans

    # -- the tick ------------------------------------------------------------
    def step(self, now: float, dt: float
             ) -> tuple[list[Request], list[Request]]:
        """Advance ``dt`` seconds of replica time; returns
        ``(handoffs, completed)`` — prefills finished on a
        prefill-only replica, and requests whose last token decoded."""
        handoffs: list[Request] = []
        completed: list[Request] = []
        prefill_budget = dt
        if self._active and (self._queue or self._prefilling is not None):
            prefill_budget = dt * self.prefill_share
        prefill_used = self._run_prefill(now, prefill_budget, handoffs,
                                         completed)
        self._run_decode(now, dt - prefill_used, completed)
        return handoffs, completed

    def _run_prefill(self, now: float, budget: float,
                     handoffs: list[Request],
                     completed: list[Request]) -> float:
        used = 0.0
        while budget > 0.0:
            if self._prefilling is None:
                if not self._queue:
                    break
                head = self._queue[0]
                # reserve-ahead: the WHOLE stream must fit, or the head
                # waits (KV pressure backs the queue up — that pressure
                # is the scaling signal, not a silent drop)
                reserve = (head.prompt_tokens if self.prefill_only
                           else head.kv_tokens)
                if self._kv_reserved + reserve > self.kv_capacity:
                    break
                self._queue.popleft()
                self._kv_reserved += reserve
                self._prefilling = head
                self._prefill_left = self.costs.prefill_seconds(
                    head.prompt_tokens)
            spend = min(budget, self._prefill_left)
            budget -= spend
            used += spend
            self._prefill_left -= spend
            if self._prefill_left > 1e-12:
                break
            req = self._prefilling
            assert req is not None
            self._prefilling = None
            self._prefill_left = 0.0
            req.prefill_done = now
            req.needs_prefill = False
            if self.prefill_only:
                # handoff: the decode pool re-reserves; release ours
                self._kv_reserved -= req.prompt_tokens
                handoffs.append(req)
            elif req.output_tokens <= 1:
                # prefill-only workloads (embeddings, scoring): the one
                # "output" token is the prefill's own logits
                req.generated = req.output_tokens
                req.finished = now
                self._kv_reserved -= req.kv_tokens
                completed.append(req)
            else:
                self._kv_resident += req.prompt_tokens
                self._active.append(req)
        return used

    def _run_decode(self, now: float, budget: float,
                    completed: list[Request]) -> None:
        if not self._active:
            self._decode_accum = 0.0
            return
        budget += self._decode_accum
        while self._active:
            step_s = self.costs.decode_step_seconds(self._kv_resident)
            if budget < step_s:
                break
            budget -= step_s
            still_active: list[Request] = []
            for req in self._active:
                req.generated += 1
                self._kv_resident += 1
                if req.generated >= req.output_tokens:
                    req.finished = now
                    self._kv_reserved -= req.kv_tokens
                    self._kv_resident -= (req.prompt_tokens
                                          + req.generated)
                    completed.append(req)
                else:
                    still_active.append(req)
            self._active = still_active
        self._decode_accum = budget if self._active else 0.0
