"""The event-driven simulator engine, ``nos_tpu/sim/engine.py`` for the
port (copied: it imports nothing else of the package): one virtual
clock, one deterministically ordered event queue.  Scenario events (a
node kill, a burst) are one-shots that compose with periodic tick work
instead of hiding inside it, and a simulated stretch costs only the
events that happen.

**Deterministic tie-break contract** (pinned by
``tests/test_torch_sim.py`` against the JAX package's engine): events
at the same timestamp fire in

    ``(time, priority, label, seq)``

order.  ``priority`` separates planes (faults before ticks before
samplers — module constants below); ``label`` is the stable per-source
name every ``TraceSource`` stamps, so two *differently labelled* events
at one instant order by label regardless of the order their sources
were installed in — shuffling scenario composition must never change a
journal byte.  ``seq`` (schedule order) only breaks ties *within* one
label, where insertion order is the source's own deterministic
emission order.

No wall-clock calls live here: the engine IS the clock.
Wall-time measurement belongs to callers, via an injected reference.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional

#: Priority planes for same-timestamp ordering: scenario faults fire
#: before the periodic tick work they must be visible to (a node kill
#: at t is observed by the tick at t, exactly like the old in-tick
#: ``if now >= KILL_T`` checks), and samplers observe state after the
#: tick that produced it.
PRIO_FAULT = 0
PRIO_TRACE = 50
PRIO_TICK = 100
PRIO_SAMPLE = 200


class SimEngine:
    """Virtual clock + deterministically ordered event queue.

    ``schedule``/``at``/``after`` enqueue one-shots; ``tick_loop``
    replicates the classic bench loop ``while now < until (and pred):
    now += period; body()`` exactly — including its float-accumulation
    sequence — so a ported bench reproduces its numbers byte-for-byte.
    ``run`` drains the queue in contract order.
    """

    def __init__(self) -> None:
        self._now = 0.0
        self._seq = 0
        # (time, priority, label, seq, fn)
        self._heap: list[
            tuple[float, int, str, int, Callable[[], None]]] = []
        self._fired = 0

    # -- clock --------------------------------------------------------------
    def now(self) -> float:
        """Current virtual time.  Pass ``engine.now`` wherever a
        component takes an injectable ``clock`` callable."""
        return self._now

    @property
    def clock(self) -> Callable[[], float]:
        return self.now

    @property
    def events_fired(self) -> int:
        return self._fired

    def pending(self) -> int:
        return len(self._heap)

    # -- scheduling ---------------------------------------------------------
    def at(self, when: float, fn: Callable[[], None], *,
           priority: int = PRIO_FAULT, label: str = "") -> None:
        """One-shot at virtual time ``when`` (>= now; the past is a
        scenario bug, not a scheduling feature)."""
        if when < self._now:
            raise ValueError(
                f"cannot schedule event {label!r} at t={when} "
                f"(now={self._now}): the virtual clock is monotonic")
        self._seq += 1
        heapq.heappush(self._heap, (when, priority, label, self._seq, fn))

    def after(self, delay: float, fn: Callable[[], None], *,
              priority: int = PRIO_FAULT, label: str = "") -> None:
        self.at(self._now + delay, fn, priority=priority, label=label)

    def tick_loop(self, period: float, fn: Callable[[], None], *,
                  until: float,
                  while_fn: Optional[Callable[[], bool]] = None,
                  priority: int = PRIO_TICK,
                  label: str = "tick") -> None:
        """The ported bench loop.  Semantics are EXACTLY

            while now < until (and while_fn()):
                now += period; fn()

        — the continuation condition is evaluated at the *current*
        time, then the clock advances by float accumulation
        (``now + period``, the same rounding sequence the ``+=`` loops
        produced) and the body runs.  A bench moved onto this keeps its
        tick count and timestamps bit-identical."""

        def arm() -> None:
            if self._now < until and (while_fn is None or while_fn()):
                self.at(self._now + period, fire,
                        priority=priority, label=label)

        def fire() -> None:
            fn()
            arm()

        arm()

    # -- run ----------------------------------------------------------------
    def step(self) -> bool:
        """Fire the single next event; False when the queue is empty."""
        if not self._heap:
            return False
        when, _prio, _label, _seq, fn = heapq.heappop(self._heap)
        self._now = when
        self._fired += 1
        fn()
        return True

    def run(self, until: Optional[float] = None) -> int:
        """Drain the queue in contract order; with ``until``, stop
        before the first event past it (clock lands on ``until``).
        Returns the number of events fired."""
        fired_before = self._fired
        while self._heap:
            if until is not None and self._heap[0][0] > until:
                break
            self.step()
        if until is not None and self._now < until:
            self._now = until
        return self._fired - fired_before
