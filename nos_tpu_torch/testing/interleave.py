"""An interleaving explorer for lock pairs (DPOR lite),
``nos_tpu/testing/interleave.py`` for the port.

The lock checker (``testing/lockcheck.py``) convicts only the orders it
happens to witness in whatever interleaving the OS produced.  This
module owns the schedule instead, for the few lock pairs the decision
plane stakes its correctness on.  Two or three threads run under a
cooperative controller that takes control at every lock acquisition
(the only schedule points that matter for lock order: code between
acquisitions is invisible to the other threads under the checker's
discipline) and walks the schedule tree depth first:

- **stateless re-execution**: each schedule replays the scenario from
  scratch along a recorded prefix of decisions, then extends it; the
  scenarios are cheap and deterministic, so no state is snapshotted;
- **sleep sets** (the "lite" half of DPOR): once the branch under
  choice ``t`` is exhausted, its siblings carry ``t`` asleep and do not
  schedule it until a *dependent* operation (the same lock taken by
  another thread) runs, so schedules that only reorder independent
  acquisitions are explored once, not ``n!`` times;
- **the lock checker's graph**: every explored lock feeds the same
  ``LockGraph`` gate-set machinery (``_note_acquired`` /
  ``_note_released``), so each schedule gets lockdep's inversion
  verdict, and the explorer also reports the schedules where an
  inversion bites: every unfinished thread waiting on a lock another
  holds, a realised deadlock, with its wait cycle.

``REGRESSION_CORPUS`` models the known critical pairs: the
``replay_dropped`` inversion of the chaos API server (withheld watch
events delivered without the store lock turn every component's
api-then-own order into own-then-api), the scheduler cache against the
watch pump, the chip-second ledger's hold stamping, and the quarantine
transition.  ``tests/test_torch_interleave.py`` requires the buggy
replay to be found again within 5000 schedules and the fixed models to
explore clean to the end.
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field
from typing import Callable

from nos_tpu_torch.testing.lockcheck import _REAL_LOCK, LockGraph

__all__ = [
    "ExplorationError",
    "ExploreResult",
    "Env",
    "ExploredLock",
    "explore",
    "REGRESSION_CORPUS",
    "replay_dropped_scenario",
    "cache_watch_pump_scenario",
    "ledger_hold_scenario",
    "quarantine_transition_scenario",
]

# Hard per-run step bound: a scenario looping forever on lock ops would
# otherwise hang the DFS.  Corpus scenarios use a handful of steps.
_MAX_STEPS_PER_RUN = 10_000


class ExplorationError(Exception):
    """The scenario broke the explorer's contract (nondeterministic
    replay, release of a lock the thread does not own, step bound)."""


class _AbortRun(BaseException):
    """Internal: unwind a worker thread at teardown (BaseException so
    ``except Exception`` handlers inside scenario bodies cannot eat
    it)."""


_MACHINERY = ("_site", "acquire", "release", "__enter__", "__exit__",
              "_pause")


def _site() -> str:
    """Nearest caller frame outside the lock machinery — the scenario
    line to blame in lockcheck's edge sites.  Skips by function name,
    not file: the regression corpus's scenario bodies live in this
    module and must still get blamed."""
    frame = sys._getframe(1)
    while frame is not None \
            and frame.f_code.co_filename == __file__ \
            and frame.f_code.co_name in _MACHINERY:
        frame = frame.f_back
    if frame is None:
        return "?"
    return (f"{frame.f_code.co_filename.split('/')[-1]}:"
            f"{frame.f_lineno}")


# -- cooperative substrate ---------------------------------------------------

class _Worker:
    """One scenario thread under controller custody."""

    def __init__(self, ctl: "_Controller", tid: int,
                 body: Callable[[], None]) -> None:
        self.ctl = ctl
        self.tid = tid
        self.body = body
        self.paused = False
        self.granted = False
        self.done = False
        self.exc: BaseException | None = None
        # ("spawn",) before the body starts, then
        # ("acquire", lock_name, lock) at each acquisition point.
        self.pending: tuple | None = None
        self.thread = threading.Thread(
            target=self._run, name=f"interleave-T{tid}", daemon=True)

    def _run(self) -> None:
        try:
            # Initial pause: the controller owns the schedule from the
            # very first operation of every thread.
            self.ctl._pause(self, ("spawn",))
            self.body()
        except _AbortRun:
            pass
        except BaseException as e:  # noqa: BLE001 — verdict surface
            self.exc = e
        finally:
            with self.ctl._cv:
                self.done = True
                self.paused = False
                self.ctl._cv.notify_all()


class _Controller:
    """One run's cooperative scheduler: exactly one worker executes at a
    time; everyone else is parked at a schedule point.  All worker/
    controller state below is touched only under ``_cv`` or while its
    owning worker is the single runner, so the real lock in the
    condition is the only synchronization the substrate needs."""

    def __init__(self) -> None:
        self._cv = threading.Condition(_REAL_LOCK())
        self.workers: list[_Worker] = []
        self._by_ident: dict[int, _Worker] = {}
        self.abort = False

    def spawn(self, body: Callable[[], None]) -> _Worker:
        w = _Worker(self, len(self.workers), body)
        self.workers.append(w)
        return w

    def start(self) -> None:
        for w in self.workers:
            w.thread.start()
            self._by_ident[w.thread.ident] = w

    def current(self) -> _Worker:
        try:
            return self._by_ident[threading.get_ident()]
        except KeyError:
            raise ExplorationError(
                "explored lock touched from outside a scenario thread"
            ) from None

    # -- worker side --------------------------------------------------------
    def _pause(self, w: _Worker, op: tuple) -> None:
        with self._cv:
            if self.abort:
                raise _AbortRun
            w.pending = op
            w.paused = True
            self._cv.notify_all()
            while not w.granted:
                self._cv.wait()
                if self.abort:
                    w.granted = False
                    raise _AbortRun
            w.granted = False
            w.paused = False
            w.pending = None

    # -- controller side ----------------------------------------------------
    def wait_quiescent(self) -> None:
        # A worker with an outstanding grant may not have woken yet —
        # it still reads as paused, but its pending op is stale.
        with self._cv:
            while not all(w.done or (w.paused and not w.granted)
                          for w in self.workers):
                self._cv.wait()

    def snapshot(self) -> tuple[dict[int, tuple], set[int]]:
        """(pending op key per live thread, enabled thread ids).  Only
        valid while quiescent.  An acquisition is enabled when the lock
        is free or reentrantly ours; "spawn" always is."""
        pending: dict[int, tuple] = {}
        enabled: set[int] = set()
        for w in self.workers:
            if w.done:
                continue
            op = w.pending
            if op[0] == "spawn":
                pending[w.tid] = ("spawn", w.tid)
                enabled.add(w.tid)
            else:
                _, name, lock = op
                pending[w.tid] = ("acquire", name)
                if lock.owner is None or (lock.owner is w
                                          and lock.reentrant):
                    enabled.add(w.tid)
        return pending, enabled

    def grant(self, tid: int) -> None:
        with self._cv:
            self.workers[tid].granted = True
            self._cv.notify_all()

    def render_deadlock(self) -> str:
        parts = []
        for w in self.workers:
            if w.done or w.pending is None or w.pending[0] != "acquire":
                continue
            _, name, lock = w.pending
            owner = lock.owner
            if owner is w:
                holder = "itself (non-reentrant re-acquire)"
            elif owner is not None:
                holder = f"T{owner.tid}"
            else:
                continue
            parts.append(f"T{w.tid} waits for {name} held by {holder}")
        return "deadlock: " + "; ".join(parts)

    def teardown(self) -> None:
        with self._cv:
            self.abort = True
            self._cv.notify_all()
        for w in self.workers:
            w.thread.join(timeout=5.0)
            if w.thread.is_alive():
                raise ExplorationError(
                    f"worker T{w.tid} failed to unwind at teardown")


class ExploredLock:
    """Cooperative lock: acquisition is a schedule point the controller
    arbitrates; with exactly one runner there is no real contention, so
    ownership is plain state.  Feeds the run's :class:`LockGraph`
    exactly like :class:`~nos_tpu_torch.testing.lockcheck.CheckedLock`, so
    every schedule gets the full gate-set inversion verdict."""

    def __init__(self, ctl: _Controller, graph: LockGraph, name: str,
                 reentrant: bool = False) -> None:
        self._ctl = ctl
        self._graph = graph
        self.name = name
        self.reentrant = reentrant
        self.owner: _Worker | None = None
        self.count = 0

    def acquire(self) -> bool:
        w = self._ctl.current()
        self._ctl._pause(w, ("acquire", self.name, self))
        # Granted: the controller verified the lock is free (or
        # reentrantly ours) before scheduling us.
        if self.owner is w:
            self.count += 1
            self._graph._note_reacquired(self)
        else:
            if self.owner is not None:
                raise ExplorationError(
                    f"controller granted {self.name} while held")
            self.owner, self.count = w, 1
            self._graph._note_acquired(self, _site())
        return True

    def release(self) -> None:
        w = self._ctl.current()
        if self.owner is not w:
            raise ExplorationError(
                f"T{w.tid} released {self.name} without owning it")
        self.count -= 1
        if self.count == 0:
            self.owner = None
        self._graph._note_released(self)

    def __enter__(self) -> "ExploredLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
        return None

    def __repr__(self) -> str:
        return f"<ExploredLock {self.name}>"


class Env:
    """What a scenario's ``build`` callback gets: a lock factory wired
    to this run's controller and graph."""

    def __init__(self, ctl: _Controller, graph: LockGraph) -> None:
        self._ctl = ctl
        self._graph = graph
        self.locks: list[ExploredLock] = []

    def lock(self, name: str, reentrant: bool = False) -> ExploredLock:
        lk = ExploredLock(self._ctl, self._graph, name, reentrant)
        self.locks.append(lk)
        return lk


# -- DFS with sleep sets -----------------------------------------------------

def _dependent(op_a: tuple, op_b: tuple) -> bool:
    """Two schedule-point ops interfere iff they acquire the same lock;
    "spawn" commutes with everything."""
    return (op_a[0] == "acquire" and op_b[0] == "acquire"
            and op_a[1] == op_b[1])


@dataclass
class _Node:
    """One decision point on the persistent DFS stack.  ``done`` is the
    ordered set of choices explored so far; the branch currently being
    explored is ``chosen`` (always the last entry of ``done``).  The
    effective sleep set for the current branch is ``sleep_in`` plus
    every *earlier* entry of ``done`` with the op it had here — the
    textbook sleep-set growth across siblings."""

    pending: dict[int, tuple]
    enabled: frozenset
    sleep_in: dict[int, tuple]
    done: list[int]
    chosen: int

    def effective_sleep(self) -> dict[int, tuple]:
        eff = dict(self.sleep_in)
        for t in self.done:
            if t != self.chosen:
                eff[t] = self.pending[t]
        return eff


@dataclass
class ExploreResult:
    """Verdict of one scenario's exploration."""

    scenario: str
    schedules: int = 0
    complete: bool = False
    inversions: list[str] = field(default_factory=list)
    deadlocks: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)
    first_violation_schedule: int | None = None

    @property
    def clean(self) -> bool:
        return not (self.inversions or self.deadlocks or self.errors)

    def assert_clean(self) -> None:
        if not self.clean:
            problems = self.inversions + self.deadlocks + self.errors
            raise AssertionError(
                f"interleave[{self.scenario}]: {len(problems)} "
                f"violation(s) in {self.schedules} schedule(s):\n  "
                + "\n  ".join(problems))

    def _saw(self, schedule: int) -> None:
        if self.first_violation_schedule is None:
            self.first_violation_schedule = schedule


class _Explorer:
    def __init__(self, name: str,
                 build: Callable[[Env], list[Callable[[], None]]]) -> None:
        self.name = name
        self.build = build
        self.nodes: list[_Node] = []

    def run_once(self) -> tuple[LockGraph, str | None, list[str]]:
        """Execute one schedule: replay the decision prefix on the
        persistent node stack, then extend with default (lowest enabled
        thread not asleep) choices, appending new nodes."""
        graph = LockGraph(name=f"interleave:{self.name}")
        ctl = _Controller()
        env = Env(ctl, graph)
        bodies = self.build(env)
        if not 2 <= len(bodies) <= 3:
            raise ExplorationError(
                f"scenario {self.name} must yield 2 or 3 threads, "
                f"got {len(bodies)}")
        for body in bodies:
            ctl.spawn(body)
        deadlock: str | None = None
        sleep: dict[int, tuple] = {}
        depth = 0
        try:
            ctl.start()
            while True:
                if depth > _MAX_STEPS_PER_RUN:
                    raise ExplorationError(
                        f"scenario {self.name} exceeded "
                        f"{_MAX_STEPS_PER_RUN} schedule points")
                ctl.wait_quiescent()
                pending, enabled = ctl.snapshot()
                if not pending:
                    break               # every thread ran to completion
                if not enabled:
                    deadlock = ctl.render_deadlock()
                    break
                if depth < len(self.nodes):
                    node = self.nodes[depth]
                    if node.pending != pending:
                        raise ExplorationError(
                            f"scenario {self.name} replayed "
                            f"nondeterministically at step {depth}: "
                            f"{node.pending} became {pending}")
                else:
                    cands = sorted(t for t in enabled if t not in sleep)
                    if not cands:
                        # Every enabled move is asleep: this state's
                        # behaviors are covered by sibling branches.
                        break
                    node = _Node(pending=dict(pending),
                                 enabled=frozenset(enabled),
                                 sleep_in=dict(sleep),
                                 done=[cands[0]], chosen=cands[0])
                    self.nodes.append(node)
                chosen_op = node.pending[node.chosen]
                sleep = {t: op
                         for t, op in node.effective_sleep().items()
                         if not _dependent(op, chosen_op)}
                ctl.grant(node.chosen)
                depth += 1
        finally:
            ctl.teardown()
        graph.close()
        errors = [
            f"T{w.tid} raised {type(w.exc).__name__}: {w.exc}"
            for w in ctl.workers if w.exc is not None
        ]
        return graph, deadlock, errors

    def backtrack(self) -> bool:
        """Advance the deepest node with an unexplored, un-slept
        alternative; truncate everything below it.  False when the
        whole tree is exhausted."""
        while self.nodes:
            node = self.nodes[-1]
            tried = set(node.done) | set(node.sleep_in)
            alts = sorted(t for t in node.enabled if t not in tried)
            if alts:
                node.done.append(alts[0])
                node.chosen = alts[0]
                return True
            self.nodes.pop()
        return False


def explore(name: str,
            build: Callable[[Env], list[Callable[[], None]]],
            *, max_schedules: int = 5000,
            stop_on_first: bool = False) -> ExploreResult:
    """Exhaustively schedule ``build``'s threads; see module docstring.

    ``max_schedules`` bounds the run count (``complete`` is False when
    it bites); ``stop_on_first`` ends exploration at the first schedule
    exhibiting any violation — the regression-gate mode."""
    explorer = _Explorer(name, build)
    result = ExploreResult(scenario=name)
    seen: set[str] = set()
    while True:
        if result.schedules >= max_schedules:
            break
        graph, deadlock, errors = explorer.run_once()
        result.schedules += 1
        for inv in graph.inversions:
            text = inv.render()
            if text not in seen:
                seen.add(text)
                result.inversions.append(text)
                result._saw(result.schedules)
        if deadlock is not None and deadlock not in seen:
            seen.add(deadlock)
            result.deadlocks.append(deadlock)
            result._saw(result.schedules)
        if errors:
            result.errors.extend(errors)
            result._saw(result.schedules)
        if stop_on_first and not result.clean:
            break
        if not explorer.backtrack():
            result.complete = True
            break
    return result


# -- regression corpus -------------------------------------------------------
#
# Abstract models of the decision plane's critical pairs: each scenario
# names its locks after the real attributes and reproduces the real
# nesting shape, nothing more — the explorer checks ORDER, and order is
# exactly what these shapes pin down.

def replay_dropped_scenario(buggy: bool = False):
    """The ``ChaosAPIServer.replay_dropped`` pair (``testing/chaos.py``).

    Live watch delivery fires callbacks **under** the APIServer store
    lock, and a component callback takes its own lock inside — the
    sanctioned api→component order (kube/client.py).  The original
    replay drained withheld events *without* the store lock, so a
    callback re-entering the api from under the component lock
    manifested component→api: the AB/BA inversion an instrumented
    chaos soak caught, kept as a seeded regression the explorer must
    find again (buggy=True) and certify fixed (buggy=False: the replay
    delivers under the store lock, as ``_notify`` does)."""

    def build(env: Env) -> list[Callable[[], None]]:
        api = env.lock("APIServer._lock", reentrant=True)
        comp = env.lock("SchedulerCache._lock")

        def live_delivery() -> None:
            # _notify: callbacks are entitled to the store lock held.
            with api:
                with comp:      # component callback takes its own lock
                    pass

        def replay() -> None:
            if buggy:
                # drain without the store lock: the callback holds the
                # component lock when it re-enters the api (try_get)
                with comp:
                    with api:
                        pass
            else:
                # the fix: deliver under the store lock, exactly like
                # the live bus; the callback's api re-entry is then a
                # reentrant re-acquire, not a new edge
                with api:
                    with comp:
                        with api:
                            pass

        return [live_delivery, replay]

    return build


def cache_watch_pump_scenario():
    """SchedulerCache vs the watch pump: the pump delivers under the
    api lock into ``_on_node``/``_on_pod`` (api→cache); the scheduler
    reads via ``snapshot()``, which copies under the cache lock and
    RELEASES before the scheduler talks to the api again — cache and
    api are never nested in that direction, by design."""

    def build(env: Env) -> list[Callable[[], None]]:
        api = env.lock("APIServer._lock", reentrant=True)
        cache = env.lock("SchedulerCache._lock")

        def pump() -> None:
            with api:           # watch event arrives under store lock
                with cache:     # _on_node books it into the index
                    pass

        def scheduler() -> None:
            with cache:         # snapshot(): copy out under the lock...
                pass
            with api:           # ...then bind() against the api, lock-free
                pass

        return [pump, scheduler]

    return build


def ledger_hold_scenario():
    """ChipSecondLedger hold stamping vs the obs surface: actuation
    paths stamp holds (``set_hold``/``clear_hold``) strictly OUTSIDE
    any api critical section, while the report reader snapshots under
    the api and then reads holds — only the reader nests, so there is
    no cycle to invert."""

    def build(env: Env) -> list[Callable[[], None]]:
        api = env.lock("APIServer._lock", reentrant=True)
        ledger = env.lock("ChipSecondLedger._lock")

        def actuator() -> None:
            with ledger:        # set_hold: stamp the actuation window
                pass
            with api:           # then patch the node annotation
                pass

        def reporter() -> None:
            with api:           # consistent cluster snapshot...
                with ledger:    # ...then holds() merges the hold map
                    pass

        return [actuator, reporter]

    return build


def quarantine_transition_scenario():
    """Quarantine state machine vs the watch pump: transitions driven
    from watch callbacks run api→quarantine; the probe ticker mutates
    quarantine state under its own lock and only afterwards patches
    node taints through the api — same one-way nesting discipline."""

    def build(env: Env) -> list[Callable[[], None]]:
        api = env.lock("APIServer._lock", reentrant=True)
        quar = env.lock("QuarantineList._lock")

        def watch_transition() -> None:
            with api:           # node NotReady event under store lock
                with quar:      # record the suspect transition
                    pass

        def probe_tick() -> None:
            with quar:          # advance suspect -> quarantined
                pass
            with api:           # then taint the node
                pass

        return [watch_transition, probe_tick]

    return build


# (name, build factory, expect_clean) — the determinism gate walks this.
REGRESSION_CORPUS = [
    ("replay-dropped-buggy", replay_dropped_scenario(buggy=True), False),
    ("replay-dropped-fixed", replay_dropped_scenario(buggy=False), True),
    ("cache-watch-pump", cache_watch_pump_scenario(), True),
    ("ledger-hold", ledger_hold_scenario(), True),
    ("quarantine-transition", quarantine_transition_scenario(), True),
]
