"""A dynamic lock-order checker for tests (lockdep, ThreadSanitizer
lite), ``nos_tpu/testing/lockcheck.py`` for the port.

Lock ordering is a property of the whole program: ``kube/client.py``
has one sanctioned order (the APIServer's lock before any component's,
since watch callbacks run under it), and this checks it at test time.

- ``CheckedLock`` and ``CheckedRLock`` wrap real locks and record, per
  thread, the acquisition graph: taking B while holding A adds the edge
  A->B.  If the reverse path B->...->A is known already (from any
  thread, at any earlier time), that is a lock-order inversion, a
  possible AB/BA deadlock even if this run never interleaved fatally,
  and it is recorded with both acquisition sites.
- ``LockGraph.install()`` replaces ``threading.Lock`` and ``RLock`` so
  that every lock built inside the ``with`` block is checked, named by
  the line that built it.
- ``guard_state(obj, graph)`` also records every write to an object's
  fields made without its owning lock held: the fields and locks its
  class declares with ``utils/guards.guarded_by``, or, for a class that
  declares none, every field against ``lock_attr``.

``graph.assert_clean()`` raises with every inversion and unguarded
write; detection records and does not raise, so a run is never cut
short.  ``unguard_all()`` undoes ``guard_state``'s class patches.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

# Bind the REAL factories at import time: the graph's own bookkeeping
# must never run through a checked lock, and install() swaps the
# module-level names out from under everyone else.
_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock


@dataclass
class Inversion:
    first: str          # "A -> B" with sites
    second: str         # "B -> A" with sites

    def render(self) -> str:
        return (f"lock-order inversion: {self.second} "
                f"but the established order is {self.first}")


@dataclass
class LockGraph:
    """Global acquisition-order graph + violation sink for one test.

    Edges carry a **gate set**: the intersection, over every witness of
    the edge, of the other locks held around it.  A cycle is convicted
    only when no single lock gates ALL its edges — if every chain of
    the would-be deadlock runs under one common outer lock (the
    APIServer store lock gating nested watch delivery), the chains can
    never reach their blocking points concurrently and the order is
    safe (lockdep's nesting annotation, derived instead of declared)."""

    name: str = "lockgraph"
    edges: dict[str, set[str]] = field(default_factory=dict)
    edge_sites: dict[tuple[str, str], str] = field(default_factory=dict)
    edge_gates: dict[tuple[str, str], frozenset] = field(
        default_factory=dict)
    inversions: list[Inversion] = field(default_factory=list)
    unguarded_writes: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._mutex = _REAL_LOCK()
        self._tls = threading.local()
        self._counter = 0
        self._closed = False

    def close(self) -> None:
        """Stop recording violations (held-stack bookkeeping continues,
        so still-live checked locks stay correct).  Call after the
        verdict: a thread leaked past teardown then appends nothing to
        a graph no assertion will ever read."""
        self._closed = True

    # -- lock factory -------------------------------------------------------
    def lock(self, name: str = "", *, reentrant: bool = False):
        """A checked lock registered on this graph.  Auto-names from a
        counter when the construction site gives nothing better."""
        with self._mutex:
            self._counter += 1
            label = name or f"lock#{self._counter}"
        cls = CheckedRLock if reentrant else CheckedLock
        return cls(self, label)

    # -- held-stack bookkeeping (called by Checked*Lock) --------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquired(self, lock: "CheckedLock", site: str) -> None:
        held = self._held()
        held_names = {entry[0].name for entry in held}
        with self._mutex:
            for other, _count, other_site in held:
                if other is lock:
                    continue
                a, b = other.name, lock.name
                gate = frozenset(held_names - {a, b})
                key = (a, b)
                is_new = b not in self.edges.get(a, ())
                old_gate = self.edge_gates.get(key)
                new_gate = (gate if old_gate is None
                            else old_gate & gate)
                if is_new or new_gate != old_gate:
                    self.edges.setdefault(a, set()).add(b)
                    self.edge_gates[key] = new_gate
                    self.edge_sites.setdefault(
                        key,
                        f"{a} (held at {other_site}) -> "
                        f"{b} (acquired at {site})")
                    # a cycle b -> ... -> a closed (or re-opened by a
                    # shrinking gate set) by this edge is an inversion
                    # unless one lock gates every edge of the cycle
                    if not self._closed \
                            and self._ungated_cycle(b, a, new_gate):
                        rev = self.edge_sites.get(
                            (b, a)) or self._path_str(b, a)
                        self.inversions.append(Inversion(
                            first=rev,
                            second=f"{a} (held at {other_site}) -> "
                                   f"{b} (acquired at {site})"))
        held.append((lock, 1, site))

    def _note_reacquired(self, lock: "CheckedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                other, count, site = held[i]
                held[i] = (other, count + 1, site)
                return
        # _release_save/_acquire_restore cycles can restore a lock this
        # thread no longer tracks; treat as a fresh acquisition
        held.append((lock, 1, "restore"))

    def _note_released(self, lock: "CheckedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                other, count, site = held[i]
                if count > 1:
                    held[i] = (other, count - 1, site)
                else:
                    del held[i]
                return

    def holds(self, lock: "CheckedLock") -> bool:
        return any(entry[0] is lock for entry in self._held())

    # -- graph queries ------------------------------------------------------
    def _ungated_cycle(self, src: str, dst: str,
                       closing_gate: frozenset) -> bool:
        """Is there a path src -> ... -> dst whose chains, together with
        the closing edge's chain, hold NO common lock at their blocking
        points?  Each edge's chain holds its *from*-lock plus the edge's
        gate set, so the running intersection folds in ``gate | {from}``
        per hop (the closing edge dst -> src contributes
        ``closing_gate | {dst}``).  DFS over (node, intersection); an
        EMPTY intersection reaching dst is a convictable cycle — no
        single lock serializes all its chains.  Mutex held."""
        if src == dst and not closing_gate:
            # self-edge on a lock CLASS: two same-site instances nested
            # with no outer gate — convictable (the gate-set endpoint
            # exclusion must not treat the class itself as its own gate,
            # the two chains hold *different instances* of it)
            return True
        start = (src, closing_gate | {dst})
        stack, seen = [start], {start}
        while stack:
            node, gates = stack.pop()
            if node == dst:
                if not gates:
                    return True
                continue
            for nxt in self.edges.get(node, ()):
                nxt_gates = gates & (self.edge_gates.get(
                    (node, nxt), frozenset()) | {node})
                state = (nxt, nxt_gates)
                if state not in seen:
                    seen.add(state)
                    stack.append(state)
        return False

    def _path_str(self, src: str, dst: str) -> str:
        return f"{src} -> ... -> {dst}"

    # -- verdict ------------------------------------------------------------
    def assert_clean(self) -> None:
        problems = [inv.render() for inv in self.inversions]
        problems += self.unguarded_writes
        if problems:
            raise AssertionError(
                f"{self.name}: {len(problems)} lock-discipline "
                "violation(s):\n  " + "\n  ".join(problems))

    # -- global instrumentation --------------------------------------------
    def install(self):
        """Context manager: every ``threading.Lock()``/``RLock()``
        constructed inside gets checked on this graph, named by the
        caller's file:line.  Construction-site naming keeps two
        APIServers' locks distinct runs apart but MERGES all instances
        born at one site into one graph node — exactly lockdep's
        lock-class semantics, which is what makes witnessing an order
        once enough to convict the reverse order later."""
        return _Installed(self)


class _Installed:
    def __init__(self, graph: LockGraph) -> None:
        self._graph = graph

    def __enter__(self) -> LockGraph:
        import sys

        graph = self._graph

        def _site() -> str:
            frame = sys._getframe(2)
            return f"{frame.f_code.co_filename.split('/')[-1]}:" \
                   f"{frame.f_lineno}"

        def make_lock():
            return CheckedLock(graph, f"Lock@{_site()}")

        def make_rlock():
            return CheckedRLock(graph, f"RLock@{_site()}")

        self._saved = (threading.Lock, threading.RLock)
        threading.Lock = make_lock          # type: ignore[assignment]
        threading.RLock = make_rlock        # type: ignore[assignment]
        return graph

    def __exit__(self, *exc) -> None:
        threading.Lock, threading.RLock = self._saved
        return None


def _call_site() -> str:
    """Nearest caller frame outside this module (so `with lock:` blames
    the user's line, not CheckedLock.__enter__)."""
    import sys

    frame = sys._getframe(1)
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    if frame is None:
        return "?"
    return (f"{frame.f_code.co_filename.split('/')[-1]}:"
            f"{frame.f_lineno}")


class CheckedLock:
    """threading.Lock wrapper that feeds the acquisition graph.

    API-compatible with the real thing (acquire/release/locked/context
    manager) so ``threading.Condition``/``Event`` built on top keep
    working while instrumented."""

    _reentrant = False

    def __init__(self, graph: LockGraph, name: str) -> None:
        self._graph = graph
        self.name = name
        self._lock = _REAL_LOCK()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._graph._note_acquired(self, _call_site())
        return got

    def release(self) -> None:
        self._graph._note_released(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_current_thread(self) -> bool:
        return self._graph.holds(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
        return None

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


class CheckedRLock(CheckedLock):
    """Reentrant flavor: re-acquiring a held lock bumps a count instead
    of adding edges (self-edges are not inversions).  Implements the
    private RLock protocol (``_is_owned``/``_release_save``/
    ``_acquire_restore``) so ``threading.Condition`` waits correctly
    under instrumentation."""

    _reentrant = True

    def __init__(self, graph: LockGraph, name: str) -> None:
        super().__init__(graph, name)
        self._lock = _REAL_RLOCK()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        already = self._graph.holds(self)
        got = self._lock.acquire(blocking, timeout)
        if got:
            if already:
                self._graph._note_reacquired(self)
            else:
                self._graph._note_acquired(self, _call_site())
        return got

    # -- threading.Condition private protocol --------------------------------
    def _is_owned(self) -> bool:
        return self._lock._is_owned()

    def _release_save(self):
        # Condition.wait: fully release (however deep), hand back state.
        count = 0
        while self._graph.holds(self):
            self._graph._note_released(self)
            count += 1
        return self._lock._release_save(), count

    def _acquire_restore(self, state) -> None:
        saved, count = state
        self._lock._acquire_restore(saved)
        if count:
            self._graph._note_acquired(self, "condition-restore")
            for _ in range(count - 1):
                self._graph._note_reacquired(self)


# -- guarded shared state ---------------------------------------------------

_GUARDED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_PATCHED_CLASSES: dict[type, object] = {}     # cls -> original __setattr__


def unguard_all() -> None:
    """Restore every class __setattr__ guard_state patched and forget
    all guarded instances.  Call at test teardown (the lock_discipline
    fixture and the soak verdict do) so instrumentation — even its
    cheap per-write lookup — does not outlive the test that asked for
    it."""
    for cls, original in _PATCHED_CLASSES.items():
        cls.__setattr__ = original
    _PATCHED_CLASSES.clear()
    for obj in list(_GUARDED):
        del _GUARDED[obj]


def guard_state(obj: object, graph: LockGraph,
                lock_attr: str = "_lock", name: str = "",
                use_annotations: bool = True) -> object:
    """Enforce "writes only with the owning lock held" on ``obj``.

    Two contract sources, in priority order:

    1. **@guarded_by declarations** (``nos_tpu_torch/utils/guards.py``):
       when the class carries a ``__guarded_by__`` table, that is the
       contract: each declared lock attribute is replaced with a
       :class:`CheckedRLock` and only writes to the declared fields are
       judged, each against its declared lock.  Pass
       ``use_annotations=False`` to ignore it.
    2. **whole-object mode**: with no table, ``lock_attr`` is replaced
       and every field write without it is convicted (right for ad-hoc
       test doubles).

    The class's ``__setattr__`` is wrapped once either way.  Reads stay
    free: the contract is "every mutator takes the lock", not full
    atomicity."""
    cls = type(obj)
    table: dict[str, str] = {}
    if use_annotations:
        table = dict(getattr(cls, "__guarded_by__", {}) or {})
    if table:
        for la in sorted(set(table.values())):
            label = (f"{name}.{la}" if name
                     else f"{cls.__name__}.{la}")
            object.__setattr__(obj, la, graph.lock(label, reentrant=True))
        _GUARDED[obj] = (graph, table)
    else:
        label = name or f"{cls.__name__}.{lock_attr}"
        object.__setattr__(obj, lock_attr,
                           graph.lock(label, reentrant=True))
        _GUARDED[obj] = (graph, lock_attr)

    if cls not in _PATCHED_CLASSES:
        original = cls.__setattr__
        _PATCHED_CLASSES[cls] = original

        def checking_setattr(self, attr, value):
            entry = _GUARDED.get(self)
            # Data-descriptor attrs (property setters) are mediated:
            # the setter body runs AFTER this interception, so judge the
            # raw field write it performs (which recurses through here)
            # rather than the not-yet-locked property assignment.
            if entry is not None and not entry[0]._closed \
                    and not hasattr(getattr(type(self), attr, None),
                                    "__set__"):
                g, contract = entry
                if isinstance(contract, dict):
                    # annotated: only declared fields, per-field lock
                    la = contract.get(attr)
                else:
                    # legacy: every field except the lock itself
                    la = contract if attr != contract else None
                lock = self.__dict__.get(la) if la is not None else None
                if isinstance(lock, CheckedLock) \
                        and not lock.held_by_current_thread():
                    g.unguarded_writes.append(
                        f"unguarded write: {type(self).__name__}.{attr} "
                        f"set at {_call_site()} without {lock.name} held")
            original(self, attr, value)

        cls.__setattr__ = checking_setattr
    return obj
