"""noslint rules N001–N006: this codebase's implicit invariants, executable.

Each rule encodes one contract the tree has already paid for breaking
(docs/static-analysis.md has the full catalog with examples).  Rules are
deliberately syntactic — single-file AST passes with conservative
heuristics — so zero-dependency, fast, and explainable; the dynamic
half (lock-order, unlocked writes) lives in nos_tpu_torch/testing/lockcheck.py
where syntax cannot reach.
"""

from __future__ import annotations

import ast
import builtins
import re
from typing import Iterable, Iterator

from .core import ModuleSource, Rule, Violation

METRIC_NAME_RE = re.compile(r"^nos_tpu_[a-z0-9_]+$")

#: Paths that implement the API substrate / retry machinery itself —
#: their raw writes ARE the mechanism N001 routes everyone else through.
SUBSTRATE_PATHS = (
    "nos_tpu_torch/utils/retry.py",
    "nos_tpu_torch/kube/client.py",
    "nos_tpu_torch/kube/rest.py",
    "nos_tpu_torch/testing/chaos.py",
    "nos_tpu_torch/analysis/",
)


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a Name/Attribute chain ('' otherwise)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _last_segment(func: ast.AST) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _is_super_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "super")


class RetryWrappedWrites(Rule):
    """N001: API mutations must flow through utils.retry.retry_on_conflict.

    Every ``api.patch(..., mutate=...)`` / ``api.update(KIND_*, obj)`` is a
    read-modify-write against the store that can lose an optimistic-
    concurrency race (Conflict) or hit a transport blip; every write
    site is wrapped by hand and this rule keeps the next one honest.
    Sites where Conflict is *semantically meaningful* (leader-election
    CAS: losing the race means losing the election, retrying would steal
    the lease) carry a ``# noslint: N001`` pragma with that reason.
    """

    id = "N001"
    title = "unretried API mutation (route through utils.retry)"
    scope = ("nos_tpu_torch/",)
    exclude = SUBSTRATE_PATHS

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            if _is_super_call(func.value):
                continue
            if func.attr == "patch" and any(
                    kw.arg == "mutate" for kw in node.keywords):
                yield Violation(
                    self.id, mod.relpath, node.lineno,
                    "raw api.patch(...) — wrap in "
                    "utils.retry.retry_on_conflict so Conflict/transient "
                    "errors are retried (or pragma why a lost race must "
                    "NOT be retried)")
            elif func.attr == "update" and self._is_api_update(node):
                yield Violation(
                    self.id, mod.relpath, node.lineno,
                    "raw api.update(KIND, obj) — a stale resourceVersion "
                    "raises Conflict; wrap in utils.retry.retry_on_conflict "
                    "(or pragma why the CAS loss is meaningful)")

    @staticmethod
    def _is_api_update(node: ast.Call) -> bool:
        if len(node.args) < 2:
            return False
        first = node.args[0]
        return (isinstance(first, ast.Name)
                and first.id.startswith("KIND_")) or (
            isinstance(first, ast.Constant) and isinstance(first.value, str))


class InjectableClock(Rule):
    """N002: no wall/monotonic clock *calls* in decision-plane code.

    Controllers, partitioning, and the scheduler run under the seeded
    chaos substrate with an injected ``clock`` callable (the
    PartitionerController pattern) so each seed is deterministic; a raw
    ``time.time()``/``time.sleep()`` call re-introduces real time and
    breaks seed reproducibility.  A *reference* used as an injectable
    default (``clock: Callable[[], float] = time.monotonic``) is fine —
    only calls are flagged.
    """

    id = "N002"
    title = "raw clock call in deterministic code (inject a clock)"
    # obs/ is in scope: span/journal timestamps must come from the
    # tracer's/journal's injectable clock or chaos seeds stop
    # reproducing byte-identical flight recordings.  serving/ likewise:
    # the autoscaler's cooldown clocks and the trace generator run
    # under the virtual bench clock, and a raw time.time() would both
    # break seed reproducibility and mis-measure cooldowns against
    # pod creation timestamps stamped from the injected clock.
    # capacity/ too: the provisioner's deadlines, breaker windows and
    # surplus timers all run on the injected clock — the capacity fleets'
    # virtual-clock scenarios and the chaos soak depend on it.
    # sim/ is the virtual clock itself: the engine IS time for every
    # composed scenario, so a raw clock call there desynchronizes the
    # whole simulated fleet (wall-time measurement enters via an
    # injected wall_clock reference only).
    scope = ("nos_tpu_torch/capacity/", "nos_tpu_torch/controllers/", "nos_tpu_torch/obs/",
             "nos_tpu_torch/partitioning/", "nos_tpu_torch/requests/",
             "nos_tpu_torch/scheduler/", "nos_tpu_torch/serving/", "nos_tpu_torch/sim/")

    BANNED_DOTTED = frozenset({
        "time.time", "time.time_ns", "time.sleep",
        "time.monotonic", "time.monotonic_ns",
        "datetime.now", "datetime.utcnow", "datetime.today",
        "datetime.datetime.now", "datetime.datetime.utcnow",
        "datetime.datetime.today",
    })
    TIME_FUNCS = frozenset({"time", "time_ns", "sleep", "monotonic",
                            "monotonic_ns"})

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        from_time: set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                from_time.update(
                    a.asname or a.name for a in node.names
                    if a.name in self.TIME_FUNCS)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            bare = (isinstance(node.func, ast.Name)
                    and node.func.id in from_time)
            if dotted in self.BANNED_DOTTED or bare:
                yield Violation(
                    self.id, mod.relpath, node.lineno,
                    f"{dotted or _last_segment(node.func)}() call in "
                    "deterministic code — accept an injectable "
                    "`clock: Callable[[], float]` (see "
                    "PartitionerController) so chaos seeds reproduce")


class MetricDiscipline(Rule):
    """N003: metric names literal + ``nos_tpu_``-prefixed, registered via
    ``REGISTRY.describe`` exactly once, label keys consistent per metric.

    Cross-file: ``check`` accumulates every REGISTRY call site, all
    verdicts come from ``finalize``.  Sites passing a non-literal
    ``labels=`` expression are skipped by the consistency check (no
    dataflow), which is why the rule also insists names themselves are
    literals — the registry stays greppable.
    """

    id = "N003"
    title = "metric naming/registration/label discipline"
    # NB: the exclude list names the Registry implementation and the
    # analyzer itself ONLY — nos_tpu_torch/obs/ (timeseries, slo) is in scope
    # like any other emitter; test_analysis pins that it stays so.
    scope = ("nos_tpu_torch/",)
    exclude = ("nos_tpu_torch/exporter/metrics.py", "nos_tpu_torch/analysis/")
    cross_file = True

    TRACKED = frozenset({"inc", "set", "observe", "time", "describe",
                         "quantile"})
    #: verbs that may carry a `buckets=` histogram layout
    BUCKET_BEARING = frozenset({"observe", "describe"})

    def __init__(self) -> None:
        # name -> [(path, line)]
        self._described: dict[str, list[tuple[str, int]]] = {}
        # name -> [(path, line, label_keys | None)]
        self._used: dict[str, list[tuple[str, int, frozenset | None]]] = {}
        # name -> [(path, line, bucket bounds)]
        self._buckets: dict[str, list[tuple[str, int, tuple]]] = {}
        self._pending: list[Violation] = []

    def check(self, mod: ModuleSource) -> Iterable[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr in self.TRACKED
                    and _dotted(func.value).split(".")[-1] == "REGISTRY"):
                continue
            if not node.args:
                continue
            first = node.args[0]
            if not (isinstance(first, ast.Constant)
                    and isinstance(first.value, str)):
                self._pending.append(Violation(
                    self.id, mod.relpath, node.lineno,
                    f"REGISTRY.{func.attr}: metric name must be a string "
                    "literal so the series registry stays statically "
                    "checkable"))
                continue
            name = first.value
            if not METRIC_NAME_RE.match(name):
                self._pending.append(Violation(
                    self.id, mod.relpath, node.lineno,
                    f"metric {name!r} must match "
                    "^nos_tpu_[a-z0-9_]+$ (project namespace)"))
            site = (mod.relpath, node.lineno)
            if func.attr in self.BUCKET_BEARING:
                self._check_buckets(mod, node, name)
            if func.attr == "describe":
                self._described.setdefault(name, []).append(site)
            else:
                self._used.setdefault(name, []).append(
                    site + (self._label_keys(node),))
        return ()

    def _check_buckets(self, mod: ModuleSource, node: ast.Call,
                       name: str) -> None:
        """A `buckets=` histogram layout must be a literal tuple/list of
        increasing numbers — the layout is part of the series contract
        (all call sites and the scrape config agree on `le=` values),
        so it must be statically checkable like the metric name."""
        for kw in node.keywords:
            if kw.arg != "buckets":
                continue
            val = kw.value
            if isinstance(val, ast.Constant) and val.value is None:
                return
            values: list[float] | None = None
            if isinstance(val, (ast.Tuple, ast.List)) and all(
                    isinstance(e, ast.Constant)
                    and isinstance(e.value, (int, float))
                    and not isinstance(e.value, bool)
                    for e in val.elts):
                values = [float(e.value) for e in val.elts]
            if values is None:
                self._pending.append(Violation(
                    self.id, mod.relpath, node.lineno,
                    f"metric {name!r}: buckets= must be a literal "
                    "tuple/list of numbers — the le= series layout is "
                    "part of the scrape contract and must be statically "
                    "checkable"))
                return
            if not values or any(b2 <= b1 for b1, b2
                                 in zip(values, values[1:])):
                self._pending.append(Violation(
                    self.id, mod.relpath, node.lineno,
                    f"metric {name!r}: buckets must be non-empty and "
                    "strictly increasing (the Registry raises at "
                    "runtime; fix it here first)"))
                return
            self._buckets.setdefault(name, []).append(
                (mod.relpath, node.lineno, tuple(values)))
            return

    @staticmethod
    def _label_keys(node: ast.Call) -> frozenset | None:
        """Label key set of a call site; None = unknown (non-literal)."""
        for kw in node.keywords:
            if kw.arg != "labels":
                continue
            val = kw.value
            if isinstance(val, ast.Constant) and val.value is None:
                return frozenset()
            if isinstance(val, ast.Dict) and all(
                    isinstance(k, ast.Constant) for k in val.keys):
                return frozenset(k.value for k in val.keys)
            return None     # computed labels: skip consistency check
        return frozenset()  # no labels argument

    def finalize(self) -> Iterator[Violation]:
        yield from self._pending
        for name, sites in sorted(self._used.items()):
            if name not in self._described:
                path, line, _ = sites[0]
                yield Violation(
                    self.id, path, line,
                    f"metric {name!r} is emitted but never registered — "
                    "add exactly one REGISTRY.describe(...) in the owning "
                    "module so /metrics carries HELP text")
        for name, sites in sorted(self._described.items()):
            for path, line in sites[1:]:
                yield Violation(
                    self.id, path, line,
                    f"metric {name!r} registered more than once (first at "
                    f"{sites[0][0]}:{sites[0][1]}) — one describe per "
                    "metric; the Registry raises on conflicting help text")
        for name, sites in sorted(self._used.items()):
            known = [(p, ln, keys) for p, ln, keys in sites
                     if keys is not None]
            if not known:
                continue
            canonical = known[0][2]
            for path, line, keys in known[1:]:
                if keys != canonical:
                    yield Violation(
                        self.id, path, line,
                        f"metric {name!r} label keys {sorted(keys)} differ "
                        f"from {sorted(canonical)} at "
                        f"{known[0][0]}:{known[0][1]} — one label schema "
                        "per metric or the series explode")
        for name, bsites in sorted(self._buckets.items()):
            first_path, first_line, canonical_b = bsites[0]
            for path, line, bounds in bsites[1:]:
                if bounds != canonical_b:
                    yield Violation(
                        self.id, path, line,
                        f"metric {name!r} bucket layout {bounds} differs "
                        f"from {canonical_b} at {first_path}:{first_line} "
                        "— one bucket layout per histogram (the Registry "
                        "raises on the conflict at runtime)")


class NoBlockingUnderLock(Rule):
    """N004: no blocking calls in the *syntactic* body of ``with lock:``.

    A sleep/network/future-wait under a held lock turns one slow caller
    into a convoy (and under the APIServer RLock, into a stalled watch
    bus).  Scope is the direct statement body — calls made *by called
    functions* are the dynamic checker's job (testing/lockcheck.py);
    nested ``def``/``lambda`` bodies are excluded (deferred execution).
    INFO+ logging counts as blocking (handler I/O); ``logger.debug`` is
    allowed — disabled-level calls return before formatting.
    """

    id = "N004"
    title = "blocking call inside `with lock:`"
    scope = ("nos_tpu_torch/",)
    exclude = ("nos_tpu_torch/analysis/",)

    BLOCKING_LAST = frozenset({"sleep", "result", "urlopen", "wait",
                               "retry_on_conflict"})
    BLOCKING_DOTTED_PREFIX = ("requests.", "subprocess.", "socket.")
    LOG_IO = frozenset({"info", "warning", "error", "exception",
                        "critical"})

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            lock_names = [self._lock_name(item.context_expr)
                          for item in node.items]
            lock = next((n for n in lock_names if n), "")
            if not lock:
                continue
            for call in self._body_calls(node.body):
                why = self._blocking_reason(call)
                if why:
                    yield Violation(
                        self.id, mod.relpath, call.lineno,
                        f"{why} while holding {lock!r} — move it outside "
                        "the lock scope (compute under the lock, block "
                        "after release)")

    @staticmethod
    def _lock_name(expr: ast.AST) -> str:
        """'...lock'-ish context managers: `self._lock`, `api.locked()`."""
        if isinstance(expr, ast.Call):
            if _last_segment(expr.func) == "locked":
                return _dotted(expr.func) or "locked()"
            return ""
        dotted = _dotted(expr)
        last = dotted.split(".")[-1].lower()
        return dotted if "lock" in last else ""

    def _body_calls(self, body: list[ast.stmt]) -> Iterator[ast.Call]:
        """Calls in the statement body, not descending into deferred
        scopes (function/class definitions, lambdas)."""
        stack: list[ast.AST] = list(body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    def _blocking_reason(self, call: ast.Call) -> str:
        dotted = _dotted(call.func)
        last = _last_segment(call.func)
        if last in self.BLOCKING_LAST:
            return f"blocking {dotted or last}() call"
        if any(dotted.startswith(p) for p in self.BLOCKING_DOTTED_PREFIX):
            return f"blocking {dotted}() call"
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in self.LOG_IO
                and _dotted(call.func.value).split(".")[-1]
                in ("logger", "logging")):
            return f"log I/O ({dotted})"
        return ""


class NoSwallowedExceptions(Rule):
    """N005: no bare ``except:``; no silently-swallowed broad excepts.

    A run-loop/reconcile body that catches ``Exception`` and does
    *nothing* (no raise, no log, no counter, no recorded state — body
    with no call at all) turns the next real bug into a silent stall;
    the seed's missing-import class survived exactly this way.  Narrow
    the exception type, or handle it observably, or pragma the few
    best-effort sites with the reason they must never raise.
    """

    id = "N005"
    title = "bare/swallowed exception handler"
    scope = ("nos_tpu_torch/",)
    exclude = ("nos_tpu_torch/analysis/",)

    BROAD = frozenset({"Exception", "BaseException"})

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield Violation(
                    self.id, mod.relpath, node.lineno,
                    "bare `except:` catches SystemExit/KeyboardInterrupt "
                    "— name the exception type (at minimum `Exception`)")
                continue
            if self._is_broad(node.type) and self._swallows(node):
                yield Violation(
                    self.id, mod.relpath, node.lineno,
                    "broad except whose body neither raises, logs, nor "
                    "records — a swallowed failure here becomes a silent "
                    "stall; narrow the type or handle it observably")

    def _is_broad(self, type_node: ast.AST) -> bool:
        names = (type_node.elts if isinstance(type_node, ast.Tuple)
                 else [type_node])
        return any(isinstance(n, ast.Name) and n.id in self.BROAD
                   for n in names)

    @staticmethod
    def _swallows(handler: ast.ExceptHandler) -> bool:
        """Swallowed = no raise, no call, and the bound exception (if
        any) never read — `first_exc = e` style recording counts as
        handling; `return False` alone does not."""
        for stmt in handler.body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Raise, ast.Call)):
                    return False
                if (handler.name and isinstance(node, ast.Name)
                        and node.id == handler.name
                        and isinstance(node.ctx, ast.Load)):
                    return False
        return True


class NameHygiene(Rule):
    """N006: undefined names (latent NameError) + unused imports.

    The bound-anywhere model: a load of a name bound *nowhere in the
    file* (any scope, plus builtins) cannot resolve at runtime — that is
    exactly the seed's ``build_api``-missing-import class across the six
    cmd/ entrypoints, caught without executing them.  Names bound in
    *some* scope are assumed visible (no per-scope flow analysis): zero
    false positives at the cost of missing cross-scope misuse, which
    tier-1 execution covers.  Unused-import runs everywhere except
    ``__init__.py`` (re-export surface).
    """

    id = "N006"
    title = "undefined name / unused import"
    scope = ("nos_tpu_torch/",)
    exclude = ("nos_tpu_torch/analysis/",)

    IMPLICIT = frozenset({
        "__name__", "__file__", "__doc__", "__package__", "__loader__",
        "__spec__", "__builtins__", "__debug__", "__class__", "__path__",
        "__annotations__", "__dict__",
    })

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        bound: set[str] = set()
        loads: dict[str, int] = {}      # name -> first load line
        imports: list[tuple[str, int]] = []
        star_import = False
        dunder_all: set[str] = set()

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.setdefault(node.id, node.lineno)
                else:
                    bound.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                bound.add(node.name)
            elif isinstance(node, ast.arg):
                bound.add(node.arg)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name.split(".")[0]
                    bound.add(name)
                    imports.append((name, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name == "*":
                        star_import = True
                        continue
                    name = alias.asname or alias.name
                    bound.add(name)
                    if node.module != "__future__":
                        imports.append((name, node.lineno))
            elif isinstance(node, ast.ExceptHandler) and node.name:
                bound.add(node.name)
            elif isinstance(node, (ast.Global, ast.Nonlocal)):
                bound.update(node.names)
            else:
                # 3.10 match bindings (MatchAs/MatchStar/MatchMapping)
                for attr in ("name", "rest"):
                    val = getattr(node, attr, None)
                    if isinstance(val, str) and type(node).__name__ \
                            .startswith("Match"):
                        bound.add(val)

        # Quoted annotations ('-> "ClusterSnapshot"') are uses: parse
        # every string constant sitting in an annotation position and
        # count its identifiers as loads, so TYPE_CHECKING-only imports
        # referenced by forward refs are not "unused".
        ann_roots: list[ast.AST] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.AnnAssign):
                ann_roots.append(node.annotation)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.returns is not None:
                    ann_roots.append(node.returns)
            elif isinstance(node, ast.arg) and node.annotation is not None:
                ann_roots.append(node.annotation)
        for root in ann_roots:
            for sub in ast.walk(root):
                if not (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)):
                    continue
                try:
                    expr = ast.parse(sub.value, mode="eval")
                except SyntaxError:
                    continue
                for ref in ast.walk(expr):
                    if isinstance(ref, ast.Name):
                        loads.setdefault(ref.id, sub.lineno)

        for stmt in mod.tree.body:
            if (isinstance(stmt, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "__all__"
                            for t in stmt.targets)
                    and isinstance(stmt.value, (ast.List, ast.Tuple))):
                dunder_all.update(
                    e.value for e in stmt.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))

        known = bound | self.IMPLICIT | set(dir(builtins))
        if not star_import:
            for name, line in sorted(loads.items(),
                                     key=lambda kv: kv[1]):
                if name not in known:
                    yield Violation(
                        self.id, mod.relpath, line,
                        f"undefined name {name!r} — bound nowhere in this "
                        "file: a latent NameError on the first call "
                        "(missing import?)")

        if mod.relpath.endswith("__init__.py"):
            return
        for name, line in imports:
            if name not in loads and name not in dunder_all:
                yield Violation(
                    self.id, mod.relpath, line,
                    f"unused import {name!r} — delete it (or export via "
                    "__all__ if it is the module's API)")


def default_rules() -> list[Rule]:
    """Fresh instances of every rule: the tokenize/AST passes N001–N006,
    the dataflow rules N007–N010 (rules_flow.py) and the determinism
    certification N011–N012 (rules_det.py; N003, N009 and N012 carry
    cross-file state, hence fresh instances per run)."""
    from .rules_det import det_rules
    from .rules_flow import flow_rules

    return [RetryWrappedWrites(), InjectableClock(), MetricDiscipline(),
            NoBlockingUnderLock(), NoSwallowedExceptions(), NameHygiene(),
            *flow_rules(), *det_rules()]
