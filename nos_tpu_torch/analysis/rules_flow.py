"""noslint rules N007–N010: the dataflow-backed invariants.

These are the load-bearing contracts of the *parallel* decision plane
(the parallel planner shards planning across plan pools): each one is a
convention written down in comments and docstrings, now enforced
by the dataflow engine (nos_tpu_torch/analysis/dataflow.py) before the
parallel-shard planner turns conventions into race conditions.

- **N007** — COW escape: values from ``ClusterSnapshot.fork()`` /
  ``get_node_for_write()`` are only safe inside the fork's
  commit/revert scope; storing one on ``self``, returning/yielding it,
  or capturing it in an escaping closure detaches it from the dirty-set
  (``revert()`` restores the *snapshot's* object — the escaped alias
  keeps mutating a node no rollback can see).
- **N008** — cache-invalidation completeness: a write to a *watched*
  field (``.status.phase``, ``.spec.node_name``,
  ``.metadata.annotations[...]``, ``.metadata.labels[...]``) of an
  object obtained live from the API (``api.get``/``api.list``) must be
  post-dominated by an invalidation (API write-back, generation bump,
  or watch-event emission) on every modeled path — the
  vanished-pod class, where one early-out skipped the bump.
- **N009** — leaf-lock contract: ``DecisionJournal.record()`` and the
  tracer export paths must stay leaves — their transitive callee graph
  (cross-file, via the symbol index) must not reach ``api.*``,
  ``threading.*``, or another ``record()``/``emit()``, and under their
  own lock they may call nothing but ``self._push_locked``.
- **N010** — ``@guarded_by`` (nos_tpu_torch/utils/guards.py): every write to
  a declared field must sit syntactically under ``with self.<lock>:``,
  or inside a ``*_locked`` method whose call sites are themselves
  checked.  The same declaration drives the dynamic check
  (``lockcheck.guard_state``) — one contract, two proofs.

Conservatism notes live on each rule; the shared principle: a rule only
convicts what it can *show* (a stored alias, a bump-free path, a banned
reachable call, an unlocked write site) — unresolved calls and nested
closures are documented blind spots covered by the dynamic half.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Iterator

from .core import ModuleSource, Rule, Violation
from .dataflow import (
    FunctionFlow, SymbolIndex, attr_chain_root, dotted_name, escapes,
    iter_calls, iter_functions, module_name_of, walk_in_scope,
)

# ---------------------------------------------------------------------------
# N007 — COW escape
# ---------------------------------------------------------------------------


class CowEscape(Rule):
    """N007: fork-scoped COW references must not outlive the fork."""

    id = "N007"
    title = "COW node/fork reference escapes its commit/revert scope"
    scope = ("nos_tpu_torch/",)
    # the snapshot itself RETURNS these objects — that is the mechanism
    exclude = ("nos_tpu_torch/partitioning/core/snapshot.py",
               "nos_tpu_torch/analysis/")

    SOURCES = frozenset({"fork", "get_node_for_write"})

    _KIND_MSG = {
        "stored-on-self": "stored on {detail} — the alias outlives the "
                          "fork and revert() cannot restore through it",
        "returned": "returned from the function — it leaves the fork's "
                    "commit/revert scope",
        "yielded": "yielded — the consumer sees it after commit/revert "
                   "may have replaced the snapshot's object",
        "stored-global": "stored in module global {detail} — the alias "
                         "outlives every fork scope",
        "closure": "captured by an escaping closure ({detail}) — it can "
                   "run after the fork is gone",
    }

    def _is_source(self, call: ast.Call) -> bool:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return False
        if func.attr not in self.SOURCES:
            return False
        recv = dotted_name(func.value)
        return recv.split(".")[0] not in ("os", "multiprocessing")

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        for fn in iter_functions(mod.tree):
            if not any(self._is_source(c) for c in ast.walk(fn)
                       if isinstance(c, ast.Call)):
                continue
            for esc in escapes(fn, self._is_source):
                template = self._KIND_MSG[esc.kind]
                yield Violation(
                    self.id, mod.relpath, esc.unit.lineno,
                    f"COW reference {esc.name!r} (from fork()/"
                    "get_node_for_write()) "
                    + template.format(detail=esc.detail)
                    + "; keep it local to the fork scope")


# ---------------------------------------------------------------------------
# N008 — cache-invalidation completeness
# ---------------------------------------------------------------------------


class CacheInvalidation(Rule):
    """N008: watched-field writes on live API objects need an
    invalidation on every path.

    "Live" is dataflow-derived: the written object's name must reach the
    write from an ``api.get(...)`` / ``api.list(...)`` definition
    (including iteration targets and name copies).  Writes through
    deep copies, constructor results, or function parameters are not
    convicted — a mutate-callback's parameter is the substrate's object
    and the substrate emits the event after invoking it, which is why
    the scheduler's ``def mutate(p)`` closures stay clean.  The
    post-domination check runs on the CFG's modeled paths only
    (exceptions escaping the function are not paths — see build_cfg).
    """

    id = "N008"
    title = "watched-field write without invalidation on every path"
    scope = ("nos_tpu_torch/scheduler/", "nos_tpu_torch/partitioning/",
             "nos_tpu_torch/kube/")
    # the substrate emits watch events itself; its direct store writes
    # ARE the invalidation everyone else must pair with
    exclude = ("nos_tpu_torch/kube/client.py", "nos_tpu_torch/kube/rest.py",
               "nos_tpu_torch/kube/objects.py")

    #: attribute tails that watch consumers key on
    WATCHED_ATTRS = (("status", "phase"), ("spec", "node_name"))
    WATCHED_DICTS = (("metadata", "annotations"), ("metadata", "labels"))
    DICT_MUTATORS = frozenset({"pop", "update", "setdefault", "clear"})

    #: a call whose last segment is one of these counts as invalidation
    INVALIDATORS = frozenset({
        "retry_on_conflict", "_patch_pod", "assume",
        "bump", "_bump", "_bump_locked", "_bump_node", "bump_node",
        "notify", "_notify", "emit", "_emit", "_emit_event",
    })
    #: generic CRUD verbs invalidate ONLY on an api receiver — `update`
    #: is also a dict mutator and `delete` a common method name; an
    #: unqualified match would let `labels.update(...)` silence the rule
    API_VERBS = frozenset({"patch", "update", "create", "delete"})

    @staticmethod
    def _is_api_read(call: ast.Call) -> bool:
        func = call.func
        if not isinstance(func, ast.Attribute) \
                or func.attr not in ("get", "list"):
            return False
        recv = dotted_name(func.value)
        last = recv.split(".")[-1] if recv else ""
        return last in ("api", "_api")

    def _live_defs(self, flow: FunctionFlow) -> set[int]:
        """Unit ids defining names that hold live API objects."""
        live: set[int] = set()
        units = list(flow.cfg.units())
        changed = True
        while changed:
            changed = False
            for unit in units:
                if id(unit) in live:
                    continue
                # every value position that can carry a live object:
                # plain/annotated assigns (mypy strict pushes scheduler
                # code toward `pod: Pod = api.get(...)`), tuple-valued
                # assigns, and loop iterables
                vals: list[ast.AST] = []
                if isinstance(unit, ast.Assign):
                    vals = (list(unit.value.elts)
                            if isinstance(unit.value, (ast.Tuple, ast.List))
                            else [unit.value])
                elif isinstance(unit, ast.AnnAssign) \
                        and unit.value is not None:
                    vals = [unit.value]
                elif isinstance(unit, (ast.For, ast.AsyncFor)):
                    vals = [unit.iter]
                for val in vals:
                    if isinstance(val, ast.Subscript):
                        # `pods[0]` pulls a live element out of a live
                        # list — same object, same staleness hazard
                        val = val.value
                    if (isinstance(val, ast.Call)
                            and self._is_api_read(val)) or (
                            isinstance(val, ast.Name)
                            and flow.defs_of(unit, val.id) & live):
                        live.add(id(unit))
                        changed = True
                        break
        return live

    def _watched_write(
            self, unit: ast.AST) -> tuple[ast.Name, str, ast.Call | None] | None:
        """(root name node, field description, the mutator call or None)
        when this unit writes a watched field, else None.  The call is
        carried so the invalidation check can exclude it — `labels.pop`
        shares its NAME with api-verb invalidators and must not count
        as invalidating the very write it is."""
        targets: list[ast.AST] = []
        if isinstance(unit, ast.Assign):
            targets = list(unit.targets)
        elif isinstance(unit, ast.AugAssign):
            targets = [unit.target]
        elif isinstance(unit, ast.AnnAssign) and unit.value is not None:
            targets = [unit.target]
        elif isinstance(unit, ast.Delete):
            targets = list(unit.targets)
        for t in targets:
            hit = self._match_watched(t)
            if hit:
                return hit[0], hit[1], None
        if isinstance(unit, ast.Expr) and isinstance(unit.value, ast.Call):
            call = unit.value
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in self.DICT_MUTATORS:
                hit = self._match_watched_dict(call.func.value)
                if hit:
                    return hit[0], hit[1], call
        return None

    def _match_watched(self, target: ast.AST) -> tuple[ast.Name, str] | None:
        if isinstance(target, ast.Attribute):
            if isinstance(target.value, ast.Attribute):
                pair = (target.value.attr, target.attr)
                # a watched DICT matched as a whole-attribute target is
                # its most drastic write: `pod.metadata.labels = {...}`
                if pair in self.WATCHED_ATTRS \
                        or pair in self.WATCHED_DICTS:
                    root = attr_chain_root(target)
                    if isinstance(root, ast.Name):
                        return root, ".".join(pair)
        if isinstance(target, ast.Subscript):
            return self._match_watched_dict(target.value)
        return None

    def _match_watched_dict(self, value: ast.AST) -> tuple[ast.Name, str] | None:
        if isinstance(value, ast.Attribute) \
                and isinstance(value.value, ast.Attribute):
            pair = (value.value.attr, value.attr)
            if pair in self.WATCHED_DICTS:
                root = attr_chain_root(value)
                if isinstance(root, ast.Name):
                    return root, ".".join(pair)
        return None

    #: "_gen", "gen", "generation(s)", "node_gen" — but not "agenda" or
    #: "regenerate_hint": the bump-counter match is boundary-anchored
    _GEN_RE = re.compile(r"(^|_)gen(eration)?s?($|_)")

    def _is_invalidation(self, unit: ast.AST,
                         exclude: ast.Call | None = None) -> bool:
        # iter_calls walks a unit's own expressions only — compound
        # units (If/While/For headers) expose their headers, never
        # their bodies (those are separate CFG units)
        for sub in iter_calls(unit):
            if sub is exclude:
                continue
            func = sub.func
            last = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else "")
            if last in self.INVALIDATORS:
                return True
            if last in self.API_VERBS and isinstance(func, ast.Attribute):
                recv = dotted_name(func.value)
                if (recv.split(".")[-1] if recv else "") in ("api", "_api"):
                    return True
        # writing a generation counter directly also invalidates
        targets: list[ast.AST] = []
        if isinstance(unit, ast.Assign):
            targets = list(unit.targets)
        elif isinstance(unit, ast.AugAssign):
            targets = [unit.target]
        for t in targets:
            if isinstance(t, ast.Subscript) and self._GEN_RE.search(
                    dotted_name(t.value).split(".")[-1] or ""):
                return True
            if isinstance(t, ast.Attribute) and self._GEN_RE.search(t.attr):
                return True
        return False

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        for fn in iter_functions(mod.tree):
            # cheap pre-scan: only build the CFG where a watched write
            # even appears (most functions skip the dataflow entirely)
            if not any(self._watched_write(s) is not None
                       for s in ast.walk(fn)
                       if isinstance(s, (ast.Assign, ast.AugAssign,
                                         ast.AnnAssign, ast.Expr,
                                         ast.Delete))):
                continue
            flow = FunctionFlow(fn)
            live = self._live_defs(flow)
            if not live:
                continue
            for unit in flow.cfg.units():
                hit = self._watched_write(unit)
                if hit is None:
                    continue
                root, field, write_call = hit
                if not (flow.defs_of(unit, root.id) & live):
                    continue            # not a live API object
                if self._is_invalidation(unit, exclude=write_call):
                    continue
                if flow.always_reaches_after(unit, self._is_invalidation):
                    continue
                yield Violation(
                    self.id, mod.relpath, unit.lineno,
                    f"write to watched field {root.id}.{field} of a live "
                    "API object has a path to return with NO invalidation "
                    "(api write-back, generation bump, or event emission) "
                    "— stale-cache hazard; bump/emit on every path or "
                    "mutate a copy")


# ---------------------------------------------------------------------------
# N009 — leaf-lock contract (cross-file)
# ---------------------------------------------------------------------------


class LeafLockContract(Rule):
    """N009: the journal/tracer export paths stay leaf locks.

    Instrumentation must never add a lock-order edge: any code path may
    call ``record()`` while holding any lock, so ``record()`` itself
    must reach no other lock-ordered subsystem.  ``check`` only feeds
    the symbol index; the verdicts come from ``finalize`` once the whole
    tree is indexed.  Unresolvable calls are judged by their dotted
    pattern only — the documented blind spot the lockcheck'd chaos soak
    covers at runtime.
    """

    id = "N009"
    title = "journal/tracer leaf-lock contract breach"
    scope = ("nos_tpu_torch/",)
    cross_file = True

    ROOTS = (
        ("nos_tpu_torch.obs.journal", "DecisionJournal.record"),
        ("nos_tpu_torch.obs.trace", "_SpanHandle.__exit__"),
        ("nos_tpu_torch.obs.trace", "RingExporter.export"),
    )
    BANNED_ATTRS = frozenset({"record", "emit"})
    UNDER_LOCK_OK = frozenset({"len", "list", "dict", "tuple", "min",
                               "max", "id"})

    def __init__(self) -> None:
        self.index = SymbolIndex()
        self._mods: dict[str, ModuleSource] = {}

    def check(self, mod: ModuleSource) -> Iterable[Violation]:
        self.index.add_module(mod.relpath, mod.tree)
        self._mods[module_name_of(mod.relpath)] = mod
        return ()

    def _banned(self, call: ast.Call,
                resolved: tuple[str, str] | None) -> str:
        dotted = dotted_name(call.func)
        segs = dotted.split(".") if dotted else []
        if segs and any(s in ("api", "_api") for s in segs[:-1]):
            return f"reaches the API client ({dotted})"
        if dotted.startswith("threading."):
            return f"reaches threading ({dotted})"
        last = segs[-1] if segs else ""
        if last in self.BANNED_ATTRS:
            return f"re-enters a journal/exporter ({dotted}())"
        if resolved is not None and resolved[1].split(".")[-1] \
                in self.BANNED_ATTRS:
            return (f"re-enters a journal/exporter "
                    f"({resolved[0]}.{resolved[1]})")
        return ""

    def finalize(self) -> Iterator[Violation]:
        # a root whose MODULE was indexed but whose function is gone was
        # renamed or moved — without this, the refactor silently voids
        # the whole certification (noslint exits 0 checking nothing)
        for mod_name, qual in self.ROOTS:
            if (mod_name, qual) not in self.index.functions \
                    and mod_name in self._mods:
                m = self._mods[mod_name]
                yield Violation(
                    self.id, m.relpath, 1,
                    f"leaf-lock contract root {mod_name}.{qual} no "
                    "longer resolves — it was renamed or moved; update "
                    "LeafLockContract.ROOTS so the certification stays "
                    "live")
        seen: set[tuple[str, str]] = set()
        work = [r for r in self.ROOTS if r in self.index.functions]
        while work:
            key = work.pop()
            if key in seen:
                continue
            seen.add(key)
            sym = self.index.functions[key]
            mod = self._mods.get(sym.module)
            relpath = mod.relpath if mod else sym.module
            for call, resolved in self.index.callees(key):
                why = self._banned(call, resolved)
                if why:
                    via = ""
                    if key not in self.ROOTS:
                        via = f" (reached via {'.'.join(key)})"
                    yield Violation(
                        self.id, relpath, call.lineno,
                        f"leaf-lock contract: {key[1]} {why}{via} — "
                        "record()/export must stay a leaf so "
                        "instrumenting any call site can never add a "
                        "lock-order edge")
                    continue
                if resolved is not None and resolved not in seen:
                    work.append(resolved)
        # under-lock strictness: the roots' own `with self._lock:` body
        # may call nothing but self._push_locked (+ trivial builtins)
        for key in self.ROOTS:
            sym = self.index.functions.get(key)
            if sym is None:
                continue
            mod = self._mods.get(sym.module)
            relpath = mod.relpath if mod else sym.module
            for node in ast.walk(sym.node):
                if not isinstance(node, (ast.With, ast.AsyncWith)):
                    continue
                if not any(dotted_name(i.context_expr).endswith("_lock")
                           for i in node.items):
                    continue
                for stmt in node.body:
                    for sub in walk_in_scope(stmt):
                        if not isinstance(sub, ast.Call):
                            continue
                        dotted = dotted_name(sub.func)
                        if dotted == "self._push_locked" or \
                                dotted in self.UNDER_LOCK_OK:
                            continue
                        yield Violation(
                            self.id, relpath, sub.lineno,
                            f"{key[1]} calls {dotted or '<expr>'}() under "
                            "its own lock — the leaf contract allows only "
                            "the bare append (self._push_locked); move "
                            "this call outside the critical section")


# ---------------------------------------------------------------------------
# N010 — @guarded_by, the static half
# ---------------------------------------------------------------------------


class GuardedByDiscipline(Rule):
    """N010: declared guarded fields are written only under their lock.

    Checked per decorated class:

    - every write (assign / augassign / subscript / attribute-through /
      known container mutators / del) to a declared field must be inside
      ``with self.<lock>:`` — except in ``__init__``/``__post_init__``
      (pre-publication) and in methods named ``*_locked`` (the
      caller-holds-lock convention);
    - every call of a ``self.*_locked()`` method must itself be under
      the lock (or inside another ``*_locked`` method / ``__init__``);
    - the declared lock attribute must actually be created in
      ``__init__`` (or at class level);
    - decorator arguments must be string literals — the contract is
      static or it is nothing.

    Writes inside nested defs/lambdas are not judged (deferred
    execution); the dynamic half convicts those at runtime.
    """

    id = "N010"
    title = "@guarded_by field written without its lock"
    scope = ("nos_tpu_torch/",)
    exclude = ("nos_tpu_torch/analysis/",)

    MUTATORS = frozenset({
        "append", "add", "insert", "extend", "appendleft", "pop",
        "popitem", "popleft", "clear", "update", "setdefault", "remove",
        "discard", "__setitem__",
    })
    EXEMPT_METHODS = frozenset({"__init__", "__post_init__", "__new__",
                                "__del__"})

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef):
                yield from self._check_class(mod, cls)
        yield from self._external_locked_calls(mod)

    # -- external *_locked call sites ---------------------------------------
    def _external_locked_calls(self, mod: ModuleSource) -> Iterator[Violation]:
        """`other._bump_locked()` from OUTSIDE the owning class must sit
        under a ``with`` on that same receiver (``with other._lock:``) —
        the in-class self.* form is judged precisely against the
        declared lock by _locked_call_sites; this is the syntactic
        best-effort for every other caller, so the convention the docs
        promise ('a future unlocked caller is a tier-1 failure') holds
        across class and module boundaries too."""
        for fn in iter_functions(mod.tree):
            if fn.name.endswith("_locked") or fn.name in self.EXEMPT_METHODS:
                continue
            yield from self._scan_external(mod, fn, fn.body, frozenset())

    def _scan_external(self, mod: ModuleSource, fn: ast.AST,
                       body: Iterable[ast.stmt],
                       held: frozenset[str]) -> Iterator[Violation]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                 # nested scopes scanned on their own
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                newly = {dotted_name(i.context_expr)
                         for i in stmt.items if dotted_name(i.context_expr)}
                yield from self._scan_external(mod, fn, stmt.body,
                                               held | frozenset(newly))
                continue
            for sub in iter_calls(stmt):
                if not (isinstance(sub.func, ast.Attribute)
                        and sub.func.attr.endswith("_locked")):
                    continue
                recv = dotted_name(sub.func.value)
                if not recv or recv == "self":
                    continue             # in-class form: precise check
                if any(h == recv or h.startswith(recv + ".")
                       for h in held):
                    continue             # a lock on that receiver is held
                yield Violation(
                    self.id, mod.relpath, sub.lineno,
                    f"call to {recv}.{sub.func.attr}() without a "
                    f"`with {recv}.<lock>:` in scope — *_locked methods "
                    "assume their caller holds the owning object's lock "
                    "(the convention N010 certifies)")
            for child_body in self._child_bodies(stmt):
                yield from self._scan_external(mod, fn, child_body, held)

    # -- per-class ----------------------------------------------------------
    def _check_class(self, mod: ModuleSource,
                     cls: ast.ClassDef) -> Iterator[Violation]:
        table: dict[str, str] = {}       # field -> lock attr
        for deco in cls.decorator_list:
            if not (isinstance(deco, ast.Call)
                    and self._is_guarded_by(deco.func)):
                continue
            args = deco.args
            if not args or not all(
                    isinstance(a, ast.Constant) and isinstance(a.value, str)
                    for a in args):
                yield Violation(
                    self.id, mod.relpath, deco.lineno,
                    "@guarded_by arguments must be string literals — "
                    "the static checker cannot follow computed names")
                continue
            if len(args) < 2:
                # guards.guarded_by raises this at import time too; the
                # static half flags it so a never-imported module can't
                # carry a vacuous contract
                yield Violation(
                    self.id, mod.relpath, deco.lineno,
                    "@guarded_by declares a lock but no fields — the "
                    "contract is a no-op; list the guarded fields")
                continue
            lock = args[0].value
            for a in args[1:]:
                table[a.value] = lock
        if not table:
            return
        locks = set(table.values())

        # the declared lock(s) must exist — only checkable when the class
        # has no bases that could create it (DecisionJournal's _lock
        # comes from BoundedRing; cross-file inheritance is out of a
        # per-file rule's sight)
        bases = [b for b in cls.bases
                 if dotted_name(b.value if isinstance(b, ast.Subscript)
                                else b).split(".")[-1]
                 not in ("object", "Generic", "Protocol")]
        if not bases:
            created = self._attrs_created(cls)
            for lock in sorted(locks):
                if lock not in created:
                    yield Violation(
                        self.id, mod.relpath, cls.lineno,
                        f"@guarded_by names lock attribute {lock!r} but "
                        f"{cls.name}.__init__ never creates it")

        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in self.EXEMPT_METHODS:
                continue
            held_free = item.name.endswith("_locked")
            yield from self._scan(mod, cls, item, item.body, table,
                                  frozenset(locks) if held_free
                                  else frozenset())

    @staticmethod
    def _is_guarded_by(func: ast.AST) -> bool:
        return (isinstance(func, ast.Name) and func.id == "guarded_by") or (
            isinstance(func, ast.Attribute) and func.attr == "guarded_by")

    @staticmethod
    def _attrs_created(cls: ast.ClassDef) -> set[str]:
        out: set[str] = set()
        for item in cls.body:
            if isinstance(item, ast.Assign):
                out.update(t.id for t in item.targets
                           if isinstance(t, ast.Name))
            if isinstance(item, ast.AnnAssign) and item.value is not None \
                    and isinstance(item.target, ast.Name):
                out.add(item.target.id)
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and item.name in ("__init__", "__post_init__"):
                for node in ast.walk(item):
                    if isinstance(node, ast.Attribute) \
                            and isinstance(node.ctx, ast.Store) \
                            and isinstance(node.value, ast.Name) \
                            and node.value.id == "self":
                        out.add(node.attr)
        return out

    # -- recursive body scan with lock context ------------------------------
    def _scan(self, mod: ModuleSource, cls: ast.ClassDef,
              method: ast.AST, body: Iterable[ast.stmt],
              table: dict[str, str],
              held: frozenset[str]) -> Iterator[Violation]:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                 # deferred: dynamic half's job
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                newly = {dotted_name(i.context_expr)[len("self."):]
                         for i in stmt.items
                         if dotted_name(i.context_expr).startswith("self.")}
                yield from self._scan(mod, cls, method, stmt.body, table,
                                      held | frozenset(newly))
                continue
            for v in self._stmt_writes(stmt, table, held):
                field, lock, node = v
                yield Violation(
                    self.id, mod.relpath, node.lineno,
                    f"{cls.name}.{field} is @guarded_by({lock!r}) but "
                    f"this write in {getattr(method, 'name', '?')}() is "
                    f"not under `with self.{lock}:` — take the lock, or "
                    "move the write into a *_locked helper whose callers "
                    "hold it")
            yield from self._locked_call_sites(mod, cls, method, stmt,
                                               table, held)
            # recurse into compound statements (if/for/try/...)
            for child_body in self._child_bodies(stmt):
                yield from self._scan(mod, cls, method, child_body,
                                      table, held)

    @staticmethod
    def _child_bodies(stmt: ast.stmt) -> Iterator[list[ast.stmt]]:
        for name in ("body", "orelse", "finalbody"):
            val = getattr(stmt, name, None)
            if isinstance(val, list) and val \
                    and isinstance(val[0], ast.stmt):
                yield val
        for h in getattr(stmt, "handlers", []) or []:
            yield h.body
        for c in getattr(stmt, "cases", []) or []:
            yield c.body

    def _stmt_writes(self, stmt: ast.stmt, table: dict[str, str],
                     held: frozenset[str]) -> Iterator[
                         tuple[str, str, ast.AST]]:
        """(field, lock, node) for each unlocked guarded write in the
        statement's own expressions (compound headers included; nested
        bodies handled by _scan's recursion)."""
        targets: list[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = list(stmt.targets)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if not (isinstance(stmt, ast.AnnAssign) and stmt.value is None):
                targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = list(stmt.targets)
        # flatten tuple/list destructuring: `self._a, self._b = ...`
        # writes both declared fields
        flat: list[ast.AST] = []
        while targets:
            t = targets.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                targets.extend(t.elts)
            elif isinstance(t, ast.Starred):
                targets.append(t.value)
            else:
                flat.append(t)
        for t in flat:
            field = self._guarded_field_of(t, table)
            if field and table[field] not in held:
                yield field, table[field], t
        # container mutators in the statement's OWN expressions (compound
        # statements contribute their headers only — their bodies are
        # re-scanned by _scan's recursion, once)
        for sub in iter_calls(stmt):
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in self.MUTATORS:
                field = self._guarded_field_of(sub.func.value, table)
                if field and table[field] not in held:
                    yield field, table[field], sub

    @staticmethod
    def _guarded_field_of(target: ast.AST,
                          table: dict[str, str]) -> str | None:
        """The declared field a write target touches: the FIRST attribute
        off ``self`` in the chain (``self._gen[k]``, ``self._x.y = ...``,
        ``self._items.append``)."""
        node = target
        first_attr: str | None = None
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            if isinstance(node, ast.Attribute):
                first_attr = node.attr
            node = node.value
        if isinstance(node, ast.Name) and node.id == "self" \
                and first_attr in table:
            return first_attr
        return None

    def _locked_call_sites(self, mod: ModuleSource, cls: ast.ClassDef,
                           method: ast.AST, stmt: ast.stmt,
                           table: dict[str, str],
                           held: frozenset[str]) -> Iterator[Violation]:
        if held:
            return
        for sub in iter_calls(stmt):
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr.endswith("_locked") \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id == "self":
                yield Violation(
                    self.id, mod.relpath, sub.lineno,
                    f"call to self.{sub.func.attr}() outside "
                    f"`with self.{sorted(set(table.values()))[0]}:` — "
                    "*_locked methods assume their caller holds the "
                    "lock (the convention N010 certifies)")


def flow_rules() -> list[Rule]:
    """Fresh instances of the dataflow rules N007–N010."""
    return [CowEscape(), CacheInvalidation(), LeafLockContract(),
            GuardedByDiscipline()]
