"""noslint rules N011–N012: the determinism certification pass.

The incremental scheduler and the sharded planner anchor on the
planner being a *pure function of the snapshot*: byte-identical decision
journals across hash seeds and worker counts (determinism.py, ``python
-m nos_tpu_torch.analysis --determinism``, proves it dynamically).
These rules forbid, statically, the two nondeterminism classes that
would make that anchor flap:

- **N011** — unordered-collection iteration feeding a decision: a value
  of ``set``/``frozenset`` type (literal, constructor, comprehension,
  set operator, annotation) iterated by an *order-sensitive* consumer —
  a loop that appends/yields/breaks/returns/records, a list/generator
  comprehension, ``list()``/``tuple()``/``.join()`` materialization,
  ``next(iter(...))``/``.pop()`` (pure hash order), or a
  ``min``/``max`` with ``key=`` (ties break by iteration order) — in
  decision-plane code.  The fix is ``sorted(..., key=...)``; an audited
  stable order gets a reasoned pragma.  Plain dicts are
  insertion-ordered (3.7+) and exempt, BUT a dict *built by iterating a
  tainted source* (``{k: f(k) for k in some_set}``) inherits hash
  insertion order, so iterating it — or its
  ``.keys()/.values()/.items()`` views — is convicted too.

- **N012** — invalidation-protocol completeness: classes carrying
  ``@invalidated_by('<event>', '<field>', ...)``
  (nos_tpu_torch/utils/guards.py) declare that in-place mutations of each
  watched source field must be post-dominated, on every modeled path,
  by an emission of the declared invalidation event — a call whose last
  segment is the event name, or a write to ``self.<event>`` (the
  counter-bump form).  Whole-field rebinds (``self._idx = {}``) are the
  invalidate-by-rebuild idiom and exempt, as are ``__init__``/
  ``__post_init__`` and the event method itself.  This extends N008
  (single watched-attribute writes on live API objects) to the full
  index protocol: the watch-maintained SchedulerCache indexes, the
  scheduler's per-cycle lister feeding the class-scan caches and its
  window-busy map (``_busy_map_cache``, whose in-place flips ride
  ``_mark_busy``), and the planner snapshot's epoch-memoised views.  A REQUIRED registry keeps
  the certification live across renames (the N009 pattern): the named
  cache classes must carry the declaration at all.

Conservatism: both rules convict only what they can *show* — taint and
aliases propagate through plain name copies, one ``.get()``/subscript
element hop, and assignment pairs; mutations reached through deeper
aliasing or cross-function flow are blind spots the dynamic half
(determinism.py, the interleave explorer) covers at runtime.
"""

from __future__ import annotations

import ast
from typing import Iterator

from .core import ModuleSource, Rule, Violation
from .dataflow import (
    FunctionFlow, attr_chain_root, dotted_name, iter_calls, iter_functions,
    module_name_of, use_roots, walk_in_scope,
)

# ---------------------------------------------------------------------------
# N011 — unordered iteration feeding a decision
# ---------------------------------------------------------------------------


class UnorderedIterationHazard(Rule):
    """N011: set/frozenset iteration order must never reach a decision."""

    id = "N011"
    title = "unordered-collection iteration feeds an order-sensitive decision"
    scope = ("nos_tpu_torch/scheduler/", "nos_tpu_torch/partitioning/",
             "nos_tpu_torch/capacity/", "nos_tpu_torch/controllers/",
             "nos_tpu_torch/serving/", "nos_tpu_torch/quota/", "nos_tpu_torch/sim/",
             "nos_tpu_torch/requests/")

    SET_CONSTRUCTORS = frozenset({"set", "frozenset"})
    #: methods that return a set when their receiver is one
    SET_METHODS = frozenset({"union", "intersection", "difference",
                             "symmetric_difference", "copy"})
    SET_ANNOTATIONS = frozenset({"set", "frozenset", "Set", "FrozenSet",
                                 "AbstractSet", "MutableSet"})
    SET_BINOPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)
    #: dict views whose order is the dict's insertion order — hazardous
    #: exactly when the dict itself was built in hash order
    DICT_VIEWS = frozenset({"keys", "values", "items", "copy"})

    #: loop-body calls that make the iteration order observable
    ORDERED_SINKS = frozenset({"append", "extend", "insert", "appendleft",
                               "record", "emit"})
    #: consumers whose result is independent of argument order — a
    #: comprehension/list() handed DIRECTLY to one of these is fine.
    #: min/max qualify only without key= (ties break by encounter order)
    INSENSITIVE_CONSUMERS = frozenset({
        "sorted", "set", "frozenset", "sum", "any", "all", "len",
        "min", "max", "dict", "Counter"})

    # -- taint ---------------------------------------------------------------
    def _ann_is_set(self, ann: ast.AST) -> bool:
        if isinstance(ann, ast.Subscript):
            ann = ann.value
        d = dotted_name(ann)
        return (d.split(".")[-1] if d else "") in self.SET_ANNOTATIONS

    @staticmethod
    def _pairs(unit: ast.AST) -> Iterator[tuple[str, ast.AST]]:
        """(bound name, value expr) pairs of an assignment unit."""
        if isinstance(unit, ast.Assign):
            for t in unit.targets:
                if isinstance(t, ast.Name):
                    yield t.id, unit.value
                elif isinstance(t, (ast.Tuple, ast.List)) \
                        and isinstance(unit.value, (ast.Tuple, ast.List)) \
                        and len(t.elts) == len(unit.value.elts):
                    for el, v in zip(t.elts, unit.value.elts):
                        if isinstance(el, ast.Name):
                            yield el.id, v
        elif isinstance(unit, ast.AnnAssign) \
                and isinstance(unit.target, ast.Name) \
                and unit.value is not None:
            yield unit.target.id, unit.value

    def _analyze(self, fn: ast.AST) -> tuple[FunctionFlow, set, set]:
        """(flow, set-tainted defs, hash-ordered-dict defs) — defs are
        (unit id, name)."""
        flow = FunctionFlow(fn)
        units = list(flow.cfg.units())
        sets: set[tuple[int, str]] = set()
        ords: set[tuple[int, str]] = set()

        a = fn.args
        for arg in (a.posonlyargs + a.args + a.kwonlyargs):
            if arg.annotation is not None \
                    and self._ann_is_set(arg.annotation):
                sets.add((id(fn), arg.arg))

        def name_in(unit: ast.AST, name: str, pool: set) -> bool:
            return any((u, name) in pool for u in flow.defs_of(unit, name))

        def set_expr(unit: ast.AST, expr: ast.AST) -> bool:
            if isinstance(expr, (ast.Set, ast.SetComp)):
                return True
            if isinstance(expr, ast.Name):
                return name_in(unit, expr.id, sets)
            if isinstance(expr, ast.BinOp) \
                    and isinstance(expr.op, self.SET_BINOPS):
                return set_expr(unit, expr.left) \
                    or set_expr(unit, expr.right)
            if isinstance(expr, ast.IfExp):
                return set_expr(unit, expr.body) \
                    or set_expr(unit, expr.orelse)
            if isinstance(expr, ast.Call):
                f = expr.func
                if isinstance(f, ast.Name) \
                        and f.id in self.SET_CONSTRUCTORS:
                    return True
                if isinstance(f, ast.Attribute) \
                        and f.attr in self.SET_METHODS:
                    return set_expr(unit, f.value)
            return False

        def ord_expr(unit: ast.AST, expr: ast.AST) -> bool:
            """A dict whose INSERTION order is hash order."""
            if isinstance(expr, ast.DictComp):
                return any(set_expr(unit, g.iter)
                           for g in expr.generators)
            if isinstance(expr, ast.Name):
                return name_in(unit, expr.id, ords)
            if isinstance(expr, ast.Call):
                f = expr.func
                if isinstance(f, ast.Name) and f.id == "dict" and expr.args:
                    arg = expr.args[0]
                    if isinstance(arg, (ast.GeneratorExp, ast.ListComp)):
                        return any(set_expr(unit, g.iter)
                                   for g in arg.generators)
                    return set_expr(unit, arg) or ord_expr(unit, arg)
                if isinstance(f, ast.Attribute) \
                        and f.attr in self.DICT_VIEWS:
                    return ord_expr(unit, f.value)
            return False

        changed = True
        while changed:
            changed = False
            for unit in units:
                for name, val in self._pairs(unit):
                    key = (id(unit), name)
                    if key not in sets and set_expr(unit, val):
                        sets.add(key)
                        changed = True
                    if key not in ords and ord_expr(unit, val):
                        ords.add(key)
                        changed = True
                if isinstance(unit, ast.AnnAssign) \
                        and isinstance(unit.target, ast.Name) \
                        and self._ann_is_set(unit.annotation):
                    key = (id(unit), unit.target.id)
                    if key not in sets:
                        sets.add(key)
                        changed = True
        self._set_expr = set_expr
        self._ord_expr = ord_expr
        return flow, sets, ords

    # -- sinks ---------------------------------------------------------------
    def _hazardous_iter(self, unit: ast.AST, it: ast.AST) -> bool:
        """The iterable's order is hash-dependent (set-tainted or a
        hash-ordered dict / its views), after unwrapping enumerate()."""
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "enumerate" and it.args:
            it = it.args[0]
        return self._set_expr(unit, it) or self._ord_expr(unit, it)

    def _body_is_order_sensitive(self, body: list[ast.stmt]) -> bool:
        """The loop body makes iteration order observable: ordered
        accumulation, first-match selection, emission, or keyed stores
        (insertion order of the result).  Pure set/counter building
        (``.add``, ``|=``, ``sum``) is order-insensitive and exempt."""
        for stmt in body:
            for sub in [stmt, *walk_in_scope(stmt)]:
                if isinstance(sub, (ast.Break, ast.Return,
                                    ast.Yield, ast.YieldFrom)):
                    return True
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in self.ORDERED_SINKS:
                    return True
                if isinstance(sub, ast.Assign) and any(
                        isinstance(t, ast.Subscript) for t in sub.targets):
                    return True
        return False

    def _blessed(self, unit: ast.AST) -> set[int]:
        """id()s of argument nodes handed DIRECTLY to an
        order-insensitive consumer (``sorted(list(s))`` &c)."""
        out: set[int] = set()
        for call in iter_calls(unit):
            f = call.func
            fname = f.id if isinstance(f, ast.Name) else ""
            if fname not in self.INSENSITIVE_CONSUMERS:
                continue
            if fname in ("min", "max") \
                    and any(kw.arg == "key" for kw in call.keywords):
                continue
            out.update(id(a) for a in call.args)
        return out

    _FIX = ("; iterate sorted(..., key=...) or document the stable "
            "order with a reasoned pragma")

    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        for fn in iter_functions(mod.tree):
            # cheap pre-scan: any set-producing syntax or annotation at
            # all?  Most functions skip the dataflow entirely.
            if not self._prescan(fn):
                continue
            flow, sets, ords = self._analyze(fn)
            if not sets and not ords:
                continue
            for unit in flow.cfg.units():
                yield from self._judge_unit(mod, unit)

    def _prescan(self, fn: ast.AST) -> bool:
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.Set, ast.SetComp)):
                return True
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Name) \
                    and sub.func.id in self.SET_CONSTRUCTORS:
                return True
            if isinstance(sub, ast.arg) and sub.annotation is not None \
                    and self._ann_is_set(sub.annotation):
                return True
            if isinstance(sub, ast.AnnAssign) \
                    and self._ann_is_set(sub.annotation):
                return True
        return False

    def _judge_unit(self, mod: ModuleSource,
                    unit: ast.AST) -> Iterator[Violation]:
        if isinstance(unit, (ast.For, ast.AsyncFor)) \
                and self._hazardous_iter(unit, unit.iter) \
                and self._body_is_order_sensitive(unit.body):
            yield Violation(
                self.id, mod.relpath, unit.lineno,
                "for-loop over an unordered collection (set/frozenset "
                "or hash-ordered dict) with an order-sensitive body "
                "(append/yield/break/return/record/keyed store) — the "
                "decision depends on PYTHONHASHSEED" + self._FIX)
            return
        blessed = self._blessed(unit)
        for root in use_roots(unit):
            nodes = [root] if isinstance(
                root, (ast.Call, ast.ListComp, ast.GeneratorExp)) else []
            nodes += list(walk_in_scope(root))
            for sub in nodes:
                v = self._judge_expr(mod, unit, sub, blessed)
                if v is not None:
                    yield v

    def _judge_expr(self, mod: ModuleSource, unit: ast.AST, sub: ast.AST,
                    blessed: set[int]) -> Violation | None:
        if isinstance(sub, (ast.ListComp, ast.GeneratorExp)) \
                and id(sub) not in blessed \
                and any(self._hazardous_iter(unit, g.iter)
                        for g in sub.generators):
            return Violation(
                self.id, mod.relpath, sub.lineno,
                "comprehension over an unordered collection materializes "
                "hash order into a sequence" + self._FIX)
        if not isinstance(sub, ast.Call):
            return None
        f = sub.func
        if isinstance(f, ast.Name):
            if f.id in ("list", "tuple") and len(sub.args) == 1 \
                    and id(sub) not in blessed \
                    and self._hazardous_iter(unit, sub.args[0]):
                return Violation(
                    self.id, mod.relpath, sub.lineno,
                    f"{f.id}() over an unordered collection materializes "
                    "hash order into a sequence" + self._FIX)
            if f.id in ("min", "max") and sub.args \
                    and any(kw.arg == "key" for kw in sub.keywords) \
                    and self._hazardous_iter(unit, sub.args[0]):
                return Violation(
                    self.id, mod.relpath, sub.lineno,
                    f"{f.id}(..., key=) over an unordered collection "
                    "breaks ties by hash iteration order" + self._FIX)
            if f.id == "next" and sub.args \
                    and isinstance(sub.args[0], ast.Call) \
                    and isinstance(sub.args[0].func, ast.Name) \
                    and sub.args[0].func.id == "iter" \
                    and sub.args[0].args \
                    and self._hazardous_iter(unit, sub.args[0].args[0]):
                return Violation(
                    self.id, mod.relpath, sub.lineno,
                    "next(iter(...)) over an unordered collection picks a "
                    "hash-order-dependent element" + self._FIX)
        if isinstance(f, ast.Attribute):
            if f.attr == "pop" and not sub.args \
                    and self._set_expr(unit, f.value):
                return Violation(
                    self.id, mod.relpath, sub.lineno,
                    "set.pop() removes a hash-order-dependent element"
                    + self._FIX)
            if f.attr == "join" and len(sub.args) == 1 \
                    and self._hazardous_iter(unit, sub.args[0]):
                return Violation(
                    self.id, mod.relpath, sub.lineno,
                    "str.join() over an unordered collection materializes "
                    "hash order" + self._FIX)
        return None


# ---------------------------------------------------------------------------
# N012 — @invalidated_by, the static half
# ---------------------------------------------------------------------------


class InvalidationProtocol(Rule):
    """N012: declared watched-field mutations emit their invalidation
    event on every modeled path.

    Checked per ``@invalidated_by``-decorated class (see the module
    docstring for the mutation/emission/exemption model).  Cross-file
    half: the REQUIRED registry below pins the cache classes the
    incremental scheduler depends on — a rename that silently
    drops the declaration is itself a violation, so the certification
    cannot rot into a no-op.
    """

    id = "N012"
    title = "@invalidated_by watched-field mutation without its event"
    scope = ("nos_tpu_torch/",)
    exclude = ("nos_tpu_torch/analysis/",)
    cross_file = True

    #: (module, class, what the declaration certifies) — these classes
    #: MUST carry @invalidated_by (the incremental scheduler's caches)
    REQUIRED = (
        ("nos_tpu_torch.scheduler.cache", "SchedulerCache",
         "the watch-maintained node/pod indexes behind snapshot()"),
        ("nos_tpu_torch.scheduler.scheduler", "Scheduler",
         "the cycle lister feeding the class-scan caches, and the "
         "window-busy map (_busy_map_cache) whose mutations must ride "
         "_mark_busy"),
        ("nos_tpu_torch.partitioning.core.snapshot", "ClusterSnapshot",
         "the node map behind the epoch-memoised planner views"),
    )

    MUTATORS = frozenset({
        "append", "add", "insert", "extend", "appendleft", "pop",
        "popitem", "popleft", "clear", "update", "setdefault", "remove",
        "discard", "add_pod", "remove_pod",
    })
    EXEMPT_METHODS = frozenset({"__init__", "__post_init__", "__new__"})

    def __init__(self) -> None:
        # (module, class) -> (relpath, lineno, carries declaration)
        self._classes: dict[tuple[str, str], tuple[str, int, bool]] = {}
        self._required_mods = {m for m, _, _ in self.REQUIRED}
        self._seen_modules: set[str] = set()

    # -- per-file ------------------------------------------------------------
    def check(self, mod: ModuleSource) -> Iterator[Violation]:
        module = module_name_of(mod.relpath)
        if module in self._required_mods:
            self._seen_modules.add(module)
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            table, errs = self._decl_table(mod, cls)
            yield from errs
            if module in self._required_mods:
                self._classes[(module, cls.name)] = (
                    mod.relpath, cls.lineno, bool(table))
            if table:
                yield from self._check_class(mod, cls, table)

    @staticmethod
    def _is_decorator(func: ast.AST) -> bool:
        return (isinstance(func, ast.Name)
                and func.id == "invalidated_by") or (
            isinstance(func, ast.Attribute)
            and func.attr == "invalidated_by")

    def _decl_table(self, mod: ModuleSource, cls: ast.ClassDef) -> tuple[
            dict[str, str], list[Violation]]:
        table: dict[str, str] = {}
        errs: list[Violation] = []
        for deco in cls.decorator_list:
            if not (isinstance(deco, ast.Call)
                    and self._is_decorator(deco.func)):
                continue
            args = deco.args
            if not args or not all(
                    isinstance(a, ast.Constant) and isinstance(a.value, str)
                    for a in args):
                errs.append(Violation(
                    self.id, mod.relpath, deco.lineno,
                    "@invalidated_by arguments must be string literals — "
                    "the static checker cannot follow computed names"))
                continue
            if len(args) < 2:
                errs.append(Violation(
                    self.id, mod.relpath, deco.lineno,
                    "@invalidated_by declares an event but no watched "
                    "fields — the contract is a no-op; list the fields"))
                continue
            event = args[0].value
            for a in args[1:]:
                table[a.value] = event
        if table:
            errs.extend(self._check_events_exist(mod, cls, table))
        return table, errs

    def _check_events_exist(self, mod: ModuleSource, cls: ast.ClassDef,
                            table: dict[str, str]) -> Iterator[Violation]:
        """Each declared event must be a method of the class or an
        attribute its __init__ creates (counter form) — only checkable
        when the class has no bases that could supply it."""
        from .rules_flow import GuardedByDiscipline

        bases = [b for b in cls.bases
                 if dotted_name(b.value if isinstance(b, ast.Subscript)
                                else b).split(".")[-1]
                 not in ("object", "Generic", "Protocol")]
        if bases:
            return
        methods = {item.name for item in cls.body
                   if isinstance(item, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))}
        created = GuardedByDiscipline._attrs_created(cls)
        for event in sorted(set(table.values())):
            if event not in methods and event not in created:
                yield Violation(
                    self.id, mod.relpath, cls.lineno,
                    f"@invalidated_by names event {event!r} but "
                    f"{cls.name} defines no such method and __init__ "
                    "creates no such attribute — the declared protocol "
                    "cannot fire")

    # -- the dataflow check --------------------------------------------------
    def _check_class(self, mod: ModuleSource, cls: ast.ClassDef,
                     table: dict[str, str]) -> Iterator[Violation]:
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in self.EXEMPT_METHODS:
                continue
            # the event method IS the emitter: its own mutations of the
            # fields it invalidates are the protocol, not a breach
            fields = {f: e for f, e in table.items() if e != item.name}
            if not fields:
                continue
            if not self._mentions_fields(item, fields):
                continue
            yield from self._check_method(mod, cls, item, fields)

    @staticmethod
    def _mentions_fields(fn: ast.AST, fields: dict[str, str]) -> bool:
        return any(isinstance(sub, ast.Attribute) and sub.attr in fields
                   for sub in ast.walk(fn))

    def _check_method(self, mod: ModuleSource, cls: ast.ClassDef,
                      fn: ast.AST, fields: dict[str, str]
                      ) -> Iterator[Violation]:
        flow = FunctionFlow(fn)
        units = list(flow.cfg.units())
        alias, elem = self._aliases(flow, units, fields)

        def field_of(unit: ast.AST, name: str) -> str | None:
            for pool in (alias, elem):
                for u in flow.defs_of(unit, name):
                    fld = pool.get((u, name))
                    if fld is not None:
                        return fld
            return None

        def emission_pred(event: str, exclude: ast.AST | None = None):
            def is_emission(unit: ast.AST) -> bool:
                for call in iter_calls(unit):
                    if call is exclude:
                        continue
                    f = call.func
                    last = f.attr if isinstance(f, ast.Attribute) else (
                        f.id if isinstance(f, ast.Name) else "")
                    if last == event:
                        return True
                targets: list[ast.AST] = []
                if isinstance(unit, ast.Assign):
                    targets = list(unit.targets)
                elif isinstance(unit, (ast.AugAssign, ast.AnnAssign)):
                    targets = [unit.target]
                return any(isinstance(t, ast.Attribute) and t.attr == event
                           for t in targets)
            return is_emission

        for unit in units:
            for fld, node, mut_call in self._mutations(unit, fields,
                                                       field_of):
                if emission_pred(fields[fld], exclude=mut_call)(unit):
                    continue
                if flow.always_reaches_after(
                        unit, emission_pred(fields[fld])):
                    continue
                yield Violation(
                    self.id, mod.relpath, node.lineno,
                    f"{cls.name}.{fld} is @invalidated_by"
                    f"({fields[fld]!r}) but this mutation in "
                    f"{getattr(fn, 'name', '?')}() has a path to return "
                    "with NO emission of the event — a derived cache "
                    "keyed on it goes stale; emit on every path or "
                    "rebuild the field wholesale")

    def _aliases(self, flow: FunctionFlow, units: list[ast.AST],
                 fields: dict[str, str]) -> tuple[
                     dict[tuple[int, str], str], dict[tuple[int, str], str]]:
        """Local names copying a watched field (``x = self._idx``) and
        one-hop element reads (``ni = x.get(k)`` / ``ni = x[k]``) —
        mutator calls through either count as field mutations."""
        alias: dict[tuple[int, str], str] = {}
        elem: dict[tuple[int, str], str] = {}

        def src_field(unit: ast.AST, expr: ast.AST) -> str | None:
            if isinstance(expr, ast.Attribute) \
                    and isinstance(expr.value, ast.Name) \
                    and expr.value.id == "self" and expr.attr in fields:
                return expr.attr
            if isinstance(expr, ast.Name):
                for u in flow.defs_of(unit, expr.id):
                    fld = alias.get((u, expr.id))
                    if fld is not None:
                        return fld
            return None

        changed = True
        while changed:
            changed = False
            for unit in units:
                for name, val in UnorderedIterationHazard._pairs(unit):
                    key = (id(unit), name)
                    fld = src_field(unit, val)
                    if fld is not None and alias.get(key) != fld:
                        alias[key] = fld
                        changed = True
                        continue
                    container: ast.AST | None = None
                    if isinstance(val, ast.Subscript):
                        container = val.value
                    elif isinstance(val, ast.Call) \
                            and isinstance(val.func, ast.Attribute) \
                            and val.func.attr == "get":
                        container = val.func.value
                    if container is not None:
                        fld = src_field(unit, container)
                        if fld is not None and elem.get(key) != fld:
                            elem[key] = fld
                            changed = True
        return alias, elem

    def _chain_field(self, node: ast.AST,
                     fields: dict[str, str]) -> tuple[str | None, bool]:
        """(watched field, chain-is-deep) for a target/receiver chain.
        Peels Attribute/Subscript AND call results
        (``self._idx.setdefault(k, {})[p] = v``); "deep" means the
        write goes THROUGH the field (mutation) rather than rebinding
        it (``self._idx = {}``, exempt)."""
        deep = False
        first_attr: str | None = None
        cur = node
        while True:
            if isinstance(cur, ast.Attribute):
                if first_attr is not None:
                    deep = True
                first_attr = cur.attr
                cur = cur.value
            elif isinstance(cur, ast.Subscript):
                deep = True
                first_attr = None
                cur = cur.value
            elif isinstance(cur, ast.Call):
                deep = True
                first_attr = None
                cur = cur.func
            else:
                break
        if isinstance(cur, ast.Name) and cur.id == "self" \
                and first_attr in fields:
            return first_attr, deep
        return None, deep

    def _mutations(self, unit: ast.AST, fields: dict[str, str],
                   field_of) -> Iterator[
                       tuple[str, ast.AST, ast.AST | None]]:
        """(field, anchor node, mutator call or None) per watched
        mutation in this unit."""
        targets: list[ast.AST] = []
        aug = False
        if isinstance(unit, ast.Assign):
            targets = list(unit.targets)
        elif isinstance(unit, ast.AugAssign):
            targets, aug = [unit.target], True
        elif isinstance(unit, ast.AnnAssign) and unit.value is not None:
            targets = [unit.target]
        elif isinstance(unit, ast.Delete):
            targets = list(unit.targets)
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
            fld, deep = self._chain_field(t, fields)
            if fld is not None and (deep or aug):
                yield fld, t, None
                continue
            # writes through a local alias / element alias
            root = attr_chain_root(t)
            if isinstance(root, ast.Name) and root is not t:
                fld = field_of(unit, root.id)
                if fld is not None:
                    yield fld, t, None
        for call in iter_calls(unit):
            f = call.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr in self.MUTATORS):
                continue
            fld, _ = self._chain_field(f.value, fields)
            if fld is None:
                root = attr_chain_root(f.value)
                if isinstance(root, ast.Name):
                    fld = field_of(unit, root.id)
            if fld is not None:
                yield fld, call, call

    # -- cross-file: the certification must stay live ------------------------
    def finalize(self) -> Iterator[Violation]:
        for module, cls_name, what in self.REQUIRED:
            if module not in self._seen_modules:
                continue                 # module not in this sweep's paths
            entry = self._classes.get((module, cls_name))
            relpath = module.replace(".", "/") + ".py"
            if entry is None:
                yield Violation(
                    self.id, relpath, 1,
                    f"N012 registry root {module}.{cls_name} no longer "
                    "resolves — it was renamed or moved; update "
                    "InvalidationProtocol.REQUIRED so the determinism "
                    "certification stays live")
            elif not entry[2]:
                yield Violation(
                    self.id, entry[0], entry[1],
                    f"{cls_name} maintains {what} but declares no "
                    "@invalidated_by protocol — every cross-cycle cache "
                    "source must name its invalidation event "
                    "(utils/guards.py; docs/static-analysis.md v3)")


def det_rules() -> list[Rule]:
    """Fresh instances of the determinism rules N011–N012."""
    return [UnorderedIterationHazard(), InvalidationProtocol()]
