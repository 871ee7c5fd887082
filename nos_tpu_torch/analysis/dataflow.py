"""noslint's dataflow engine: CFG, def-use, inevitability, escape, symbols.

The N001–N006 rules are single-pass AST pattern matches — they cannot
see that a ``get_node_for_write()`` result was *stored*, that a
watched-field write has a branch that skips its generation bump, or that
a call three hops away reaches ``api.*``.  This module is the analysis substrate the
dataflow rules (rules_flow.py, N007–N010) stand on:

- :func:`build_cfg` — an intraprocedural control-flow graph over
  *units* (elementary statements and branch/loop headers).  Branches,
  loops (with ``break``/``continue``), ``with``, ``try``/``except``/
  ``finally`` (abnormal exits are routed through enclosing ``finally``
  bodies by inlining them, the classic lowering) and ``match`` are
  modeled; exceptions are modeled only as edges from the ``try`` region
  to its handlers — a call that raises out of the function is *not* a
  modeled path (rules that need "all paths" semantics state this).
- :class:`FunctionFlow` — reaching definitions / def-use chains over
  the CFG, plus :meth:`FunctionFlow.always_reaches_after`, the backward
  must-analysis ("on every modeled path from here to the function exit,
  a unit matching ``pred`` occurs") that N008 uses for its
  post-domination check.
- :func:`escapes` — intraprocedural escape analysis: given taint
  sources (calls), propagate through name copies via def-use and report
  every way the value outlives the frame: stored on ``self``, returned,
  yielded, or captured by a closure that itself escapes (N007).
- :class:`SymbolIndex` — a cross-file symbol table + best-effort call
  resolution (``self.m()`` through base classes, module aliases,
  ``from``-imports, module-level singletons like ``REGISTRY``), the
  finalize-phase substrate for N009's callee-graph reachability.

Everything here is conservative in the direction each *rule* needs and
says so at the rule; the engine itself just reports facts.
"""

from __future__ import annotations

import ast
import copy
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

# ---------------------------------------------------------------------------
# Small AST helpers (shared with rules_flow)
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """Best-effort dotted name of a Name/Attribute chain ('' otherwise)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def attr_chain_root(node: ast.AST) -> ast.AST:
    """The innermost value of an Attribute/Subscript chain (peels both)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def walk_in_scope(node: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does NOT descend into nested function/class/lambda
    scopes (their statements belong to a different CFG)."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, _SCOPE_NODES):
            stack.extend(ast.iter_child_nodes(child))


def iter_functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    """Every def in the module, at any nesting depth (methods included)."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ---------------------------------------------------------------------------
# CFG
# ---------------------------------------------------------------------------


@dataclass
class Block:
    id: int
    units: list[ast.AST] = field(default_factory=list)
    succs: set[int] = field(default_factory=set)
    preds: set[int] = field(default_factory=set)


class CFG:
    """Intraprocedural control-flow graph.  ``entry`` holds the argument
    bindings (the FunctionDef node itself is its unit); ``exit`` holds
    no units.  ``pos(unit)`` locates a unit as (block id, index)."""

    def __init__(self) -> None:
        self.blocks: dict[int, Block] = {}
        self.entry = self._new().id
        self.exit = self._new().id
        self._pos: dict[int, tuple[int, int]] = {}

    def _new(self) -> Block:
        b = Block(len(self.blocks))
        self.blocks[b.id] = b
        return b

    def add_unit(self, block_id: int, unit: ast.AST) -> None:
        blk = self.blocks[block_id]
        self._pos[id(unit)] = (block_id, len(blk.units))
        blk.units.append(unit)

    def edge(self, a: int, b: int) -> None:
        self.blocks[a].succs.add(b)
        self.blocks[b].preds.add(a)

    def pos(self, unit: ast.AST) -> tuple[int, int]:
        return self._pos[id(unit)]

    def units(self) -> Iterator[ast.AST]:
        for blk in self.blocks.values():
            yield from blk.units


class _CFGBuilder:
    """One pass over a function body.  ``finally`` routing inlines the
    pending ``finally`` bodies at every abnormal exit (return / break /
    continue) — the classic lowering, so inevitability sees them."""

    def __init__(self, fn: ast.AST) -> None:
        self.cfg = CFG()
        self.fn = fn
        # (header_block, after_block, finally_depth) per open loop
        self._loops: list[tuple[int, int, int]] = []
        self._finallys: list[list[ast.stmt]] = []

    def build(self) -> CFG:
        self.cfg.add_unit(self.cfg.entry, self.fn)  # argument bindings
        end = self._body(getattr(self.fn, "body", []), self.cfg.entry)
        if end is not None:
            self.cfg.edge(end, self.cfg.exit)
        return self.cfg

    # -- statement dispatch -------------------------------------------------
    def _body(self, stmts: Iterable[ast.stmt], cur: int | None) -> int | None:
        for stmt in stmts:
            if cur is None:
                # unreachable code after return/raise/break: park it in a
                # fresh block with no predecessors so facts still exist
                cur = self.cfg._new().id
            cur = self._stmt(stmt, cur)
        return cur

    def _stmt(self, stmt: ast.stmt, cur: int) -> int | None:
        if isinstance(stmt, ast.If):
            return self._if(stmt, cur)
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._loop(stmt, cur)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self.cfg.add_unit(cur, stmt)       # context exprs + binds
            return self._body(stmt.body, cur)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, cur)
        if isinstance(stmt, ast.Match):
            return self._match(stmt, cur)
        if isinstance(stmt, (ast.Return, ast.Raise)):
            self.cfg.add_unit(cur, stmt)
            cur = self._run_finallys(cur, 0)
            if cur is not None:
                self.cfg.edge(cur, self.cfg.exit)
            return None
        if isinstance(stmt, (ast.Break, ast.Continue)):
            self.cfg.add_unit(cur, stmt)
            if not self._loops:
                return None                    # malformed; be lenient
            header, after, depth = self._loops[-1]
            cur2 = self._run_finallys(cur, depth)
            if cur2 is not None:
                self.cfg.edge(cur2, after if isinstance(stmt, ast.Break)
                              else header)
            return None
        # simple statement (nested defs/classes are opaque binding units)
        self.cfg.add_unit(cur, stmt)
        return cur

    def _run_finallys(self, cur: int, down_to: int) -> int | None:
        """Inline every pending finally body (innermost first) above
        ``down_to`` on the abnormal-exit path starting at ``cur``.

        Each inlining gets a DEEP COPY of the statements: CFG positions
        and dataflow facts are keyed by node identity, so reusing the
        originals (which the normal path in _try already owns) would
        silently overwrite one copy's facts with the other's — judging
        a finally-body write's inevitability only on the last path
        registered.  Copies keep their source linenos for reporting."""
        for body in reversed(self._finallys[down_to:]):
            nxt = self.cfg._new().id
            self.cfg.edge(cur, nxt)
            end = self._body(copy.deepcopy(body), nxt)
            if end is None:
                return None                    # finally itself diverted
            cur = end
        return cur

    # -- compound forms -----------------------------------------------------
    def _if(self, stmt: ast.If, cur: int) -> int | None:
        self.cfg.add_unit(cur, stmt)           # the test
        join = self.cfg._new().id
        then = self.cfg._new().id
        self.cfg.edge(cur, then)
        then_end = self._body(stmt.body, then)
        if then_end is not None:
            self.cfg.edge(then_end, join)
        if stmt.orelse:
            other = self.cfg._new().id
            self.cfg.edge(cur, other)
            else_end = self._body(stmt.orelse, other)
            if else_end is not None:
                self.cfg.edge(else_end, join)
        else:
            self.cfg.edge(cur, join)
        return join if self.cfg.blocks[join].preds else None

    def _loop(self, stmt: ast.stmt, cur: int) -> int:
        header = self.cfg._new().id
        self.cfg.edge(cur, header)
        self.cfg.add_unit(header, stmt)        # test / iter+target bind
        after = self.cfg._new().id
        body_start = self.cfg._new().id
        self.cfg.edge(header, body_start)
        infinite = (isinstance(stmt, ast.While)
                    and isinstance(stmt.test, ast.Constant)
                    and bool(stmt.test.value))
        orelse = getattr(stmt, "orelse", [])
        if orelse and not infinite:
            else_start = self.cfg._new().id
            self.cfg.edge(header, else_start)
            else_end = self._body(orelse, else_start)
            if else_end is not None:
                self.cfg.edge(else_end, after)
        elif not infinite:
            self.cfg.edge(header, after)       # zero iterations / test false
        self._loops.append((header, after, len(self._finallys)))
        body_end = self._body(stmt.body, body_start)
        self._loops.pop()
        if body_end is not None:
            self.cfg.edge(body_end, header)    # back edge
        return after

    def _try(self, stmt: ast.Try, cur: int) -> int | None:
        region_lo = len(self.cfg.blocks)
        try_start = self.cfg._new().id
        self.cfg.edge(cur, try_start)
        if stmt.finalbody:
            self._finallys.append(stmt.finalbody)
        body_end = self._body(stmt.body, try_start)
        if body_end is not None and stmt.orelse:
            body_end = self._body(stmt.orelse, body_end)
        region_hi = len(self.cfg.blocks)
        ends: list[int] = [body_end] if body_end is not None else []
        for handler in stmt.handlers:
            h_start = self.cfg._new().id
            # an exception can surface from anywhere in the try region —
            # including mid-block, before any of a block's defs landed,
            # which the pre-try edge (cur) conservatively models
            for bid in [cur, *range(region_lo, region_hi)]:
                self.cfg.edge(bid, h_start)
            self.cfg.add_unit(h_start, handler)   # `except T as e:` binds e
            h_end = self._body(handler.body, h_start)
            if h_end is not None:
                ends.append(h_end)
        if stmt.finalbody:
            self._finallys.pop()
            fin = self.cfg._new().id
            for e in ends:
                self.cfg.edge(e, fin)
            if not ends:
                # every normal path diverted; finally still runs on them
                # via _run_finallys inlining — this block is the residual
                # exceptional pass-through
                self.cfg.edge(try_start, fin)
            return self._body(stmt.finalbody, fin)
        if not ends:
            return None
        join = self.cfg._new().id
        for e in ends:
            self.cfg.edge(e, join)
        return join

    def _match(self, stmt: ast.Match, cur: int) -> int | None:
        self.cfg.add_unit(cur, stmt)           # subject eval
        join = self.cfg._new().id
        exhaustive = False
        for case in stmt.cases:
            c_start = self.cfg._new().id
            self.cfg.edge(cur, c_start)
            self.cfg.add_unit(c_start, case)   # pattern binds
            c_end = self._body(case.body, c_start)
            if c_end is not None:
                self.cfg.edge(c_end, join)
            if (isinstance(case.pattern, ast.MatchAs)
                    and case.pattern.pattern is None and case.guard is None):
                exhaustive = True              # wildcard `case _:`
        if not exhaustive:
            self.cfg.edge(cur, join)
        return join if self.cfg.blocks[join].preds else None


def build_cfg(fn: ast.AST) -> CFG:
    """CFG of one function (or a synthetic Module treated as a body)."""
    return _CFGBuilder(fn).build()


# ---------------------------------------------------------------------------
# Per-unit def/use extraction
# ---------------------------------------------------------------------------


def unit_defs(unit: ast.AST, entry: bool = False) -> set[str]:
    """Names this unit binds (assignment targets, loop targets, with-as,
    imports, def/class names, except-as, match captures; plus the
    arguments when the unit is the CFG *entry* — a nested-def statement
    binds only its name, its parameters live in the inner scope)."""
    out: set[str] = set()
    if isinstance(unit, (ast.FunctionDef, ast.AsyncFunctionDef)):
        if entry:
            a = unit.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs):
                out.add(arg.arg)
            if a.vararg:
                out.add(a.vararg.arg)
            if a.kwarg:
                out.add(a.kwarg.arg)
        out.add(unit.name)
        return out
    if isinstance(unit, ast.ClassDef):
        return {unit.name}
    if isinstance(unit, ast.ExceptHandler):
        return {unit.name} if unit.name else set()
    if isinstance(unit, (ast.Import, ast.ImportFrom)):
        for alias in unit.names:
            if alias.name != "*":
                out.add(alias.asname or alias.name.split(".")[0])
        return out
    targets: list[ast.AST] = []
    if isinstance(unit, ast.Assign):
        targets = list(unit.targets)
    elif isinstance(unit, (ast.AugAssign, ast.AnnAssign)):
        targets = [unit.target]
    elif isinstance(unit, (ast.For, ast.AsyncFor)):
        targets = [unit.target]
    elif isinstance(unit, (ast.With, ast.AsyncWith)):
        targets = [i.optional_vars for i in unit.items if i.optional_vars]
    elif isinstance(unit, ast.match_case):
        for sub in ast.walk(unit.pattern):
            for attr in ("name", "rest"):
                v = getattr(sub, attr, None)
                if isinstance(v, str):
                    out.add(v)
        return out
    for t in targets:
        for sub in ast.walk(t):
            # Store ctx only: `pod.status.phase = x` does NOT rebind
            # `pod` (the chain root is a Load) — treating it as a kill
            # would sever the def-use chain mid-object-mutation
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Store):
                out.add(sub.id)
    # walrus binds anywhere in the unit's expressions
    for sub in walk_in_scope(unit):
        if isinstance(sub, ast.NamedExpr) and isinstance(sub.target, ast.Name):
            out.add(sub.target.id)
    return out


def use_roots(unit: ast.AST) -> list[ast.AST]:
    """The expression roots whose Name loads count as uses of this unit
    (compound statements contribute their header expressions only —
    their bodies are separate units)."""
    if isinstance(unit, ast.If):
        return [unit.test]
    if isinstance(unit, ast.While):
        return [unit.test]
    if isinstance(unit, (ast.For, ast.AsyncFor)):
        return [unit.iter]
    if isinstance(unit, (ast.With, ast.AsyncWith)):
        return [i.context_expr for i in unit.items]
    if isinstance(unit, ast.Match):
        return [unit.subject]
    if isinstance(unit, ast.match_case):
        return [unit.guard] if unit.guard else []
    if isinstance(unit, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef, ast.ExceptHandler)):
        return []
    if isinstance(unit, ast.Try):
        # no header expression at all — the bodies are separate units
        # (CFG) / separately-scanned statements (N010); falling through
        # to the default would re-walk the whole subtree with the wrong
        # context
        return []
    return [unit]


def iter_calls(unit: ast.AST) -> Iterator[ast.Call]:
    """Every Call in the unit's own expressions (its ``use_roots``) —
    the one place the 'walk headers, not bodies' subtlety lives for the
    rules that scan a statement's calls."""
    for root in use_roots(unit):
        # walk_in_scope yields children only, so a root that IS a Call
        # must be yielded itself — but never via a full ast.walk, which
        # would descend into lambda bodies (deferred execution the
        # scope-aware walk deliberately excludes)
        if isinstance(root, ast.Call):
            yield root
        for sub in walk_in_scope(root):
            if isinstance(sub, ast.Call):
                yield sub


def unit_uses(unit: ast.AST) -> set[str]:
    """Names this unit loads (nested function/lambda bodies excluded —
    those are closure captures, reported by :func:`closure_captures`)."""
    out: set[str] = set()
    for root in use_roots(unit):
        nodes = [root] if isinstance(root, ast.Name) else list(
            walk_in_scope(root))
        for sub in nodes:
            if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
                out.add(sub.id)
    return out


def _free_names(closure: ast.AST) -> set[str]:
    """Names a def/lambda loads but does not bind itself (two passes:
    all bindings first, then loads outside them)."""
    bound: set[str] = set()
    a = closure.args
    for arg in (a.posonlyargs + a.args + a.kwonlyargs):
        bound.add(arg.arg)
    if a.vararg:
        bound.add(a.vararg.arg)
    if a.kwarg:
        bound.add(a.kwarg.arg)
    for inner in ast.walk(closure):
        if isinstance(inner, ast.Name) \
                and isinstance(inner.ctx, (ast.Store, ast.Del)):
            bound.add(inner.id)
        elif isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)) and inner is not closure:
            bound.add(inner.name)
    return {inner.id for inner in ast.walk(closure)
            if isinstance(inner, ast.Name)
            and isinstance(inner.ctx, ast.Load)
            and inner.id not in bound}


def closure_captures(unit: ast.AST) -> dict[ast.AST, set[str]]:
    """Nested def/lambda nodes within this unit -> the free names their
    bodies load.  A statement-level ``def`` is itself a closure (the
    unit binds its name; the body captures the enclosing frame)."""
    out: dict[ast.AST, set[str]] = {}
    if isinstance(unit, (ast.FunctionDef, ast.AsyncFunctionDef)):
        # a nested-def statement unit — NOT the CFG entry (escapes()
        # never passes the entry here; its reaching set is empty anyway)
        out[unit] = _free_names(unit)
        return out
    for root in use_roots(unit):
        for sub in ast.walk(root):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                out[sub] = _free_names(sub)
    return out


# ---------------------------------------------------------------------------
# Reaching definitions / def-use
# ---------------------------------------------------------------------------


class FunctionFlow:
    """Reaching-definitions dataflow over one function's CFG.

    A *definition* is (name, unit); ``reaching(unit)`` is the set of
    definitions live at the unit's entry.  ``defs_of(unit, name)``
    filters that to one name — the def-use chain read.  The analysis is
    a classic forward may-union fixpoint; loops converge because the
    lattice is finite.
    """

    def __init__(self, fn: ast.AST, cfg: CFG | None = None) -> None:
        self.fn = fn
        self.cfg = cfg or build_cfg(fn)
        self._defs: dict[int, set[str]] = {}
        self._in: dict[int, set[tuple[str, int]]] = {}
        self._unit_in: dict[int, set[tuple[str, int]]] = {}
        self._solve()

    def _solve(self) -> None:
        cfg = self.cfg
        gen: dict[int, dict[str, int]] = {}
        for bid, blk in cfg.blocks.items():
            g: dict[str, int] = {}
            for unit in blk.units:
                for name in unit_defs(unit, entry=(unit is self.fn)):
                    g[name] = id(unit)
            gen[bid] = g
        in_sets: dict[int, set[tuple[str, int]]] = {
            bid: set() for bid in cfg.blocks}
        work = list(cfg.blocks)
        out_sets: dict[int, set[tuple[str, int]]] = {
            bid: set() for bid in cfg.blocks}
        while work:
            bid = work.pop()
            blk = cfg.blocks[bid]
            new_in: set[tuple[str, int]] = set()
            for p in blk.preds:
                new_in |= out_sets[p]
            in_sets[bid] = new_in
            killed = set(gen[bid])
            new_out = {(n, u) for (n, u) in new_in if n not in killed}
            new_out |= {(n, u) for n, u in gen[bid].items()}
            if new_out != out_sets[bid]:
                out_sets[bid] = new_out
                work.extend(blk.succs)
        self._in = in_sets
        # per-unit IN: walk each block forward applying gen/kill
        for bid, blk in cfg.blocks.items():
            live = set(in_sets[bid])
            for unit in blk.units:
                self._unit_in[id(unit)] = set(live)
                bound = unit_defs(unit, entry=(unit is self.fn))
                if bound:
                    live = {(n, u) for (n, u) in live if n not in bound}
                    live |= {(n, id(unit)) for n in bound}

    def reaching(self, unit: ast.AST) -> set[tuple[str, int]]:
        return self._unit_in.get(id(unit), set())

    def defs_of(self, unit: ast.AST, name: str) -> set[int]:
        """id()s of the units whose definition of ``name`` reaches
        ``unit`` (the AugAssign/self-referential read sees the prior
        defs, since a unit's IN excludes its own bindings)."""
        return {u for (n, u) in self.reaching(unit) if n == name}

    # -- inevitability (the N008 post-domination read) ----------------------
    def always_reaches_after(self, unit: ast.AST,
                             pred: Callable[[ast.AST], bool]) -> bool:
        """True iff on EVERY modeled path from just after ``unit`` to the
        function exit, some unit matching ``pred`` occurs.  Exceptions
        escaping the function are not modeled paths (build_cfg)."""
        bid, idx = self.cfg.pos(unit)
        blk = self.cfg.blocks[bid]
        for later in blk.units[idx + 1:]:
            if pred(later):
                return True
        inev = self._inevitable_in(pred)
        succs = blk.succs
        return bool(succs) and all(inev[s] for s in succs)

    def _inevitable_in(self, pred: Callable[[ast.AST], bool]) -> dict[int, bool]:
        """inev[b]: every path starting at b's entry hits a pred unit.
        Greatest fixpoint (init True, exit False, iterate down)."""
        cfg = self.cfg
        has = {bid: any(pred(u) for u in blk.units)
               for bid, blk in cfg.blocks.items()}
        inev = {bid: True for bid in cfg.blocks}
        inev[cfg.exit] = False
        changed = True
        while changed:
            changed = False
            for bid, blk in cfg.blocks.items():
                if bid == cfg.exit or has[bid]:
                    continue
                val = bool(blk.succs) and all(inev[s] for s in blk.succs)
                if val != inev[bid]:
                    inev[bid] = val
                    changed = True
        return inev


# ---------------------------------------------------------------------------
# Escape analysis (N007)
# ---------------------------------------------------------------------------


def _direct_subexprs(expr: ast.AST) -> list[ast.AST]:
    """Sub-expressions reachable without crossing a Call boundary: the
    positions from which a value is handed onward verbatim (tuple/list
    elements, conditional arms) rather than consumed by a callee."""
    out: list[ast.AST] = []
    stack = [expr]
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, ast.Call):
            continue
        stack.extend(ast.iter_child_nodes(node))
    return out


@dataclass(frozen=True)
class Escape:
    kind: str          # "stored-on-self" | "returned" | "yielded" |
    #                    "stored-global" | "closure"
    unit: ast.AST      # the escaping statement (line anchor)
    name: str          # the tainted name that escaped
    detail: str = ""


def escapes(fn: ast.AST, source: Callable[[ast.Call], bool],
            flow: FunctionFlow | None = None) -> list[Escape]:
    """Every way a value produced by a ``source`` call outlives ``fn``.

    Taint: a name assigned (directly or through name-copy chains, incl.
    annotated and tuple-destructured assignments) from a source call —
    plus the source call appearing *directly* in the escaping position
    (``self._x = snap.fork()``, ``return snap.fork()``) with no
    intermediate name at all.  Reported escapes: assignment into
    ``self.*`` (or a subscript/attribute thereof), assignment to a
    module global, return, yield, ``.append/.add/...`` of a tainted
    value into a ``self.*`` container, and capture by a closure that
    itself escapes (returned, yielded, or stored on ``self``).  A
    closure that stays local — a ``sorted(key=...)`` lambda — does not
    escape.
    """
    flow = flow or FunctionFlow(fn)
    units = list(flow.cfg.units())

    def direct_source(expr: ast.AST | None) -> bool:
        """A source call sits in ``expr`` without crossing another call
        boundary — the value is handed onward verbatim."""
        if expr is None:
            return False
        return any(isinstance(s, ast.Call) and source(s)
                   for s in _direct_subexprs(expr))

    # -- seed + propagate taint through name copies -------------------------
    # tainted definitions are (defining unit id, name): tuple targets
    # taint only the element actually paired with a source/copy value
    tainted: set[tuple[int, str]] = set()

    def is_tainted(unit: ast.AST, name: str) -> bool:
        return any((u, name) in tainted
                   for u in flow.defs_of(unit, name))

    def pairs(unit: ast.AST) -> Iterator[tuple[str, ast.AST]]:
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

    changed = True
    while changed:
        changed = False
        for unit in units:
            for name, val in pairs(unit):
                if (id(unit), name) in tainted:
                    continue
                is_src = isinstance(val, ast.Call) and source(val)
                is_copy = (isinstance(val, ast.Name)
                           and is_tainted(unit, val.id))
                if is_src or is_copy:
                    tainted.add((id(unit), name))
                    changed = True

    def first_source_label(expr: ast.AST) -> str:
        for s in _direct_subexprs(expr):
            if isinstance(s, ast.Call) and source(s):
                return (dotted_name(s.func) or "<source>") + "(...)"
        return "<source>(...)"

    def target_value_pairs(unit: ast.Assign) -> Iterator[
            tuple[ast.AST, ast.AST]]:
        """(target element, value expr) with tuple destructuring paired
        element-wise so `self._x, y = fork(), 5` judges each side."""
        for t in unit.targets:
            if isinstance(t, (ast.Tuple, ast.List)) \
                    and isinstance(unit.value, (ast.Tuple, ast.List)) \
                    and len(t.elts) == len(unit.value.elts):
                yield from zip(t.elts, unit.value.elts)
            else:
                yield t, unit.value

    mutators = {"append", "add", "insert", "appendleft", "extend",
                "setdefault", "update"}

    # -- containers holding tainted values ----------------------------------
    # `out[k] = n` / `out.append(n)` put the alias inside a LOCAL
    # container; returning/yielding/storing that container then carries
    # every element past the frame.  Judged flow-insensitively (a name,
    # once a carrier, stays one) — the certifier errs conservative.
    container_hot: set[str] = set()

    def _value_carries(unit: ast.AST, val: ast.AST) -> bool:
        if isinstance(val, ast.Name):
            return is_tainted(unit, val.id) or val.id in container_hot
        return isinstance(val, ast.Call) and source(val)

    changed = True
    while changed:
        changed = False
        for unit in units:
            if isinstance(unit, ast.Assign):
                for t, val in target_value_pairs(unit):
                    if not isinstance(t, ast.Subscript):
                        continue
                    root = attr_chain_root(t)
                    if isinstance(root, ast.Name) and root.id != "self" \
                            and root.id not in container_hot \
                            and _value_carries(unit, val):
                        container_hot.add(root.id)
                        changed = True
                # `alias = out` keeps carrying
                for name, val in pairs(unit):
                    if isinstance(val, ast.Name) \
                            and val.id in container_hot \
                            and name not in container_hot:
                        container_hot.add(name)
                        changed = True
            if isinstance(unit, (ast.Expr, ast.Assign)):
                for sub in iter_calls(unit):
                    if not (isinstance(sub.func, ast.Attribute)
                            and sub.func.attr in mutators):
                        continue
                    recv = attr_chain_root(sub.func.value)
                    if isinstance(recv, ast.Name) and recv.id != "self" \
                            and recv.id not in container_hot \
                            and any(_value_carries(unit, a)
                                    for a in sub.args):
                        container_hot.add(recv.id)
                        changed = True

    out: list[Escape] = []
    # closure name -> (def unit, captured tainted names)
    closures: dict[str, tuple[ast.AST, set[str]]] = {}
    # names the function declares `global`: a bare-name store to one is
    # a module-level escape
    global_names: set[str] = set()
    for sub in walk_in_scope(fn):
        if isinstance(sub, ast.Global):
            global_names.update(sub.names)

    for unit in units:
        hot = {n for n in unit_uses(unit)
               if is_tainted(unit, n) or n in container_hot}
        if isinstance(unit, ast.Assign):
            for t, val in target_value_pairs(unit):
                root = attr_chain_root(t)
                rhs_names = {s.id for s in ast.walk(val)
                             if isinstance(s, ast.Name)
                             and isinstance(s.ctx, ast.Load)} & hot
                carried = bool(rhs_names) or direct_source(val)
                name = (sorted(rhs_names)[0] if rhs_names
                        else first_source_label(val))
                if not carried:
                    continue
                if t is root:
                    if isinstance(t, ast.Name) and t.id in global_names:
                        out.append(Escape("stored-global", unit,
                                          name, t.id))
                    continue
                if isinstance(root, ast.Name) and root.id == "self":
                    out.append(Escape("stored-on-self", unit, name,
                                      dotted_name(t) or "self.<...>"))
        if isinstance(unit, ast.AugAssign):
            # `self._dirty += [node]` / `self._seen |= {node}` store the
            # value exactly like the plain-assign container forms
            root = attr_chain_root(unit.target)
            rhs_names = {s.id for s in ast.walk(unit.value)
                         if isinstance(s, ast.Name)
                         and isinstance(s.ctx, ast.Load)} & hot
            carried = bool(rhs_names) or direct_source(unit.value)
            if carried:
                name = (sorted(rhs_names)[0] if rhs_names
                        else first_source_label(unit.value))
                if unit.target is not root and isinstance(root, ast.Name) \
                        and root.id == "self":
                    out.append(Escape("stored-on-self", unit, name,
                                      dotted_name(unit.target)
                                      or "self.<...>"))
                elif isinstance(unit.target, ast.Name) \
                        and unit.target.id in global_names:
                    out.append(Escape("stored-global", unit, name,
                                      unit.target.id))
        if isinstance(unit, ast.Return) and unit.value is not None:
            names = {s.id for s in ast.walk(unit.value)
                     if isinstance(s, ast.Name)
                     and isinstance(s.ctx, ast.Load)} & hot
            for n in sorted(names):
                out.append(Escape("returned", unit, n))
            if not names and direct_source(unit.value):
                out.append(Escape("returned", unit,
                                  first_source_label(unit.value)))
        if isinstance(unit, (ast.Expr, ast.Assign)):
            for sub in walk_in_scope(unit):
                if isinstance(sub, (ast.Yield, ast.YieldFrom)) \
                        and sub.value is not None:
                    names = {s.id for s in ast.walk(sub.value)
                             if isinstance(s, ast.Name)
                             and isinstance(s.ctx, ast.Load)} & hot
                    for n in sorted(names):
                        out.append(Escape("yielded", unit, n))
                    if not names and direct_source(sub.value):
                        out.append(Escape("yielded", unit,
                                          first_source_label(sub.value)))
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in mutators:
                    recv_root = attr_chain_root(sub.func.value)
                    arg_names: set[str] = set()
                    for a in sub.args:
                        if isinstance(a, ast.Name) and a.id in hot:
                            arg_names.add(a.id)
                        elif isinstance(a, ast.Call) and source(a):
                            arg_names.add(first_source_label(a))
                    if arg_names and isinstance(recv_root, ast.Name) \
                            and recv_root.id == "self":
                        for n in sorted(arg_names):
                            out.append(Escape(
                                "stored-on-self", unit, n,
                                f"{dotted_name(sub.func.value)}"
                                f".{sub.func.attr}(...)"))
        # closures capturing tainted names
        for closure, free in closure_captures(unit).items():
            cap = {n for n in free if is_tainted(unit, n)}
            if not cap:
                continue
            if isinstance(closure, ast.Lambda):
                # a lambda escapes only when the unit itself hands it
                # out DIRECTLY (returned, yielded, or stored on self —
                # incl. `self._cbs.append(lambda: ...)`); a lambda
                # consumed by any OTHER call argument (`sorted(key=...)`)
                # dies with the call (documented conservative assumption)
                if isinstance(unit, ast.Return) and unit.value is not None \
                        and closure in _direct_subexprs(unit.value):
                    out.append(Escape("closure", unit, sorted(cap)[0],
                                      "lambda returned"))
                elif isinstance(unit, ast.Assign) \
                        and closure in _direct_subexprs(unit.value) \
                        and any(
                            isinstance(attr_chain_root(t), ast.Name)
                            and attr_chain_root(t).id == "self"  # type: ignore[union-attr]
                            and t is not attr_chain_root(t)
                            for t in unit.targets):
                    out.append(Escape("closure", unit, sorted(cap)[0],
                                      "lambda stored on self"))
                elif isinstance(unit, (ast.Expr, ast.Assign)) and any(
                        isinstance(sub, (ast.Yield, ast.YieldFrom))
                        and sub.value is not None
                        and closure in _direct_subexprs(sub.value)
                        for sub in walk_in_scope(unit)):
                    out.append(Escape("closure", unit, sorted(cap)[0],
                                      "lambda yielded"))
                elif any(
                        isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in mutators
                        and closure in sub.args
                        and isinstance(attr_chain_root(sub.func.value),
                                       ast.Name)
                        and attr_chain_root(sub.func.value).id == "self"  # type: ignore[union-attr]
                        for sub in iter_calls(unit)):
                    out.append(Escape("closure", unit, sorted(cap)[0],
                                      "lambda stored on self"))
            else:
                closures[closure.name] = (unit, cap)

    # a named closure escapes if its NAME is returned/yielded/stored-on-self
    if closures:
        for unit in units:
            esc_names: set[str] = set()
            if isinstance(unit, ast.Return) and unit.value is not None:
                esc_names = {s.id for s in ast.walk(unit.value)
                             if isinstance(s, ast.Name)}
            elif isinstance(unit, ast.Assign):
                roots = [attr_chain_root(t) for t in unit.targets]
                if any(isinstance(r, ast.Name) and r.id == "self"
                       and t is not r
                       for r, t in zip(roots, unit.targets)):
                    esc_names = {s.id for s in ast.walk(unit.value)
                                 if isinstance(s, ast.Name)}
            if isinstance(unit, (ast.Expr, ast.Assign)):
                # `yield handler` and `self._cbs.append(handler)` hand
                # the closure out just like return/store-on-self
                for sub in walk_in_scope(unit):
                    if isinstance(sub, (ast.Yield, ast.YieldFrom)) \
                            and sub.value is not None:
                        esc_names |= {s.id for s in ast.walk(sub.value)
                                      if isinstance(s, ast.Name)}
                for sub in iter_calls(unit):
                    if isinstance(sub.func, ast.Attribute) \
                            and sub.func.attr in mutators:
                        recv = attr_chain_root(sub.func.value)
                        if isinstance(recv, ast.Name) and recv.id == "self":
                            esc_names |= {a.id for a in sub.args
                                          if isinstance(a, ast.Name)}
            for cname in esc_names & set(closures):
                def_unit, cap = closures[cname]
                out.append(Escape("closure", def_unit, sorted(cap)[0],
                                  f"closure {cname!r} outlives the frame"))
    return out


# ---------------------------------------------------------------------------
# Cross-file symbol index + call resolution (N009)
# ---------------------------------------------------------------------------


def module_name_of(relpath: str) -> str:
    """'nos_tpu_torch/obs/journal.py' -> 'nos_tpu_torch.obs.journal'."""
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


@dataclass
class FunctionSym:
    module: str
    qualname: str          # "Class.method" or "func"
    node: ast.AST
    cls: str | None = None


class SymbolIndex:
    """Best-effort cross-file symbol table: functions/methods, class
    bases, imports, and module-level singleton instances (``X = C()``).

    ``resolve_call`` maps a call site in a known function to the callee's
    (module, qualname) key when the receiver is: a bare local/imported
    name, ``self.m()`` (searched through indexed base classes), a module
    alias (``J.record``), an indexed singleton (``REGISTRY.inc``), or a
    locally-constructed instance is NOT tracked — unresolved calls return
    None and callers fall back to pattern checks on the dotted name."""

    def __init__(self) -> None:
        self.functions: dict[tuple[str, str], FunctionSym] = {}
        # (module, class) -> list of base (module, class) keys
        self.bases: dict[tuple[str, str], list[tuple[str, str]]] = {}
        # module -> {alias: module-dotted}
        self.mod_imports: dict[str, dict[str, str]] = {}
        # module -> {name: (source module, original name)}
        self.from_imports: dict[str, dict[str, tuple[str, str]]] = {}
        # (module, name) -> (module, class) for X = C() at module level
        self.instances: dict[tuple[str, str], tuple[str, str]] = {}

    # -- building -----------------------------------------------------------
    def add_module(self, relpath: str, tree: ast.AST) -> None:
        module = module_name_of(relpath)
        mi = self.mod_imports.setdefault(module, {})
        fi = self.from_imports.setdefault(module, {})
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    mi[alias.asname or alias.name.split(".")[0]] = \
                        alias.name if alias.asname else \
                        alias.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                src = node.module
                if node.level:
                    parts = module.split(".")
                    src = ".".join(parts[: len(parts) - node.level]
                                   + [node.module])
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    fi[alias.asname or alias.name] = (src, alias.name)
        # classes/functions first: the singleton scan below resolves
        # `X = C()` against them, wherever C sits in the file
        self._index_scope(module, tree, cls=None)
        for node in tree.body if isinstance(tree, ast.Module) else []:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call) \
                    and isinstance(node.value.func, ast.Name):
                cls_key = self._resolve_name(module, node.value.func.id)
                for t in node.targets:
                    if isinstance(t, ast.Name) and cls_key:
                        self.instances[(module, t.id)] = cls_key

    def _index_scope(self, module: str, scope: ast.AST,
                     cls: str | None) -> None:
        for node in ast.iter_child_nodes(scope):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{cls}.{node.name}" if cls else node.name
                self.functions[(module, qual)] = FunctionSym(
                    module, qual, node, cls)
                self._index_scope(module, node, cls)  # nested defs: parent qual
            elif isinstance(node, ast.ClassDef):
                bases = []
                for b in node.bases:
                    key = None
                    if isinstance(b, ast.Name):
                        key = self._resolve_name(module, b.id)
                    elif isinstance(b, ast.Attribute):
                        d = dotted_name(b)
                        head, _, tail = d.rpartition(".")
                        src = self.mod_imports.get(module, {}).get(head)
                        if src:
                            key = (src, tail)
                    if key:
                        bases.append(key)
                self.bases[(module, node.name)] = bases
                self._index_scope(module, node, node.name)
            elif isinstance(node, (ast.If, ast.Try, ast.With, ast.AsyncWith)):
                self._index_scope(module, node, cls)

    def _resolve_name(self, module: str, name: str) -> tuple[str, str] | None:
        """A bare name in `module` -> (defining module, qualname)."""
        if (module, name) in self.functions or (module, name) in self.bases:
            return (module, name)
        src = self.from_imports.get(module, {}).get(name)
        if src:
            return src
        return None

    # -- call resolution ----------------------------------------------------
    def resolve_call(self, module: str, cls: str | None,
                     call: ast.Call) -> tuple[str, str] | None:
        func = call.func
        if isinstance(func, ast.Name):
            key = self._resolve_name(module, func.id)
            if key is None:
                return None
            if key in self.functions:
                return key
            # a class: the call constructs it -> __init__
            init = self._method(key, "__init__")
            return init
        if not isinstance(func, ast.Attribute):
            return None
        recv, attr = func.value, func.attr
        if isinstance(recv, ast.Name):
            if recv.id == "self" and cls is not None:
                return self._method((module, cls), attr)
            # module alias?
            target_mod = self.mod_imports.get(module, {}).get(recv.id)
            if target_mod and (target_mod, attr) in self.functions:
                return (target_mod, attr)
            # from-imported module (``from nos_tpu_torch.obs import journal``)
            src = self.from_imports.get(module, {}).get(recv.id)
            if src:
                submod = f"{src[0]}.{src[1]}"
                if (submod, attr) in self.functions:
                    return (submod, attr)
            # module-level singleton (REGISTRY.inc)
            inst = self.instances.get((module, recv.id))
            if inst is None and src:
                inst = self.instances.get(src)
            if inst is not None:
                return self._method(inst, attr)
        return None

    def _method(self, cls_key: tuple[str, str],
                name: str) -> tuple[str, str] | None:
        """Method lookup through indexed bases (best-effort MRO)."""
        seen: set[tuple[str, str]] = set()
        work = [cls_key]
        while work:
            key = work.pop(0)
            if key in seen:
                continue
            seen.add(key)
            fkey = (key[0], f"{key[1]}.{name}")
            if fkey in self.functions:
                return fkey
            work.extend(self.bases.get(key, []))
        return None

    def callees(self, key: tuple[str, str]) -> Iterator[
            tuple[ast.Call, tuple[str, str] | None]]:
        """(call site, resolved callee key or None) for every call in the
        function's body — including nested closures (conservative: the
        leaf contract cares that the code CAN run, not when)."""
        sym = self.functions.get(key)
        if sym is None:
            return
        for node in ast.walk(sym.node):
            if isinstance(node, ast.Call):
                yield node, self.resolve_call(sym.module, sym.cls, node)
