"""The dataflow engine and rules N007–N010 of the port's analyzer
(``nos_tpu_torch/analysis/``), held to the JAX package's
(``tests/test_dataflow.py``'s cases, each run under both analyzers).

- **CFG/def-use facts** on synthetic functions: branches, loops with
  break/continue, try/except/finally (return-through-finally
  inlining), with-blocks, match, and nested closures;
- **escape facts**: each way a tainted value can outlive the frame,
  and the local-use shapes that must NOT count;
- **rule fixtures**: firing, silent and pragma cases per rule
  N007–N010 through ``Analyzer.lint``, which under the port also holds
  the findings to JAX's on the same snippet
  (``tests/test_torch_analysis.py``);
- the ``@guarded_by`` runtime carrier and the lock checker reading it.
"""

from __future__ import annotations

import ast
import os
import threading

import pytest

from test_torch_analysis import ANALYZERS, PKGS, REPO_ROOT, rules_of

pytestmark = pytest.mark.analysis


@pytest.fixture(params=PKGS)
def an(request):
    return ANALYZERS[request.param]


def fn_of(an, src: str, name: str = None) -> ast.FunctionDef:
    tree = ast.parse(src)
    fns = [f for f in an.dataflow.iter_functions(tree)
           if name is None or f.name == name]
    return fns[0]


def stmt_at(flow, line: int) -> ast.AST:
    for unit in flow.cfg.units():
        if getattr(unit, "lineno", None) == line:
            return unit
    raise AssertionError(f"no unit at line {line}")


# ---------------------------------------------------------------------------
# CFG + reaching definitions
# ---------------------------------------------------------------------------

class TestDefUse:
    def test_straightline_reaching_def(self, an):
        src = (
            "def f(a):\n"
            "    x = a\n"        # line 2
            "    y = x\n"        # line 3
            "    return y\n"     # line 4
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src))
        use = stmt_at(flow, 3)
        defs = flow.defs_of(use, "x")
        assert len(defs) == 1
        # the argument def of `a` reaches line 2
        assert flow.defs_of(stmt_at(flow, 2), "a")

    def test_branch_merges_both_defs(self, an):
        src = (
            "def f(c):\n"
            "    if c:\n"
            "        x = 1\n"    # line 3
            "    else:\n"
            "        x = 2\n"    # line 5
            "    return x\n"     # line 6
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src))
        ret = stmt_at(flow, 6)
        assert len(flow.defs_of(ret, "x")) == 2

    def test_branch_kill_is_per_path(self, an):
        src = (
            "def f(c):\n"
            "    x = 0\n"        # line 2
            "    if c:\n"
            "        x = 1\n"    # line 4: kills line 2 on this path only
            "    return x\n"     # line 5
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src))
        assert len(flow.defs_of(stmt_at(flow, 5), "x")) == 2

    def test_loop_back_edge_carries_defs(self, an):
        src = (
            "def f(items):\n"
            "    acc = 0\n"
            "    for i in items:\n"   # line 3: defines i
            "        acc = acc + i\n"  # line 4: sees line-2 AND line-4 defs
            "    return acc\n"
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src))
        body = stmt_at(flow, 4)
        assert len(flow.defs_of(body, "acc")) == 2
        assert flow.defs_of(body, "i")

    def test_while_break_continue_edges(self, an):
        src = (
            "def f(c):\n"
            "    x = 0\n"
            "    while c:\n"
            "        if x:\n"
            "            break\n"
            "        x = 1\n"
            "        continue\n"
            "    return x\n"          # line 8
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src))
        # both the pre-loop and in-loop defs reach the return (break
        # after x=1? no — break precedes it; the back edge carries it)
        assert len(flow.defs_of(stmt_at(flow, 8), "x")) == 2

    def test_with_block_is_straightline(self, an):
        src = (
            "def f(self):\n"
            "    with self._lock:\n"
            "        x = 1\n"
            "    return x\n"          # line 4
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src))
        assert len(flow.defs_of(stmt_at(flow, 4), "x")) == 1

    def test_except_handler_sees_pre_raise_defs(self, an):
        src = (
            "def f():\n"
            "    x = 1\n"
            "    try:\n"
            "        x = 2\n"
            "        g()\n"
            "    except ValueError as e:\n"
            "        y = x\n"          # line 7: both defs may reach
            "    return x\n"
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src))
        assert len(flow.defs_of(stmt_at(flow, 7), "x")) == 2
        assert flow.defs_of(stmt_at(flow, 7), "e")

    def test_unit_defs_and_uses_primitives(self, an):
        tree = ast.parse("a, b = q\nc += a\n")
        assign, aug = tree.body
        assert an.dataflow.unit_defs(assign) == {"a", "b"}
        assert an.dataflow.unit_uses(assign) == {"q"}
        assert an.dataflow.unit_defs(aug) == {"c"}
        assert "a" in an.dataflow.unit_uses(aug)

    def test_nested_def_binds_only_its_name(self, an):
        src = (
            "def f(p):\n"
            "    p = get()\n"          # line 2
            "    def mutate(p):\n"     # line 3: binds `mutate`, NOT p
            "        return p\n"
            "    return p\n"           # line 5: still sees line-2 def
        )
        flow = an.dataflow.FunctionFlow(fn_of(an, src, "f"))
        ret = stmt_at(flow, 5)
        assert flow.defs_of(ret, "p") == {
            id(stmt_at(flow, 2))}
        assert flow.defs_of(ret, "mutate")


# ---------------------------------------------------------------------------
# Inevitability (the N008 post-domination read)
# ---------------------------------------------------------------------------

def _is_bump(unit: ast.AST) -> bool:
    return any(isinstance(s, ast.Call)
               and isinstance(s.func, ast.Attribute)
               and s.func.attr == "bump"
               for s in ast.walk(unit)
               if not isinstance(unit, (ast.If, ast.While, ast.For))
               or s in ast.walk(unit.test if hasattr(unit, "test")
                                else unit))


class TestInevitability:
    def check(self, an, src, line, expect):
        flow = an.dataflow.FunctionFlow(fn_of(an, src))

        def pred(u):
            return isinstance(u, ast.Expr) \
                and isinstance(u.value, ast.Call) \
                and isinstance(u.value.func, ast.Attribute) \
                and u.value.func.attr == "bump"

        assert flow.always_reaches_after(stmt_at(flow, line), pred) \
            is expect

    def test_same_block_later_bump(self, an):
        self.check(an, "def f(s):\n    s.write()\n    s.bump()\n", 2, True)

    def test_branch_skips_bump(self, an):
        self.check(an, 
            "def f(s, c):\n"
            "    s.write()\n"          # line 2
            "    if c:\n"
            "        s.bump()\n",
            2, False)

    def test_both_branches_bump(self, an):
        self.check(an, 
            "def f(s, c):\n"
            "    s.write()\n"
            "    if c:\n"
            "        s.bump()\n"
            "    else:\n"
            "        s.bump()\n",
            2, True)

    def test_finally_always_bumps_even_past_return(self, an):
        self.check(an, 
            "def f(s, c):\n"
            "    try:\n"
            "        s.write()\n"      # line 3
            "        if c:\n"
            "            return 1\n"
            "    finally:\n"
            "        s.bump()\n",
            3, True)

    def test_loop_zero_iterations_skips_bump(self, an):
        self.check(an, 
            "def f(s, items):\n"
            "    s.write()\n"          # line 2
            "    for i in items:\n"
            "        s.bump()\n",
            2, False)

    def test_bump_after_loop_is_inevitable(self, an):
        self.check(an, 
            "def f(s, items):\n"
            "    s.write()\n"
            "    for i in items:\n"
            "        pass\n"
            "    s.bump()\n",
            2, True)

    def test_early_return_before_bump(self, an):
        self.check(an, 
            "def f(s, c):\n"
            "    s.write()\n"          # line 2
            "    if c:\n"
            "        return None\n"    # escapes without bumping
            "    s.bump()\n",
            2, False)


# ---------------------------------------------------------------------------
# Escape facts
# ---------------------------------------------------------------------------

def _src_fork(call: ast.Call) -> bool:
    return isinstance(call.func, ast.Attribute) \
        and call.func.attr in ("fork", "get_node_for_write")


class TestEscapes:
    def kinds(self, an, src):
        return sorted(e.kind for e in an.dataflow.escapes(fn_of(an, src), _src_fork))

    def test_local_use_does_not_escape(self, an):
        assert self.kinds(an, 
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    changed = n.update()\n"
            "    return changed\n") == []

    def test_stored_on_self_escapes(self, an):
        assert self.kinds(an, 
            "def f(self, snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    self._n = n\n") == ["stored-on-self"]

    def test_copy_chain_then_return_escapes(self, an):
        assert self.kinds(an, 
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    alias = n\n"
            "    return alias\n") == ["returned"]

    def test_yield_escapes(self, an):
        assert self.kinds(an, 
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    yield n\n") == ["yielded"]

    def test_append_to_self_container_escapes(self, an):
        assert self.kinds(an, 
            "def f(self, snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    self._all.append(n)\n") == ["stored-on-self"]

    def test_append_to_local_container_is_fine(self, an):
        assert self.kinds(an, 
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    out = []\n"
            "    out.append(n)\n"
            "    n.mutate()\n") == []

    def test_escaping_closure_capture_convicted(self, an):
        assert self.kinds(an, 
            "def f(self, snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    def later():\n"
            "        return n.free()\n"
            "    self._cb = later\n") == ["closure"]

    def test_returned_closure_capture_convicted(self, an):
        assert self.kinds(an, 
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    def later():\n"
            "        return n.free()\n"
            "    return later\n") == ["closure"]

    def test_lambda_appended_to_self_container_escapes(self, an):
        assert self.kinds(an, 
            "def f(self, snap, p):\n"
            "    node = snap.get_node_for_write('x')\n"
            "    self._callbacks.append(lambda: node.add_pod(p))\n"
        ) == ["closure"]

    def test_yielded_closures_escape(self, an):
        assert self.kinds(an, 
            "def f(self, snap, names):\n"
            "    for n in names:\n"
            "        node = snap.get_node_for_write(n)\n"
            "        def handler():\n"
            "            node.add_pod(None)\n"
            "        yield handler\n") == ["closure"]
        assert self.kinds(an, 
            "def f(snap):\n"
            "    node = snap.get_node_for_write('x')\n"
            "    yield lambda: node.free()\n") == ["closure"]

    def test_named_closure_appended_to_self_container_escapes(self, an):
        assert self.kinds(an, 
            "def f(self, snap):\n"
            "    node = snap.get_node_for_write('x')\n"
            "    def cb():\n"
            "        return node\n"
            "    self._cbs.append(cb)\n") == ["closure"]

    def test_local_lambda_is_fine(self, an):
        assert self.kinds(an, 
            "def f(snap, xs):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    return sorted(xs, key=lambda t: n.rank(t))[0]\n") == []

    def test_container_indirection_return_escapes(self, an):
        """`out[n] = node; return out` carries every element past the
        fork scope — the container becomes a carrier."""
        assert self.kinds(an, 
            "def f(snap, names):\n"
            "    out = {}\n"
            "    for n in names:\n"
            "        node = snap.get_node_for_write(n)\n"
            "        out[n] = node\n"
            "    return out\n") == ["returned"]
        assert self.kinds(an, 
            "def f(self, snap):\n"
            "    acc = []\n"
            "    acc.append(snap.get_node_for_write('x'))\n"
            "    self._acc = acc\n") == ["stored-on-self"]

    def test_local_container_that_stays_local_is_fine(self, an):
        assert self.kinds(an, 
            "def f(snap, names):\n"
            "    out = {}\n"
            "    for n in names:\n"
            "        out[n] = snap.get_node_for_write(n)\n"
            "    count = 0\n"
            "    return count\n") == []

    def test_augassign_store_on_self_escapes(self, an):
        """`self._dirty += [n]` / `self._seen |= {n}` store the alias
        exactly like the plain-assign and .append forms."""
        assert self.kinds(an, 
            "def f(self, snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    self._dirty += [n]\n") == ["stored-on-self"]
        assert self.kinds(an, 
            "def f(self, snap):\n"
            "    self._seen |= {snap.get_node_for_write('x')}\n"
        ) == ["stored-on-self"]

    def test_augassign_to_local_is_fine(self, an):
        assert self.kinds(an, 
            "def f(snap):\n"
            "    out = []\n"
            "    out += [snap.get_node_for_write('x')]\n"
            "    out[0].mutate()\n") == []

    def test_rebound_name_clears_taint(self, an):
        assert self.kinds(an, 
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    n.mutate()\n"
            "    n = 'clean'\n"
            "    return n\n") == []


# ---------------------------------------------------------------------------
# Symbol index
# ---------------------------------------------------------------------------

class TestSymbolIndex:
    def test_module_name_of(self, an):
        assert an.dataflow.module_name_of(an.rel("nos_tpu/obs/journal.py")) \
            == an.rel("nos_tpu.obs.journal")
        assert an.dataflow.module_name_of(
            an.rel("nos_tpu/obs/__init__.py")) == an.rel("nos_tpu.obs")

    def test_resolution_self_base_alias_singleton(self, an):
        idx = an.dataflow.SymbolIndex()
        idx.add_module("pkg/base.py", ast.parse(
            "class Base:\n"
            "    def helper(self):\n"
            "        pass\n"))
        idx.add_module("pkg/mod.py", ast.parse(
            "from pkg.base import Base\n"
            "import pkg.util as U\n"
            "class C(Base):\n"
            "    def m(self):\n"
            "        self.helper()\n"
            "        U.work()\n"
            "        REG.inc()\n"
            "class Reg:\n"
            "    def inc(self):\n"
            "        pass\n"
            "REG = Reg()\n"))
        idx.add_module("pkg/util.py", ast.parse("def work():\n    pass\n"))
        resolved = {r for _, r in idx.callees(("pkg.mod", "C.m"))}
        assert ("pkg.base", "Base.helper") in resolved   # via base class
        assert ("pkg.util", "work") in resolved          # module alias
        assert ("pkg.mod", "Reg.inc") in resolved        # singleton


# ---------------------------------------------------------------------------
# Rule fixtures: N007–N010
# ---------------------------------------------------------------------------

class TestN007:
    def test_fires_on_stored_returned_yielded(self, an):
        src = (
            "class P:\n"
            "    def plan(self, snapshot):\n"
            "        snapshot.fork()\n"
            "        node = snapshot.get_node_for_write('n')\n"
            "        self._last = node\n"            # stored
            "        snapshot.commit()\n"
            "    def gen(self, snapshot):\n"
            "        n = snapshot.get_node_for_write('x')\n"
            "        yield n\n"                      # yielded
            "    def ret(self, snapshot):\n"
            "        n = snapshot.get_node_for_write('x')\n"
            "        alias = n\n"
            "        return alias\n"                 # returned via copy
        )
        assert rules_of(an.lint(src, "CowEscape")) == ["N007"] * 3

    def test_silent_on_fork_scoped_use(self, an):
        src = (
            "def plan(snapshot, pods):\n"
            "    snapshot.fork()\n"
            "    node = snapshot.get_node_for_write('n')\n"
            "    changed = node.update_geometry_for({})\n"
            "    if changed:\n"
            "        snapshot.commit()\n"
            "    else:\n"
            "        snapshot.revert()\n"
            "    return changed\n"
        )
        assert an.lint(src, "CowEscape") == []

    def test_snapshot_substrate_exempt(self, an):
        src = (
            "class ClusterSnapshot:\n"
            "    def get_node_for_write(self, name):\n"
            "        n = self._writable(name)\n"
            "        return n\n"
        )
        assert an.lint(src, "CowEscape",
            relpath="nos_tpu/partitioning/core/snapshot.py") == []

    def test_pragma_suppressed(self, an):
        src = (
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    # noslint: N007 — handed to the caller which owns the fork\n"
            "    return n\n"
        )
        assert an.lint(src, "CowEscape") == []

    def test_fires_on_direct_store_without_intermediate_name(self, an):
        """The headline hazard needs no intermediate name: the source
        call can sit directly in the escaping position."""
        src = (
            "class P:\n"
            "    def direct_store(self, snap, name):\n"
            "        self._last = snap.get_node_for_write(name)\n"
            "    def direct_return(self, snap):\n"
            "        return snap.fork()\n"
            "    def direct_yield(self, snap):\n"
            "        yield snap.get_node_for_write('x')\n"
            "    def annotated(self, snap):\n"
            "        node: Node = snap.get_node_for_write('x')\n"
            "        return node\n"
            "    def tuple_elem(self, snap, x):\n"
            "        self._n, other = snap.fork(), x\n"
        )
        v = an.lint(src, "CowEscape")
        assert rules_of(v) == ["N007"] * 5
        # ...and consuming the result inside the frame stays silent
        src_ok = (
            "def f(snap):\n"
            "    count = len(snap.fork().nodes())\n"
            "    return count\n"
        )
        assert an.lint(src_ok, "CowEscape") == []

    def test_fires_on_module_global_store(self, an):
        src = (
            "_LAST = None\n"
            "def f(snap):\n"
            "    global _LAST\n"
            "    n = snap.get_node_for_write('x')\n"
            "    _LAST = n\n"                         # module-global escape
        )
        v = an.lint(src, "CowEscape")
        assert rules_of(v) == ["N007"]
        assert "_LAST" in v[0].message
        # a plain local rebinding of the same shape stays silent
        src_local = (
            "def f(snap):\n"
            "    n = snap.get_node_for_write('x')\n"
            "    last = n\n"
            "    last.add_pod('p')\n"
        )
        assert an.lint(src_local, "CowEscape") == []


class TestN008:
    REL = "nos_tpu/scheduler/foo.py"

    def test_fires_on_branch_skipping_bump(self, an):
        src = (
            "class S:\n"
            "    def handle(self, name):\n"
            "        node = self._api.get('Node', name)\n"
            "        node.status.phase = 'Running'\n"
            "        if name:\n"
            "            self._bump_locked(name)\n"
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008"]
        assert "status.phase" in v[0].message

    def test_silent_when_bump_post_dominates(self, an):
        src = (
            "class S:\n"
            "    def handle(self, name):\n"
            "        node = self._api.get('Node', name)\n"
            "        node.metadata.annotations['k'] = 'v'\n"
            "        self._bump_locked(name)\n"
            "    def loop(self):\n"
            "        for node in self._api.list('Node'):\n"
            "            node.metadata.labels['k'] = 'v'\n"
            "            self._api.update('Node', node)\n"
        )
        assert an.lint(src, "CacheInvalidation",
                           relpath=self.REL) == []

    def test_silent_on_copies_and_mutate_callbacks(self, an):
        src = (
            "class S:\n"
            "    def copy(self, name):\n"
            "        node = clone(self._api.get('Node', name))\n"
            "        node.status.phase = 'Running'\n"
            "    def cb(self, name):\n"
            "        def mutate(p):\n"
            "            p.spec.node_name = name\n"
            "        retry_on_conflict(self._api, 'Pod', name, mutate)\n"
        )
        assert an.lint(src, "CacheInvalidation",
                           relpath=self.REL) == []

    def test_out_of_scope_path_unflagged(self, an):
        src = (
            "def f(api):\n"
            "    p = api.get('Pod', 'x')\n"
            "    p.status.phase = 'Running'\n"
        )
        assert an.lint(src, "CacheInvalidation",
                           relpath="nos_tpu/models/foo.py") == []

    def test_dict_mutator_does_not_self_invalidate(self, an):
        """`labels.update(...)` shares its NAME with the api-verb
        invalidator `api.update` — the write itself must not count as
        its own invalidation (same for pop/clear/setdefault)."""
        src = (
            "class S:\n"
            "    def bad(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        pod.metadata.labels.update({'k': 'v'})\n"
            "    def ok(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        pod.metadata.labels.update({'k': 'v'})\n"
            "        self._api.update('Pod', pod)\n"   # real write-back
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008"]
        assert v[0].line == 4

    def test_other_units_dict_mutator_is_not_an_invalidation(self, an):
        """A SECOND watched-dict write must not silence the first: the
        api-verb invalidators require an api receiver."""
        src = (
            "class S:\n"
            "    def bad(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        pod.status.phase = 'Failed'\n"
            "        pod.metadata.labels.update({'k': 'v'})\n"
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert [x.line for x in v] == [4, 5]
        assert rules_of(v) == ["N008", "N008"]

    def test_whole_dict_replacement_fires(self, an):
        """`pod.metadata.labels = {...}` is the most drastic watched-dict
        write — it must convict like the per-key form."""
        src = (
            "class S:\n"
            "    def bad(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        pod.metadata.labels = {'a': 'b'}\n"
            "    def bad_aug(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        pod.metadata.labels |= {'a': 'b'}\n"
            "    def ok(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        pod.metadata.labels = {'a': 'b'}\n"
            "        self._api.patch('Pod', name, pod)\n"
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008", "N008"]
        assert [x.line for x in v] == [4, 7]

    def test_header_lambda_body_not_walked_for_calls(self, an):
        """A lambda inside a compound-statement HEADER is deferred
        execution: its body must neither convict N010 nor count as an
        N008 invalidation."""
        src = (
            "import threading\n"
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock', '_items')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._items = []\n"
            "    def ok(self):\n"
            "        if self.check(an, lambda: self._items.append(1)):\n"
            "            pass\n"
        )
        assert an.lint(src, "GuardedByDiscipline") == []

    def test_annotated_assign_from_api_is_live(self, an):
        """mypy strict pushes scheduler code toward `pod: Pod =
        api.get(...)` — the annotation must not launder liveness."""
        src = (
            "class S:\n"
            "    def bad(self, name):\n"
            "        pod: object = self._api.get('Pod', name)\n"
            "        pod.status.phase = 'Failed'\n"
            "    def bad_tuple(self, name):\n"
            "        pods, n = self._api.list('Pod'), 0\n"
            "        pods[0].status.phase = 'Failed'\n"
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008", "N008"]
        assert [x.line for x in v] == [4, 7]

    def test_subscript_element_of_live_list_is_live(self, an):
        """`pods[0]` is the same object the cache watches — indexing
        instead of iterating must not launder liveness."""
        src = (
            "class S:\n"
            "    def bad(self, name):\n"
            "        pods = self._api.list('Pod')\n"
            "        pod = pods[0]\n"
            "        pod.status.phase = 'Failed'\n"
            "    def ok(self, name):\n"
            "        pods = self._api.list('Pod')\n"
            "        pod = pods[0]\n"
            "        pod.status.phase = 'Failed'\n"
            "        self._api.patch('Pod', name, pod)\n"
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008"]
        assert v[0].line == 5

    def test_finally_write_escaping_on_early_return_path_fires_once(self, an):
        """The finally body runs on BOTH the normal path (bump follows)
        and the early-return path (nothing follows).  Each inlined copy
        gets its own identity, so inevitability judges the return path
        separately — and identical findings from multiple copies
        collapse to one."""
        src = (
            "class S:\n"
            "    def bad(self, name, flag):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        try:\n"
            "            if flag:\n"
            "                return None\n"
            "            self._work()\n"
            "        finally:\n"
            "            pod.status.phase = 'Failed'\n"
            "        self._gen[name] = 1\n"
            "    def ok(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        try:\n"
            "            self._work()\n"
            "        finally:\n"
            "            pod.status.phase = 'Failed'\n"
            "            self._gen[name] = 1\n"
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008"]
        assert v[0].line == 9

    def test_del_watched_dict_entry_fires_and_writeback_silences(self, an):
        """`del pod.metadata.annotations[k]` is the same stale-cache
        hazard as `.pop(k)` — the Delete statement form must convict."""
        src = (
            "class S:\n"
            "    def bad(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        del pod.metadata.annotations['k']\n"
            "    def ok(self, name):\n"
            "        pod = self._api.get('Pod', name)\n"
            "        del pod.metadata.annotations['k']\n"
            "        self._api.patch('Pod', name, pod)\n"
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008"]
        assert v[0].line == 4

    def test_gen_substring_lookalikes_are_not_bumps(self, an):
        src = (
            "class S:\n"
            "    def bad(self, name):\n"
            "        node = self._api.get('Node', name)\n"
            "        node.status.phase = 'Ready'\n"
            "        self.agenda[name] = 1\n"          # not a gen bump
            "    def ok(self, name):\n"
            "        node = self._api.get('Node', name)\n"
            "        node.status.phase = 'Ready'\n"
            "        self._gen[name] = 1\n"            # a real one
        )
        v = an.lint(src, "CacheInvalidation", relpath=self.REL)
        assert rules_of(v) == ["N008"]
        assert v[0].line == 4


class TestN009:
    REL = "nos_tpu/obs/journal.py"

    def _lint(self, an, src):
        return an.lint(src, "LeafLockContract", relpath=self.REL)

    def test_fires_on_api_reach_and_reentry(self, an):
        src = (
            "class DecisionJournal:\n"
            "    def record(self, category):\n"
            "        self._api.patch('Pod', 'p', mutate=None)\n"
            "        self._other.record(category)\n"
        )
        v = self._lint(an, src)
        assert rules_of(v) == ["N009", "N009"]

    def test_fires_transitively_through_helper(self, an):
        src = (
            "class DecisionJournal:\n"
            "    def record(self, category):\n"
            "        self._flush()\n"
            "    def _flush(self):\n"
            "        import threading\n"
            "        threading.Event().wait()\n"
        )
        v = self._lint(an, src)
        assert rules_of(v) == ["N009"]
        assert "reached via" in v[0].message

    def test_fires_on_nontrivial_call_under_lock(self, an):
        src = (
            "class DecisionJournal:\n"
            "    def record(self, category):\n"
            "        with self._lock:\n"
            "            self._seq += 1\n"
            "            self._rebuild_index()\n"
        )
        v = self._lint(an, src)
        assert rules_of(v) == ["N009"]
        assert "under" in v[0].message

    def test_silent_on_the_leaf_shape(self, an):
        src = (
            "class DecisionJournal:\n"
            "    def record(self, category):\n"
            "        rec = object()\n"
            "        with self._lock:\n"
            "            self._seq += 1\n"
            "            evicted = self._push_locked(rec)\n"
            "        REGISTRY.inc('nos_tpu_journal_records_total')\n"
            "        return rec\n"
        )
        assert self._lint(an, src) == []

    def test_renamed_root_is_itself_a_violation(self, an):
        """If record() is renamed/moved, the certification must not
        silently check nothing — the unresolved root is the finding."""
        src = (
            "class DecisionJournal:\n"
            "    def record_decision(self, category):\n"   # renamed
            "        pass\n"
        )
        v = self._lint(an, src)
        assert rules_of(v) == ["N009"]
        assert "no longer resolves" in v[0].message
        assert "DecisionJournal.record" in v[0].message

    def test_real_tree_roots_resolve(self, an):
        """The rule is inert if its roots vanish in a refactor — pin
        that the real modules still define them."""
        rule = an.rule("LeafLockContract")()
        an.core.run([rule], [os.path.join(REPO_ROOT, an.pkg, "obs")],
                    root=REPO_ROOT)
        assert rule.ROOTS
        assert all(k in rule.index.functions for k in rule.ROOTS)


class TestN010:
    def test_fires_on_unlocked_writes_and_unlocked_locked_call(self, an):
        src = (
            "import threading\n"
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock', '_items', '_gen')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._items = []\n"
            "        self._gen = {}\n"
            "    def bad(self):\n"
            "        self._items.append(1)\n"       # unlocked mutator
            "        self._gen['a'] = 2\n"          # unlocked subscript
            "    def caller(self):\n"
            "        self._touch_locked()\n"        # lock not held
            "    def _touch_locked(self):\n"
            "        self._gen['a'] = 3\n"          # exempt (_locked)
        )
        v = an.lint(src, "GuardedByDiscipline")
        assert rules_of(v) == ["N010"] * 3

    def test_silent_on_locked_writes_and_init(self, an):
        src = (
            "import threading\n"
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock', '_items', '_gen')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._items = []\n"
            "        self._gen = {}\n"              # init: pre-publication
            "    def ok(self):\n"
            "        with self._lock:\n"
            "            self._items.append(1)\n"
            "            self._gen['a'] = 2\n"
            "            self._touch_locked()\n"
            "        return len(self._items)\n"     # reads stay free
            "    def _touch_locked(self):\n"
            "        del self._gen['a']\n"
        )
        assert an.lint(src, "GuardedByDiscipline") == []

    def test_missing_lock_and_nonliteral_args_flagged(self, an):
        src = (
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock', '_x')\n"
            "class NoLock:\n"
            "    def __init__(self):\n"
            "        self._x = 1\n"
            "\n"
            "NAME = '_y'\n"
            "@guarded_by('_lock', NAME)\n"
            "class Computed:\n"
            "    pass\n"
        )
        v = an.lint(src, "GuardedByDiscipline")
        msgs = " | ".join(x.message for x in v)
        assert "never creates it" in msgs
        assert "string literals" in msgs

    def test_try_wrapped_locked_write_not_convicted(self, an):
        """The common `try: with self._lock: ...` idiom must stay
        clean, and an unlocked write inside a try body is reported
        exactly once (not re-walked at the Try statement level)."""
        src = (
            "import threading\n"
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock', '_items')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._items = []\n"
            "    def ok(self, x):\n"
            "        try:\n"
            "            with self._lock:\n"
            "                self._items.append(x)\n"
            "                self._push_locked(x)\n"
            "        except ValueError:\n"
            "            raise\n"
            "    def bad(self, x):\n"
            "        try:\n"
            "            self._items.append(x)\n"    # unlocked, once
            "        except ValueError:\n"
            "            raise\n"
        )
        v = an.lint(src, "GuardedByDiscipline")
        assert rules_of(v) == ["N010"]
        assert v[0].line == 17

    def test_tuple_destructuring_write_flagged(self, an):
        src = (
            "import threading\n"
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock', '_a', '_b')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self._a, self._b = 0, 0\n"
            "    def bad(self, x):\n"
            "        self._a, self._b = x, x\n"       # both unlocked
            "    def ok(self, x):\n"
            "        with self._lock:\n"
            "            self._a, self._b = x, x\n"
        )
        v = an.lint(src, "GuardedByDiscipline")
        assert rules_of(v) == ["N010"] * 2
        assert {x.line for x in v} == {9}

    def test_class_level_annotated_lock_counts_as_created(self, an):
        """`_lock: ClassVar[Lock] = Lock()` at class level IS a created
        lock; a bare annotation with no value is not."""
        src = (
            "import threading\n"
            "from typing import ClassVar\n"
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock', '_n')\n"
            "class Annotated:\n"
            "    _lock: ClassVar[threading.Lock] = threading.Lock()\n"
            "    def __init__(self):\n"
            "        self._n = 0\n"
            "\n"
            "@guarded_by('_lock', '_n')\n"
            "class BareAnnotation:\n"
            "    _lock: threading.Lock\n"       # declared, never created
            "    def __init__(self):\n"
            "        self._n = 0\n"
        )
        v = an.lint(src, "GuardedByDiscipline")
        assert rules_of(v) == ["N010"]
        assert "BareAnnotation" in v[0].message

    def test_zero_field_decorator_flagged(self, an):
        """@guarded_by('_lock') with no fields is a vacuous contract —
        the static half flags what guards.guarded_by raises on at
        import time, so a never-imported module can't carry one."""
        src = (
            "import threading\n"
            "from nos_tpu.utils.guards import guarded_by\n"
            "@guarded_by('_lock')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
        )
        v = an.lint(src, "GuardedByDiscipline")
        assert rules_of(v) == ["N010"]
        assert "no fields" in v[0].message

    def test_external_locked_caller_needs_receiver_lock(self, an):
        """`other._bump_locked()` from outside the owning class is the
        exact parallel-shard merge shape — it must hold a lock on that
        same receiver, or be a *_locked method itself."""
        src = (
            "class Merger:\n"
            "    def bad(self, k):\n"
            "        self._cache._bump_locked(k)\n"
            "    def ok(self, k):\n"
            "        with self._cache._lock:\n"
            "            self._cache._bump_locked(k)\n"
            "    def _merge_locked(self, k):\n"
            "        self._cache._bump_locked(k)\n"   # carries convention
            "\n"
            "def free_bad(cache, k):\n"
            "    cache._bump_locked(k)\n"
            "\n"
            "def free_ok(cache, k):\n"
            "    with cache._lock:\n"
            "        cache._bump_locked(k)\n"
        )
        v = an.lint(src, "GuardedByDiscipline")
        assert rules_of(v) == ["N010"] * 2
        assert {x.line for x in v} == {3, 11}

    def test_subclass_with_base_skips_lock_existence(self, an):
        src = (
            "from nos_tpu.utils.guards import guarded_by\n"
            "from other import Base\n"
            "@guarded_by('_lock', '_seq')\n"
            "class Derived(Base):\n"
            "    def bump(self):\n"
            "        with self._lock:\n"
            "            self._seq += 1\n"
        )
        assert an.lint(src, "GuardedByDiscipline") == []


# ---------------------------------------------------------------------------
# @guarded_by runtime carrier + lockcheck integration
# ---------------------------------------------------------------------------

class TestGuardedByRuntime:
    def test_table_merges_and_inherits(self, an):
        G = an.module("utils.guards")

        @G.guarded_by("_lock", "_a", "_b")
        class Base:
            pass

        @G.guarded_by("_lock", "_c")
        class Child(Base):
            pass

        assert G.guarded_fields(Base) == {"_a": "_lock", "_b": "_lock"}
        assert G.guarded_fields(Child) == {
            "_a": "_lock", "_b": "_lock", "_c": "_lock"}
        # extending the child never mutated the base's table
        assert "_c" not in G.guarded_fields(Base)

    def test_conflicting_redeclaration_raises(self, an):
        G = an.module("utils.guards")
        with pytest.raises(ValueError, match="one lock per field"):
            @G.guarded_by("_other", "_a")
            @G.guarded_by("_lock", "_a")
            class Bad:
                pass

    def test_zero_fields_raises(self, an):
        """@guarded_by('_lock') with no fields would be a silent no-op
        contract — {} table, nothing checked by either half."""
        G = an.module("utils.guards")
        # the port words its refusal in the shared helper of both
        # decorators
        said = {"nos_tpu": "fields it guards",
                "nos_tpu_torch": "at least one field"}[an.pkg]
        with pytest.raises(ValueError, match=said):
            G.guarded_by("_lock")

    def test_guard_state_reads_annotations(self, an):
        G = an.module("utils.guards")
        lc = an.module("testing.lockcheck")

        @G.guarded_by("_lock", "_guarded")
        class Shared:
            def __init__(self):
                self._lock = threading.Lock()
                self._guarded = 0
                self._free = 0

        g = lc.LockGraph(name="annot")
        s = Shared()
        try:
            lc.guard_state(s, g)
            with s._lock:
                s._guarded = 1           # locked: fine
            s._free = 2                  # undeclared field: not judged
            g.assert_clean()
            s._guarded = 3               # unlocked declared write
            assert len(g.unguarded_writes) == 1
            assert "_guarded" in g.unguarded_writes[0]
        finally:
            g.close()
            lc.unguard_all()

    def test_guard_state_legacy_mode_still_guards_everything(self, an):
        lc = an.module("testing.lockcheck")

        class Plain:
            def __init__(self):
                self._lock = threading.Lock()
                self.field = 0

        g = lc.LockGraph(name="legacy")
        p = Plain()
        try:
            lc.guard_state(p, g)
            p.field = 1                  # no table: every field judged
            assert len(g.unguarded_writes) == 1
        finally:
            g.close()
            lc.unguard_all()

    def test_annotated_decision_plane_classes_carry_tables(self, an):
        G = an.module("utils.guards")
        DecisionJournal = an.module("obs.journal").DecisionJournal
        classes = (DecisionJournal,
                   an.module("partitioning.core.quarantine")
                   .QuarantineList,
                   an.module("partitioning.state").ClusterState,
                   an.module("scheduler.cache").SchedulerCache)
        for cls in classes:
            table = G.guarded_fields(cls)
            assert table, f"{cls.__name__} lost its @guarded_by table"
            assert set(table.values()) == {"_lock"}
        # the journal inherits the ring's fields and adds its own
        assert "_items" in G.guarded_fields(DecisionJournal)
        assert "_seq" in G.guarded_fields(DecisionJournal)


class TestCfgShapes:
    """The builder handles the syntax zoo without falling over."""

    @pytest.mark.parametrize("src", [
        "def f():\n    match x:\n        case 1:\n            a = 1\n"
        "        case _:\n            a = 2\n    return a\n",
        "def f():\n    while True:\n        if q():\n            break\n"
        "    return 1\n",
        "def f():\n    try:\n        a = 1\n    except (ValueError,"
        " KeyError) as e:\n        a = 2\n    except Exception:\n"
        "        raise\n    else:\n        a = 3\n    finally:\n"
        "        b = a\n    return b\n",
        "def f():\n    for i in range(3):\n        try:\n"
        "            continue\n        finally:\n            cleanup()\n",
        "def f():\n    with open('x') as fh, lock:\n        return fh\n",
    ])
    def test_builds_and_flows(self, an, src):
        fn = fn_of(an, src)
        cfg = an.dataflow.build_cfg(fn)
        assert cfg.blocks[cfg.entry].units
        an.dataflow.FunctionFlow(fn, cfg)      # fixpoint terminates
