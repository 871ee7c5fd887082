"""The determinism certification of the port's analyzer (rules N011,
N012 in ``nos_tpu_torch/analysis/rules_det.py``) held to the JAX
package's (``tests/test_rules_det.py``'s cases, each run under both
analyzers through ``Analyzer.lint``), the journal capture both
packages' parallel planners replay, and the port's dual-run harness
(``nos_tpu_torch/analysis/determinism.py``): its trace in process and a
4-cell corner of its 12-cell matrix in child interpreters, whose
journals must be byte-identical.
"""

from __future__ import annotations

import json

import pytest

from test_torch_analysis import ANALYZERS, PKGS, rules_of

pytestmark = pytest.mark.analysis

# In-scope placement for N011 (the decision directories).
SCHED = "nos_tpu/scheduler/fixture.py"


@pytest.fixture(params=PKGS)
def an(request):
    return ANALYZERS[request.param]


# ---------------------------------------------------------------------------
# N011: unordered iteration flowing into decisions
# ---------------------------------------------------------------------------

class TestN011:
    def test_flags_set_iteration_into_order_sensitive_sinks(self, an):
        src = (
            "def f(xs: set):\n"
            "    out = []\n"
            "    for x in xs:\n"
            "        out.append(x)\n"
            "    return out\n"
            "\n"
            "def g(nodes: set):\n"
            "    return next(iter(nodes))\n"
            "\n"
            "def h(tainted: frozenset):\n"
            "    return [x for x in tainted]\n"
        )
        v = an.lint(src, "UnorderedIterationHazard", relpath=SCHED)
        assert rules_of(v) == ["N011", "N011", "N011"]
        assert [x.line for x in v] == [3, 8, 11]

    def test_keyed_min_ties_break_in_hash_order(self, an):
        # min(xs) uses the elements' total order — deterministic; a key
        # function can TIE, and ties return the first element visited
        src = ("def f(nodes: set):\n"
               "    return min(nodes, key=len)\n")
        v = an.lint(src, "UnorderedIterationHazard", relpath=SCHED)
        assert rules_of(v) == ["N011"]

    def test_blessed_orders_and_insensitive_consumers_pass(self, an):
        src = (
            "def f(xs: set):\n"
            "    out = []\n"
            "    for x in sorted(xs):\n"
            "        out.append(x)\n"
            "    return out\n"
            "\n"
            "def g(nodes: set):\n"
            "    return min(nodes)\n"
            "\n"
            "def h(xs: set):\n"
            "    return len(xs)\n"
            "\n"
            "def commutes(xs: set):\n"
            "    total = 0\n"
            "    for x in xs:\n"
            "        total += x\n"
            "    return total\n"
        )
        assert an.lint(src, "UnorderedIterationHazard",
                           relpath=SCHED) == []

    def test_pragma_with_reason_suppresses(self, an):
        src = (
            "def f(xs: set):\n"
            "    out = []\n"
            "    for x in xs:  # noslint: N011 — audited: singleton\n"
            "        out.append(x)\n"
            "    return out\n"
        )
        assert an.lint(src, "UnorderedIterationHazard",
                           relpath=SCHED) == []

    def test_out_of_scope_directories_are_exempt(self, an):
        src = ("def f(xs: set):\n"
               "    out = []\n"
               "    for x in xs:\n"
               "        out.append(x)\n")
        assert an.lint(src, "UnorderedIterationHazard",
                           relpath="nos_tpu/obs/fixture.py") == []


# ---------------------------------------------------------------------------
# N012: cross-cycle cached state must emit its invalidation event
# ---------------------------------------------------------------------------

_N012_CLASS = (
    "from nos_tpu.utils.guards import invalidated_by\n"
    "\n"
    "@invalidated_by('_bump', '_idx')\n"
    "class C:\n"
    "    def __init__(self):\n"
    "        self._idx = {}\n"
    "        self._gen = 0\n"
    "\n"
)


class TestN012:
    def test_mutation_without_emission_convicted(self, an):
        src = _N012_CLASS + (
            "    def mutate(self, k, v):\n"
            "        self._idx[k] = v\n"
            "\n"
            "    def _bump(self):\n"
            "        self._gen += 1\n"
        )
        v = an.lint(src, "InvalidationProtocol", relpath=SCHED)
        assert rules_of(v) == ["N012"]
        assert "_bump" in v[0].message

    def test_post_dominating_emission_passes(self, an):
        src = _N012_CLASS + (
            "    def mutate(self, k, v):\n"
            "        self._idx[k] = v\n"
            "        self._bump()\n"
            "\n"
            "    def _bump(self):\n"
            "        self._gen += 1\n"
        )
        assert an.lint(src, "InvalidationProtocol",
                           relpath=SCHED) == []

    def test_counter_bump_emission_form_passes(self, an):
        # ClusterSnapshot's form: the event is an attribute the mutator
        # writes (self._gen += 1), not a method call
        src = (
            "from nos_tpu.utils.guards import invalidated_by\n"
            "\n"
            "@invalidated_by('_gen', '_idx')\n"
            "class C:\n"
            "    def __init__(self):\n"
            "        self._idx = {}\n"
            "        self._gen = 0\n"
            "\n"
            "    def mutate(self, k, v):\n"
            "        self._idx[k] = v\n"
            "        self._gen += 1\n"
        )
        assert an.lint(src, "InvalidationProtocol",
                           relpath=SCHED) == []

    def test_whole_field_rebind_is_exempt(self, an):
        # invalidate-by-rebuild: replacing the container IS the
        # invalidation (Scheduler._class_scan_cache = {})
        src = _N012_CLASS + (
            "    def reset(self):\n"
            "        self._idx = {}\n"
            "\n"
            "    def _bump(self):\n"
            "        self._gen += 1\n"
        )
        assert an.lint(src, "InvalidationProtocol",
                           relpath=SCHED) == []

    def test_pragma_with_reason_suppresses(self, an):
        src = _N012_CLASS + (
            "    def mutate(self, k, v):\n"
            "        self._idx[k] = v  "
            "# noslint: N012 — caller bumps, audited\n"
            "\n"
            "    def _bump(self):\n"
            "        self._gen += 1\n"
        )
        assert an.lint(src, "InvalidationProtocol",
                           relpath=SCHED) == []

    def test_declared_carriers_stay_declared(self, an):
        # The REQUIRED registry names the real cross-cycle cache
        # carriers; importing them must show live declarations (the
        # static sweep separately proves their mutators emit).
        ClusterSnapshot = an.module("partitioning.core.snapshot").ClusterSnapshot
        SchedulerCache = an.module("scheduler.cache").SchedulerCache
        Scheduler = an.module("scheduler.scheduler").Scheduler
        invalidated_fields = an.module("utils.guards").invalidated_fields

        assert invalidated_fields(SchedulerCache)["_node_objs"] \
            == "_bump_locked"
        assert invalidated_fields(ClusterSnapshot)["_nodes"] \
            == "_mutation_gen"
        assert invalidated_fields(Scheduler)["_cycle_lister_cache"] \
            == "_invalidate_scans"
        # the window-busy map rides its own event in both packages:
        # every in-place flip routes through _mark_busy
        busy = invalidated_fields(Scheduler).get("_busy_map_cache")
        assert busy == "_mark_busy"

    def test_busy_map_mutation_off_the_event_convicted(self, an):
        # Conviction fixture mirroring Scheduler's stacked declaration:
        # an in-place write to the window-busy map that does not ride
        # _mark_busy must be an N012 verdict, with the event named.
        src = (
            "from nos_tpu.utils.guards import invalidated_by\n"
            "\n"
            "@invalidated_by('_invalidate', '_lister')\n"
            "@invalidated_by('_mark_busy', '_busy_map_cache')\n"
            "class S:\n"
            "    def __init__(self):\n"
            "        self._busy_map_cache = {}\n"
            "        self._lister = None\n"
            "\n"
            "    def bind(self, key):\n"
            "        self._busy_map_cache[key] = True\n"
            "\n"
            "    def _mark_busy(self, key):\n"
            "        self._busy_map_cache[key] = True\n"
            "\n"
            "    def _invalidate(self):\n"
            "        pass\n"
        )
        v = an.lint(src, "InvalidationProtocol", relpath=SCHED)
        assert rules_of(v) == ["N012"]
        assert "_mark_busy" in v[0].message

    def test_busy_map_mutation_riding_the_event_passes(self, an):
        src = (
            "from nos_tpu.utils.guards import invalidated_by\n"
            "\n"
            "@invalidated_by('_mark_busy', '_busy_map_cache')\n"
            "class S:\n"
            "    def __init__(self):\n"
            "        self._busy_map_cache = {}\n"
            "\n"
            "    def bind(self, key):\n"
            "        self._mark_busy(key)\n"
            "\n"
            "    def _mark_busy(self, key):\n"
            "        self._busy_map_cache[key] = True\n"
        )
        assert an.lint(src, "InvalidationProtocol",
                           relpath=SCHED) == []

    def test_carrier_rejects_non_string_names(self, an):
        # both checkers read the table as attribute names; a non-string
        # entry is unresolvable for them, so it must fail at declaration
        G = an.module("utils.guards")
        guarded_by, invalidated_by = G.guarded_by, G.invalidated_by
        with pytest.raises(ValueError):
            invalidated_by(123, "_f")       # type: ignore[arg-type]
        with pytest.raises(ValueError):
            invalidated_by("_bump", b"_f")  # type: ignore[arg-type]
        with pytest.raises(ValueError):
            guarded_by("_lock", 7)          # type: ignore[arg-type]

    def test_registry_covers_required_modules(self, an):
        required = {(m, c) for m, c, _
                    in an.rule("InvalidationProtocol").REQUIRED}
        assert (an.rel("nos_tpu.scheduler.cache"), "SchedulerCache") \
            in required
        assert (an.rel("nos_tpu.scheduler.scheduler"), "Scheduler") \
            in required
        assert (an.rel("nos_tpu.partitioning.core.snapshot"),
                "ClusterSnapshot") in required


# ---------------------------------------------------------------------------
# Journal capture/replay (the plan_workers determinism substrate)
# ---------------------------------------------------------------------------

class TestJournalCapture:
    def test_capture_buffers_and_replay_restamps(self, an):
        J = an.module("obs.journal")
        DecisionJournal, JournalCapture = J.DecisionJournal, J.JournalCapture
        capture_records, get_journal = J.capture_records, J.get_journal
        record, set_journal = J.record, J.set_journal
        prev = set_journal(DecisionJournal(clock=lambda: 42.0))
        try:
            capture = JournalCapture()
            with capture_records(capture):
                record("plan-node-committed", "host-1", placed=3)
                record("plan-node-reverted", "host-2")
            # nothing reached the ambient journal yet
            assert get_journal().events() == []
            capture.replay()
            events = get_journal().events()
            assert [(r.category, r.subject) for r in events] == [
                ("plan-node-committed", "host-1"),
                ("plan-node-reverted", "host-2"),
            ]
            # seq/ts are the AMBIENT journal's — replay is
            # indistinguishable from inline recording
            assert [r.seq for r in events] == [1, 2]
            assert all(r.ts == 42.0 for r in events)
        finally:
            set_journal(prev)

    def test_capture_is_context_scoped(self, an):
        J = an.module("obs.journal")
        DecisionJournal, JournalCapture = J.DecisionJournal, J.JournalCapture
        capture_records, get_journal = J.capture_records, J.get_journal
        record, set_journal = J.record, J.set_journal
        prev = set_journal(DecisionJournal())
        try:
            with capture_records(JournalCapture()):
                record("pod-bound", "ns/captured")
            record("pod-bound", "ns/direct")
            assert [r.subject for r in get_journal().events()] \
                == ["ns/direct"]
        finally:
            set_journal(prev)


# ---------------------------------------------------------------------------
# nosdiff: the dual-run harness
# ---------------------------------------------------------------------------

class TestNosdiff:
    """The port's harness on its own trace (``determinism.trace_spec``:
    the MIG fleet at 64 nodes in 4 NVLink domains, 200 pending pods);
    tests/test_rules_det.py holds JAX's on bench_plan's."""

    def test_run_trace_is_deterministic_in_process(self):
        # same interpreter, twice: everything except PYTHONHASHSEED —
        # which needs subprocesses — must already be pinned
        from nos_tpu_torch.analysis.determinism import run_trace
        from nos_tpu_torch.obs import journal as J
        from nos_tpu_torch.obs import trace

        journal, tracer = J.get_journal(), trace.get_tracer()
        first = run_trace(plan_workers=1, cycles=1)
        second = run_trace(plan_workers=4, cycles=1, incremental=False)
        assert first == second
        assert len(first) > 50      # the trace actually decides things
        # the process's journal and tracer are handed back
        assert J.get_journal() is journal
        assert trace.get_tracer() is tracer
        cats = {r["category"] for r in first}
        assert {"plan-node-committed", "plan-shard-merged",
                "plan-block-carved", "pod-bound", "pod-rejected",
                "gang-rejected"} <= cats
        assert {r["trace_id"] for r in first} == {""}   # tracer off

    def test_trace_is_the_mig_fleet_in_four_domains(self):
        """bench_plan.py's layout and mix: 4 domains of 16, half full,
        its 4x4 row as 2x8 block pods pending, each in a pod group of its
        own."""
        from nos_tpu_torch.analysis import determinism as D
        from nos_tpu_torch.testing import fleet

        spec = D.trace_spec()
        assert len(spec["nodes"]) == 64 and len(spec["pending"]) == 200
        assert sum(bool(n["bound"]) for n in spec["nodes"]) == 32
        assert [(n["domain"], n["host_index"]) for n in spec["nodes"]] == [
            (f"nvl-{i // 16}", i % 16) for i in range(64)]
        assert {p["profile"] for p in spec["pending"]} == \
            {p for p, _ in fleet.MIG_POD_MIX}
        blocks = [p for p in spec["pending"]
                  if p["profile"] == fleet.MIG_BLOCK]
        assert len(blocks) == 18
        assert len({p["gang"] for p in blocks}) == 18

    def test_the_trace_carves_blocks_and_rejects_their_gangs(self):
        """The plan leg's group pass carves aligned windows in the two
        virgin domains, journaled; the schedule leg's gang path rejects
        every block gang each cycle (no block is actuated there)."""
        from nos_tpu_torch.analysis.determinism import run_trace
        from nos_tpu_torch.testing import fleet

        from nos_tpu_torch.analysis import determinism as D

        records = run_trace(plan_workers=4, cycles=2)
        rows = [(r["category"], r["subject"], r["attrs"]) for r in records]
        windows = fleet.block_windows(rows)
        assert {d for _, d, _ in windows} == {"nvl-2", "nvl-3"}
        members = {n: {"0": {b: 1}} for b, _, names in windows
                   for n in names}
        assert fleet.block_plan_problems(D.trace_spec(), windows,
                                         members) == []
        rejected = [s for c, s, _ in rows if c == "gang-rejected"]
        assert len(rejected) == 2 * 18

    def test_golden_matrix_corner_byte_identical(self):
        # tier-1 corner of the full 12-cell matrix: 2 seeds x sharded
        # workers x incremental on/off, one scheduler cycle; the
        # journals must byte-match — a full rescan each cycle against
        # the watch-fed dirty set
        from nos_tpu_torch.analysis.determinism import run_matrix

        report = run_matrix(hash_seeds=("0", "random"),
                            plan_workers=(4,),
                            incremental=("on", "off"), cycles=1,
                            verbose=False)
        assert report.ok, "\n".join(report.failures)
        assert len(report.cells) == 4
        assert report.records > 50
        # the cells really ran under different interpreters/settings
        assert len({c.label for c in report.cells}) == 4
        assert {c.incremental for c in report.cells} == {"on", "off"}
        assert all(c.trace_s is not None and 0 < c.trace_s < c.wall_s
                   for c in report.cells)
        # output is canonical JSON lines
        rec = json.loads(report.cells[0].output.splitlines()[0])
        assert {"category", "subject", "seq", "ts"} <= set(rec)

    def test_judge_fails_a_divergence_an_exit_and_a_timeout(self):
        from nos_tpu_torch.analysis.determinism import CellResult, judge

        ok = CellResult("0", 1, "on", b'{"a":1}\n{"a":2}\n', 0)
        report = judge([ok, CellResult("1", 1, "on", ok.output, 0)],
                       verbose=False)
        assert report.ok and report.records == 2
        report = judge([ok, CellResult("1", 4, "off", b'{"a":1}\n', 0),
                        CellResult("random", 1, "on", b"", 3, "boom"),
                        "child PYTHONHASHSEED=0 exceeded 120s"],
                       verbose=False)
        assert not report.ok
        text = "\n".join(report.failures)
        assert "exceeded 120s" in text
        assert "exited 3" in text and "boom" in text
        assert "prefix" in text

    def test_first_divergence_reports_record_index(self, an):
        _first_divergence = an.module("analysis.determinism")._first_divergence
        ref = b'{"a":1}\n{"a":2}\n'
        other = b'{"a":1}\n{"a":3}\n'
        msg = _first_divergence(ref, other)
        assert "record 2" in msg
        prefix = _first_divergence(ref, ref + b'{"a":4}\n')
        assert "prefix" in prefix


class TestSmokeDeterminism:
    """chip_smoke.py's phase 20 host plumbing on a cut matrix: its cells
    run at once and are judged as ``run_matrix`` judges them."""

    def test_cut_matrix_passes_and_a_divergence_fails(self, monkeypatch):
        import chip_smoke
        from nos_tpu_torch.analysis import determinism as D

        monkeypatch.setattr(D, "matrix_cells",
                            lambda: [("0", 4, "on"), ("random", 1, "off")])
        out = chip_smoke._determinism_matrix(cycles=1, children=2)
        assert out["cells"] == 2 and out["records"] > 50
        assert [c["records"] for c in out["children"]] == [out["records"]] * 2

        real = D.run_cell

        def drifting(seed, workers, inc, cycles):
            cell = real(seed, workers, inc, cycles)
            if seed == "random":
                cell.output = cell.output.replace(b"pod-bound", b"pod-bind", 1)
            return cell

        monkeypatch.setattr(D, "run_cell", drifting)
        with pytest.raises(SystemExit, match="journal diverges"):
            chip_smoke._determinism_matrix(cycles=1, children=2)
