"""The port's interleaving explorer (``nos_tpu_torch/testing/interleave.py``)
to JAX's budgets (``tests/test_interleave.py``), and to the JAX explorer's
verdicts on the same corpus.

- **regression corpus**: the buggy ``replay_dropped`` model found again
  (an inversion and a realised deadlock) within 5000 schedules, every
  fixed model clean to the end, each scenario's schedule count and
  verdicts those of the JAX explorer;
- **explorer mechanics**: exhaustiveness (a deadlock in only one
  interleaving of a 3-cycle is found), sleep sets (independent locks do
  not multiply the schedules), the gate set (a common outer lock makes an
  AB/BA pair safe, as in the lock checker), reentrancy;
- **failure surfaces**: scenario exceptions and lock misuse become result
  errors, not hangs.
"""

from __future__ import annotations

import pytest

from nos_tpu_torch.testing.interleave import (
    REGRESSION_CORPUS, ExplorationError, ExploreResult, explore,
    replay_dropped_scenario,
)

pytestmark = pytest.mark.interleave

# The budget for finding the replay_dropped inversion again (JAX's).
REPLAY_BUDGET = 5000


# ---------------------------------------------------------------------------
# The regression corpus (the determinism gate's dynamic half)
# ---------------------------------------------------------------------------

class TestRegressionCorpus:
    @pytest.mark.parametrize(
        "name,build,expect_clean",
        REGRESSION_CORPUS,
        ids=[name for name, _, _ in REGRESSION_CORPUS])
    def test_corpus_verdicts(self, name, build, expect_clean):
        result = explore(name, build, max_schedules=REPLAY_BUDGET)
        assert result.complete, (
            f"{name}: budget exhausted after {result.schedules} schedules")
        assert result.clean == expect_clean, (
            f"{name}: expected clean={expect_clean}, got "
            f"{result.inversions + result.deadlocks + result.errors}")

    def test_buggy_replay_rediscovered_within_budget(self):
        result = explore("replay-dropped-buggy",
                         replay_dropped_scenario(buggy=True),
                         max_schedules=REPLAY_BUDGET)
        # the inversion (lockcheck's graph verdict) AND the schedule
        # where it actually bites (a realized deadlock) must both be
        # found, well inside the budget
        assert result.first_violation_schedule is not None
        assert result.first_violation_schedule <= REPLAY_BUDGET
        assert result.inversions, "gate-set inversion not rediscovered"
        assert result.deadlocks, "deadlocking schedule not rediscovered"
        assert any("SchedulerCache._lock" in d and "APIServer._lock" in d
                   for d in result.deadlocks)

    def test_fixed_replay_is_certified_clean(self):
        result = explore("replay-dropped-fixed",
                         replay_dropped_scenario(buggy=False),
                         max_schedules=REPLAY_BUDGET)
        assert result.complete and result.clean

    @pytest.mark.parametrize(
        "name,build,expect_clean",
        REGRESSION_CORPUS,
        ids=[name for name, _, _ in REGRESSION_CORPUS])
    def test_corpus_verdicts_are_the_jax_explorer_s(self, name, build,
                                                    expect_clean):
        from nos_tpu.testing import interleave as jax_interleave

        (jbuild,) = [b for n, b, _ in jax_interleave.REGRESSION_CORPUS
                     if n == name]
        got = explore(name, build, max_schedules=REPLAY_BUDGET)
        want = jax_interleave.explore(name, jbuild,
                                      max_schedules=REPLAY_BUDGET)
        # inversions name each edge's source line, which differ between
        # the two modules; their count and the deadlocks do not
        assert (got.schedules, got.complete, got.clean,
                got.first_violation_schedule, len(got.inversions),
                got.deadlocks, got.errors) == \
            (want.schedules, want.complete, want.clean,
             want.first_violation_schedule, len(want.inversions),
             want.deadlocks, want.errors)

    def test_stop_on_first_short_circuits(self):
        result = explore("replay-dropped-buggy",
                         replay_dropped_scenario(buggy=True),
                         max_schedules=REPLAY_BUDGET, stop_on_first=True)
        assert not result.clean
        assert result.schedules == result.first_violation_schedule


# ---------------------------------------------------------------------------
# Explorer mechanics
# ---------------------------------------------------------------------------

def _ring_scenario(env):
    """3-thread dining-philosophers ring: deadlock exists only in the
    interleavings where each thread grabs its first lock before any
    grabs its second — exhaustiveness is what finds it."""
    a = env.lock("A")
    b = env.lock("B")
    c = env.lock("C")

    def t0():
        with a:
            with b:
                pass

    def t1():
        with b:
            with c:
                pass

    def t2():
        with c:
            with a:
                pass

    return [t0, t1, t2]


def _gated_scenario(env):
    """Both nesting orders of A/B exist, but every chain runs under one
    common outer gate G — lockcheck's gate-set semantics say no
    deadlock is reachable, and the explorer (which reuses them, and
    explores every schedule) must agree on both counts."""
    g = env.lock("G")
    a = env.lock("A")
    b = env.lock("B")

    def t0():
        with g:
            with a:
                with b:
                    pass

    def t1():
        with g:
            with b:
                with a:
                    pass

    return [t0, t1]


def _independent_scenario(env):
    """Two threads over disjoint locks: every interleaving commutes, so
    sleep sets should collapse the tree to a handful of schedules."""
    a = env.lock("A")
    b = env.lock("B")

    def t0():
        with a:
            pass
        with a:
            pass

    def t1():
        with b:
            pass
        with b:
            pass

    return [t0, t1]


class TestExplorerMechanics:
    def test_three_thread_ring_deadlock_found(self):
        result = explore("ring", _ring_scenario)
        assert result.complete
        assert result.deadlocks, "the ring's one deadlock interleaving missed"
        assert any("T0" in d and "T1" in d and "T2" in d
                   for d in result.deadlocks)

    def test_gate_set_blesses_common_outer_lock(self):
        result = explore("gated", _gated_scenario)
        assert result.complete
        assert result.clean, (result.inversions + result.deadlocks)

    def test_sleep_sets_prune_independent_interleavings(self):
        result = explore("independent", _independent_scenario)
        assert result.complete and result.clean
        # 2 threads x (spawn + 4 lock ops): naive DFS visits dozens of
        # schedules; with every pair of cross-thread ops independent,
        # sleep sets must collapse to single digits
        assert result.schedules < 10, result.schedules

    def test_reentrant_reacquire_is_not_a_self_deadlock(self):
        def build(env):
            r = env.lock("R", reentrant=True)

            def t0():
                with r:
                    with r:
                        pass

            def t1():
                with r:
                    pass

            return [t0, t1]

        result = explore("reentrant", build)
        assert result.complete and result.clean

    def test_non_reentrant_self_acquire_is_a_deadlock(self):
        def build(env):
            lk = env.lock("L")

            def t0():
                with lk:
                    with lk:
                        pass

            def t1():
                pass

            return [t0, t1]

        result = explore("self-deadlock", build)
        assert result.deadlocks
        assert any("itself" in d for d in result.deadlocks)


# ---------------------------------------------------------------------------
# Failure surfaces
# ---------------------------------------------------------------------------

class TestFailureSurfaces:
    def test_scenario_exception_becomes_result_error(self):
        def build(env):
            a = env.lock("A")

            def t0():
                with a:
                    raise ValueError("boom")

            def t1():
                with a:
                    pass

            return [t0, t1]

        result = explore("raises", build)
        assert not result.clean
        assert any("ValueError" in e for e in result.errors)

    def test_foreign_release_is_convicted(self):
        def build(env):
            a = env.lock("A")

            def t0():
                a.release()     # never acquired

            def t1():
                pass

            return [t0, t1]

        result = explore("foreign-release", build)
        assert any("without owning" in e for e in result.errors)

    def test_wrong_thread_count_rejected(self):
        with pytest.raises(ExplorationError):
            explore("solo", lambda env: [lambda: None])

    def test_assert_clean_raises_with_detail(self):
        result = ExploreResult(scenario="x", schedules=1,
                               deadlocks=["deadlock: T0 waits"])
        with pytest.raises(AssertionError, match="T0 waits"):
            result.assert_clean()
