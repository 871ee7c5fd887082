"""The comparison that decides ``correct``, against hand counts."""

import math

from portbench.check import Readings, gaps, verdict


def _ref():
    # median first-gradient norm 2.0; "b" is nought to rounding (under a
    # thousandth of it), so its change is left out
    return Readings([10.0, 9.0], {"a": 4.0, "b": 1e-4, "c": 2.0},
                    {"a": 1.0, "b": 0.5, "c": 2.0})


def test_gaps_by_hand():
    side = Readings([10.001, 9.003], {"a": 4.2, "b": 0.1, "c": 2.0},
                    {"a": 1.02, "b": 0.9, "c": 2.2})
    found = gaps(side, _ref())
    assert math.isclose(found["loss_gap"]["value"], 0.003, rel_tol=1e-6)
    assert found["loss_gap"]["at"] == "step 2"
    # a: 0.2 / 4; b: 0.1 / 2 (the median leaf's norm); c: 0
    assert math.isclose(found["grad_gap"]["value"], 0.05)
    assert math.isclose(found["grad_median_gap"]["value"], 0.0999 / 2)
    # changes: a 0.02 / 1.5 (median of a and c), c 0.2 / 2; b left out
    assert found["left_out"] == ["b"]
    assert math.isclose(found["update_gap"]["value"], 0.1)
    assert found["update_gap"]["at"] == "c"


def test_verdict_holds_each_number_to_its_limit():
    found = gaps(_ref(), _ref())
    ok, shown = verdict(found, {"loss_gap": 1e-3, "grad_gap": 1e-3})
    assert ok and set(shown) == {"loss_gap", "grad_gap"}
    assert shown["grad_gap"] == {"value": 0.0, "limit": 1e-3, "at": "a"}
    side = Readings([math.nan, 9.0], _ref().grad_norms, _ref().update_norms)
    ok, shown = verdict(gaps(side, _ref()), {"loss_gap": 1e-3})
    assert not ok and shown["loss_gap"]["value"] == math.inf
