"""The control at test size: the reference put in the program's place in
fp8 (one precision below the configuration's bf16 activations; here
below fp32) fails the cell's check on three seeds."""

import pytest

from portbench import check, readings
from portbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("family", ["dense", "moe"])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 3, 90210])
def test_control_fails(family, seed):
    cell = tiny_cell(family)
    args = (cell.spec, seed, cell.batch_size, cell.seq_len, 3, "cpu")
    ref = readings.reference(*args)
    control = readings.reference(*args, fp8=True)
    ok, shown = check.verdict(check.gaps(control, ref), cell.limits)
    assert not ok, shown


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(cuda):
    """One short run of the first cell at its own size."""
    import subprocess
    import sys
    import json
    from portbench.tests.conftest import ROOT

    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mistral7b-train-s8k", "--seed", "424242", "--seconds", "5",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
