"""The port's checkpoints (nos_tpu_torch.models.checkpoint) on
torch.distributed.checkpoint, over one and two gloo ranks: the JAX
TrainCheckpointer's contract (step directories, max_to_keep=3, a second
save of a step declined, restore into a fresh trainer's abstract state,
FileNotFoundError with nothing to restore), and a run resumed after 3
steps equal bitwise to 6 straight."""

import dataclasses

import numpy as np
import pytest

from nos_tpu.models import llama as jl
from nos_tpu_torch.parallel.mesh import run_ranks
from nos_tpu_torch.testing import ranks

from test_torch_llama import port_cfg

TINY = port_cfg(jl.TINY)
# one rank; two ranks over fsdp (each holds half of every parameter and
# of its moments); and tp x sp with ring attention
MESHES = {"fsdp=1": TINY, "fsdp=2": TINY,
          "tp=2,sp=2": dataclasses.replace(TINY, attn_impl="ring")}


@pytest.fixture(scope="module", params=list(MESHES))
def contract(request, tmp_path_factory):
    text = request.param
    world = int(np.prod([int(p.split("=")[1]) for p in text.split(",")]))
    out = run_ranks(ranks.checkpoint_contract, world, text, MESHES[text],
                    str(tmp_path_factory.mktemp("ck") / "run"), timeout=180)
    assert all(o == out[0] for o in out[1:])      # every rank agrees
    return out[0]


class TestContract:
    def test_fresh_directory(self, contract):
        assert contract["fresh_latest"] is None
        assert contract["fresh_restore"] == "no checkpoint to restore"

    def test_saves_keep_the_newest_three(self, contract):
        assert contract["saved"] == [True] * 5
        assert contract["latest"] == 5
        assert contract["kept"] == ["3", "4", "5"]

    def test_existing_step_is_not_overwritten(self, contract):
        assert contract["again"] is False

    def test_restore_into_abstract_state(self, contract):
        assert contract["restored_step"] == 5
        assert contract["params_equal"] and contract["moments_equal"]

    def test_restore_an_older_step(self, contract):
        assert contract["restored_old_step"] == 4


@pytest.mark.parametrize("text", ["fsdp=1", "fsdp=2"])
def test_resumed_run_is_bitwise_the_straight_run(text, tmp_path):
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, TINY.vocab_size, (4, 32), dtype=np.int32)
               for _ in range(6)]
    world = int(text.split("=")[1])
    out = run_ranks(ranks.resume_bitwise, world, text, TINY, batches,
                    str(tmp_path / "ck"), timeout=180)
    for rank in out:
        assert rank["step"] == 6
        assert rank["resumed"] == rank["straight"]     # bitwise, as floats
        assert rank["params_bitwise"]
