"""Layer: trainer (``models/train.py`` clip and AdamW, ``models/moe.py``
Adam).  Device ms a step of kernels launched under the optimizer's step
(``Optimizer.step#...``) or under the clip's two multi-tensor ops, which
``DefaultOptimizer.step`` runs before it."""

from portbench.metrics import ms_per_step, owned

CLIP_OPS = frozenset({"aten::_foreach_norm", "aten::_foreach_mul_"})


def MATCH(name: str) -> bool:
    return name.startswith("Optimizer.step") or name in CLIP_OPS


def read(trace, cell, kind):
    return ms_per_step(trace, owned(trace, __name__.rsplit(".", 1)[-1]))
