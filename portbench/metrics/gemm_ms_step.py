"""Layer: model products (``models/llama.py`` projections and tied head,
``models/moe.py`` experts).  Device ms a step of kernels launched under
a matrix product op."""

from portbench.metrics import ms_per_step, owned

OPS = frozenset({"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
                 "aten::linear", "aten::matmul", "aten::_scaled_mm"})


def MATCH(name: str) -> bool:
    return name in OPS


def read(trace, cell, kind):
    return ms_per_step(trace, owned(trace, __name__.rsplit(".", 1)[-1]))
