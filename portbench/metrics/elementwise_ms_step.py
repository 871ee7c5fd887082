"""Layer: model elementwise work (norms, RoPE, casts, dispatch and
combine, the loss, FSDP's copies).  Device ms a step of every kernel,
copy and memset in the window that none of the fixed groups
``portbench.metrics.GROUPS`` claims: the flash forward and backward,
the matrix products and the optimizer.  A metric module added later
takes nothing from it."""

from portbench.metrics import GROUPS, ms_per_step, rules


def read(trace, cell, kind):
    table = rules(GROUPS)
    return ms_per_step(trace, [(a, -1) for a in trace.device
                               if trace.owner(a, table)[0] is None])
