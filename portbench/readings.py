"""The two sides' readings of a cell's first steps (``check.Readings``).

The program's: its first ``steps`` steps through the timed call and
feed, each one's loss, the first gradient's norms from the optimizer's
state after step 1, and each parameter's change from the seeded weights
(drawn again) after the last.  The reference's: the same from
``reference.train.run`` on the same weights and batches."""

from __future__ import annotations

import torch

from portbench import inputs
from portbench.check import Readings
from portbench.reference import train as ref_train


def _change(params: dict[str, torch.Tensor], spec, seed: int,
            device) -> dict[str, float]:
    start = inputs.make_params(spec, seed, device)
    out = {n: float(torch.linalg.vector_norm(p.float() - start[n]))
           for n, p in params.items()}
    del start
    return out


def program(session, feed, steps: int, spec, seed: int, device) -> Readings:
    losses, grads = [], {}
    for i in range(steps):
        losses.append(session.step(next(feed)))
        if i == 0:
            grads = session.first_grad_norms()
    return Readings([float(x) for x in losses],
                    {n: float(g) for n, g in grads.items()},
                    _change(session.params(), spec, seed, device))


def reference(spec, seed: int, batch_size: int, seq_len: int, steps: int,
              device, fp8: bool = False) -> Readings:
    params = inputs.make_params(spec, seed, device)
    batches = [inputs.batch(seed, i, batch_size, seq_len, spec.vocab_size)
               for i in range(steps)]
    out = ref_train.run(spec, params, batches, fp8)
    return Readings(out.losses, out.grad_norms,
                    _change(out.params, spec, seed, device))
