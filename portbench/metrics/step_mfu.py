"""Layer: the whole step (``models/train.py`` ``ShardedTrainer``,
``models/moe.py`` ``make_ep_trainer``).  Model FLOPs of a step
(``portbench.flops.model_flops``) over the mean traced step (the window
over its steps), over the card's bf16 peak."""

from portbench import flops


def read(trace, cell, kind):
    peaks = flops.peaks_for(kind)
    if peaks is None or not trace.steps or trace.window_s <= 0:
        return None
    step_s = trace.window_s / trace.steps
    return 100.0 * flops.model_flops(cell.spec, cell.batch_size,
                                     cell.seq_len) / step_s / peaks[0]
