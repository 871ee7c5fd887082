"""Layer: device (one H100 SXM).  The share of the traced window in
which no kernel, copy or memset ran: 1 - (union of device activity) /
(the window)."""


def read(trace, cell, kind):
    if trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
