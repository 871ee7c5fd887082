"""The host-window convention, ``nos_tpu/topology/windows.py`` for the
port: the member hosts of one multi-host instance are a consecutive
window of host indices inside one domain, aligned to its size (window
[i, i + size) with i % size == 0).  The defragmenter's candidate windows
come from it, and so will the multi-node gang windows (ROADMAP item
7.2), so carving and placement would change together.  No MIG instance
spans nodes, so on an H100 every window the port asks for is one node.
"""

from __future__ import annotations

from typing import Iterable


def aligned_index_windows(indices: Iterable[int],
                          size: int) -> list[list[int]]:
    """The aligned windows of ``size`` hosts all present in ``indices``."""
    present = set(indices)
    out: list[list[int]] = []
    for start in sorted(present):
        if start % size:
            continue
        window = list(range(start, start + size))
        if all(i in present for i in window):
            out.append(window)
    return out
