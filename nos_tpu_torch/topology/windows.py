"""The host-window convention, ``nos_tpu/topology/windows.py`` for the
port: the member nodes of one NVLink block are a consecutive window of
host indices inside one domain, aligned to its size (window [i, i +
size) with i % size == 0).  The partitioner's group pass carves blocks
over these windows (``partitioning/slicepart/group.py``), the gang
scheduler places block gangs in them (``scheduler/gang.py``) and the
defragmenter proposes them, so carving and placement change together.
A MIG instance's window is one node.
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
