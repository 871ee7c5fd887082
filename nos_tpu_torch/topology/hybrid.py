"""Hybrid-node family split, ``nos_tpu/topology/hybrid.py`` for the port:
which GPUs of a node each strategy owns.

The reference's hybrid partitioning gives each GPU of a node to exactly
one strategy (pkg/gpu/partitioning.go:81-135).  As the JAX package's
slice family owns a leading prefix of the host block, the MIG family
here owns the leading half of the GPUs, rounded down, and the MPS family
the rest; a one-GPU node goes to the MIG family (the JAX default halves
the block's first axis longer than one chip, and leaves a one-chip host
to the slice family).  Moving the boundary to each GPU's MIG mode, as
the reference splits, is still queued (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Mapping

from nos_tpu_torch.api import constants as C


def gpu_count(labels: Mapping[str, str]) -> int | None:
    """The node's GPU count from its label; None when absent or not a
    positive integer."""
    try:
        n = int(labels.get(C.LABEL_GPU_COUNT, ""))
    except ValueError:
        return None
    return n if n > 0 else None


def hybrid_mig_gpus(labels: Mapping[str, str], gpu_count: int) -> int | None:
    """How many leading GPUs the MIG family owns on a hybrid node; None
    when the node is not hybrid."""
    if labels.get(C.LABEL_PARTITIONING) != C.HYBRID_KIND:
        return None
    return gpu_count // 2 if gpu_count >= 2 else gpu_count


def mig_gpus(labels: Mapping[str, str], count: int) -> range:
    """GPU indices the MIG family owns: all of them on a node that is
    not hybrid, the leading half on a hybrid one."""
    mig = hybrid_mig_gpus(labels, count)
    return range(count if mig is None else mig)


def timeshare_gpus(labels: Mapping[str, str],
                   gpu_count: int) -> frozenset[int] | None:
    """GPU indices the MPS family owns; None means all of them (a node
    that is not hybrid)."""
    mig = hybrid_mig_gpus(labels, gpu_count)
    if mig is None:
        return None
    return frozenset(range(mig, gpu_count))
