"""Device mesh for the port's training path, ``nos_tpu/parallel/mesh.py``
over ``torch.distributed``.

The same five named axes as the JAX package:

- ``dp``   — pure data parallelism (replicated parameters; FSDP2's
  replicate dim, so dp > 1 with fsdp is HSDP)
- ``fsdp`` — data parallelism with sharded parameters and optimizer state
- ``tp``   — tensor parallelism, Megatron-style within attention and MLP
- ``sp``   — sequence parallelism (ring attention, ``parallel/ring.py``)
- ``ep``   — expert parallelism (MoE experts split across ranks,
  ``models/moe.py``)

``MeshSpec``, ``AXES`` and ``factorize_pow2`` are copies of the JAX
module's.  ``make_mesh`` builds a ``DeviceMesh`` over the ranks of the
default process group, ``local_block`` is ``batch_sharding``'s rule for
one rank, and ``DEFAULT_RULES`` is the table of which parameter dim each
axis shards (the port places parameters by hand, ``models/train.py``).
``run_ranks`` runs a function on n ranks, each a process of its own in
one process group: gloo on the CPU, NCCL on the card.

The JAX module's ``enable_collective_overlap`` sets TPU-only XLA flags
and has no counterpart here: FSDP2 prefetches the next block's
all-gather on its own streams.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "fsdp", "tp", "sp", "ep")

# Which dim of each tensor an axis splits (nos_tpu/parallel/mesh.py
# DEFAULT_RULES, logical axis -> mesh axis, read for the port's layouts:
# a Dense weight is [out, in], the tied embedding [vocab, embed]).
DEFAULT_RULES = (
    ("tokens [batch, seq]", "dim 0 over (dp, fsdp), dim 1 over sp"),
    ("every parameter", "dim 0 over (fsdp, sp) by FSDP2, replicated "
     "over dp"),
    ("q/k/v, gate/up weight [out, in]", "out (heads, mlp) over tp"),
    ("o, down weight [out, in]", "in (heads, mlp) over tp"),
    ("embed [vocab, embed]", "whole over tp (the JAX rules split vocab "
     "over tp: the same loss, more memory)"),
    ("norm scales, head_dim, layers", "whole"),
    ("MoE experts w_gate, w_up [E, D, F], w_down [E, F, D]",
     "E over ep, F over tp; dim 0 of each rank's share over (fsdp, sp) by "
     "FSDP2 (not over ep), replicated over dp"),
    ("MoE router [E, D]", "whole over tp and ep (every ep rank routes "
     "the same tokens)"),
)


@dataclass(frozen=True)
class MeshSpec:
    """A named mesh shape, e.g. MeshSpec(dp=1, fsdp=2, tp=2, sp=2)."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp * self.ep

    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                "sp": self.sp, "ep": self.ep}

    @staticmethod
    def parse(text: str) -> "MeshSpec":
        """Parse 'dp=2,fsdp=4' or a bare topology '2x2x4' (mapped onto
        (fsdp, tp, sp) largest-first) into a MeshSpec."""
        text = text.strip()
        if "=" in text:
            kv = dict(part.split("=") for part in text.split(","))
            return MeshSpec(**{k.strip(): int(v) for k, v in kv.items()})
        dims = sorted((int(d) for d in text.split("x")), reverse=True)
        axes = ["fsdp", "tp", "sp"]
        out = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "ep": 1}
        for ax, d in zip(axes, dims):
            out[ax] = d
        for d in dims[len(axes):]:
            out["dp"] *= d
        return MeshSpec(**out)

    @staticmethod
    def for_device_count(n: int, *, want_sp: bool = True,
                         want_tp: bool = True) -> "MeshSpec":
        """A sensible default factorization of n devices exercising every
        parallelism the count allows: sp=2 and tp=2 when divisible, the
        power-of-two part of the remainder on fsdp, and any odd factor on
        dp — batch size is freely adjustable, model dims (which fsdp/tp/sp
        must divide) are not."""
        sp = 2 if (want_sp and n % 2 == 0 and n >= 4) else 1
        tp = 2 if (want_tp and n % (2 * sp) == 0 and n // sp >= 2) else 1
        rem = n // (sp * tp)
        fsdp = rem & -rem  # largest power of two dividing rem
        return MeshSpec(dp=rem // fsdp, fsdp=fsdp, tp=tp, sp=sp)


def factorize_pow2(n: int, parts: int) -> list[int]:
    """Split n (a power of two) into `parts` factors, largest first."""
    if n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    out = [1] * parts
    i = 0
    while n > 1:
        out[i % parts] *= 2
        n //= 2
        i += 1
    return sorted(out, reverse=True)


def make_mesh(spec: MeshSpec | None = None,
              device_type: str = "cuda") -> DeviceMesh:
    """The ``DeviceMesh`` of the default process group's ranks with the
    dims ``AXES``, row-major in rank order as JAX's ``make_mesh`` lays
    out ``jax.devices()`` (so ``sp``, the ring, varies fastest of the
    used axes).  Raises ValueError when the spec's size is not the world
    size."""
    world = dist.get_world_size()
    if spec is None:
        spec = MeshSpec.for_device_count(world)
    if spec.size != world:
        raise ValueError(
            f"mesh spec {spec.shape()} needs {spec.size} devices, "
            f"got {world}")
    return init_device_mesh(
        device_type, (spec.dp, spec.fsdp, spec.tp, spec.sp, spec.ep),
        mesh_dim_names=AXES)


def mesh_spec(mesh: DeviceMesh) -> MeshSpec:
    """The MeshSpec a ``make_mesh`` mesh was built from."""
    return MeshSpec(**{ax: mesh[ax].size() for ax in AXES})


def local_block(batch: np.ndarray, mesh: DeviceMesh) -> np.ndarray:
    """This rank's block of a global [batch, seq, ...] array under
    ``batch_sharding``'s rule: rows split over (dp, fsdp), dp major, and
    the sequence split over sp."""
    spec = mesh_spec(mesh)
    rows, cols = spec.dp * spec.fsdp, spec.sp
    b, s = batch.shape[:2]
    if b % rows or s % cols:
        raise ValueError(
            f"batch {batch.shape[:2]} does not split into {rows} row "
            f"blocks (dp x fsdp) and {cols} sequence blocks (sp)")
    r = mesh["dp"].get_local_rank() * spec.fsdp \
        + mesh["fsdp"].get_local_rank()
    c = mesh["sp"].get_local_rank()
    br, bc = b // rows, s // cols
    return batch[r * br:(r + 1) * br, c * bc:(c + 1) * bc]


# -- running ranks -----------------------------------------------------------

def backend_for(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def _rank_main(fn: Callable, args: tuple, rank: int, world: int,
               store_path: str, device_type: str, results) -> None:
    """One rank's process: join the group, run ``fn(*args)``, report."""
    try:
        # what torchrun tells each worker, for code that reads it
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                          LOCAL_RANK=str(rank))
        device_id = None
        if device_type == "cuda":
            device_id = torch.device("cuda", rank)
            torch.cuda.set_device(device_id)
        else:
            # n ranks share the host's cores; one thread each keeps them
            # from oversubscribing it (and CPU reductions repeatable)
            torch.set_num_threads(1)
        dist.init_process_group(
            backend_for(device_type), rank=rank, world_size=world,
            store=dist.FileStore(store_path, world), device_id=device_id)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which
        # raises it; a rank must never die silently
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *args, device_type: str = "cpu",
              timeout: float = 300.0) -> list:
    """``fn(*args)`` on ``world`` ranks of one process group, each a
    spawned process (gloo on the CPU; NCCL on the card, rank r on card r)
    with torchrun's ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set.
    ``fn`` must be importable by name and import no more than it needs:
    the ranks start from a fresh interpreter.  Returns each rank's result
    in rank order.  Rendezvous is a ``FileStore`` in a fresh temporary
    directory, so concurrent launches never share a port or a store.

    Raises RuntimeError with the rank's traceback when any rank raises or
    dies, and TimeoutError when the ranks have not all finished within
    ``timeout`` seconds; in both cases every rank still running is killed
    first, so a hung collective cannot outlive the call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="nos-ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(fn, args, rank, world, store, device_type, results))
            for rank in range(world)]
        for p in procs:
            p.start()
        out: dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{fn.__name__} on {world} ranks: ranks "
                        f"{sorted(set(range(world)) - set(out))} not done "
                        f"after {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and not p.is_alive()
                            and p.exitcode not in (0, None)]
                    if dead:
                        raise RuntimeError(
                            f"{fn.__name__}: rank {dead[0]} died with exit "
                            f"code {procs[dead[0]].exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(
                        f"{fn.__name__} failed on rank {rank} of {world}:\n"
                        f"{payload}")
                out[rank] = pickle.loads(payload)
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            results.close()
    return [out[r] for r in range(world)]
