"""What the trainers' sessions share: the one-rank process group and
mesh the training main makes, the optimizer-state reading, the names."""

from __future__ import annotations

import torch
import torch.distributed as dist

from nos_tpu_torch.cmd.train import maybe_init_distributed
from nos_tpu_torch.parallel.mesh import MeshSpec, make_mesh


def one_rank_mesh(device: torch.device):
    """A process group of one rank (NCCL on the card) and its mesh, as
    ``cmd/train.py`` builds them without torchrun's environment."""
    maybe_init_distributed(device)
    return make_mesh(MeshSpec(), device.type)


def local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def first_moment_norms(model, optimizer, beta1: float
                       ) -> dict[str, torch.Tensor]:
    """Each parameter's first-moment norm over (1 - beta1): after one
    step of Adam(W), the norm of the gradient it was given (0 where the
    optimizer holds no state for it)."""
    out = {}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p, {})
        out[name] = (torch.linalg.vector_norm(local(state["exp_avg"]).float())
                     / (1 - beta1) if "exp_avg" in state
                     else torch.zeros((), device=local(p).device))
    return out


def check_hyper(group: dict, opt: dict) -> None:
    """Raise unless the program's optimizer runs as the configuration
    states (betas, eps, decay)."""
    want = {"betas": (opt["b1"], opt["b2"]), "eps": opt["eps"],
            "weight_decay": opt.get("weight_decay", 0.0)}
    got = {k: tuple(group[k]) if k == "betas" else group[k] for k in want}
    if got != want:
        raise RuntimeError(f"the program's optimizer runs {got}, the "
                           f"configuration states {want}")


def close() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
