"""Mixture-of-experts model family, ``nos_tpu/models/moe.py`` in PyTorch.

The MoE block is the Llama block with its MLP replaced by top-k routed
SwiGLU experts.  Routing is the JAX module's, step for step:

- an fp32 router on the normed activations (already in the activation
  dtype) gives softmax probabilities; ``top_k`` picks the k largest in
  descending order and their gates are renormalised by max(sum, 1e-9);
- every expert has a buffer of capacity C = max(1, ceil(T k / E
  capacity_factor)) over the T tokens of the global batch; a (token,
  choice) takes the next free position of its expert in token-major
  order (token t's choice 0, then its choice 1, then token t+1) and is
  dropped when that position is >= C;
- the Switch auxiliary term E sum_e mean(top1)_e mean(probs)_e times
  ``router_aux_weight``, top1 the one-hot of each token's first choice.

Where the JAX module builds one-hot [T, E, C] dispatch and combine
tensors and contracts them with einsums, the port moves rows by index:
each kept (token, choice) is copied into slot (e, c) of an [E, C, D]
buffer, the experts run as batched products [E, C, D] x [E, D, F] on
weights kept in JAX's [E, D, F] / [E, F, D] layout, and each token's
<= k outputs are gathered back and weighted.  Each slot receives at most
one token (dropped choices, and under ep those of other ranks' experts,
go to one spare slot that is cut off), so the copy's backward, a gather,
is deterministic, and so is the gather's, which adds one row into every
real slot and zeros into the spare.  The roundings are JAX's: the gate is cast to
the activation dtype before its product, products accumulate in fp32 and
are rounded once, SiLU and the gate * up product run in the activation
dtype.  ``moe_mlp_reference`` keeps the einsum form as the plain version
for the tests; nothing on the main path runs it.

Over a mesh (``parallel.mesh.make_mesh``) the tokens are replicated over
ep, as JAX's batch sharding P(("dp", "fsdp"), "sp") leaves them, and the
experts are split over it: each ep rank holds E / ep experts, routes the
same tokens, fills only its own experts' slots, and the combined output
is summed over the ep group.  The expert path's input and the gates pass
through the conjugate (identity forward, all-reduce backward over ep and
tp), so the router's gradient and the block input's are whole on every
rank.  Under tp the experts' F dim splits like the dense MLP's.  Routing
is global over the data ranks (dp, fsdp, sp), as the JAX layer sees the
global [B, S, D]: each rank gathers every rank's expert choices, takes
the position-in-expert over the global token order and keeps its own.

``MoEBlock`` returns ``(x, aux)``; the aux term is never kept in a module
attribute, since the block is a checkpoint region whose side effects
would be replayed in backward.  ``MoELlama`` remats each whole block with
no policy, as ``nn.remat(MoEBlock)`` does, ignoring ``remat_policy`` and
``scan_layers``; its layers are unrolled (``layer_{i}`` in the flax
tree).  ``make_ep_trainer`` is the sharded init and optax ``adam(1e-3)``
step over a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from nos_tpu_torch import resolve_device
from nos_tpu_torch.models.llama import (Attention, Dense, Draws, LlamaConfig,
                                        Parallel, RMSNorm, _check_parallel,
                                        _chunked_xent, _SumOver, _ToTP,
                                        ep_slice, init_attention, is_expert,
                                        rope_tables, tied_logits, tp_dim,
                                        tp_slice)
from nos_tpu_torch.models.train import _fsdp_mesh, _on_device
from nos_tpu_torch.parallel.mesh import local_block, mesh_spec


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    # auxiliary load-balancing loss weight (Switch §2.2 style)
    router_aux_weight: float = 0.01


# Small config for tests and the CPU dryrun.
TINY_MOE = MoEConfig(
    vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, max_seq_len=128,
    dtype=torch.float32, num_experts=4, top_k=2,
)


def capacity(cfg: MoEConfig, tokens: int) -> int:
    """Each expert's buffer size for ``tokens`` tokens (the JAX formula,
    in Python floats)."""
    return max(1, math.ceil(tokens * cfg.top_k / cfg.num_experts
                            * cfg.capacity_factor))


@dataclasses.dataclass(frozen=True)
class DataRanks:
    """The ranks that hold the other tokens of the global batch for this
    rank's (tp, ep) coordinate: ``rows`` = dp x fsdp row blocks, ``cols``
    = sp sequence blocks, ``blocks[i]`` the (row, col) of group rank i,
    and this rank's own (``row``, ``col``)."""

    group: object
    rows: int
    cols: int
    blocks: tuple[tuple[int, int], ...]
    row: int
    col: int

    @classmethod
    def of(cls, mesh) -> "DataRanks | None":
        """None without a mesh or when one rank holds the whole batch.
        Every rank of the mesh must call it (it makes process groups)."""
        if mesh is None:
            return None
        spec = mesh_spec(mesh)
        rows, cols = spec.dp * spec.fsdp, spec.sp
        if rows * cols == 1:
            return None
        # (dp, fsdp, tp, sp, ep) -> (tp, ep) x (dp, fsdp, sp)
        ranks = mesh.mesh.permute(2, 4, 0, 1, 3).reshape(
            spec.tp * spec.ep, rows * cols)
        group = DeviceMesh(mesh.device_type, ranks,
                           mesh_dim_names=("model", "data")).get_group("data")

        def block(rank: int) -> tuple[int, int]:
            dp, fsdp, _tp, sp, _ep = (
                int(i) for i in (mesh.mesh == rank).nonzero()[0])
            return dp * spec.fsdp + fsdp, sp

        blocks = tuple(block(r) for r in dist.get_process_group_ranks(group))
        return cls(group, rows, cols, blocks, *block(dist.get_rank()))

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global [B, S, ...] tensor from every rank's [B_l, S_l, ...]
        block."""
        parts = [torch.empty_like(local) for _ in self.blocks]
        dist.all_gather(parts, local.contiguous(), group=self.group)
        b, s = local.shape[:2]
        out = local.new_empty((self.rows * b, self.cols * s,
                               *local.shape[2:]))
        for (r, c), part in zip(self.blocks, parts):
            out[r * b:(r + 1) * b, c * s:(c + 1) * s] = part
        return out

    def mine(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global [B, S, ...] tensor."""
        b, s = full.shape[0] // self.rows, full.shape[1] // self.cols
        return full[self.row * b:(self.row + 1) * b,
                    self.col * s:(self.col + 1) * s]


@dataclasses.dataclass
class Routing:
    """One layer's routing of this rank's T_l tokens: fp32 ``probs``
    [T_l, E], the k choices ``expert`` [T_l, k] (descending probability)
    with their renormalised fp32 ``gates``, each choice's ``position`` in
    its expert's buffer over the global token order, ``kept`` = position
    < ``capacity``, the global share of tokens whose first choice is each
    expert ``top1`` [E], and the global token count."""

    probs: torch.Tensor
    expert: torch.Tensor
    gates: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    capacity: int
    top1: torch.Tensor
    tokens: int


def route(cfg: MoEConfig, logits: torch.Tensor, shape: tuple[int, int],
          data: DataRanks | None = None) -> Routing:
    """The routing of router ``logits`` [T_l, E] (fp32) for this rank's
    [B_l, S_l] block (``shape``) of the global batch."""
    num_e, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert = torch.topk(probs, k, dim=-1)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                    min=1e-9)
    local = expert.view(*shape, k)
    full = local if data is None else data.gather(local)
    tokens = full.shape[0] * full.shape[1]
    cap = capacity(cfg, tokens)
    # position of each (token, choice) in its expert's buffer: the count
    # of earlier choices of the same expert, token-major.  The scan runs
    # along the contiguous dim of [E, T*k] (down the outer dim of
    # [T*k, E] the card runs it on one thread per expert)
    flat = F.one_hot(full.reshape(-1), num_e).t().contiguous()  # [E, T*k]
    position = ((torch.cumsum(flat, 1) - flat) * flat).sum(0)
    position = position.view(*full.shape)
    if data is not None:
        position = data.mine(position)
    position = position.reshape(-1, k)
    top1 = torch.bincount(full[..., 0].reshape(-1), minlength=num_e
                          ).float() / tokens
    return Routing(probs, expert, gates, position, position < cap, cap,
                   top1, tokens)


class Experts(nn.Module):
    """This rank's experts' stacked SwiGLU weights, w_gate and w_up
    [E_l, D, F_l] and w_down [E_l, F_l, D] in the parameter dtype (JAX's
    layout; F_l = F / tp), run as batched products in the activation
    dtype.  A module of its own so FSDP2 can shard it over the data
    ranks only."""

    def __init__(self, cfg: MoEConfig, device, par: Parallel):
        super().__init__()
        self.cfg, self.par = cfg, par
        e_l = cfg.num_experts // par.ep
        d, f = cfg.hidden_size, cfg.intermediate_size // par.tp

        def weight(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                            device=device))

        self.w_gate = weight(e_l, d, f)
        self.w_up = weight(e_l, d, f)
        self.w_down = weight(e_l, f, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[E_l, C, D] -> [E_l, C, D] in the activation dtype."""
        dtype, par = self.cfg.dtype, self.par
        gate, up, down = (w.to(dtype) for w in (self.w_gate, self.w_up,
                                                 self.w_down))
        h = F.silu(torch.bmm(x, gate)) * torch.bmm(x, up)
        if par.tp == 1:
            return torch.bmm(h, down)
        # each tp rank holds a share of F: sum the fp32 products over tp,
        # then round once, as the whole product would be
        return _SumOver.apply(torch.bmm(h.float(), down.float()),
                              par.tp_group).to(dtype)


def _whole_grad(t: torch.Tensor, *axes: tuple[int, object]) -> torch.Tensor:
    """Identity forward; backward, the gradient summed over each (size,
    group) of ``axes`` whose ranks saw only their own share of it."""
    for n, group in axes:
        if n > 1:
            t = _ToTP.apply(t, group)
    return t


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts with index dispatch and combine:
    forward(x [B_l, S_l, D]) -> (y [B_l, S_l, D], the scaled aux term)."""

    def __init__(self, cfg: MoEConfig, device=None, par: Parallel = Parallel(),
                 data: DataRanks | None = None):
        super().__init__()
        self.cfg, self.par, self.data = cfg, par, data
        self.router = Dense(cfg.hidden_size, cfg.num_experts, torch.float32,
                            torch.float32, device, "router")
        self.experts = Experts(cfg, device, par)

    def route(self, x: torch.Tensor) -> Routing:
        return route(self.cfg, self.router(x.reshape(-1, x.shape[-1])),
                     x.shape[:2], self.data)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg, par = self.cfg, self.par
        bsz, seq, d = x.shape
        k, e_l = cfg.top_k, cfg.num_experts // par.ep
        r = self.route(x)
        cap = r.capacity
        # every (token, choice) token-major; those of other ranks'
        # experts and the dropped ones go to a spare slot past the end
        local = r.expert - par.ep_rank * e_l
        mine = r.kept & (local >= 0) & (local < e_l)
        slot = torch.where(mine, local * cap + r.position,
                           e_l * cap).reshape(-1)
        # each ep rank runs its own experts and each tp rank its share of
        # F: the input's gradient sums over both, the gates' over ep
        ep, tp = (par.ep, par.ep_group), (par.tp, par.tp_group)
        xt = _whole_grad(x.reshape(-1, d), ep, tp)
        buf = xt.new_zeros(e_l * cap + 1, d).index_put(
            (slot,), xt.repeat_interleave(k, dim=0))
        out = self.experts(buf[:-1].view(e_l, cap, d)).reshape(-1, d)
        out = torch.cat([out, out.new_zeros(1, d)])
        gates = torch.where(mine, _whole_grad(r.gates, ep), 0.0)
        # index_select, whose backward adds rows by index: every real slot
        # receives one row and the spare only zeros, so in any order the
        # sums are the same (indexing's backward sorts the indices and
        # adds the spare slot's run serially)
        y = (out.index_select(0, slot).float()
             * gates.reshape(-1, 1).to(cfg.dtype).float()
             ).view(-1, k, d).sum(1)
        if par.ep > 1:
            y = _SumOver.apply(y, par.ep_group)
        return y.to(cfg.dtype).view(bsz, seq, d), self._aux(r)

    def _aux(self, r: Routing) -> torch.Tensor:
        # mean(probs) over the global batch: the data ranks' sums, whose
        # gradient reaches each rank's own tokens only
        psum = r.probs.sum(0)
        if self.data is not None:
            psum = _SumOver.apply(psum, self.data.group)
        aux = self.cfg.num_experts * (r.top1 * psum / r.tokens).sum()
        return self.cfg.router_aux_weight * aux


def moe_mlp_reference(mlp: MoEMLP, x: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``MoEMLP.forward`` on one rank: the JAX
    module's one-hot [T, E, C] dispatch and combine tensors and its
    einsums, on ``mlp``'s parameters (no mesh).  For the tests; O(T E C)
    memory."""
    cfg = mlp.cfg
    if mlp.par != Parallel() or mlp.data is not None:
        raise ValueError("moe_mlp_reference runs without a mesh")
    bsz, seq, d = x.shape
    dtype = cfg.dtype
    r = mlp.route(x)
    tokens, k, num_e = bsz * seq, cfg.top_k, cfg.num_experts
    flat = F.one_hot(r.expert.reshape(-1), num_e).float()      # [T*k, E]
    pos = F.one_hot(r.position.reshape(-1).clamp(max=r.capacity - 1),
                    r.capacity).float() * r.kept.reshape(-1, 1)
    dispatch = (flat[:, :, None] * pos[:, None, :]).view(
        tokens, k, num_e, r.capacity)
    combine = (dispatch * r.gates.view(tokens, k, 1, 1)).sum(1)
    dispatch = dispatch.sum(1)
    xt = x.reshape(tokens, d)

    def product(eq, a, b):
        # an einsum in the activation dtype with an fp32 result, rounded
        return torch.einsum(eq, a.float(), b.float()).to(dtype)

    w = mlp.experts
    expert_in = product("tec,td->ecd", dispatch.to(dtype), xt.to(dtype))
    h = F.silu(product("ecd,edf->ecf", expert_in, w.w_gate.to(dtype)))
    h = h * product("ecd,edf->ecf", expert_in, w.w_up.to(dtype))
    expert_out = product("ecf,efd->ecd", h, w.w_down.to(dtype))
    y = product("tec,ecd->td", combine.to(dtype), expert_out)
    return y.view(bsz, seq, d), mlp._aux(r)


class MoEBlock(nn.Module):
    """One layer: attention, then the routed experts.  forward(x, rope)
    -> (x, the layer's aux term).  With ``remat`` the body is one
    checkpoint region under grad with no policy (everything recomputed),
    taken inside the module's call so hooks on the module (FSDP2's) stay
    outside it."""

    def __init__(self, cfg: MoEConfig, device=None, par: Parallel = Parallel(),
                 data: DataRanks | None = None, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.attn = Attention(cfg, device, par)
        self.moe_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device)
        self.moe = MoEMLP(cfg, device, par, data)

    def _body(self, x, rope):
        x = x + self.attn(self.attn_norm(x), rope)
        y, aux = self.moe(self.moe_norm(x))
        return x + y, aux

    def forward(self, x: torch.Tensor,
                rope: tuple[torch.Tensor, torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._body, x, rope, use_reentrant=False)
        return self._body(x, rope)


class MoELlama(nn.Module):
    """Decoder-only MoE LM with the Llama contract: forward(tokens) ->
    fp32 logits, forward(tokens, targets) -> the next-token loss (xent
    only; ``moe_loss`` adds the router terms).  Parameters are created
    empty on ``device`` (``cuda`` when None); fill them with
    ``init_moe_params`` or ``convert.moe_params_from_jax`` (through
    ``tp_slice`` and ``ep_slice`` over a mesh)."""

    def __init__(self, cfg: MoEConfig, device: str | torch.device | None = None,
                 mesh=None):
        super().__init__()
        par = Parallel.of(mesh)
        _check_parallel(cfg, par, mesh)
        if not 1 <= cfg.top_k <= cfg.num_experts:
            raise ValueError(f"top_k={cfg.top_k} of {cfg.num_experts} "
                             f"experts")
        if cfg.num_experts % par.ep:
            raise ValueError(f"num_experts={cfg.num_experts} does not "
                             f"divide over ep={par.ep}")
        dev = resolve_device(device)
        self.cfg, self.par = cfg, par
        data = DataRanks.of(mesh)
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.hidden_size, dtype=cfg.param_dtype,
            device=dev))
        self.layers = nn.ModuleList(
            MoEBlock(cfg, dev, par, data, cfg.remat)
            for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, dev)

    def _trunk(self, tokens: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg, par = self.cfg, self.par
        x = self.embed[tokens].to(cfg.dtype)
        seq = tokens.shape[1]
        positions = torch.arange(
            par.sp_rank * seq, (par.sp_rank + 1) * seq, dtype=torch.int32,
            device=tokens.device)[None].expand(tokens.shape)
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        aux = []
        for layer in self.layers:
            x, a = layer(x, rope)
            aux.append(a)
        return self.final_norm(x), torch.stack(aux)

    def loss_terms(self, tokens: torch.Tensor, targets: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(the next-token loss of ``targets``, each layer's aux term
        [num_layers]).  Over a mesh the loss is this rank's row block's
        (summed over sp) and the aux terms are the global batch's."""
        x, aux = self._trunk(tokens)
        return _chunked_xent(x, self.embed, targets, self.cfg.loss_chunk,
                             self.cfg.dtype, self.par), aux

    def forward(self, tokens: torch.Tensor,
                targets: torch.Tensor | None = None) -> torch.Tensor:
        if targets is not None:
            return self.loss_terms(tokens, targets)[0]
        x, _ = self._trunk(tokens)
        return tied_logits(x, self.embed.to(self.cfg.dtype))


def moe_loss(model: MoELlama, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token loss of ``tokens`` plus the layers' router terms (the
    JAX function's sum of the sown "losses" collection)."""
    xent, aux = model.loss_terms(tokens, tokens)
    return xent + aux.sum()


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device: str | torch.device | None = None
                    ) -> dict[str, torch.Tensor]:
    """A seeded ``state_dict`` for ``MoELlama(cfg)`` with flax's
    initializer distributions, as ``llama.init_params``: embed
    normal(0.02), the router [E, D] lecun-normal in fp32, the stacked
    experts lecun-normal with flax's fan-in for a 3-D kernel (the leading
    expert dim counts as receptive field: E D for w_gate and w_up, E F
    for w_down), norm scales ones.  The bits do not match flax's."""
    draws = Draws(generator, resolve_device(device))
    e, f, pd = cfg.hidden_size, cfg.intermediate_size, cfg.param_dtype
    num_e = cfg.num_experts
    sd = {"embed": draws.normal((cfg.vocab_size, e), 0.02, pd)}
    for n in range(cfg.num_layers):
        p = f"layers.{n}."
        init_attention(sd, p, cfg, draws)
        sd[p + "moe_norm.scale"] = draws.ones(e)
        sd[p + "moe.router.weight"] = draws.lecun((num_e, e), e,
                                                  torch.float32)
        for name in ("w_gate", "w_up"):
            sd[p + f"moe.experts.{name}"] = draws.lecun(
                (num_e, e, f), num_e * e, pd)
        sd[p + "moe.experts.w_down"] = draws.lecun((num_e, f, e),
                                                   num_e * f, pd)
    sd["final_norm.scale"] = draws.ones(e)
    return sd


# -- expert-parallel training --------------------------------------------------

@dataclasses.dataclass
class EPState:
    """``make_ep_trainer``'s state: the sharded model (its parameters),
    the optimizer (the Adam moments) and the count of steps taken."""

    model: MoELlama
    optimizer: torch.optim.Optimizer
    mesh: DeviceMesh
    step: int = 0

    def full(self, grads: bool = False) -> dict[str, torch.Tensor]:
        """The whole model's parameters (or, with ``grads``, the last
        step's gradients of the global loss), gathered over FSDP, tp and
        ep, on the CPU of every rank (the layout of ``init_moe_params``)."""
        spec = mesh_spec(self.mesh)
        out = {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                t = p.grad if grads else p
                t = t.full_tensor() if isinstance(t, DTensor) else t
                for axis, dim in (("tp", tp_dim(name)),
                                  ("ep", 0 if is_expert(name) else None)):
                    if dim is not None and getattr(spec, axis) > 1:
                        parts = [torch.empty_like(t)
                                 for _ in range(getattr(spec, axis))]
                        dist.all_gather(parts, t.contiguous(),
                                        group=self.mesh.get_group(axis))
                        t = torch.cat(parts, dim=dim)
                out[name] = t.cpu()
        return out


def _expert_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The mesh FSDP2 shards the experts over for this rank's (tp, ep)
    coordinate: dp replicates, (fsdp, sp) shard.  Not ep: each ep rank
    holds other experts, whose gradients must not be averaged."""
    spec = mesh_spec(mesh)
    ranks = mesh.mesh.permute(0, 1, 3, 2, 4).reshape(
        spec.dp, spec.fsdp * spec.sp, spec.tp * spec.ep)
    flat = DeviceMesh(mesh.device_type, ranks,
                      mesh_dim_names=("replicate", "shard", "model"))
    return flat["replicate", "shard"] if spec.dp > 1 else flat["shard"]


def make_ep_trainer(model_or_cfg: MoELlama | MoEConfig, mesh: DeviceMesh,
                    example_tokens, device: str | torch.device = "cuda",
                    params: dict[str, torch.Tensor] | None = None
                    ) -> tuple[EPState, Callable]:
    """Sharded init and train step for an MoE model over a mesh with an
    ``ep`` axis (``parallel.mesh.make_mesh``; every rank calls it).

    ``params`` is a full ``state_dict`` (``init_moe_params`` from a
    generator seeded 1 when None, as JAX inits from PRNGKey(1)); each
    rank keeps its tp and ep share, and FSDP2 shards the rest per block
    and at the root over (fsdp, sp, ep) and the experts over (fsdp, sp),
    dp replicating.  The optimizer is optax ``adam(1e-3)``: no clip, no
    decay, a constant rate.  Returns (state, step) with
    ``step(state, tokens) -> (state, loss)``: ``tokens`` is the global
    [B, S] batch like ``example_tokens`` (the rank takes its block,
    ``local_block``), the loss is ``moe_loss`` of the global batch, the
    same on every rank, and the state is updated in place."""
    cfg = model_or_cfg.cfg if isinstance(model_or_cfg, MoELlama) \
        else model_or_cfg
    dev = resolve_device(device)
    spec = mesh_spec(mesh)
    local_block(np.asarray(example_tokens), mesh)   # raises if it won't split
    if params is None:
        params = init_moe_params(
            cfg, torch.Generator(device=dev).manual_seed(1), dev)
    model = MoELlama(cfg, dev, mesh)
    model.load_state_dict({k: v.to(dev) for k, v in ep_slice(
        tp_slice(params, spec.tp, mesh["tp"].get_local_rank()), spec.ep,
        mesh["ep"].get_local_rank()).items()}, assign=True)
    fsdp_mesh, expert_mesh = _fsdp_mesh(mesh), _expert_mesh(mesh)
    for layer in model.layers:
        fully_shard(layer.moe.experts, mesh=expert_mesh)
        fully_shard(layer, mesh=fsdp_mesh)
    fully_shard(model, mesh=fsdp_mesh)
    # the step calls loss_terms, not forward: FSDP2's root hooks must run
    register_fsdp_forward_method(model, "loss_terms")
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8)
    state = EPState(model, optimizer, mesh)
    data_ranks = spec.dp * spec.fsdp * spec.sp

    def step(state: EPState, tokens) -> tuple[EPState, torch.Tensor]:
        # as ShardedTrainer's step: after a forward without grad FSDP2's
        # root parameters are left unsharded, which corrupts the next
        # backward's root gradients
        state.model.reshard()
        for p in state.model.parameters():
            p.grad = None
        block = _on_device(local_block(np.asarray(tokens), mesh), dev)
        xent, aux = state.model.loss_terms(block, block)
        aux = aux.sum()
        # FSDP2 averages each gradient over the data ranks (ep copies of
        # a replicated parameter are equal).  The xent is this row
        # block's, summed over sp by an all-reduce with an identity
        # backward, so its shares take sp; the aux term is the global
        # batch's, each rank's gradient its own tokens' share, so it
        # takes every data rank.
        (xent * spec.sp + aux * data_ranks).backward()
        state.optimizer.step()
        state.step += 1
        loss = xent.detach().clone()
        for axis in ("fsdp", "dp"):
            if mesh[axis].size() > 1:
                dist.all_reduce(loss, group=mesh.get_group(axis))
        return state, loss / (spec.dp * spec.fsdp) + aux.detach()

    return state, step
