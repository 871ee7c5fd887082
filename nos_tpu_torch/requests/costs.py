"""Prefill/decode cost split from the card's published peaks,
``nos_tpu/requests/costs.py`` for the port: the same formulas, priced on
an NVIDIA card.

The continuous-batching replica model needs per-request service times
with the one asymmetry that makes LLM serving hard: **prefill is
compute-bound, decode is memory-bound**.  Both are priced from ONE
table, ``ops/roofline.py``'s ``peaks_for`` (bf16 FLOP/s and HBM bytes/s
by card name), the table the kernels' bounds come from; a card it does
not know raises, so a TPU ``device_kind`` such as ``"v5e"`` fails the
config load instead of being priced as some other card:

- **prefill**: a P-token prompt costs ~``2 * params`` FLOPs a token
  (forward only: ``roofline.model_flops_per_step``'s matmul inventory
  without its 3x backward), so ``prefill_seconds = P * flops_per_token
  / (peak * compute_share * mfu)``;
- **decode**: one continuous-batching step reads the weights once and
  every resident KV entry and emits one token for every active request:
  ``(weights + kv_bytes) / (bandwidth * memory_share * efficiency)``,
  near constant in the batch, which is why batching decodes pays;
- **KV capacity**: the replica's GB left after the weights over the
  per-token KV footprint (2 tensors x layers x kv_heads x head_dim x
  dtype bytes).  Occupancy of it is the replica's load signal
  (``router.py`` publishes it as ANNOT_SERVING_LOAD).

A replica's size on an H100.  The JAX package's replica is ``chips``
TPU chips of ``hbm_gb`` each.  On the card a replica is one GPU or a
part of one, so the keys read:

- ``device_kind``: the card's name as ``torch.cuda.get_device_name``
  gives it ("NVIDIA H100 80GB HBM3"), looked up in ``peaks_for``;
- ``mig_profile``: "" for an MPS share, which time-shares the whole GPU
  (the whole peak and bandwidth); else the MIG instance the replica
  runs in ("1g.20gb", ...), which has g/7 of the compute (its compute
  slices over the card's) and its memory slots' share of the bandwidth
  (slots over the card's 8), from ``topology/known.py``'s table;
- ``hbm_gb``: the share's GB (the MPS grant's cap), or the instance's
  GB, which must be the profile's;
- ``chips``: kept so that a JAX config names the same key; a replica is
  one GPU or less, so only 1 has a meaning here and any other value is
  refused.

Everything here is a pure function of its arguments (no clocks, no
randomness), so replica timing is a deterministic function of the
request stream.
"""

from __future__ import annotations

import dataclasses
import functools

from nos_tpu_torch.ops.roofline import _PEAKS, peaks_for
from nos_tpu_torch.topology.known import DEFAULT_REGISTRY

#: The default card: an H100 SXM's name, as ``torch.cuda.get_device_name``
#: gives it.
DEFAULT_DEVICE_KIND = "NVIDIA H100 80GB HBM3"


def hbm_bandwidth_for(device_kind: str) -> float:
    """Nominal HBM bytes/s of a card, from ``roofline.peaks_for``;
    raises ValueError for a card not in that table."""
    return peaks_for(device_kind)[1]


#: HBM bytes/s by card-name needle, derived from ``roofline``'s table
#: (never typed in again), as the JAX package's ``HBM_BYTES_PER_S``.
HBM_BYTES_PER_S = {needle: bandwidth for needle, _, bandwidth in _PEAKS}


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Decode-relevant model shape (duck-typed like LlamaConfig in
    ``roofline.model_flops_per_step``).  The fields are exactly what
    prices a request: the matmul inventory for prefill FLOPs, the KV
    geometry for decode bytes, and the resident weight footprint."""

    name: str
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    vocab_size: int = 32_000
    weights_gb: float = 8.0
    kv_dtype_bytes: int = 2     # bf16 KV cache

    def __post_init__(self) -> None:
        if min(self.num_layers, self.num_heads, self.num_kv_heads,
               self.head_dim, self.intermediate_size) <= 0:
            raise ValueError(f"profile {self.name}: dims must be > 0")
        if self.weights_gb <= 0 or self.kv_dtype_bytes <= 0:
            raise ValueError(
                f"profile {self.name}: weights_gb and kv_dtype_bytes "
                f"must be > 0")

    @property
    def hidden_size(self) -> int:
        return self.num_heads * self.head_dim

    def kv_bytes_per_token(self) -> int:
        """Resident KV footprint of ONE cached token: K and V, every
        layer, every kv head."""
        return (2 * self.num_layers * self.num_kv_heads * self.head_dim
                * self.kv_dtype_bytes)

    def flops_per_token(self) -> float:
        """Forward-only FLOPs to process one token: 2 FLOPs per matmul
        parameter (attention scores are second-order at serving's prompt
        lengths and are priced into ``mfu``)."""
        h = self.hidden_size
        per_layer_mm = (
            h * self.num_heads * self.head_dim                    # q
            + 2 * h * self.num_kv_heads * self.head_dim           # k, v
            + self.num_heads * self.head_dim * h                  # o
            + 3 * h * self.intermediate_size                      # mlp
        )
        n_mm = self.num_layers * per_layer_mm + self.vocab_size * h
        return 2.0 * n_mm


@functools.lru_cache(maxsize=64)
def _shares(device_kind: str, mig_profile: str) -> tuple[float, float]:
    """(compute share, memory share) of one replica on ``device_kind``:
    (1, 1) for an MPS share; a MIG instance's compute slices over the
    card's and memory slots over the card's."""
    if not mig_profile:
        return 1.0, 1.0
    model = DEFAULT_REGISTRY.match(device_kind)
    if model is None:
        raise ValueError(f"no MIG table for {device_kind!r}")
    profile = model.profile(mig_profile)
    if profile is None:
        raise ValueError(f"{mig_profile!r} is not a MIG profile of "
                         f"{model.name}: {model.profile_names()}")
    return (profile.compute_slices / model.compute_slices,
            profile.memory_slices / model.memory_slices)


@dataclasses.dataclass(frozen=True)
class RequestCostModel:
    """Prices one replica's work (module docstring).  A disaggregated
    prefill pool's cost model names a larger MIG instance (more compute)
    than its decode pool's, with the same model profile."""

    profile: ModelProfile
    device_kind: str = DEFAULT_DEVICE_KIND
    chips: int = 1
    hbm_gb: float = 80.0
    mfu: float = 0.4            # achieved fraction of peak in prefill
    hbm_efficiency: float = 0.8  # achieved fraction of peak bandwidth
    mig_profile: str = ""

    def __post_init__(self) -> None:
        if self.chips != 1:
            raise ValueError(
                f"chips {self.chips!r}: a replica on an NVIDIA card is one "
                f"GPU or part of one (mig_profile), so chips must be 1")
        # raises for a card the roofline table does not know, "v5e" too
        peaks_for(self.device_kind)
        _shares(self.device_kind, self.mig_profile)
        if not 0.0 < self.mfu <= 1.0:
            raise ValueError("mfu must be in (0, 1]")
        if not 0.0 < self.hbm_efficiency <= 1.0:
            raise ValueError("hbm_efficiency must be in (0, 1]")
        if self.mig_profile:
            gb = DEFAULT_REGISTRY.match(self.device_kind).profile(
                self.mig_profile).memory_gb
            if self.hbm_gb != gb:
                raise ValueError(
                    f"hbm_gb {self.hbm_gb} is not {self.mig_profile}'s "
                    f"{gb} GB")
        else:
            model = DEFAULT_REGISTRY.match(self.device_kind)
            if model is not None and not 0 < self.hbm_gb <= model.memory_gb:
                raise ValueError(
                    f"hbm_gb {self.hbm_gb}: an MPS share is at most the "
                    f"card's {model.memory_gb} GB")
        if self.hbm_gb <= self.profile.weights_gb:
            raise ValueError(
                f"{self.profile.name}: weights ({self.profile.weights_gb}"
                f" GB) leave no KV room in {self.hbm_gb} GB")

    def peak_flops(self) -> float:
        """The replica's bf16 FLOP/s at full use: the card's peak times
        its compute share."""
        return peaks_for(self.device_kind)[0] * _shares(
            self.device_kind, self.mig_profile)[0]

    def bandwidth(self) -> float:
        """The replica's HBM bytes/s at full use: the card's times its
        memory share."""
        return hbm_bandwidth_for(self.device_kind) * _shares(
            self.device_kind, self.mig_profile)[1]

    def prefill_seconds(self, prompt_tokens: int) -> float:
        """Compute-bound prompt processing time."""
        flops = prompt_tokens * self.profile.flops_per_token()
        peak = self.peak_flops() * self.chips * self.mfu
        return flops / peak

    def decode_step_seconds(self, resident_kv_tokens: int) -> float:
        """One continuous-batching decode step (one token for EVERY
        active request): full weights pass + resident KV read,
        memory-bound."""
        bytes_read = (self.profile.weights_gb * 2**30
                      + resident_kv_tokens
                      * self.profile.kv_bytes_per_token())
        bw = self.bandwidth() * self.chips * self.hbm_efficiency
        return bytes_read / bw

    def kv_capacity_tokens(self) -> int:
        """KV slots in the GB left after weights."""
        free = (self.hbm_gb * self.chips - self.profile.weights_gb) \
            * 2**30
        return int(free // self.profile.kv_bytes_per_token())
