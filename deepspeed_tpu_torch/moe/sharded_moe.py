"""Top-k gating and expert dispatch at one device.

Port of ``deepspeed_tpu/moe/sharded_moe.py``: the GShard formulation, in
which one-hot dispatch and combine tensors (N, E, C) are contracted with the
token batch. Expert parallelism lives in the layer (``layer.py``): it
slices the experts out of the dispatch tensor and all-gathers their
outputs, since every rank of an expert group holds the same tokens (no
all-to-all exchanges tokens that differ across ranks).

Random draws take an explicit ``torch.Generator``: the RSample gate noise of
``top1gating`` and ``multiplicative_jitter``. They give other numbers than
``jax.random`` from the same seed.

Two behaviours of the reference that PyTorch does not give by default:
- ``jax.nn.one_hot`` gives a zero row for an index outside [0, n), and
  ``top1gating`` relies on it for a dropped token's position;
  ``torch.nn.functional.one_hot`` raises, so ``_one_hot`` compares with an
  ``arange``.
- ``lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` promises no order, so ``top_k`` takes a stable sort.
"""

import math
from typing import Optional, Tuple

import torch


def multiplicative_jitter(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                          epsilon: float = 1e-2) -> torch.Tensor:
    """Multiply by U(1 - eps, 1 + eps) drawn from ``generator`` (none: x as it is)."""
    if epsilon == 0 or generator is None:
        return x
    noise = torch.empty_like(x).uniform_(1.0 - epsilon, 1.0 + epsilon, generator=generator)
    return x * noise


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float, min_capacity: int, k: int) -> int:
    cap = int(math.ceil(k * num_tokens / num_experts * capacity_factor))
    return max(cap, min_capacity)


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a row of zeros."""
    return (idx.long()[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest values in descending
    order, the lower index first among equal values."""
    idx = torch.argsort(x.neg(), dim=-1, stable=True)[..., :k]
    return x.gather(-1, idx), idx


def top1gating(logits: torch.Tensor, capacity_factor: float, min_capacity: int,
               generator: Optional[torch.Generator] = None, noisy_gate_policy: Optional[str] = None,
               drop_tokens: bool = True, used_token_mask: Optional[torch.Tensor] = None):
    """Top-1 (Switch) gating. logits (N, E). Returns (l_aux, combine (N, E, C)
    in the logits' type, dispatch (N, E, C) bool, exp_counts (E,) float)."""
    N, E = logits.shape
    # no drop must hold the worst case, every token on one expert
    C = _capacity(N, E, capacity_factor, min_capacity, k=1) if drop_tokens else N
    if noisy_gate_policy == "RSample" and generator is not None:
        noise = torch.empty_like(logits).normal_(generator=generator)
        logits_w_noise = logits + noise
    else:
        logits_w_noise = logits
    gates = torch.softmax(logits, dim=-1)
    expert_idx = torch.argmax(logits_w_noise, dim=-1)  # (N,), the first maximum, as jnp.argmax
    mask1 = _one_hot(expert_idx, E)
    if used_token_mask is not None:
        mask1 = mask1 * used_token_mask[:, None]

    # load-balancing loss (Switch): E * sum_e mean_prob_e * frac_tokens_e
    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    l_aux = torch.sum(me * ce) * E

    positions = torch.cumsum(mask1, dim=0) - mask1  # rank among the tokens routed to e
    pos_in_expert = torch.sum(positions * mask1, dim=-1)
    if drop_tokens:
        mask1 = mask1 * (pos_in_expert < C)[:, None]
    exp_counts = torch.sum(mask1, dim=0)

    gate_val = torch.sum(gates * mask1, dim=-1)
    pos_oh = _one_hot(pos_in_expert.to(torch.int32), C)  # a dropped token's position >= C: a zero row
    dispatch = mask1[:, :, None] * pos_oh[:, None, :]
    combine = dispatch * gate_val[:, None, None]
    return l_aux, combine, dispatch.bool(), exp_counts


def topkgating(logits: torch.Tensor, k: int, capacity_factor: float, min_capacity: int,
               generator: Optional[torch.Generator] = None, drop_tokens: bool = True,
               normalize_weights: bool = True):
    """General top-k gating (k = 2 is GShard's top-2). logits (N, E). Returns
    (l_aux, combine (N, E, C), dispatch (N, E, C) bool, exp_counts (E,) int32).
    ``generator`` is accepted for the reference's signature; nothing is drawn."""
    N, E = logits.shape
    # no drop: room for every token per expert, or the clip at C - 1 would sum overflow tokens into one slot
    C = _capacity(N, E, capacity_factor, min_capacity, k) if drop_tokens else N
    gates = torch.softmax(logits, dim=-1)

    topk_vals, topk_idx = top_k(gates, k)
    if normalize_weights:
        topk_vals = topk_vals / torch.clamp_min(torch.sum(topk_vals, dim=-1, keepdim=True), 1e-9)

    # aux loss over the first choice only, as the reference
    mask1 = _one_hot(topk_idx[:, 0], E)
    me = torch.mean(gates, dim=0)
    ce = torch.mean(mask1, dim=0)
    l_aux = torch.sum(me * ce) * E

    combine = torch.zeros((N, E, C), dtype=gates.dtype, device=logits.device)
    dispatch = torch.zeros((N, E, C), dtype=torch.bool, device=logits.device)
    # choices fill capacity in priority order: choice 0 first, the occupancy carries over
    occupancy = torch.zeros((E,), dtype=torch.int32, device=logits.device)
    for j in range(k):
        mask_j = _one_hot(topk_idx[:, j], E)
        pos_j = occupancy[None, :] + torch.cumsum(mask_j, dim=0) - mask_j
        pos_in_expert = torch.sum(pos_j * mask_j, dim=-1)
        if drop_tokens:
            mask_j = mask_j * (pos_in_expert < C)[:, None]
        pos_oh = _one_hot(torch.clamp(pos_in_expert, 0, C - 1).to(torch.int32), C)
        disp_j = mask_j[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch | disp_j.bool()
        combine = combine + disp_j * topk_vals[:, j][:, None, None]
        occupancy = occupancy + torch.sum(mask_j, dim=0).to(torch.int32)
    return l_aux, combine, dispatch, occupancy


def gate_and_dispatch(x: torch.Tensor, gate_logits: torch.Tensor, k: int, capacity_factor: float,
                      min_capacity: int, generator: Optional[torch.Generator] = None, noisy_gate_policy=None,
                      drop_tokens: bool = True):
    """x (N, d), gate_logits (N, E) -> (l_aux, dispatched (E, C, d), combine (N, E, C), exp_counts)."""
    if k == 1:
        l_aux, combine, dispatch, exp_counts = top1gating(gate_logits, capacity_factor, min_capacity, generator,
                                                          noisy_gate_policy, drop_tokens)
    else:
        l_aux, combine, dispatch, exp_counts = topkgating(gate_logits, k, capacity_factor, min_capacity, generator,
                                                          drop_tokens)
    dispatched = torch.einsum("nec,nd->ecd", dispatch.to(x.dtype), x)
    return l_aux, dispatched, combine, exp_counts


def combine_output(expert_out: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """expert_out (E, C, d), combine (N, E, C) -> (N, d)."""
    return torch.einsum("nec,ecd->nd", combine.to(expert_out.dtype), expert_out)
