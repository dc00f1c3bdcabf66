"""The MoE layer at one device, as functions over the flax-layout parameters.

Port of ``deepspeed_tpu/moe/layer.py`` (``Experts`` and ``MoE``). The
parameters keep the reference's keys and layouts, so weights convert by copy
(``models.convert.params_from_numpy``):

- ``gate/kernel`` (d, E): the fp32 gate;
- ``experts/wi`` and, for swiglu, ``experts/wg`` (E, d, f); ``experts/wo``
  (E, f, d): the stacked experts;
- with ``use_residual`` (Residual MoE): ``residual_mlp_in/kernel`` (d, f),
  ``residual_mlp/kernel`` (f, d) and ``coefficient/kernel`` (d, 2).

``MoE.__call__`` returns ``(out, l_aux, exp_counts)``: the load-balancing
loss and the per-expert token counts that the reference sows into the
``losses`` and ``intermediates`` collections go back to the caller.

Under the training engine (``expert_parallel``, which it enters around its
forward) the layer computes what the JAX layer computes in GSPMD's global
view (``layer.py:94-99``). The gate routes the tokens of the whole
data-parallel batch: each rank all-gathers its rows over the data x fsdp
group (``_GatherRows``; the backward reduce-scatters the gradient), so
capacity, drops, ``l_aux`` and ``exp_counts`` are the global batch's. With
the mesh's ``expert`` axis at ep > 1 the expert leaves hold E / ep experts
(``MOE_PARTITION_RULES``): a rank takes its experts' slice of the
``(E, C, d)`` dispatch tensor (``_ExpertSlice``; backward: the slices'
gradients all-gathered over the expert group, so every rank holds the
token gradients of all experts), runs its experts, and all-gathers their
outputs over the group (``_ExpertGather``; backward: its slice) before the
combine, which then contracts over every expert on every rank as the one
device does. Each rank keeps its own rows of the combine. Every rank of an
expert group sees the same rows, so the gate's noise (RSample) must come
from generators seeded alike on those ranks. The expert-TP token mappings
are in ``moe/mappings.py``; the reference's informational ``ep_size`` field
is not ported.
"""

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import comm as dist
from .sharded_moe import combine_output, gate_and_dispatch

# the experts' dimension over ``expert``, the FFN dimension over ``tensor`` (JAX ``moe/layer.py:132-136``); the
# training planner prunes ``tensor`` at size 1 (``runtime/zero/partition.py``)
MOE_PARTITION_RULES = [
    (("experts", "wi"), ("expert", None, "tensor")),
    (("experts", "wo"), ("expert", "tensor", None)),
    (("experts", "wg"), ("expert", None, "tensor")),
    (("gate", "kernel"), (None, None)),
]


@dataclass(frozen=True)
class ExpertParallel:
    """The groups an MoE layer runs over inside the training engine: the
    expert group (``ep`` ranks, this one ``ep_rank``) and the data-parallel
    group whose rows the gate routes together (``dp`` ranks, this one
    ``dp_rank``). A group is a ``torch.distributed`` process group (``None``:
    the world)."""
    ep: int = 1
    ep_rank: int = 0
    ep_group: Any = None
    dp: int = 1
    dp_rank: int = 0
    dp_group: Any = None


_PARALLEL: Optional[ExpertParallel] = None


@contextlib.contextmanager
def expert_parallel(groups: Optional[ExpertParallel]):
    """MoE layers called inside run over ``groups`` (``None``: one device)."""
    global _PARALLEL
    prev, _PARALLEL = _PARALLEL, groups
    try:
        yield
    finally:
        _PARALLEL = prev


def _all_gather_dim0(x: torch.Tensor, n: int, group) -> torch.Tensor:
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """Forward: every rank's rows, in rank order. Backward: each rank's rows
    of the gradients summed over the group (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, n, group):
        ctx.n, ctx.group = n, group
        return _all_gather_dim0(x, n, group)

    @staticmethod
    def backward(ctx, g):
        out = torch.empty((g.shape[0] // ctx.n,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None, None


class _ExpertSlice(torch.autograd.Function):
    """Forward: this rank's experts of the dispatch tensor. Backward: the
    group's slices of the gradient all-gathered, whole on every rank."""

    @staticmethod
    def forward(ctx, x, n, rank, group):
        ctx.n, ctx.group = n, group
        e = x.shape[0] // n
        return x[rank * e:(rank + 1) * e]

    @staticmethod
    def backward(ctx, g):
        return _all_gather_dim0(g, ctx.n, ctx.group), None, None, None


class _ExpertGather(torch.autograd.Function):
    """Forward: every rank's experts' outputs, all-gathered. Backward: this
    rank's experts' slice of the gradient, which every rank of the group
    holds whole and alike."""

    @staticmethod
    def forward(ctx, x, n, rank, group):
        ctx.rank, ctx.e = rank, x.shape[0]
        return _all_gather_dim0(x, n, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.e:(ctx.rank + 1) * ctx.e], None, None, None


def _activate(h: torch.Tensor, activation: str) -> torch.Tensor:
    """The experts' non-gated activations: relu, or GELU (tanh unless ``gelu_exact``)."""
    if activation == "relu":
        return F.relu(h)
    return F.gelu(h, approximate="none" if activation == "gelu_exact" else "tanh")


@dataclass(frozen=True)
class Experts:
    """E feed-forward experts over stacked weights, as batched einsums."""
    num_experts: int
    d_model: int
    d_ff: int
    activation: str = "gelu"
    dtype: Any = torch.float32

    def param_shapes(self) -> Dict[str, Any]:
        """``(shape, init)`` leaves; every expert weight is normal(0.02)."""
        E, d, f = self.num_experts, self.d_model, self.d_ff
        out = {"wi": ((E, d, f), "normal"), "wo": ((E, f, d), "normal")}
        if self.activation == "swiglu":
            out["wg"] = ((E, d, f), "normal")
        return out

    def __call__(self, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """x (E, C, d) -> (E, C, d)."""
        dt = self.dtype
        x = x.to(dt)
        h = torch.einsum("ecd,edf->ecf", x, p["wi"].to(dt))
        if self.activation == "swiglu":
            h = F.silu(torch.einsum("ecd,edf->ecf", x, p["wg"].to(dt))) * h
        else:
            h = _activate(h, self.activation)
        return torch.einsum("ecf,efd->ecd", h, p["wo"].to(dt))


@dataclass(frozen=True)
class MoE:
    """A gated expert FFN that takes an MLP's slot: input (..., d), output
    the same shape. Capacity drops tokens only when ``train`` and
    ``drop_tokens``; the noisy gate (``noisy_gate_policy="RSample"``) only
    when training with a generator."""
    hidden_size: int
    num_experts: int = 8
    k: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_residual: bool = False
    d_ff: Optional[int] = None
    activation: str = "gelu"
    dtype: Any = torch.float32

    @property
    def ffn_dim(self) -> int:
        return self.d_ff or 4 * self.hidden_size

    @property
    def experts(self) -> Experts:
        return Experts(self.num_experts, self.hidden_size, self.ffn_dim, self.activation, self.dtype)

    def param_shapes(self) -> Dict[str, Any]:
        """``(shape, init)`` leaves under the reference's keys: the dense
        kernels lecun-normal over their input dim, the experts normal(0.02)."""
        d, f = self.hidden_size, self.ffn_dim
        out: Dict[str, Any] = {"gate": {"kernel": ((d, self.num_experts), ("kernel", d))},
                               "experts": self.experts.param_shapes()}
        if self.use_residual:
            out["residual_mlp_in"] = {"kernel": ((d, f), ("kernel", d))}
            out["residual_mlp"] = {"kernel": ((f, d), ("kernel", f))}
            out["coefficient"] = {"kernel": ((d, 2), ("kernel", d))}
        return out

    def __call__(self, p: Dict[str, Any], x: torch.Tensor, train: bool = True,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns ``(out, l_aux, exp_counts)``; ``generator`` draws the RSample noise."""
        orig_shape = x.shape
        d = orig_shape[-1]
        if d != self.hidden_size:
            raise ValueError(f"MoE: input width {d} != hidden_size {self.hidden_size}")
        par = _PARALLEL or ExpertParallel()
        local_e = p["experts"]["wi"].shape[0]
        if local_e * par.ep != self.num_experts:
            raise ValueError(f"MoE: {local_e} experts held on each of {par.ep} expert ranks, the layer has "
                             f"{self.num_experts}")
        tokens = x.reshape(-1, d)
        n_own = tokens.shape[0]
        if par.dp > 1:  # the gate routes the whole data-parallel batch, as the JAX layer's global view
            tokens = _GatherRows.apply(tokens, par.dp, par.dp_group)
        gate_logits = tokens.float() @ p["gate"]["kernel"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        # inference never drops a token: capacity is a training regulariser
        l_aux, dispatched, combine, exp_counts = gate_and_dispatch(
            tokens, gate_logits, self.k, cf, self.min_capacity, generator=generator,
            noisy_gate_policy=self.noisy_gate_policy if train else None, drop_tokens=self.drop_tokens and train)
        if par.ep > 1:
            dispatched = _ExpertSlice.apply(dispatched, par.ep, par.ep_rank, par.ep_group)
        expert_out = self.experts(p["experts"], dispatched)
        if par.ep > 1:
            expert_out = _ExpertGather.apply(expert_out, par.ep, par.ep_rank, par.ep_group)
        if par.dp > 1:
            combine = combine[par.dp_rank * n_own:(par.dp_rank + 1) * n_own]
        out = combine_output(expert_out, combine).reshape(orig_shape).to(x.dtype)
        if self.use_residual:
            # Residual MoE: mix with a dense MLP branch through a learned 2-way softmax
            dt = self.dtype
            h = _activate(x.to(dt) @ p["residual_mlp_in"]["kernel"].to(dt), "gelu")
            mlp_out = h @ p["residual_mlp"]["kernel"].to(dt)
            coef = torch.softmax(x.float() @ p["coefficient"]["kernel"].float(), dim=-1)
            out = out * coef[..., 0:1].to(x.dtype) + mlp_out * coef[..., 1:2].to(x.dtype)
        return out, l_aux, exp_counts
