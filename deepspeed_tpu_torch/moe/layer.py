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
Expert parallelism and the expert-TP token mappings (``moe/mappings.py``,
``MOE_PARTITION_RULES``) are not ported, nor is the reference's
informational ``ep_size`` field.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .sharded_moe import combine_output, gate_and_dispatch


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
        tokens = x.reshape(-1, d)
        gate_logits = tokens.float() @ p["gate"]["kernel"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        # inference never drops a token: capacity is a training regulariser
        l_aux, dispatched, combine, exp_counts = gate_and_dispatch(
            tokens, gate_logits, self.k, cf, self.min_capacity, generator=generator,
            noisy_gate_policy=self.noisy_gate_policy if train else None, drop_tokens=self.drop_tokens and train)
        expert_out = self.experts(p["experts"], dispatched)
        out = combine_output(expert_out, combine).reshape(orig_shape).to(x.dtype)
        if self.use_residual:
            # Residual MoE: mix with a dense MLP branch through a learned 2-way softmax
            dt = self.dtype
            h = _activate(x.to(dt) @ p["residual_mlp_in"]["kernel"].to(dt), "gelu")
            mlp_out = h @ p["residual_mlp"]["kernel"].to(dt)
            coef = torch.softmax(x.float() @ p["coefficient"]["kernel"].float(), dim=-1)
            out = out * coef[..., 0:1].to(x.dtype) + mlp_out * coef[..., 1:2].to(x.dtype)
        return out, l_aux, exp_counts
