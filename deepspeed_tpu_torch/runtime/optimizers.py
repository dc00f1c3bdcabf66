"""Optimizers: Adam / AdamW and FusedAdam, and ``create_optimizer``.

Port of the Adam family of ``deepspeed_tpu/runtime/optimizers.py``. The
reference builds optax transforms; here they are ``torch.optim.Optimizer``
subclasses that update fp32 parameters in place:

- ``Adam``: plain PyTorch. ``adam_w_mode=True`` is AdamW
  (``p -= lr (mhat / (sqrt(vhat) + eps) + wd p)``, the reference's
  ``optax.adamw``); ``adam_w_mode=False`` is classic L2 Adam (the decay is
  folded into the gradient before the moments, the reference's
  ``add_decayed_weights -> scale_by_adam``).
- ``FusedAdam``: AdamW through the hand-written kernel
  (``ops.fused_adam``, the reference's ``_pallas_fused_adamw``), one launch
  per parameter tensor, as the reference launched one per leaf.

``step(grad_mult=, finite=)`` takes the engine's gradient multiplier
(inverse loss scale times the clip coefficient) and overflow flag as device
tensors: the step count and the update advance only where ``finite`` holds,
and nothing is read back to the host.
"""

from typing import Dict, Optional

import torch

from ..ops.fused_adam import adam_scalars, fused_adam, fused_adam_ref

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"  # the reference's host-offloaded states; same math
_NOT_PORTED = ("lamb", "lion", "sgd", "adagrad", "onebitadam", "zerooneadam", "onebitlamb", "muon")


def _adam_args(params: Dict) -> Dict:
    betas = params.get("betas", (0.9, 0.999))
    return dict(lr=params.get("lr", 1e-3), betas=(betas[0], betas[1]), eps=params.get("eps", 1e-8),
                weight_decay=params.get("weight_decay", 0.01))


class Adam(torch.optim.Optimizer):
    """Adam / AdamW in plain PyTorch over fp32 parameters (see the module note)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01,
                 adam_w_mode: bool = True):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.adam_w_mode = adam_w_mode
        self._count = None  # applied steps, a device int32 scalar (skipped steps do not count)

    def _update(self, p, g, m, v, scalars, b1, b2, eps, wd):
        if self.adam_w_mode:
            return fused_adam_ref(p, g, m, v, scalars, b1, b2, eps, wd)
        lr, bc1, bc2, mult, finite = scalars.unbind()
        gg = g * mult + wd * p
        new_m = b1 * m + (1 - b1) * gg
        new_v = b2 * v + (1 - b2) * gg * gg
        keep = finite != 0
        p.copy_(torch.where(keep, p - lr * ((new_m / bc1) / (torch.sqrt(new_v / bc2) + eps)), p))
        m.copy_(torch.where(keep, new_m, m))
        v.copy_(torch.where(keep, new_v, v))

    @torch.no_grad()
    def step(self, closure=None, grad_mult: Optional[torch.Tensor] = None, finite: Optional[torch.Tensor] = None):
        loss = closure() if closure is not None else None
        params = [p for group in self.param_groups for p in group["params"]]
        if not params:
            return loss
        dev = params[0].device
        ok = torch.ones((), dtype=torch.bool, device=dev) if finite is None else finite.to(dev)
        if self._count is None:
            self._count = torch.zeros((), dtype=torch.int32, device=dev)
        self._count += ok.to(torch.int32)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            scalars = adam_scalars(group["lr"], self._count, b1, b2, 1.0 if grad_mult is None else grad_mult, ok,
                                   device=dev)
            for p in group["params"]:
                if p.grad is None:
                    continue
                if p.dtype != torch.float32 or p.grad.dtype != torch.float32:
                    raise TypeError("Adam/FusedAdam update fp32 parameters with fp32 gradients")
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                self._update(p, p.grad, state["exp_avg"], state["exp_avg_sq"], scalars, b1, b2, group["eps"],
                             group["weight_decay"])
        return loss


class FusedAdam(Adam):
    """AdamW whose update is the hand-written kernel D on CUDA parameters (the
    plain version on CPU parameters)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(params, lr, betas, eps, weight_decay, adam_w_mode=True)

    def _update(self, p, g, m, v, scalars, b1, b2, eps, wd):
        fused_adam(p, g.contiguous(), m, v, scalars, b1, b2, eps, wd)


def create_optimizer(name: Optional[str], params: Optional[Dict], model_params) -> Adam:
    """The optimizer of the config ``optimizer`` section over ``model_params``.
    ``adam`` honours ``adam_w_mode`` (default AdamW); ``adamw`` is always
    AdamW; ``fusedadam`` is ``FusedAdam``, or L2 Adam in plain PyTorch when
    ``adam_w_mode`` is false (the kernel implements AdamW only)."""
    params = dict(params or {})
    name = (name or ADAMW_OPTIMIZER).lower()
    a = _adam_args(params)
    adam_w_mode = params.get("adam_w_mode", True)
    if name == FUSED_ADAM and adam_w_mode:
        return FusedAdam(model_params, **a)
    if name in (ADAM_OPTIMIZER, FUSED_ADAM, CPU_ADAM):
        return Adam(model_params, adam_w_mode=adam_w_mode, **a)
    if name == ADAMW_OPTIMIZER:
        return Adam(model_params, adam_w_mode=True, **a)
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (adam, adamw, fusedadam are)")
    raise ValueError(f"Unknown optimizer type: {name}")
