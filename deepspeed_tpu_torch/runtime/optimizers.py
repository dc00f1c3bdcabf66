"""Optimizers: Adam / AdamW, FusedAdam, Lamb, Lion, SGD, Adagrad, and ``create_optimizer``.

Port of ``deepspeed_tpu/runtime/optimizers.py``. The reference builds optax
transforms; here they are ``torch.optim.Optimizer`` subclasses that update
fp32 parameters in place, each with the semantics of the optax transform
the reference's config name selects:

- ``Adam``: plain PyTorch. ``adam_w_mode=True`` is AdamW
  (``p -= lr (mhat / (sqrt(vhat) + eps) + wd p)``, the reference's
  ``optax.adamw``); ``adam_w_mode=False`` is classic L2 Adam (the decay is
  folded into the gradient before the moments, the reference's
  ``add_decayed_weights -> scale_by_adam``).
- ``FusedAdam``: AdamW through the hand-written kernel
  (``ops.fused_adam``, the reference's ``_pallas_fused_adamw``), one launch
  over every parameter tensor of a param group (``fused_adam_multi``; the
  reference's per-leaf kernels run inside one compiled step).
- ``Lamb``: ``optax.lamb``. Per leaf, the direction
  ``u = mhat / (sqrt(vhat) + eps) + wd p`` through the hand-written kernel
  (``ops.fused_lamb.lamb_direction``, one launch per leaf; its plain version
  on the CPU), then ``p -= lr * trust * u`` with the unclipped trust ratio
  ``||p|| / ||u||`` (1 where either norm is 0). The clip to [0.01, 10]
  belongs only to the ``fused_lamb_flat`` op.
- ``Lion``, ``SGD`` and ``Adagrad``: plain PyTorch with ``optax.lion``,
  ``optax.sgd`` and ``optax.adagrad``'s semantics (``torch.optim``'s
  versions differ: see each class).

``step(grad_mult=, finite=)`` takes the engine's gradient multiplier
(inverse loss scale times the clip coefficient) and overflow flag as device
tensors: the step count and the update advance only where ``finite`` holds,
and nothing is read back to the host.
"""

from typing import Callable, Dict, Optional

import torch

from ..ops import fused_lamb
from ..ops.fused_adam import adam_scalars, fused_adam_multi, fused_adam_ref

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM = "fusedadam"
CPU_ADAM = "cpuadam"  # the reference's host-offloaded states; same math
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"
_NOT_PORTED = ("onebitadam", "zerooneadam", "onebitlamb", "muon")


def _adam_args(params: Dict) -> Dict:
    betas = params.get("betas", (0.9, 0.999))
    return dict(lr=params.get("lr", 1e-3), betas=(betas[0], betas[1]), eps=params.get("eps", 1e-8),
                weight_decay=params.get("weight_decay", 0.01))


class DeviceOptimizer(torch.optim.Optimizer):
    """The step loop the port's optimizers share: a device step count that
    advances only where ``finite`` holds, the step's scalars as one device
    tensor per group (``adam_scalars``: lr, ``1 - b1^t``, ``1 - b2^t``, the
    gradient multiplier, the finite flag), and one ``_update`` per leaf
    (``_step_group`` takes a whole group where a subclass overrides it)."""

    def __init__(self, params, defaults: Dict):
        super().__init__(params, defaults)
        self._count = None  # applied steps, a device int32 scalar (skipped steps do not count)
        self._sharded: Dict[int, Callable] = {}  # id of a parameter that is one rank's part of a leaf -> its reduce

    def set_sharded(self, params, norm_reduce: Callable) -> None:
        """Mark ``params`` as parts of leaves split over ranks (ZeRO chunks,
        an expert rank's experts, a tensor rank's slice): ``norm_reduce(t)`` sums ``t`` in place
        over the ranks holding the other parts (LAMB's trust ratio needs
        whole-leaf norms; the elementwise optimizers ignore it)."""
        self._sharded.update({id(p): norm_reduce for p in params})

    def state_names(self):
        """The names of a parameter's state tensors, in the order a universal
        checkpoint numbers them (``exp_avg``, ``exp_avg_sq``, ...)."""
        return tuple(self._init_state(torch.empty(0)).keys())

    def _init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update(self, p, g, state, scalars, group) -> None:
        raise NotImplementedError

    def _leaves(self, group):
        """(p, grad, state) of each parameter of ``group`` that has a gradient,
        its state made on first use."""
        for p in group["params"]:
            if p.grad is None:
                continue
            if p.dtype != torch.float32 or p.grad.dtype != torch.float32:
                raise TypeError(f"{type(self).__name__} updates fp32 parameters with fp32 gradients")
            state = self.state[p]
            if not state:
                state.update(self._init_state(p))
            yield p, p.grad, state

    def _step_group(self, group, scalars) -> None:
        for p, g, state in self._leaves(group):
            self._update(p, g, state, scalars, group)

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
            b1, b2 = group.get("betas", (0.0, 0.0))
            scalars = adam_scalars(group["lr"], self._count, b1, b2, 1.0 if grad_mult is None else grad_mult, ok,
                                   device=dev)
            self._step_group(group, scalars)
        return loss


class Adam(DeviceOptimizer):
    """Adam / AdamW in plain PyTorch over fp32 parameters (see the module note)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01,
                 adam_w_mode: bool = True):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.adam_w_mode = adam_w_mode

    def _init_state(self, p):
        return {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}

    def _update(self, p, g, state, scalars, group):
        m, v = state["exp_avg"], state["exp_avg_sq"]
        (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
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


class FusedAdam(Adam):
    """AdamW whose update is the hand-written kernel on CUDA parameters, one
    launch for every leaf of a group (the plain version on CPU parameters)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(params, lr, betas, eps, weight_decay, adam_w_mode=True)

    def _step_group(self, group, scalars):
        leaves = list(self._leaves(group))
        (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
        fused_adam_multi([p for p, _, _ in leaves], [g.contiguous() for _, g, _ in leaves],
                         [state["exp_avg"] for _, _, state in leaves], [state["exp_avg_sq"] for _, _, state in leaves],
                         scalars, b1, b2, eps, wd)


class Lamb(Adam):
    """``optax.lamb`` (the JAX engine's ``"lamb"``): the direction through the
    hand-written kernel on CUDA parameters (its plain version on CPU
    parameters), then the unclipped trust-ratio apply in PyTorch. The
    direction of every leaf goes through one scratch buffer of the largest
    leaf's size. A leaf split over ranks (``set_sharded``: ZeRO stage >= 1,
    an expert rank's experts, a tensor rank's slice) takes its trust ratio
    from whole-leaf norms: its part's squared norms are summed over the
    ranks before the apply."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(params, lr, betas, eps, weight_decay, adam_w_mode=True)
        self._u = None

    def _update(self, p, g, state, scalars, group):
        (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
        if self._u is None:
            n = max(q.numel() for grp in self.param_groups for q in grp["params"])
            self._u = torch.empty(n, dtype=torch.float32, device=p.device)
        u = fused_lamb.lamb_direction(p, g.contiguous(), state["exp_avg"], state["exp_avg_sq"], scalars, b1, b2, eps,
                                      wd, u_out=self._u[:p.numel()].view_as(p))
        fused_lamb.lamb_apply(p, u, scalars, norm_reduce=self._sharded.get(id(p)))


class Lion(DeviceOptimizer):
    """``optax.lion``: ``p -= lr (sign((1 - b1) g + b1 mu) + wd p)``, then
    ``mu <- b2 mu + (1 - b2) g`` (``torch.optim`` has no Lion; the usual
    ports decay before the sign step, optax after)."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    def _init_state(self, p):
        return {"exp_avg": torch.zeros_like(p)}

    def _update(self, p, g, state, scalars, group):
        lr, _, _, mult, finite = scalars.unbind()
        (b1, b2), wd = group["betas"], group["weight_decay"]
        mu = state["exp_avg"]
        gg = g * mult
        update = torch.sign((1.0 - b1) * gg + b1 * mu) + wd * p
        keep = finite != 0
        p.copy_(torch.where(keep, p - lr * update, p))
        mu.copy_(torch.where(keep, (1 - b2) * gg + b2 * mu, mu))


class SGD(DeviceOptimizer):
    """``optax.sgd``: ``trace(decay=momentum, nesterov)`` then ``-lr``. The trace
    is ``t <- g + momentum t`` with no dampening, and nesterov's update is
    ``g + momentum t`` of the new trace; momentum 0 is plain SGD."""

    def __init__(self, params, lr: float = 1e-3, momentum: float = 0.0, nesterov: bool = False):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov))

    def _init_state(self, p):
        return {"momentum_buffer": torch.zeros_like(p)}

    def _update(self, p, g, state, scalars, group):
        lr, _, _, mult, finite = scalars.unbind()
        mom = group["momentum"]
        keep = finite != 0
        gg = g * mult
        t = state["momentum_buffer"]
        new_t = gg + mom * t
        update = gg + mom * new_t if group["nesterov"] else new_t
        p.copy_(torch.where(keep, p - lr * update, p))
        t.copy_(torch.where(keep, new_t, t))


class Adagrad(DeviceOptimizer):
    """``optax.adagrad``: the accumulator starts at ``initial_accumulator_value``
    (0.1) and ``p -= lr g / sqrt(acc + eps)`` with eps inside the root
    (``torch.optim.Adagrad`` starts at 0 and adds eps outside)."""

    def __init__(self, params, lr: float = 1e-2, eps: float = 1e-7, initial_accumulator_value: float = 0.1):
        super().__init__(params, dict(lr=lr, eps=eps, initial_accumulator_value=initial_accumulator_value))

    def _init_state(self, p):
        return {"sum": torch.full_like(p, self.defaults["initial_accumulator_value"])}

    def _update(self, p, g, state, scalars, group):
        lr, _, _, mult, finite = scalars.unbind()
        acc = state["sum"]
        gg = g * mult
        new_acc = gg * gg + acc
        inv = torch.where(new_acc > 0, torch.rsqrt(new_acc + group["eps"]), torch.zeros_like(new_acc))
        keep = finite != 0
        p.copy_(torch.where(keep, p - lr * (inv * gg), p))
        acc.copy_(torch.where(keep, new_acc, acc))


def create_optimizer(name: Optional[str], params: Optional[Dict], model_params) -> DeviceOptimizer:
    """The optimizer of the config ``optimizer`` section over ``model_params``,
    with the reference's defaults for each name. ``adam`` honours
    ``adam_w_mode`` (default AdamW); ``adamw`` is always AdamW; ``fusedadam``
    is ``FusedAdam``, or L2 Adam in plain PyTorch when ``adam_w_mode`` is
    false (the kernel implements AdamW only); ``lamb`` takes the Adam
    defaults (eps 1e-8, weight decay 0.01)."""
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
    if name == LAMB_OPTIMIZER:
        return Lamb(model_params, **a)
    if name == LION_OPTIMIZER:
        return Lion(model_params, lr=params.get("lr", 1e-4), betas=tuple(params.get("betas", (0.9, 0.99)))[:2],
                    weight_decay=params.get("weight_decay", 0.0))
    if name == SGD_OPTIMIZER:
        return SGD(model_params, lr=params.get("lr", 1e-3), momentum=params.get("momentum", 0.0),
                   nesterov=params.get("nesterov", False))
    if name == ADAGRAD_OPTIMIZER:
        return Adagrad(model_params, lr=params.get("lr", 1e-2), eps=params.get("eps", 1e-10))
    if name in _NOT_PORTED:
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (adam, adamw, fusedadam, lamb, lion, sgd "
                                  "and adagrad are)")
    raise ValueError(f"Unknown optimizer type: {name}")
