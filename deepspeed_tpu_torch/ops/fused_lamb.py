"""Fused LAMB: the hand-written direction kernel and its plain PyTorch version.

Port of ``deepspeed_tpu/ops/pallas/fused_lamb.py``. LAMB runs per tensor in
three phases, as the reference does: (1) one elementwise pass computes the
new moments and the Adam-style direction ``u`` (the kernel,
``csrc/fused_lamb.cu``, which replaces the Pallas ``_lamb_dir_kernel``; see
its source note); (2) the norms of ``p`` and ``u`` for the trust ratio; (3)
the apply ``p -= lr * trust * u``. Phases 2 and 3 stay in PyTorch, as the
reference keeps them in XLA.

The step's scalars are ``fused_adam.adam_scalars``' (5,) fp32 device tensor:
lr, ``1 - b1^t``, ``1 - b2^t``, the gradient multiplier and a finite flag.
The direction scales the gradient by the multiplier and, where the flag is
0, leaves m and v as they were; the apply then leaves p too. Unlike the
reference, which returns new buffers, m, v and p are updated in place.
``lamb_direction`` takes its plain version for a CPU tensor and launches the
kernel (or raises) for a CUDA tensor, and counts its launches.
"""

from typing import Callable, Optional, Tuple

import torch

from . import _build
from .fused_adam import N_SCALARS, adam_scalars


def lamb_direction_ref(p, g, m, v, scalars, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0,
                       u_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: u into ``u_out`` (fp32), m and v in place where the flag is set."""
    _, bc1, bc2, mult, finite = scalars.unbind()
    gg = g.float() * mult
    new_m = b1 * m + (1 - b1) * gg
    new_v = b2 * v + (1 - b2) * gg * gg
    u = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps) + weight_decay * p
    keep = finite != 0
    m.copy_(torch.where(keep, new_m, m))
    v.copy_(torch.where(keep, new_v, v))
    if u_out is None:
        return u
    return u_out.copy_(u)


def lamb_direction(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, scalars: torch.Tensor,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6, weight_decay: float = 0.0,
                   u_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase one of LAMB over one leaf: returns u (fp32, p's shape, written
    into ``u_out`` when given) and updates m and v in place. p, g, m, v:
    fp32, contiguous, the same number of elements; scalars from
    ``adam_scalars``. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if not p.is_cuda:
        return lamb_direction_ref(p, g, m, v, scalars, b1, b2, eps, weight_decay, u_out)
    n = p.numel()
    if u_out is None:
        u_out = torch.empty_like(p, dtype=torch.float32)
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v), ("u_out", u_out), ("scalars", scalars)):
        if t.device != p.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"lamb_direction: {name} must be contiguous float32 on {p.device}")
        if name != "scalars" and t.numel() != n:
            raise ValueError(f"lamb_direction: {name} has {t.numel()} elements, p has {n}")
    if scalars.numel() != N_SCALARS:
        raise ValueError(f"lamb_direction: scalars must hold {N_SCALARS} values (adam_scalars)")
    rc = _build.lib().ds_lamb_direction(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), u_out.data_ptr(), n,
                                        scalars.data_ptr(), float(b1), float(1.0 - b1), float(b2), float(1.0 - b2),
                                        float(eps), float(weight_decay), torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "lamb_direction")
    lamb_direction.launches += 1
    return u_out


lamb_direction.launches = 0  # kernel launches since the last reset (CPU calls do not count)


def lamb_apply(p: torch.Tensor, u: torch.Tensor, scalars: torch.Tensor, min_trust: Optional[float] = None,
               max_trust: Optional[float] = None, norm_reduce: Optional[Callable] = None) -> None:
    """Phases two and three, in place: ``p -= lr * trust * u`` where the flag is
    set, with ``trust = ||p|| / ||u||`` (clipped to [min_trust, max_trust]
    when given) and 1 where either norm is 0. Where ``p`` and ``u`` are one
    rank's chunks of a leaf, ``norm_reduce`` sums the stacked squared norms
    in place over the ranks holding the other chunks."""
    lr, finite = scalars[0], scalars[4]
    if norm_reduce is None:
        w_norm = torch.linalg.vector_norm(p.float())
        u_norm = torch.linalg.vector_norm(u)
    else:
        sq = torch.stack([torch.linalg.vector_norm(p.float()), torch.linalg.vector_norm(u)]).square()
        w_norm, u_norm = norm_reduce(sq).sqrt().unbind()
    ratio = w_norm / u_norm
    if min_trust is not None:
        ratio = torch.clamp(ratio, min_trust, max_trust)
    trust = torch.where((w_norm > 0) & (u_norm > 0), ratio, torch.ones_like(ratio))
    p.copy_(torch.where(finite != 0, p - lr * trust * u, p))


def fused_lamb_flat(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0, min_trust: float = 0.01,
                    max_trust: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One LAMB update of ONE tensor with the trust ratio clipped to
    [min_trust, max_trust] (the reference's ``fused_lamb_flat``): the
    direction through ``lamb_direction``, in place; returns (p, m, v)."""
    scalars = adam_scalars(lr, step, b1, b2, device=p.device)
    u = lamb_direction(p, g, m, v, scalars, b1, b2, eps, weight_decay)
    lamb_apply(p, u, scalars, min_trust, max_trust)
    return p, m, v


def lamb_xla(p, g, m, v, lr, step, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.0, min_trust=0.01,
             max_trust=10.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's plain form: new (p, m, v), the inputs left as they are."""
    new_m = b1 * m + (1 - b1) * g
    new_v = b2 * v + (1 - b2) * g * g
    u = (new_m / (1 - b1**step)) / (torch.sqrt(new_v / (1 - b2**step)) + eps) + weight_decay * p
    w_norm = torch.linalg.vector_norm(p)
    u_norm = torch.linalg.vector_norm(u)
    trust = torch.where((w_norm > 0) & (u_norm > 0), torch.clamp(w_norm / u_norm, min_trust, max_trust),
                        torch.ones_like(w_norm))
    return p - lr * trust * u, new_m, new_v
