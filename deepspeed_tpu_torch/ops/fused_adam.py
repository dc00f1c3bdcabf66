"""Fused AdamW: the hand-written CUDA kernel and its plain PyTorch version.

Port of ``deepspeed_tpu/ops/pallas/fused_adam.py``. The kernel
(``csrc/fused_adam.cu``) replaces the Pallas ``_adam_kernel``; see its
source note for the design. Unlike the reference, which returns new
buffers, both versions update p, m and v in place. The step's scalars live
in a small device tensor (``adam_scalars``): lr, the bias corrections
``1 - b1^t`` and ``1 - b2^t``, the gradient multiplier and a finite flag; a
step whose flag is 0 leaves p, m and v as they were.
"""

import torch

from . import _build

N_SCALARS = 5  # lr, bc1, bc2, grad_mult, finite


def adam_scalars(lr, step, b1: float, b2: float, grad_mult=1.0, finite=True, device=None) -> torch.Tensor:
    """The (5,) fp32 device tensor the kernel reads. ``lr``, ``step`` (1-based),
    ``grad_mult`` and ``finite`` may be Python numbers or 0-d device tensors;
    the bias corrections are computed in fp32 as in the reference."""
    f32 = dict(dtype=torch.float32, device=device)
    t = torch.as_tensor(step, **f32)
    parts = [torch.as_tensor(lr, **f32), 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t),
             torch.as_tensor(grad_mult, **f32), torch.as_tensor(finite, **f32)]
    return torch.stack([x.reshape(()) for x in parts])


def fused_adam_ref(p, g, m, v, scalars, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> None:
    """Plain version: the same update in place, skipped where the flag is 0."""
    lr, bc1, bc2, mult, finite = scalars.unbind()
    gg = g.float() * mult
    new_m = b1 * m + (1 - b1) * gg
    new_v = b2 * v + (1 - b2) * gg * gg
    update = (new_m / bc1) / (torch.sqrt(new_v / bc2) + eps) + weight_decay * p
    keep = finite != 0
    p.copy_(torch.where(keep, p - lr * update, p))
    m.copy_(torch.where(keep, new_m, m))
    v.copy_(torch.where(keep, new_v, v))


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, scalars: torch.Tensor,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One AdamW step over one leaf, in place. p, g, m, v: fp32, same number
    of elements, contiguous; scalars from ``adam_scalars``. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if not p.is_cuda:
        return fused_adam_ref(p, g, m, v, scalars, b1, b2, eps, weight_decay)
    n = p.numel()
    for name, t in (("g", g), ("m", m), ("v", v), ("scalars", scalars)):
        if t.device != p.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_adam: {name} must be contiguous float32 on {p.device}")
        if name != "scalars" and t.numel() != n:
            raise ValueError(f"fused_adam: {name} has {t.numel()} elements, p has {n}")
    if p.dtype != torch.float32 or not p.is_contiguous() or scalars.numel() != N_SCALARS:
        raise ValueError("fused_adam: p must be contiguous float32 and scalars hold "
                         f"{N_SCALARS} values (adam_scalars)")
    rc = _build.lib().ds_fused_adam(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), n, scalars.data_ptr(),
                                    float(b1), float(1.0 - b1), float(b2), float(1.0 - b2), float(eps),
                                    float(weight_decay), torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(rc, "fused_adam")
    fused_adam.launches += 1


fused_adam.launches = 0  # kernel launches since the last reset (CPU calls do not count)
