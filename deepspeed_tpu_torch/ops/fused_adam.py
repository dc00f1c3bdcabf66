"""Fused AdamW: the hand-written CUDA kernel and its plain PyTorch version.

Port of ``deepspeed_tpu/ops/pallas/fused_adam.py``. The kernel
(``csrc/fused_adam.cu``) replaces the Pallas ``_adam_kernel``; see its
source note for the design. One launch updates a list of leaves
(``fused_adam_multi``, at most ``TABLE_LEAVES`` a launch), as the
reference's upstream ``multi_tensor_adam.cu`` does; ``fused_adam`` is its
one-leaf case. Unlike the reference, which returns new buffers, both
versions update p, m and v in place. The step's scalars live in a small
device tensor (``adam_scalars``): lr, the bias corrections ``1 - b1^t`` and
``1 - b2^t``, the gradient multiplier and a finite flag; a step whose flag
is 0 leaves p, m and v as they were.
"""

import ctypes

import torch

from . import _build

N_SCALARS = 5  # lr, bc1, bc2, grad_mult, finite
TABLE_LEAVES = 512  # leaves one launch takes (kMaxLeaves in csrc/fused_adam.cu)


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


def fused_adam_multi_ref(params, grads, ms, vs, scalars, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> None:
    """Plain version of ``fused_adam_multi``: ``fused_adam_ref`` on each leaf."""
    for p, g, m, v in zip(params, grads, ms, vs):
        fused_adam_ref(p, g, m, v, scalars, b1, b2, eps, weight_decay)


def fused_adam_multi(params, grads, ms, vs, scalars: torch.Tensor, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One AdamW step over every leaf of the four equal-length lists, in
    place. Each leaf's p, g, m, v: fp32, the same number of elements,
    contiguous, on one device; scalars from ``adam_scalars``. CPU tensors
    take the plain version; CUDA tensors launch the kernel, once for each
    ``TABLE_LEAVES`` leaves that hold elements, or raise."""
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"fused_adam: {len(params)} params, {len(grads)} grads, {len(ms)} m and {len(vs)} v")
    if not params:
        return
    if not params[0].is_cuda:
        return fused_adam_multi_ref(params, grads, ms, vs, scalars, b1, b2, eps, weight_decay)
    dev = params[0].device
    if (scalars.device != dev or scalars.dtype != torch.float32 or not scalars.is_contiguous()
            or scalars.numel() != N_SCALARS):
        raise ValueError(f"fused_adam: scalars must be {N_SCALARS} contiguous float32 values on {dev} (adam_scalars)")
    ptrs, sizes = [], []
    for i, leaf in enumerate(zip(params, grads, ms, vs)):
        n = leaf[0].numel()
        for name, t in zip("pgmv", leaf):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"fused_adam: leaf {i}: {name} must be contiguous float32 on {dev}")
            if t.numel() != n:
                raise ValueError(f"fused_adam: leaf {i}: {name} has {t.numel()} elements, p has {n}")
        if n:
            ptrs += [t.data_ptr() for t in leaf]
            sizes.append(n)
    lib = _build.lib()
    hyper = (float(b1), float(1.0 - b1), float(b2), float(1.0 - b2), float(eps), float(weight_decay))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for lo in range(0, len(sizes), TABLE_LEAVES):
        k = min(TABLE_LEAVES, len(sizes) - lo)
        rc = lib.ds_fused_adam_multi((ctypes.c_void_p * (4 * k))(*ptrs[4 * lo:4 * (lo + k)]),
                                     (ctypes.c_longlong * k)(*sizes[lo:lo + k]), k, scalars.data_ptr(), *hyper,
                                     stream)
        _build.check(rc, "fused_adam")
        fused_adam.launches += 1


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, scalars: torch.Tensor,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One AdamW step over one leaf, in place: ``fused_adam_multi``'s one-leaf
    case (one launch on CUDA tensors, the plain version on CPU tensors)."""
    fused_adam_multi([p], [g], [m], [v], scalars, b1, b2, eps, weight_decay)


fused_adam.launches = 0  # kernel launches since the last reset (CPU calls do not count)
