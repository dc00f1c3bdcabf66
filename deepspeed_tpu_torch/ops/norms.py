"""RMSNorm: the hand-written CUDA kernel and its plain PyTorch version.

Port of ``deepspeed_tpu/ops/pallas/norms.py`` (``rms_norm`` and the body of
``rms_norm_xla``). The kernel (``csrc/rms_norm.cu``) replaces the Pallas
``_rms_kernel``; see its source note for the design. ``layer_norm`` and the
backward passes come with later slices.
"""

import torch

from . import _build


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version: ``x * rsqrt(mean(x^2) + eps) * w`` with fp32 statistics,
    returned in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., d) float32 or bfloat16; weight (d,) float32 or bfloat16. Returns
    x's shape and dtype. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if not x.is_cuda:
        return rms_norm_ref(x, weight, eps)
    d = x.shape[-1]
    if weight.shape != (d,) or not weight.is_cuda or weight.device != x.device:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} on {weight.device} does not fit x "
                         f"{tuple(x.shape)} on {x.device}")
    if not x.is_contiguous() or not weight.is_contiguous():
        raise ValueError("rms_norm: x and weight must be contiguous")
    xd, wd = _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    lib = _build.lib()
    rc = lib.ds_rms_norm(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, float(eps), xd, wd,
                         torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rms_norm")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0  # kernel launches since the last reset (CPU calls do not count)
