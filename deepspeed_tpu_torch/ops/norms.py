"""RMSNorm and LayerNorm: the hand-written CUDA kernels and their plain PyTorch versions.

Port of ``deepspeed_tpu/ops/pallas/norms.py``: ``rms_norm`` / ``rms_norm_xla``
and ``layer_norm`` / ``layer_norm_xla``. The kernels (``csrc/rms_norm.cu``,
``csrc/layer_norm.cu``) replace the Pallas ``_rms_kernel`` and ``_ln_kernel``;
see their source notes for the design. As in the reference, only the forward
is a kernel: each function is a ``torch.autograd.Function`` whose backward
recomputes the statistics from the saved input in plain PyTorch (the
reference's ``_rms_vjp_bwd`` and ``_ln_vjp_bwd``). Serving calls both; the
training forward normalises in plain PyTorch (``models/transformer.py``), as
the reference's flax modules do.
"""

import torch

from . import _build


def _check_affine(name: str, x: torch.Tensor, *params: torch.Tensor) -> None:
    d = x.shape[-1]
    for p in params:
        if p.shape != (d,) or p.device != x.device:
            raise ValueError(f"{name}: parameter {tuple(p.shape)} on {p.device} does not fit x "
                             f"{tuple(x.shape)} on {x.device}")
        if p.dtype != params[0].dtype:
            raise ValueError(f"{name}: weight and bias must share a dtype, got {params[0].dtype} and {p.dtype}")
    if not x.is_contiguous() or not all(p.is_contiguous() for p in params):
        raise ValueError(f"{name}: x and its parameters must be contiguous")


# ------------------------------------------------------------------
# RMSNorm
# ------------------------------------------------------------------
def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version: ``x * rsqrt(mean(x^2) + eps) * w`` with fp32 statistics,
    returned in x's dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def _rms_forward(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return rms_norm_ref(x, weight, eps)
    _check_affine("rms_norm", x, weight)
    d = x.shape[-1]
    xd, wd = _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    rc = _build.lib().ds_rms_norm(x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, d, float(eps), xd, wd,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rms_norm")
    rms_norm.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rms_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        # statistics recomputed from the saved x, as the reference's backward does
        x, weight = ctx.saved_tensors
        x32, g32, w32 = x.float(), g.float(), weight.float()
        r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + ctx.eps)
        gu = g32 * w32
        s = torch.mean(gu * x32, dim=-1, keepdim=True)
        dx = r * gu - (r**3) * x32 * s
        dw = (g32 * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0)
        return dx.to(x.dtype), dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., d) float32 or bfloat16; weight (d,) float32 or bfloat16. Returns
    x's shape and dtype; differentiable in x and weight. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel or raises."""
    if not (torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad)):
        return _rms_forward(x, weight, eps)  # serving: no graph to record, skip the autograd bookkeeping
    return _RMSNorm.apply(x, weight, eps)


rms_norm.launches = 0  # kernel launches since the last reset (CPU calls do not count)


# ------------------------------------------------------------------
# LayerNorm
# ------------------------------------------------------------------
def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version: ``(x - mean) * rsqrt(var + eps) * w + b`` with fp32
    statistics (var = the mean of squared deviations), returned in x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def _ln_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    if not x.is_cuda:
        return layer_norm_ref(x, weight, bias, eps)
    _check_affine("layer_norm", x, weight, bias)
    d = x.shape[-1]
    xd, wd = _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype)
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    rc = _build.lib().ds_layer_norm(x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, d,
                                    float(eps), xd, wd, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "layer_norm")
    layer_norm.launches += 1
    return out


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _ln_forward(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        d = x.shape[-1]
        x32, g32, w32 = x.float(), g.float(), weight.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(var + ctx.eps)
        xhat = (x32 - mean) * rstd
        gx = g32 * w32
        dx = rstd * (gx - gx.mean(dim=-1, keepdim=True) - xhat * (gx * xhat).mean(dim=-1, keepdim=True))
        dw = (g32 * xhat).reshape(-1, d).sum(dim=0)
        db = g32.reshape(-1, d).sum(dim=0)
        return dx.to(x.dtype), dw.to(weight.dtype), db.to(bias.dtype), None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., d) float32 or bfloat16; weight and bias (d,) float32 or
    bfloat16, independently of x. Returns x's shape and dtype; differentiable
    in x, weight and bias. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises."""
    if not (torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad)):
        return _ln_forward(x, weight, bias, eps)  # serving: no graph to record, skip the autograd bookkeeping
    return _LayerNorm.apply(x, weight, bias, eps)


layer_norm.launches = 0  # kernel launches since the last reset (CPU calls do not count)
