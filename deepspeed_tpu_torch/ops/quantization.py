"""Group-wise quantisation: the hand-written CUDA kernels and their plain versions.

Port of ``deepspeed_tpu/ops/pallas/quantization.py``: symmetric int8 / int4
quantisation over flat groups of ``group_size`` consecutive elements (int4
keeps one code per int8 byte), with one fp32 scale per group. The kernels
(``csrc/quantization.cu``) replace the Pallas ``_quant_kernel`` and
``_dequant_kernel``; see its source note. ``quantize_groupwise_xla`` and
``dequantize_groupwise_xla`` are the plain versions under the reference's
names: the oracle is the reference's XLA form, which divides by the scale,
and the kernels equal these plain versions bit for bit.

Each wrapper takes its plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor, and counts its launches. The
reference's fp8 and minifloat casts (``cast_fp8``, ``quantize_fp``,
``dequantize_fp``) are plain XLA on no ported path and are not ported.
"""

from typing import Optional, Sequence, Tuple

import torch

from . import _build


def _rows(n: int, group_size: int) -> int:
    if group_size <= 0 or n % group_size:
        raise ValueError(f"size {n} not divisible by group {group_size}")
    return n // group_size


def quantize_groupwise_xla(x: torch.Tensor, group_size: int = 128, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (rows, group_size) int8 codes and (rows,) fp32 scales of
    ``x`` (any shape, cast to fp32 first); ``scale = absmax / qmax``, 1.0 for
    an all-zero group, codes rounded half to even and clipped."""
    rows = _rows(x.numel(), group_size)
    x2 = x.reshape(rows, group_size).float()
    absmax = x2.abs().amax(dim=-1, keepdim=True)
    qmax = float(2**(bits - 1) - 1)
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns division by a
    # host scalar into a multiply by its reciprocal, one ulp off the oracle's quotient
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / absmax.new_full((), qmax))
    q = torch.clamp(torch.round(x2 / scale), -qmax - 1, qmax).to(torch.int8)
    return q, scale[:, 0]


def dequantize_groupwise_xla(q: torch.Tensor, scales: torch.Tensor, out_shape: Optional[Sequence[int]] = None,
                             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version: ``q * scale`` per group in fp32, cast to ``out_dtype``,
    reshaped to ``out_shape`` when given."""
    out = (q.float() * scales[:, None]).to(out_dtype)
    return out.reshape(out_shape) if out_shape is not None else out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_groupwise(x: torch.Tensor, group_size: int = 128, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, group_size) int8 codes and (rows,) fp32 scales of ``x``, whose
    size must divide by ``group_size``. A CPU tensor takes the plain version;
    a CUDA tensor (contiguous fp32 or bf16; bits 8 or 4) launches the kernel
    or raises."""
    if not x.is_cuda:
        return quantize_groupwise_xla(x, group_size, bits)
    rows = _rows(x.numel(), group_size)
    if not x.is_contiguous():
        raise ValueError("quantize_groupwise: x must be contiguous")
    q = torch.empty((rows, group_size), dtype=torch.int8, device=x.device)
    scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
    rc = _build.lib().ds_quantize_groupwise(x.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, int(group_size),
                                            int(bits), _build.dtype_code(x.dtype), _stream(x))
    _build.check(rc, "quantize_groupwise")
    quantize_groupwise.launches += 1
    return q, scales


def dequantize_groupwise(q: torch.Tensor, scales: torch.Tensor, out_shape: Optional[Sequence[int]] = None,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` per group: q (rows, group) int8, scales (rows,) fp32,
    the result in ``out_dtype`` and ``out_shape``. A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (fp32 or bf16 output)
    or raises."""
    if not q.is_cuda:
        return dequantize_groupwise_xla(q, scales, out_shape, out_dtype)
    if q.dim() != 2 or q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError("dequantize_groupwise: q must be contiguous (rows, group) int8")
    rows, group = q.shape
    if (scales.device != q.device or scales.dtype != torch.float32 or not scales.is_contiguous()
            or scales.shape != (rows,)):
        raise ValueError(f"dequantize_groupwise: scales must be contiguous ({rows},) float32 on {q.device}")
    code = _build.dtype_code(out_dtype)
    out = torch.empty((rows, group), dtype=out_dtype, device=q.device)
    rc = _build.lib().ds_dequantize_groupwise(q.data_ptr(), scales.data_ptr(), out.data_ptr(), q.numel(), group, code,
                                              _stream(q))
    _build.check(rc, "dequantize_groupwise")
    dequantize_groupwise.launches += 1
    return out.reshape(out_shape) if out_shape is not None else out


quantize_groupwise.launches = 0  # kernel launches since the last reset (CPU calls do not count)
dequantize_groupwise.launches = 0
