"""Grouped GEMM over expert-sorted rows, with the group offsets on the device.

``moe_grouped_gemm(x, w, offsets)`` is ``lax.ragged_dot(x, w, group_sizes)``
of the reference's MoE serving module
(``deepspeed_tpu/inference/v2/modules.py`` ``moe_tpu``): x (R, K) holds its
rows sorted by expert, w (E, K, N) the stacked experts in the flax layout,
and offsets (E + 1,) int32 the cumulative group bounds (``offsets[0] = 0``,
``offsets[E] = R``; group e is rows ``[offsets[e], offsets[e + 1])``).
Returns (R, N) in x's dtype, accumulated in fp32.

The reference's product is plain XLA, not a Pallas kernel. On the card it is
a kernel written by hand (``csrc/moe_grouped_gemm.cu``) because the group
sizes exist only on the device: a loop of matmuls over the experts would read
them back, a sync that a captured CUDA graph cannot hold. The kernel reads
the offsets itself, and its launch depends only on R, K, N, E and the tile
rows chosen here, so every routing replays one graph.

A CPU tensor takes the plain version (``moe_grouped_gemm_ref``: a loop over
the experts with host sizes, fp32 products cast to x's dtype); a CUDA tensor
launches the kernel or raises.
"""

import torch

from . import _build

GEMM_TILE_ROWS = (32, 64)  # the bf16 body's tile rows (csrc/moe_grouped_gemm.cu gg_bf16_kernel)
FP32_TILE_ROWS = 64


def tile_rows(R: int, E: int, dtype: torch.dtype) -> int:
    """Rows of a kernel tile, from host shapes only. bf16: 32 while the mean
    rows an expert are at most 16 (a decode step: each expert's weights
    read once, by one row tile), else 64 (fewer row tiles re-reading the
    weights). fp32 takes 64."""
    if dtype == torch.float32:
        return FP32_TILE_ROWS
    return GEMM_TILE_ROWS[0] if R <= 16 * E else GEMM_TILE_ROWS[1]


def moe_grouped_gemm_ref(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Plain version: each expert's rows times its weight in fp32, cast to x's
    dtype; rows outside every group stay zero. Reads the offsets on the host."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if b > a:
            out[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return out


def moe_grouped_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """x (R, K) and w (E, K, N) float32 or bfloat16 of one dtype; offsets
    (E + 1,) int32. Returns (R, N) in x's dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16 needs K and N multiples
    of 8) or raises. The launch never reads the offsets on the host."""
    if not x.is_cuda:
        return moe_grouped_gemm_ref(x, w, offsets)
    if x.dim() != 2 or w.dim() != 3 or offsets.dim() != 1:
        raise ValueError(f"moe_grouped_gemm: x (R, K), w (E, K, N) and offsets (E + 1,), got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(offsets.shape)}")
    R, K = x.shape
    E, Kw, N = w.shape
    if Kw != K or offsets.shape[0] != E + 1:
        raise ValueError(f"moe_grouped_gemm: x {tuple(x.shape)}, w {tuple(w.shape)} and offsets "
                         f"{tuple(offsets.shape)} do not fit")
    if w.dtype != x.dtype or offsets.dtype != torch.int32:
        raise ValueError(f"moe_grouped_gemm: x and w must share a dtype and offsets be int32, got {x.dtype}, "
                         f"{w.dtype}, {offsets.dtype}")
    for t, what in ((w, "w"), (offsets, "offsets")):
        if t.device != x.device:
            raise ValueError(f"moe_grouped_gemm: {what} is on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("moe_grouped_gemm: x, w and offsets must be contiguous")
    code = _build.dtype_code(x.dtype)
    out = torch.empty((R, N), dtype=x.dtype, device=x.device)
    if R == 0 or N == 0:
        return out
    rc = _build.lib().ds_moe_grouped_gemm(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(), R, K, N,
                                          E, tile_rows(R, E, x.dtype), code,
                                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "moe_grouped_gemm")
    moe_grouped_gemm.launches += 1
    return out


moe_grouped_gemm.launches = 0  # kernel launches since the last reset (CPU calls do not count)
