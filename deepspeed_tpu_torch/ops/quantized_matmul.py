"""Fused dequantize-matmul for weight-only-quantised serving.

Port of ``deepspeed_tpu/ops/pallas/quantized_matmul.py``. The layout is matmul-native: for a weight in its 2D
matmul form ``(K, N)``, codes are int8 ``(K, N)`` (or packed int4
``(K/2, N)``) and scales are fp32 ``(K/g, N)``: symmetric absmax scaling per
(K-group, output column).

- ``quantize_weight_kgroups`` and ``_dequantize_kgroups`` are plain PyTorch
  on the weight's device, as they are plain XLA in the reference.
- ``quantized_matmul(x, q, scales, packed=False)``: x ``(M, K)``; returns
  ``(M, N)`` accumulated in fp32 and cast to x's dtype. A CPU tensor takes
  the plain version (``quantized_matmul_ref``: dequantise, then matmul); a
  CUDA tensor launches the kernel (``csrc/quantized_matmul.cu``, which
  replaces the Pallas ``_qmm_kernel``) or raises. The reference's shape
  limits (at most 64 groups, 128-multiples) are limits of its tiling and do
  not exist here.
- ``_qmm_plan(M, K, N, n_groups, packed, sms)`` is the bf16 kernel's launch
  plan, chosen here on the host: the tile (``QMM_TILES``) and how many
  slices of whole groups split K, so that a decode step's few output tiles
  still cover every SM. A split launch sums its fp32 partials (a workspace
  from ``torch.empty``) in slice order inside the same launch, using one
  counter per output tile (``_utils.tile_counters``: a zeroed int32 buffer
  kept per device, which the kernel leaves zeroed), so results repeat bit
  for bit. The split launches of a device (this kernel's and
  ``moe_grouped_gemm``'s) share that buffer, so they must not run
  concurrently on several streams.
- ``quantized_matmul_sharded``: the same kernel on a tensor-parallel rank's
  codes (quantised after sharding, so groups never cross the shard edge):
  N-sharded codes give this rank's output columns, K-sharded codes its
  partial product, which the layer's row-parallel reduce sums once.
"""

from typing import Tuple

import torch

from ..device import sm_count
from . import _build
from ._utils import block_that_divides, tile_counters


def quantize_weight_kgroups(w: torch.Tensor, group_size: int = 128, bits: int = 8,
                            pack: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantise a 2D matmul weight ``(K, N)`` into K-grouped symmetric codes.

    Returns ``(codes, scales (K/g, N) fp32)``. ``bits=8``: codes int8
    ``(K, N)``. ``bits=4, pack=True``: codes int8 ``(K/2, N)``, two int4
    nibbles per byte: within each group, byte row ``r`` holds code ``k = r``
    in the LOW nibble and ``k = r + g/2`` in the HIGH nibble. ``bits=4,
    pack=False`` keeps the int4 code range in int8 storage. ``pack=True``
    degrades to unpacked storage when the effective group size is odd;
    callers detect packing from ``codes.shape[0] != K``. An all-zero group
    gets scale 1.0.
    """
    K, N = w.shape
    g = group_size if K % group_size == 0 else block_that_divides(K, group_size)
    wf = w.float().reshape(K // g, g, N)
    absmax = wf.abs().amax(dim=1)  # (K/g, N)
    qmax = float(2**(bits - 1) - 1)
    scales = torch.where(absmax == 0, torch.ones_like(absmax), absmax / qmax)
    q = torch.clamp(torch.round(wf / scales[:, None, :]), -qmax - 1, qmax).to(torch.int32)
    if not pack or g % 2 != 0:  # an odd group cannot split into nibble halves
        return q.reshape(K, N).to(torch.int8), scales
    if bits != 4:
        raise ValueError("packing is the int4 storage format")
    lo = q[:, :g // 2, :] & 15  # low nibble: rows [0, g/2)
    hi = q[:, g // 2:, :] & 15  # high nibble: rows [g/2, g)
    packed = (lo | (hi << 4)).to(torch.int8)  # (K/g, g/2, N); values over 127 wrap, as the bytes do
    return packed.reshape(K // 2, N), scales


def _unpack_int4(p32: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Packed int32 bytes -> signed codes, doubling ``dim`` (the rows of a
    group) by concatenation, per the packing layout above."""
    lo = ((p32 & 15) ^ 8) - 8
    hi = (((p32 >> 4) & 15) ^ 8) - 8
    return torch.cat([lo, hi], dim=dim)


def _dequantize_kgroups(q: torch.Tensor, scales: torch.Tensor, packed: bool) -> torch.Tensor:
    """Full (K, N) fp32 weight from kgroups codes (the materialising path)."""
    n_groups = scales.shape[0]
    if packed:
        Kh, N = q.shape
        codes = _unpack_int4(q.to(torch.int32).reshape(n_groups, Kh // n_groups, N), dim=1)  # (K/g, g, N)
    else:
        K, N = q.shape
        codes = q.to(torch.int32).reshape(n_groups, K // n_groups, N)
    return (codes.float() * scales[:, None, :]).reshape(-1, q.shape[1])


def quantized_matmul_ref(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *,
                         packed: bool = False) -> torch.Tensor:
    """Plain version: dequantise the whole weight to fp32, multiply in fp32,
    cast to x's dtype."""
    return (x.float() @ _dequantize_kgroups(q, scales, packed)).to(x.dtype)


# The bf16 kernel's tile configurations (csrc/quantized_matmul.cu QCfg): (rows, columns) of x's and
# the output's tile; a configuration's index is what the kernel takes. QMM_MAX_SPLITS bounds the
# slices of K per configuration: the last slice of a tile to finish sums all of them, 16 loads a
# thread at a time, so more slices lengthen the launch's tail.
QMM_TILES = ((16, 128), (64, 128), (128, 128))
QMM_MAX_SPLITS = (16, 16, 4)


def _qmm_plan(M: int, K: int, N: int, n_groups: int, packed: bool, sms: int) -> Tuple[int, int, int]:
    """The bf16 launch plan: ``(cfg, splits, groups_per_split)``.

    The tile grows with M (16 rows at a decode step, 64 up to 64 rows, 128
    beyond). When the output tiles alone leave SMs idle, K is cut into
    ``splits`` slices of ``groups_per_split`` whole groups: at M <= 64 toward
    about two blocks per SM (two fit an SM) and at least one, at larger M
    only when the tiles fill less than half of the SMs (a prefill chunk's
    grid is left whole); never more than ``QMM_MAX_SPLITS``. A count that
    divides the groups evenly is preferred, the one whose grid is closest to
    that target (measured on an H100: uneven last slices and surplus slices
    both cost); otherwise the last slice is shorter. Slices need groups of a
    multiple of 8 code rows (the kernel's 16-byte copies of x)."""
    cfg = 0 if M <= 16 else 1 if M <= 64 else 2
    bm, bn = QMM_TILES[cfg]
    tiles = -(-M // bm) * -(-N // bn)
    gq = (K // 2 if packed else K) // n_groups
    target = 2 * sms if cfg < 2 else (sms if 2 * tiles <= sms else 0)
    if gq % 8 or tiles >= target:
        return cfg, 1, n_groups
    cap = min(QMM_MAX_SPLITS[cfg], n_groups)
    even = [s for s in range(2, cap + 1) if n_groups % s == 0 and tiles * s >= min(target, sms)]
    if even:
        splits = min(even, key=lambda s: abs(tiles * s - target))
        return cfg, splits, n_groups // splits
    want = min(-(-target // tiles), cap)
    per = -(-n_groups // want)
    return cfg, -(-n_groups // per), per


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *, packed: bool = False) -> torch.Tensor:
    """x (M, K) float32 or bfloat16; q int8 (K, N), or (K/2, N) when
    ``packed``; scales fp32 (K/g, N). Returns (M, N) in x's dtype. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel, for
    every M, K, N and group size, or raises. bf16 follows ``_qmm_plan``."""
    if not x.is_cuda:
        return quantized_matmul_ref(x, q, scales, packed=packed)
    if x.dim() != 2 or q.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"quantized_matmul: x, q and scales must be 2D, got {tuple(x.shape)}, {tuple(q.shape)}, "
                         f"{tuple(scales.shape)}")
    M, K = x.shape
    Kq, N = q.shape
    n_groups = scales.shape[0]
    if K != Kq * (2 if packed else 1) or scales.shape[1] != N or n_groups == 0 or K % n_groups:
        raise ValueError(f"quantized_matmul: x {tuple(x.shape)}, q {tuple(q.shape)} (packed={packed}) and scales "
                         f"{tuple(scales.shape)} do not fit")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"quantized_matmul: q must be int8 and scales float32, got {q.dtype} and {scales.dtype}")
    for t, what in ((q, "q"), (scales, "scales")):
        if t.device != x.device:
            raise ValueError(f"quantized_matmul: {what} is on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("quantized_matmul: x, q and scales must be contiguous")
    code = _build.dtype_code(x.dtype)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    cfg, splits, per = 0, 1, n_groups
    ws = counters = None
    if x.dtype == torch.bfloat16 and M > 0 and N > 0:
        cfg, splits, per = _qmm_plan(M, K, N, n_groups, packed, sm_count(x.device))
        if splits > 1:
            bm, bn = QMM_TILES[cfg]
            ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
            counters = tile_counters(x.device, -(-M // bm) * -(-N // bn))
    rc = _build.lib().ds_quantized_matmul(x.data_ptr(), q.data_ptr(), scales.data_ptr(), out.data_ptr(), M, K, N,
                                          n_groups, int(packed), code, cfg, splits, per,
                                          None if ws is None else ws.data_ptr(),
                                          None if counters is None else counters.data_ptr(),
                                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "quantized_matmul")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0  # kernel launches since the last reset (CPU calls do not count)


def quantized_matmul_sharded(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor, *, packed: bool = False,
                             qmm=quantized_matmul) -> torch.Tensor:
    """``quantized_matmul`` on one rank's TP-sharded codes (JAX
    ``quantized_matmul_sharded``, ``quantized_matmul.py:195``). The JAX
    wrapper teaches GSPMD the matmul's algebra and, for K-sharded codes,
    sums the partials over the K axis inside the wrapper; here each rank is
    a process holding its shard, so this is ``qmm`` (the kernel, or its plain
    version) on the rank's columns or K rows. The K partials are not reduced
    here: the row-parallel projections (``o_proj``, ``down_proj``) feed the
    layer's ``tp_all_reduce`` seam, which sums them once."""
    return qmm(x, q, scales, packed=packed)
