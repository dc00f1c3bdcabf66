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
the offsets itself, and its launch follows ``gemm_plan``, which depends only
on R, K, N, E and the card's SM count, so every routing replays one graph.

A CPU tensor takes the plain version (``moe_grouped_gemm_ref``: a loop over
the experts with host sizes, fp32 products cast to x's dtype); a CUDA tensor
launches the kernel or raises.
"""

from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from ._utils import tile_counters
from ..device import sm_count

# The bf16 body (csrc/moe_grouped_gemm.cu gg_wgmma_kernel): tile rows (wgmma's N side, one kernel each), weight
# columns a tile (64 for each of the two consumer warpgroups), the k depth of a TMA box (one ring stage), and
# the most slices a split K takes
GEMM_TILE_ROWS = (16, 32, 64, 128, 256)
GEMM_TILE_COLS = 128
GEMM_BOX_K = 64
GEMM_MAX_SPLITS = 8
FP32_TILE = 64  # the fp32 body's tile rows and columns (gg_fp32_kernel)


class GemmPlan(NamedTuple):
    """One launch of the kernel: ``rows`` x ``cols`` output tiles, the grid
    of tiles any routing can need (row-tile slots, column tiles, split), K
    cut into ``split`` slices of ``steps`` boxes of ``GEMM_BOX_K`` (the last
    may be shorter, none is empty) when the routing gives fewer than
    ``split_below`` tiles (else one slice takes all of K), and the fp32
    workspace of the split's partials in bytes (0 unsplit)."""
    rows: int
    cols: int
    split: int
    steps: int
    split_below: int
    grid: Tuple[int, int, int]
    ws_bytes: int


def gemm_plan(R: int, K: int, N: int, E: int, dtype: torch.dtype, sms: int, rows: Optional[int] = None,
              split: Optional[int] = None) -> GemmPlan:
    """The launch for x (R, K), w (E, K, N), from host shapes only: no
    routing reaches it, so one graph serves them all. ``rows`` and ``split``
    force a choice (tests and the sweep in ``chip_smoke.py``).

    bf16: the tile's rows are the smallest of ``GEMM_TILE_ROWS`` that hold
    twice an expert's mean rows (16 at the serve's 16-row decode step, 32 at
    128 rows, 256 from about 1,000), so most groups take one tile (the kernel
    trims each tile's MMA to its own rows). The ``ceil(R / rows) + E``
    row-tile slots cover any routing (a group of s rows takes
    ``ceil(s / rows)`` tiles). K is split when the fewest tiles any routing
    can give (every row on one expert) leave SMs idle: into slices of whole
    boxes toward one tile an SM, at most ``GEMM_MAX_SPLITS``; the kernel
    takes the slices only when the routing's own tiles are fewer than the
    SMs (``split_below``), since a split costs a few percent at a decode
    step's usual routing. A forced split always splits. fp32 takes 64 x 64
    tiles and never splits."""
    if dtype == torch.float32:
        grid = (-(-R // FP32_TILE) + E, -(-N // FP32_TILE), 1)
        return GemmPlan(FP32_TILE, FP32_TILE, 1, -(-K // GEMM_BOX_K), 0, grid, 0)
    if rows is None:
        rows = next((t for t in GEMM_TILE_ROWS if t >= 2 * -(-R // E)), GEMM_TILE_ROWS[-1])
    row_tiles, col_tiles, nk = -(-R // rows), -(-N // GEMM_TILE_COLS), max(1, -(-K // GEMM_BOX_K))
    split_below = 2**31 - 1 if split is not None else sms
    if split is None:
        fewest = row_tiles * col_tiles
        split = 1 if fewest >= sms else min(GEMM_MAX_SPLITS, -(-sms // fewest))
    steps = -(-nk // max(1, min(split, nk)))
    split = -(-nk // steps)
    return GemmPlan(rows, GEMM_TILE_COLS, split, steps, split_below if split > 1 else 0,
                    (row_tiles + E, col_tiles, split), 4 * split * R * N if split > 1 else 0)


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


def moe_grouped_gemm(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                     plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """x (R, K) and w (E, K, N) float32 or bfloat16 of one dtype; offsets
    (E + 1,) int32. Returns (R, N) in x's dtype. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (bf16 needs K and N multiples
    of 8) with ``plan`` (default ``gemm_plan``'s) or raises. The launch never
    reads the offsets on the host."""
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
    if K == 0:  # empty sums: every row is zero, as in the plain version
        return out.zero_()
    if plan is None:
        plan = gemm_plan(R, K, N, E, x.dtype, sm_count(x.device))
    ws = counters = None
    if plan.split > 1:
        ws = torch.empty(plan.ws_bytes // 4, dtype=torch.float32, device=x.device)
        counters = tile_counters(x.device, plan.grid[0] * plan.grid[1])
    rc = _build.lib().ds_moe_grouped_gemm(x.data_ptr(), w.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                                          None if ws is None else ws.data_ptr(),
                                          None if counters is None else counters.data_ptr(), R, K, N, E, plan.rows,
                                          plan.split, plan.steps, plan.split_below, code,
                                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "moe_grouped_gemm")
    moe_grouped_gemm.launches += 1
    return out


moe_grouped_gemm.launches = 0  # kernel launches since the last reset (CPU calls do not count)
