"""Paged (block-table) KV-cache attention for ragged serving.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``. Layout as in the
reference: a per-layer pool ``(num_blocks, block_size, KVH, D)``, a
per-row block table mapping (row, page slot) -> pool block, and a flat
slot mapping (token -> block * block_size + offset) for writes.

- ``paged_attention_decode`` (one query token per row) and
  ``paged_attention_prefill`` (a chunk of consecutive positions per row)
  are hand-written CUDA kernels (``csrc/paged_attention.cu``) with plain
  PyTorch versions beside them; a CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises.
- ``paged_attention_ref`` is the gather-based reference, and
  ``paged_attention_mixed`` routes a fused quantum's decode and prefill
  rows exactly as the reference does.

The pools are updated in place (``update_kv_pages``) where the JAX code
donates them. The int8 ``(codes, scales)`` pools and the TP sharding helpers
come with later slices.
"""

import functools
from typing import Callable, Optional, Sequence

import torch

from . import _build

NEG_INF = -1e30


# ------------------------------------------------------------------
# pools
# ------------------------------------------------------------------
def make_kv_pool(shape: Sequence[int], dtype: torch.dtype, device) -> torch.Tensor:
    """Zeroed KV page pool of ``shape`` = (..., bs, KVH, D)."""
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def kv_layer(pool: torch.Tensor, i: int) -> torch.Tensor:
    """Per-layer slice of a stacked (L, ...) pool: a view, so writes land in
    the pool and no write-back (the reference's ``kv_set_layer``) is needed."""
    return pool[i]


def update_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                    slot_mapping: torch.Tensor):
    """Scatter new KV entries into the page pools, in place (the reference
    scatters functionally into donated buffers).

    k_pages/v_pages: (N, bs, KVH, D); k_new/v_new: (T, KVH, D);
    slot_mapping: (T,) flat slot = block_id * bs + offset. Returns the pools.
    """
    n, bs, kvh, d = k_pages.shape
    idx = slot_mapping.to(torch.long)
    k_pages.view(n * bs, kvh, d).index_copy_(0, idx, k_new.to(k_pages.dtype))
    v_pages.view(n * bs, kvh, d).index_copy_(0, idx, v_new.to(v_pages.dtype))
    return k_pages, v_pages


# ------------------------------------------------------------------
# gather-based reference
# ------------------------------------------------------------------
def _gather_attention(q, k_pages, v_pages, block_tables, ctx_lens, q_positions, scale, alibi_slopes, window,
                      zero_empty_rows: bool):
    B, S, H, D = q.shape
    _, bs, KVH, _ = k_pages.shape
    P = block_tables.shape[1]
    G = H // KVH
    scale = scale if scale is not None else D**-0.5
    bt = block_tables.long()
    L = P * bs
    k = k_pages[bt].reshape(B, L, KVH, D).float()
    v = v_pages[bt].reshape(B, L, KVH, D).float()
    qf = q.float().reshape(B, S, KVH, G, D) * scale
    s = torch.einsum("bskgd,blkd->bskgl", qf, k)
    key_pos = torch.arange(L, dtype=torch.int32, device=q.device)[None, None, None, None, :]
    if alibi_slopes is not None:
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device).reshape(KVH, G)
        s = s + sl[None, None, :, :, None] * key_pos.float()
    qpos = q_positions[:, :, None, None, None]
    valid = (key_pos < ctx_lens[:, None, None, None, None]) & (key_pos <= qpos)
    if window is not None:
        valid = valid & (key_pos > qpos - window)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if zero_empty_rows:
        p = p * valid  # a row with no visible key gets no weight at all (zeros out)
    out = torch.einsum("bskgl,blkd->bskgd", p, v)
    return out.reshape(B, S, H, D).to(q.dtype)


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor, block_tables: torch.Tensor,
                        ctx_lens: torch.Tensor, q_positions: torch.Tensor, scale: Optional[float] = None,
                        alibi_slopes=None, window: Optional[int] = None) -> torch.Tensor:
    """Causal attention of q against paged context (the reference's gather path).

    q: (B, S, H, D); block_tables: (B, P); ctx_lens: (B,) total context
    (incl. the S new tokens); q_positions: (B, S) absolute positions.
    ``alibi_slopes``: optional (H,) slopes, bias ``slope_h * key_position``;
    ``window``: sliding-window width. Returns (B, S, H, D).
    """
    return _gather_attention(q, k_pages, v_pages, block_tables, ctx_lens, q_positions, scale, alibi_slopes,
                             window, zero_empty_rows=False)


# ------------------------------------------------------------------
# kernel A: decode
# ------------------------------------------------------------------
def paged_attention_decode_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                               block_tables: torch.Tensor, ctx_lens: torch.Tensor, scale: Optional[float] = None,
                               alibi_slopes=None, window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the decode kernel: q (B, H, D) at position ctx - 1
    against its pages. A row with ctx_len == 0 writes zeros."""
    return _gather_attention(q[:, None], k_pages, v_pages, block_tables, ctx_lens, (ctx_lens - 1)[:, None], scale,
                             alibi_slopes, window, zero_empty_rows=True)[:, 0]


def _check_pools(name, q, k_pages, v_pages, block_tables, ctx_lens, B):
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pools must both be (N, bs, KVH, D), got {tuple(k_pages.shape)} and "
                         f"{tuple(v_pages.shape)}")
    for t, what in ((k_pages, "k_pages"), (v_pages, "v_pages"), (block_tables, "block_tables"),
                    (ctx_lens, "ctx_lens")):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise ValueError(f"{name}: pools are {k_pages.dtype}/{v_pages.dtype}, q is {q.dtype}")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise ValueError(f"{name}: block_tables and ctx_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(ctx_lens.shape) != (B,):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} / ctx_lens {tuple(ctx_lens.shape)} "
                         f"do not match {B} rows")


def paged_attention_decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_tables: torch.Tensor, ctx_lens: torch.Tensor, scale: Optional[float] = None,
                           alibi_slopes=None, window: Optional[int] = None) -> torch.Tensor:
    """One-token-per-row paged attention. q: (B, H, D); pools (N, bs, KVH, D);
    block_tables (B, P) int32; ctx_lens (B,) int32. Returns (B, H, D).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (float32 or bfloat16, D in {64, 128}, H / KVH <= 8) or raises; ALiBi and
    the sliding window are not in the kernel yet."""
    if not q.is_cuda:
        return paged_attention_decode_ref(q, k_pages, v_pages, block_tables, ctx_lens, scale, alibi_slopes, window)
    if alibi_slopes is not None or window is not None:
        raise NotImplementedError("paged_attention_decode: ALiBi and sliding window are not in the CUDA kernel")
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"paged_attention_decode: q must be contiguous (B, H, D), got {tuple(q.shape)}")
    B, H, D = q.shape
    _check_pools("paged_attention_decode", q, k_pages, v_pages, block_tables, ctx_lens, B)
    _, bs, KVH, Dk = k_pages.shape
    if Dk != D or H % KVH:
        raise ValueError(f"paged_attention_decode: q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    scale = scale if scale is not None else D**-0.5
    out = torch.empty_like(q)
    rc = _build.lib().ds_paged_attention_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(), ctx_lens.data_ptr(),
        out.data_ptr(), B, H, KVH, D, bs, block_tables.shape[1], float(scale), _build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0  # kernel launches since the last reset (CPU calls do not count)


# ------------------------------------------------------------------
# kernel B: chunked prefill
# ------------------------------------------------------------------
def paged_attention_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                                block_tables: torch.Tensor, ctx_lens: torch.Tensor, q_positions: torch.Tensor,
                                scale: Optional[float] = None, alibi_slopes=None,
                                window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the prefill kernel: q (B, S, H, D) at q_positions
    (B, S) against the paged context. A query that sees no key writes zeros."""
    return _gather_attention(q, k_pages, v_pages, block_tables, ctx_lens, q_positions, scale, alibi_slopes, window,
                             zero_empty_rows=True)


def paged_attention_prefill(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                            block_tables: torch.Tensor, ctx_lens: torch.Tensor, q_positions: torch.Tensor,
                            scale: Optional[float] = None, alibi_slopes=None,
                            window: Optional[int] = None) -> torch.Tensor:
    """Chunked-prefill attention of a query block against the paged context.

    q: (B, S, H, D); q_positions: (B, S) absolute and consecutive per row
    (the kernel reads row 0's position); ctx_lens (B,) counts the new
    tokens too. Returns (B, S, H, D). Any S: the kernel tiles the queries,
    so there is no size limit and no gather fallback on the card. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (float32 or bfloat16, D in {64, 128}) or raises."""
    if not q.is_cuda:
        return paged_attention_prefill_ref(q, k_pages, v_pages, block_tables, ctx_lens, q_positions, scale,
                                           alibi_slopes, window)
    if alibi_slopes is not None or window is not None:
        raise NotImplementedError("paged_attention_prefill: ALiBi and sliding window are not in the CUDA kernel")
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"paged_attention_prefill: q must be contiguous (B, S, H, D), got {tuple(q.shape)}")
    B, S, H, D = q.shape
    _check_pools("paged_attention_prefill", q, k_pages, v_pages, block_tables, ctx_lens, B)
    if tuple(q_positions.shape) != (B, S) or not q_positions.is_cuda:
        raise ValueError(f"paged_attention_prefill: q_positions {tuple(q_positions.shape)} on "
                         f"{q_positions.device} does not fit q {tuple(q.shape)}")
    _, bs, KVH, Dk = k_pages.shape
    if Dk != D or H % KVH:
        raise ValueError(f"paged_attention_prefill: q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    scale = scale if scale is not None else D**-0.5
    qpos0 = q_positions[:, 0].to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _build.lib().ds_paged_attention_prefill(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(), ctx_lens.data_ptr(),
        qpos0.data_ptr(), out.data_ptr(), B, S, H, KVH, D, bs, block_tables.shape[1], float(scale),
        _build.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_attention_prefill")
    paged_attention_prefill.launches += 1
    return out


paged_attention_prefill.launches = 0  # kernel launches since the last reset (CPU calls do not count)


# ------------------------------------------------------------------
# mixed decode + prefill dispatch (SplitFuse fused step)
# ------------------------------------------------------------------
def paged_attention_mixed(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_tables: torch.Tensor, ctx_lens: torch.Tensor, q_positions: torch.Tensor, *,
                          n_dec: int, chunk: int, scale: Optional[float] = None, alibi_slopes=None,
                          window: Optional[int] = None, decode_fn: Optional[Callable] = None,
                          prefill_fn: Optional[Callable] = None) -> torch.Tensor:
    """Serve decode rows and chunked-prefill rows of one quantum.

    q: (T, H, D) flat query tokens: rows [0, n_dec) are single-token decode
    rows, the remainder is the (n_pre, chunk) prefill segment, row-major.
    block_tables/ctx_lens are per ROW (decode rows first); q_positions: (T,).
    One decode launch covers everything when either segment is empty or
    when ``chunk == 1`` (a one-token chunk queries at ctx - 1, which is the
    decode contract); otherwise the decode and prefill functions run back
    to back. ``decode_fn``/``prefill_fn`` take (q, k_pages, v_pages,
    block_tables, ctx_lens[, q_positions]); they default to the kernel
    wrappers with ``scale``, ``alibi_slopes`` and ``window`` bound.
    Returns (T, H, D).
    """
    if decode_fn is None:
        decode_fn = functools.partial(paged_attention_decode, scale=scale, alibi_slopes=alibi_slopes, window=window)
    if prefill_fn is None:
        prefill_fn = functools.partial(paged_attention_prefill, scale=scale, alibi_slopes=alibi_slopes,
                                       window=window)
    T, H, D = q.shape
    n_pre = (T - n_dec) // chunk if chunk else 0
    if n_pre == 0 or chunk == 1:
        return decode_fn(q, k_pages, v_pages, block_tables, ctx_lens)
    if n_dec == 0:
        qp = q.reshape(n_pre, chunk, H, D)
        return prefill_fn(qp, k_pages, v_pages, block_tables, ctx_lens,
                          q_positions.reshape(n_pre, chunk)).reshape(T, H, D)
    o_dec = decode_fn(q[:n_dec].contiguous(), k_pages, v_pages, block_tables[:n_dec], ctx_lens[:n_dec])
    qp = q[n_dec:].reshape(n_pre, chunk, H, D)
    o_pre = prefill_fn(qp, k_pages, v_pages, block_tables[n_dec:], ctx_lens[n_dec:],
                       q_positions[n_dec:].reshape(n_pre, chunk))
    return torch.cat([o_dec, o_pre.reshape(n_pre * chunk, H, D)], dim=0)
