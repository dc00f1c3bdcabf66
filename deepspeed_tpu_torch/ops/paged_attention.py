"""Paged (block-table) KV-cache attention for ragged serving.

Port of ``deepspeed_tpu/ops/pallas/paged_attention.py``. Layout as in the
reference: a per-layer pool ``(num_blocks, block_size, KVH, D)``, a
per-row block table mapping (row, page slot) -> pool block, and a flat
slot mapping (token -> block * block_size + offset) for writes.

- ``paged_attention_decode`` (one query token per row) and
  ``paged_attention_prefill`` (a chunk of consecutive positions per row)
  are hand-written CUDA kernels with plain PyTorch versions beside them; a
  CPU tensor takes the plain version, a CUDA tensor launches the kernel or
  raises. ``csrc/paged_attention.cu`` holds the entry points and the
  float32 bodies; a bf16 q goes to ``csrc/paged_decode.cu`` (the context
  split across blocks, then a fixed-order combine) and
  ``csrc/paged_prefill.cu`` (tensor-core tiles). Every body takes ALiBi
  slopes and a sliding window.
- ``_decode_plan`` and ``_prefill_plan`` give the bf16 launches their split
  counts from shapes and the SM count alone, never from ``ctx_lens``: the
  launches need no device-to-host sync.
- The kernels take D in ``KERNEL_HEAD_DIMS`` (64, 80, 96, 128, 256: phi-2,
  phi-3-mini and gpt-neox-20b, gemma and gpt-j beside the llama family)
  and any group of query heads a KV head (decode: chunks of 8 heads a
  block; prefill: the group's rows packed 64 to a block); another D raises
  on the card. The plain versions take any D and group.
- ``paged_attention_ref`` is the gather-based reference, and
  ``paged_attention_mixed`` routes a fused quantum's decode and prefill
  rows exactly as the reference does.

int8 paged KV (``kv_quant_bits=8``): a pool is the pair ``(codes int8
(N, bs, KVH, D), scales fp32 (N, bs, KVH))``: one symmetric scale per slot
and KV head. The scale is per *slot* rather than per block so that
quantise-on-append stays local: writing a slot rewrites its own scale and
never re-quantises its neighbours. Every function below takes either
representation; the CUDA kernels multiply by the scales next to their
products.

The pools are updated in place (``update_kv_pages``) where the JAX code
donates them. Under tensor-parallel serving a rank's pool holds KVH / tp of
the KV heads of every global block (``shard_kv_pool``): the kernels read
KVH off the arrays and need no TP awareness.
"""

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from ..device import sm_count
from . import _build

NEG_INF = -1e30


# ------------------------------------------------------------------
# pools
# ------------------------------------------------------------------
KVPool = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]  # pages, or (int8 codes, fp32 scales)


def kv_pool_is_quantized(pool: KVPool) -> bool:
    """True when ``pool`` is the int8 ``(codes, scales)`` pair."""
    return isinstance(pool, tuple)


def kv_pool_shape(pool: KVPool) -> Tuple[int, ...]:
    """(..., bs, KVH, D) of a pool, plain tensor or ``(codes, scales)``."""
    return tuple((pool[0] if isinstance(pool, tuple) else pool).shape)


def make_kv_pool(shape: Sequence[int], dtype: torch.dtype, device, kv_quant_bits: int = 0) -> KVPool:
    """Zeroed KV page pool of ``shape`` = (..., bs, KVH, D): a plain tensor,
    or at ``kv_quant_bits=8`` the ``(int8 codes, fp32 scales)`` pair with
    per-slot-per-head scale planes ``shape[:-1]``."""
    shape = tuple(shape)
    if kv_quant_bits == 8:
        return (torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    if kv_quant_bits:
        raise ValueError(f"kv_quant_bits must be 0 or 8, got {kv_quant_bits}")
    return torch.zeros(shape, dtype=dtype, device=device)


def kv_pool_shard_shape(shape: Sequence[int], tp: int) -> Tuple[int, ...]:
    """A rank's pool shape under tensor-parallel serving: KVH / tp heads of
    every block (JAX ``kv_pool_shard_spec``: the KVH axis on ``tensor``)."""
    shape = tuple(shape)
    if shape[-2] % tp:
        raise ValueError(f"{shape[-2]} KV heads do not split over tensor_parallel={tp}")
    return shape[:-2] + (shape[-2] // tp, shape[-1])


def shard_kv_pool(pool: KVPool, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of a whole pool: KVH / tp heads of every global
    block (JAX ``shard_kv_pool``; the engine allocates its slice directly,
    ``kv_pool_shard_shape``). An int8 ``(codes, scales)`` pool raises, as in
    the JAX package."""
    if isinstance(pool, tuple):
        raise NotImplementedError("int8 KV pools do not shard over the tensor axis yet")
    kvh = kv_pool_shard_shape(pool.shape, tp)[-2]
    return pool.narrow(-2, rank * kvh, kvh).contiguous()


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(slot, kv-head) int8: (..., KVH, D) -> codes of the same
    shape + fp32 scales (..., KVH). All-zero rows keep scale 1.0, so they
    dequantise exactly too."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scales = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    codes = torch.clamp(torch.round(xf / scales[..., None]), -128, 127).to(torch.int8)
    return codes, scales


def dequantize_kv(pool: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """fp32 view of an int8 ``(codes, scales)`` pool (oracle and debug path)."""
    codes, scales = pool
    return codes.float() * scales[..., None]


def kv_layer(pool: KVPool, i: int) -> KVPool:
    """Per-layer slice of a stacked (L, ...) pool, plain or quantised: views,
    so writes land in the pool and no write-back (the reference's
    ``kv_set_layer``) is needed."""
    if isinstance(pool, tuple):
        return tuple(p[i] for p in pool)
    return pool[i]


def update_kv_pages(k_pages: KVPool, v_pages: KVPool, k_new: torch.Tensor, v_new: torch.Tensor,
                    slot_mapping: torch.Tensor):
    """Scatter new KV entries into the page pools, in place (the reference
    scatters functionally into donated buffers).

    k_pages/v_pages: (N, bs, KVH, D), or the ``(codes, scales)`` pair, in
    which case the new entries are quantised on append and their codes and
    scales are both written; k_new/v_new: (T, KVH, D); slot_mapping: (T,)
    flat slot = block_id * bs + offset. Returns the pools.
    """
    idx = slot_mapping.to(torch.long)
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        if isinstance(pages, tuple):
            codes, scales = pages
            n, bs, kvh, d = codes.shape
            new_q, new_s = quantize_kv(new)
            codes.view(n * bs, kvh, d).index_copy_(0, idx, new_q)
            scales.view(n * bs, kvh).index_copy_(0, idx, new_s)
        else:
            n, bs, kvh, d = pages.shape
            pages.view(n * bs, kvh, d).index_copy_(0, idx, new.to(pages.dtype))
    return k_pages, v_pages


# ------------------------------------------------------------------
# gather-based reference
# ------------------------------------------------------------------
def _gather_attention(q, k_pages, v_pages, block_tables, ctx_lens, q_positions, scale, alibi_slopes, window,
                      zero_empty_rows: bool):
    B, S, H, D = q.shape
    _, bs, KVH, _ = kv_pool_shape(k_pages)
    P = block_tables.shape[1]
    G = H // KVH
    scale = scale if scale is not None else D**-0.5
    bt = block_tables.long()
    L = P * bs

    def gather(pages):
        if isinstance(pages, tuple):  # codes and scale planes of the live pages only, then dequantise
            codes, scales = pages
            return codes[bt].reshape(B, L, KVH, D).float() * scales[bt].reshape(B, L, KVH)[..., None]
        return pages[bt].reshape(B, L, KVH, D).float()

    k, v = gather(k_pages), gather(v_pages)
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


def paged_attention_ref(q: torch.Tensor, k_pages: KVPool, v_pages: KVPool, block_tables: torch.Tensor,
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
def paged_attention_decode_ref(q: torch.Tensor, k_pages: KVPool, v_pages: KVPool,
                               block_tables: torch.Tensor, ctx_lens: torch.Tensor, scale: Optional[float] = None,
                               alibi_slopes=None, window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the decode kernel: q (B, H, D) at position ctx - 1
    against its pages. A row with ctx_len == 0 writes zeros."""
    return _gather_attention(q[:, None], k_pages, v_pages, block_tables, ctx_lens, (ctx_lens - 1)[:, None], scale,
                             alibi_slopes, window, zero_empty_rows=True)[:, 0]


def _check_pools(name, q, k_pages, v_pages, block_tables, ctx_lens, B):
    """Validate the operands of a kernel launch; returns (k, v, k_scales, v_scales)
    with the scale planes None for unquantised pools."""
    if kv_pool_is_quantized(k_pages) != kv_pool_is_quantized(v_pages):
        raise ValueError(f"{name}: one pool is int8 (codes, scales) and the other is not")
    quantized = kv_pool_is_quantized(k_pages)
    (k, ks), (v, vs) = (k_pages, v_pages) if quantized else ((k_pages, None), (v_pages, None))
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: pools must both be (N, bs, KVH, D), got {tuple(k.shape)} and {tuple(v.shape)}")
    named = [(k, "k_pages"), (v, "v_pages"), (block_tables, "block_tables"), (ctx_lens, "ctx_lens")]
    if quantized:
        named += [(ks, "k scales"), (vs, "v scales")]
    for t, what in named:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name}: {what} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if quantized:
        if k.dtype != torch.int8 or v.dtype != torch.int8 or ks.dtype != torch.float32 or vs.dtype != torch.float32:
            raise ValueError(f"{name}: an int8 pool is (int8 codes, float32 scales), got {k.dtype}/{ks.dtype} and "
                             f"{v.dtype}/{vs.dtype}")
        if ks.shape != k.shape[:-1] or vs.shape != v.shape[:-1]:
            raise ValueError(f"{name}: scale planes {tuple(ks.shape)}/{tuple(vs.shape)} do not fit codes "
                             f"{tuple(k.shape)}")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: pools are {k.dtype}/{v.dtype}, q is {q.dtype}")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise ValueError(f"{name}: block_tables and ctx_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(ctx_lens.shape) != (B,):
        raise ValueError(f"{name}: block_tables {tuple(block_tables.shape)} / ctx_lens {tuple(ctx_lens.shape)} "
                         f"do not match {B} rows")
    return k, v, ks, vs


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# The bf16 launch plans (csrc/paged_decode.cu, csrc/paged_prefill.cu).
# The constants are paged_probe.py's best on an H100 SXM (PERF.md).
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)  # the head dims the CUDA bodies are built for
DECODE_HEADS = 8               # query heads a decode block holds; a larger group takes ceil(G / 8) blocks
TILE_KEYS = 64                 # keys of a prefill tile; decode splits are whole multiples of it
DECODE_BLOCKS_PER_SM = 32      # decode's grid aims at this many blocks an SM; splits past ctx exit at once
DECODE_MIN_SPLIT_KEYS = 256    # a decode split walks at least this many keys
PREFILL_ROWS = 64              # score rows (query positions x heads of a KV head) of a prefill block
PREFILL_BLOCKS_PER_SM = 1      # a split prefill grid aims at about one block an SM


def _decode_plan(B: int, KVH: int, P: int, bs: int, sms: int) -> Tuple[int, int]:
    """The bf16 decode's ``(splits, split_keys)``: split j covers key
    positions [j split_keys, (j + 1) split_keys) of a row's P bs slots, so
    the splits cover them with no gap and no empty tail. From host-known
    values only: the grid (splits, KVH, B) aims at ``DECODE_BLOCKS_PER_SM``
    blocks an SM (the longest context is unknown, and a split past a row's
    ctx exits at once), with at least ``DECODE_MIN_SPLIT_KEYS`` keys a split.
    ``KVH`` counts the grid's (KV head, chunk of ``DECODE_HEADS`` heads)
    pairs when a group is larger than 8."""
    L = P * bs
    want = -(-DECODE_BLOCKS_PER_SM * sms // max(1, B * KVH))
    splits = max(1, min(want, -(-L // DECODE_MIN_SPLIT_KEYS)))
    per = -(-L // splits)
    keys = -(-per // TILE_KEYS) * TILE_KEYS
    return -(-L // keys), keys


def _prefill_plan(B: int, S: int, H: int, KVH: int, P: int, bs: int, sms: int) -> int:
    """The bf16 prefill's split count: 1 unless its blocks (``PREFILL_ROWS``
    score rows of one KV head each) are fewer than the SMs; then each
    block's key tiles are dealt round-robin to splits, toward
    ``PREFILL_BLOCKS_PER_SM`` blocks an SM, never more splits than tiles."""
    blocks = -(-S * (H // KVH) // PREFILL_ROWS) * B * KVH
    if blocks >= sms:
        return 1
    return max(1, min(-(-PREFILL_BLOCKS_PER_SM * sms // blocks), -(-P * bs // TILE_KEYS)))


_SLOPES: Dict[tuple, torch.Tensor] = {}  # (device, slopes) -> the fp32 slopes on that device


def _features(name: str, alibi_slopes, window, H: int, device: torch.device):
    """The kernels' ALiBi slopes (an fp32 (H,) tensor on ``device``, or None;
    copied there once per distinct set of slopes) and window (0: none)."""
    win = int(window or 0)
    if win < 0:
        raise ValueError(f"{name}: the window must not be negative, got {window}")
    if alibi_slopes is None:
        return None, win
    if isinstance(alibi_slopes, torch.Tensor) and alibi_slopes.device == device:
        slopes = alibi_slopes.reshape(-1).to(torch.float32).contiguous()
    else:
        values = tuple(torch.as_tensor(alibi_slopes, dtype=torch.float32).reshape(-1).cpu().tolist())
        key = (device, values)
        if key not in _SLOPES:
            _SLOPES[key] = torch.tensor(values, dtype=torch.float32, device=device)
        slopes = _SLOPES[key]
    if slopes.numel() != H:
        raise ValueError(f"{name}: {slopes.numel()} ALiBi slopes for {H} heads")
    return slopes, win


def paged_attention_decode(q: torch.Tensor, k_pages: KVPool, v_pages: KVPool,
                           block_tables: torch.Tensor, ctx_lens: torch.Tensor, scale: Optional[float] = None,
                           alibi_slopes=None, window: Optional[int] = None) -> torch.Tensor:
    """One-token-per-row paged attention. q: (B, H, D); pools (N, bs, KVH, D)
    of q's dtype, or int8 ``(codes, scales)`` pairs; block_tables (B, P)
    int32; ctx_lens (B,) int32. Returns (B, H, D).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (float32 or bfloat16, D in ``KERNEL_HEAD_DIMS``, any H / KVH, with or
    without ALiBi ``alibi_slopes`` (H,) and a sliding ``window``) or raises.
    bf16 splits each row's context as ``_decode_plan`` says."""
    if not q.is_cuda:
        return paged_attention_decode_ref(q, k_pages, v_pages, block_tables, ctx_lens, scale, alibi_slopes, window)
    if q.dim() != 3 or not q.is_contiguous():
        raise ValueError(f"paged_attention_decode: q must be contiguous (B, H, D), got {tuple(q.shape)}")
    B, H, D = q.shape
    k, v, ks, vs = _check_pools("paged_attention_decode", q, k_pages, v_pages, block_tables, ctx_lens, B)
    _, bs, KVH, Dk = k.shape
    if Dk != D or H % KVH:
        raise ValueError(f"paged_attention_decode: q {tuple(q.shape)} does not fit pools {tuple(k.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"paged_attention_decode: the CUDA kernels take head dims {KERNEL_HEAD_DIMS}, "
                                  f"not {D}")
    scale = scale if scale is not None else D**-0.5
    slopes, win = _features("paged_attention_decode", alibi_slopes, window, H, q.device)
    P = block_tables.shape[1]
    chunks = KVH * -(-(H // KVH) // DECODE_HEADS)  # the grid's (KV head, chunk of heads) pairs
    splits, split_keys = _decode_plan(B, chunks, P, bs, sm_count(q.device)) if q.dtype == torch.bfloat16 \
        else (1, P * bs)
    ws = torch.empty(B * H * splits * (D + 2), dtype=torch.float32, device=q.device) if splits > 1 else None
    out = torch.empty_like(q)
    rc = _build.lib().ds_paged_attention_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), block_tables.data_ptr(), ctx_lens.data_ptr(),
        _ptr(slopes), out.data_ptr(), _ptr(ws), B, H, KVH, D, bs, P, win, splits, split_keys, float(scale),
        _build.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_attention_decode")
    paged_attention_decode.launches += 1
    return out


paged_attention_decode.launches = 0  # kernel launches since the last reset (CPU calls do not count)


# ------------------------------------------------------------------
# kernel B: chunked prefill
# ------------------------------------------------------------------
def paged_attention_prefill_ref(q: torch.Tensor, k_pages: KVPool, v_pages: KVPool,
                                block_tables: torch.Tensor, ctx_lens: torch.Tensor, q_positions: torch.Tensor,
                                scale: Optional[float] = None, alibi_slopes=None,
                                window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the prefill kernel: q (B, S, H, D) at q_positions
    (B, S) against the paged context. A query that sees no key writes zeros."""
    return _gather_attention(q, k_pages, v_pages, block_tables, ctx_lens, q_positions, scale, alibi_slopes, window,
                             zero_empty_rows=True)


def paged_attention_prefill(q: torch.Tensor, k_pages: KVPool, v_pages: KVPool,
                            block_tables: torch.Tensor, ctx_lens: torch.Tensor, q_positions: torch.Tensor,
                            scale: Optional[float] = None, alibi_slopes=None,
                            window: Optional[int] = None) -> torch.Tensor:
    """Chunked-prefill attention of a query block against the paged context.

    q: (B, S, H, D); q_positions: (B, S) absolute and consecutive per row
    (the kernel reads row 0's position); ctx_lens (B,) counts the new
    tokens too; the pools are of q's dtype or int8 ``(codes, scales)``
    pairs. Returns (B, S, H, D). Any S: the kernel tiles the queries,
    so there is no size limit and no gather fallback on the card. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (float32 or bfloat16, D in ``KERNEL_HEAD_DIMS``, any H / KVH, with or
    without ALiBi and a sliding window) or raises. bf16 splits the keys of a small
    chunk as ``_prefill_plan`` says."""
    if not q.is_cuda:
        return paged_attention_prefill_ref(q, k_pages, v_pages, block_tables, ctx_lens, q_positions, scale,
                                           alibi_slopes, window)
    if q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"paged_attention_prefill: q must be contiguous (B, S, H, D), got {tuple(q.shape)}")
    B, S, H, D = q.shape
    k, v, ks, vs = _check_pools("paged_attention_prefill", q, k_pages, v_pages, block_tables, ctx_lens, B)
    if tuple(q_positions.shape) != (B, S) or not q_positions.is_cuda:
        raise ValueError(f"paged_attention_prefill: q_positions {tuple(q_positions.shape)} on "
                         f"{q_positions.device} does not fit q {tuple(q.shape)}")
    _, bs, KVH, Dk = k.shape
    if Dk != D or H % KVH:
        raise ValueError(f"paged_attention_prefill: q {tuple(q.shape)} does not fit pools {tuple(k.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(f"paged_attention_prefill: the CUDA kernels take head dims {KERNEL_HEAD_DIMS}, "
                                  f"not {D}")
    scale = scale if scale is not None else D**-0.5
    slopes, win = _features("paged_attention_prefill", alibi_slopes, window, H, q.device)
    P = block_tables.shape[1]
    splits = _prefill_plan(B, S, H, KVH, P, bs, sm_count(q.device)) if q.dtype == torch.bfloat16 else 1
    ws = torch.empty(B * S * H * splits * (D + 2), dtype=torch.float32, device=q.device) if splits > 1 else None
    qpos0 = q_positions[:, 0].to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _build.lib().ds_paged_attention_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), block_tables.data_ptr(), ctx_lens.data_ptr(),
        qpos0.data_ptr(), _ptr(slopes), out.data_ptr(), _ptr(ws), B, S, H, KVH, D, bs, P, win, splits,
        float(scale), _build.dtype_code(q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_attention_prefill")
    paged_attention_prefill.launches += 1
    return out


paged_attention_prefill.launches = 0  # kernel launches since the last reset (CPU calls do not count)


# ------------------------------------------------------------------
# mixed decode + prefill dispatch (SplitFuse fused step)
# ------------------------------------------------------------------
def paged_attention_mixed(q: torch.Tensor, k_pages: KVPool, v_pages: KVPool,
                          block_tables: torch.Tensor, ctx_lens: torch.Tensor, q_positions: torch.Tensor, *,
                          n_dec: int, chunk: int, scale: Optional[float] = None, alibi_slopes=None,
                          window: Optional[int] = None, decode_fn: Optional[Callable] = None,
                          prefill_fn: Optional[Callable] = None) -> torch.Tensor:
    """Serve decode rows and chunked-prefill rows of one quantum.

    q: (T, H, D) flat query tokens: rows [0, n_dec) are single-token decode
    rows, the remainder is the (n_pre, chunk) prefill segment, row-major.
    block_tables/ctx_lens are per ROW (decode rows first); q_positions: (T,).
    The pools pass through unchanged, plain or int8 ``(codes, scales)``.
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
