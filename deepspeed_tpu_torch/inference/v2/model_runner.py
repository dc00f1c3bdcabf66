"""Ragged forward passes over the parameter tree, on the paged KV pool.

Port of ``deepspeed_tpu/inference/v2/model_runner.py`` for one device:
``_transformer_layer``, the layer stack, ``ragged_forward`` (a (B, S) batch
in one mode), ``fused_forward`` (the SplitFuse mixed decode + prefill pass)
and ``make_fused_step_fn`` (one quantum: the fused pass, then ``steps - 1``
decode steps of the burst). PyTorch runs eagerly, so ``jit`` has no
counterpart and the reference's ``lax.scan`` over burst steps is a Python
loop. The KV pools are updated in place where the JAX programs donate them.

The attention, norm and quantised-matmul kernels come from a ``V2Modules``
bundle (``modules.build_modules``); passing ``build_modules(plain=True)``
runs the same step on the kernels' plain PyTorch versions. The KV pools are
plain tensors or int8 ``(codes, scales)`` pairs. Tensor parallelism,
speculative verify and the unfused step/burst programs come with later
slices.
"""

import functools
from typing import Callable, Dict, Optional

import torch

from ...models.transformer import TransformerConfig, _is_moe_layer, alibi_slopes, apply_rope, device_rope_tables
from ...ops.paged_attention import KVPool, kv_layer, paged_attention_mixed, update_kv_pages
from ..generation import sample_logits
from .modules import V2Modules, _norm_p, _proj, build_modules


def _attn_fn_builder(cfg: TransformerConfig, mods: V2Modules) -> Callable:
    """window -> (decode_attn, prefill_attn): one bound pair per
    distinct per-layer window value, shared by the ragged and fused
    forwards. Unlike the reference's interpret mode, prefill always gets its
    kernel: there is no gather fallback on the card."""
    slopes = alibi_slopes(cfg.n_heads) if cfg.pos_emb == "alibi" else None
    fns: Dict[Optional[int], tuple] = {}

    def attn_fns(window):
        if window not in fns:
            decode = functools.partial(mods.decode_attn, scale=cfg.attn_scale, alibi_slopes=slopes, window=window)
            prefill = functools.partial(mods.prefill_attn, scale=cfg.attn_scale, alibi_slopes=slopes,
                                        window=window)
            fns[window] = (decode, prefill)
        return fns[window]

    return attn_fns


def _transformer_layer(cfg: TransformerConfig, lp: Dict, x: torch.Tensor, k_pages_i: KVPool,
                       v_pages_i: KVPool, slot_mapping: torch.Tensor, cos, sin, positions: torch.Tensor,
                       attn_apply: Callable, mods: V2Modules):
    """One transformer block over (B, S) tokens against this layer's page
    pool: qkv + rope + KV page write (in place) + ``attn_apply(q, kp, vp)`` +
    FFN. Returns the block's output."""
    B, S = x.shape[:2]
    dtype = cfg.dtype
    h = mods.norm(cfg, _norm_p(cfg, lp, 0), x)
    qmm = mods.quantized_matmul
    q = _proj(h, lp["attn"]["q_proj"], "bsd,dhk->bshk", dtype, qmm)
    k = _proj(h, lp["attn"]["k_proj"], "bsd,dhk->bshk", dtype, qmm)
    v = _proj(h, lp["attn"]["v_proj"], "bsd,dhk->bshk", dtype, qmm)
    if cfg.clip_qkv is not None:  # olmo: clamp projections before rope
        q, k, v = (t.clamp(-cfg.clip_qkv, cfg.clip_qkv) for t in (q, k, v))
    if cfg.qk_norm:  # qwen3: per-head rms before rope
        q = mods.rms_norm(q.contiguous(), lp["attn"]["q_norm"]["scale"], cfg.norm_eps).to(dtype)
        k = mods.rms_norm(k.contiguous(), lp["attn"]["k_norm"]["scale"], cfg.norm_eps).to(dtype)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, cos, sin, positions, rotary_dim=cfg.rotary_dim, style=cfg.rope_style)
        k = apply_rope(k, cos, sin, positions, rotary_dim=cfg.rotary_dim, style=cfg.rope_style)

    KVH, D = k.shape[-2], k.shape[-1]
    update_kv_pages(k_pages_i, v_pages_i, k.reshape(B * S, KVH, D), v.reshape(B * S, KVH, D), slot_mapping)

    attn = attn_apply(q.contiguous(), k_pages_i, v_pages_i)
    attn_out = _proj(attn, lp["attn"]["o_proj"], "bshk,hkd->bsd", dtype, qmm)

    if cfg.block_type == "parallel_shared":  # falcon-7b / phi / gpt-j
        ffn_in = h
    elif cfg.block_type == "parallel":  # gpt-neox parallel residual
        ffn_in = mods.norm(cfg, _norm_p(cfg, lp, 1), x)
    else:
        x = x + attn_out
        ffn_in = mods.norm(cfg, _norm_p(cfg, lp, 1), x)
    ffn_out = mods.mlp(cfg, lp["mlp"], ffn_in)
    if cfg.block_type in ("parallel", "parallel_shared"):
        x = x + attn_out + ffn_out
    else:
        x = x + ffn_out
    return x


def _run_stack(cfg: TransformerConfig, params: Dict, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping,
               positions, mods: V2Modules, *, mixed: bool, decode: bool = False, n_dec: int = 0, chunk: int = 0):
    """The per-layer stack shared by the serving forwards. ``mixed`` selects
    the fused decode + prefill attention (``paged_attention_mixed``);
    otherwise the single-mode module routing runs with the ``decode`` flag."""
    if any(_is_moe_layer(cfg, i) for i in range(cfg.n_layers)):
        raise NotImplementedError("MoE layers are served by a later port slice")
    cos = sin = None
    if cfg.pos_emb == "rope":
        cos, sin = device_rope_tables(cfg, x.device)
    slopes = alibi_slopes(cfg.n_heads) if cfg.pos_emb == "alibi" else None
    attn_fns = _attn_fn_builder(cfg, mods)
    flat_pos = positions[0] if mixed else None

    for i in range(cfg.n_layers):
        lp = params[f"layer_{i}"]
        w_i = cfg.window_for(i)
        decode_attn, prefill_attn = attn_fns(w_i)
        if mixed:
            def attn_apply(q, kp, vp, *, _da=decode_attn, _pa=prefill_attn):
                out = paged_attention_mixed(q[0], kp, vp, block_tables, ctx_lens, flat_pos, n_dec=n_dec,
                                            chunk=chunk, decode_fn=_da, prefill_fn=_pa)
                return out[None]  # (1, T, H, D)
        else:
            def attn_apply(q, kp, vp, *, _w=w_i, _da=decode_attn, _pa=prefill_attn):
                return mods.attention(cfg, q, kp, vp, block_tables, ctx_lens, positions, decode=decode,
                                      slopes=slopes, decode_attn=_da, prefill_attn=_pa, window=_w)

        # kv_layer returns views: the layer's KV writes land in the stacked pools
        x = _transformer_layer(cfg, lp, x, kv_layer(k_pages, i), kv_layer(v_pages, i), slot_mapping, cos, sin,
                               positions, attn_apply, mods)
    return x, k_pages, v_pages


def ragged_forward(cfg: TransformerConfig, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                   k_pages: KVPool, v_pages: KVPool, block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                   slot_mapping: torch.Tensor, last_token_idx: torch.Tensor, *, decode: bool,
                   mods: Optional[V2Modules] = None):
    """One engine step over the paged cache.

    input_ids/positions: (B, S); k_pages/v_pages: (L, N, bs, KVH, D), plain
    or int8 ``(codes, scales (L, N, bs, KVH))``;
    block_tables: (B, P) int32; ctx_lens: (B,) context length *including*
    the current tokens; slot_mapping: (B*S,) flat KV slots for the new
    tokens; last_token_idx: (B,) index of each row's last real token.
    Returns (last-real-token logits (B, V) fp32, k_pages, v_pages).
    """
    mods = mods or build_modules()
    x = mods.embedding(cfg, params, input_ids, positions)
    x, k_pages, v_pages = _run_stack(cfg, params, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping,
                                     positions, mods, mixed=False, decode=decode)
    return mods.unembed(cfg, params, x, last_token_idx), k_pages, v_pages


def fused_forward(cfg: TransformerConfig, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                  k_pages: KVPool, v_pages: KVPool, block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                  slot_mapping: torch.Tensor, last_flat: torch.Tensor, *, n_dec: int, chunk: int,
                  mods: Optional[V2Modules] = None):
    """SplitFuse mixed step: decode rows AND chunked-prefill rows in ONE
    forward over the paged pool, so every layer reads its weights once for
    the whole ragged token batch.

    input_ids/positions/slot_mapping: (T,) flat token batch — flat slots
    [0, n_dec) are single-token decode rows; the remainder is the prefill
    segment, (n_pre, chunk) row-major. block_tables: (N, P) and
    ctx_lens/last_flat: (N,) are per ROW (decode rows first); ``last_flat``
    holds the flat index of each row's last real token. Returns ((N, V) fp32
    next-token logits, k_pages, v_pages).
    """
    mods = mods or build_modules()
    x = mods.embedding(cfg, params, input_ids[None], positions[None])  # (1, T, d)
    x, k_pages, v_pages = _run_stack(cfg, params, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping,
                                     positions[None], mods, mixed=True, n_dec=n_dec, chunk=chunk)
    # per-row last-token hidden states -> (N, 1, d) for the unembed module's
    # (batch, seq) contract
    x_last = x[0, last_flat.long()][:, None, :]
    zeros = torch.zeros((last_flat.shape[0],), dtype=torch.int32, device=x.device)
    return mods.unembed(cfg, params, x_last, zeros), k_pages, v_pages


def make_fused_step_fn(cfg: TransformerConfig, *, n_dec: int, n_pre: int, chunk: int, do_sample: bool = False,
                       temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
                       mods: Optional[V2Modules] = None) -> Callable:
    """The step of one scheduler quantum (Dynamic SplitFuse).

    It runs the mixed prefill + decode pass (``fused_forward``), samples each
    row's next token on the device, then advances the batch ``steps - 1``
    further paged-decode steps, where ``steps - 1`` is the leading dim of the
    follow-on slot table. Finished rows (token == ``eos_id``; -1 disables)
    write their KV to garbage slots and repeat their token. The reference
    skips a step once every row is done (``lax.cond``); here every step
    runs, which yields the same tokens without a host sync. Returns
    (N, steps) int32 tokens on the device.
    """
    mods = mods or build_modules()
    n_rows = n_dec + n_pre

    def fused(params, ids, positions, k_pages, v_pages, block_tables, ctx, slots0, last_flat, adv_slots,
              garbage_slots, eos_id: int, generator: Optional[torch.Generator]):
        # ids/positions/slots0: (T,) flat; block_tables (N, P); ctx/last_flat/
        # garbage_slots (N,); adv_slots (steps-1, N)
        logits, k_pages, v_pages = fused_forward(cfg, params, ids, positions, k_pages, v_pages, block_tables,
                                                 ctx, slots0, last_flat, n_dec=n_dec, chunk=chunk, mods=mods)
        toks = sample_logits(logits, generator, do_sample, temperature, top_k, top_p).to(torch.int32)
        done = toks == eos_id
        zeros_last = torch.zeros((n_rows,), dtype=torch.int32, device=ids.device)
        out = [toks]
        for off in range(adv_slots.shape[0]):
            slots_w = torch.where(done, garbage_slots, adv_slots[off])
            lg, k_pages, v_pages = ragged_forward(cfg, params, toks[:, None], (ctx + off)[:, None], k_pages,
                                                  v_pages, block_tables, ctx + off + 1, slots_w, zeros_last,
                                                  decode=True, mods=mods)
            nxt = sample_logits(lg, generator, do_sample, temperature, top_k, top_p).to(torch.int32)
            nxt = torch.where(done, toks, nxt)  # finished rows repeat their eos
            done = done | (nxt == eos_id)
            toks = nxt
            out.append(nxt)
        return torch.stack(out, dim=1), k_pages, v_pages

    return fused
