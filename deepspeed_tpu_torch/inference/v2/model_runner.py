"""Ragged forward passes over the parameter tree, on the paged KV pool.

Port of ``deepspeed_tpu/inference/v2/model_runner.py``:
``_transformer_layer``, the layer stack, ``ragged_forward`` (a (B, S) batch
in one mode), ``fused_forward`` (the SplitFuse mixed decode + prefill pass),
``make_step_fns`` (the unfused loop's prefill and decode steps),
``make_burst_fn`` (``steps`` decode steps in one call),
``make_fused_step_fn`` (one quantum: the fused pass, then ``steps - 1``
decode steps of the burst), and ``spec_verify_forward`` /
``make_spec_verify_fn`` (speculative decoding's K-token verify). The reference's ``lax.scan`` over burst steps
is a Python loop over the slot table's leading dim; a CUDA engine captures
each step for a bucket as one CUDA graph (``graphs.py``), which unrolls that
loop, where the JAX engine jits one program. The KV pools are updated in
place where the JAX programs donate them.

The attention, norm, quantised-matmul and grouped-GEMM kernels come from a ``V2Modules``
bundle (``modules.build_modules``); passing ``build_modules(plain=True)``
runs the same step on the kernels' plain PyTorch versions. The KV pools are
plain tensors or int8 ``(codes, scales)`` pairs.

Tensor parallelism (JAX ``model_runner.py:59-83``, ``:142-233``): with
``mods.tp`` a ``TPContext``, each rank runs the same stack on its shard of
the heads, of the MLP or expert hidden dim and of the pool's KV heads (the
geometry is read off the local arrays), with ALiBi slopes sliced to its
heads, and the two row-parallel partial sums of each layer (after
``o_proj`` and after the MLP or MoE output) go through ``tp_all_reduce``
over the ``tensor`` group; the biases of those two projections add after
the reduce, once. The JAX package runs the stack as one ``shard_map``
region; here each rank is a process that runs the region's body.
"""

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ...comm import ReduceOp, all_reduce
from ...comm.collectives import tp_all_reduce
from ...models.transformer import TransformerConfig, _is_moe_layer, alibi_slopes, apply_rope, device_rope_tables
from ...ops.paged_attention import KVPool, kv_layer, paged_attention_mixed, update_kv_pages
from ..generation import sample_logits
from .modules import V2Modules, _norm_p, _proj, build_modules
from .spec import select_committed


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Explicit-collective tensor-parallel execution context (JAX
    ``TPContext``): this rank's place on the ``tensor`` axis, the process
    group of that axis (None: the whole world), and the reduce's mode:
    ``bits`` (``DS_TPU_TP_ALLREDUCE_BITS``, 0 = exact) and ``interleave``
    (chunks a reduce, the T3 seam). ``mesh`` is the mesh's signature
    (``parallel.mesh.mesh_signature``)."""

    tp: int
    rank: int = 0
    group: Any = None
    axis: str = "tensor"
    bits: int = 0
    interleave: int = 1
    mesh: str = "mesh[none]"

    def signature(self) -> str:
        """Step-key and fingerprint identity of this sharded step class."""
        return f"tp{self.tp}:{self.axis}:b{self.bits}:il{self.interleave}:{self.mesh}"

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel seam: ``tp_all_reduce`` in this context's mode."""
        return tp_all_reduce(x, self.group, bits=self.bits, interleave=self.interleave)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The column-parallel seam: the identity (serving takes no gradient;
        training's ``parallel.tensor.TensorParallel.copy`` sums it)."""
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """An exact sum over the group (the vocab-parallel embedding and head)."""
        out = x.contiguous().clone()
        all_reduce(out, ReduceOp.SUM, group=self.group)
        return out

    def embed(self, wte: torch.Tensor, ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """Embedding rows of ``ids`` from a vocab-sharded ``wte``: ids clamp to
        the whole vocabulary (one device's gather), this rank looks up the rows
        it holds (zeros elsewhere) and the group sums them, exactly (one term
        is non-zero). A ``wte`` kept whole (a vocabulary the degree does not
        divide) is a plain lookup."""
        ids = ids.long().clamp(0, vocab_size - 1)
        n = wte.shape[0]
        if n == vocab_size:
            return wte[ids]
        local = ids - self.rank * n
        mine = ((local >= 0) & (local < n))[..., None]
        return self.sum(torch.where(mine, wte[local.clamp(0, n - 1)], torch.zeros((), dtype=wte.dtype,
                                                                                 device=wte.device)))

    def vocab_logits(self, logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """The whole rows from this rank's vocab columns: summed over the group
        into a zeroed row (an exact gather that gloo also runs on CUDA
        tensors); whole columns pass as they are."""
        n = logits.shape[-1]
        if n == vocab_size:
            return logits
        full = logits.new_zeros(logits.shape[:-1] + (vocab_size,))
        full[..., self.rank * n:(self.rank + 1) * n] = logits
        return self.sum(full)

    def local_slopes(self, n_heads: int):
        """This rank's heads' ALiBi slopes."""
        hs = n_heads // self.tp
        return alibi_slopes(n_heads)[self.rank * hs:(self.rank + 1) * hs]


def _attn_fn_builder(cfg: TransformerConfig, mods: V2Modules, slopes=None) -> Callable:
    """window -> (decode_attn, prefill_attn): one bound pair per
    distinct per-layer window value, shared by the ragged and fused
    forwards. Unlike the reference's interpret mode, prefill always gets its
    kernel: there is no gather fallback on the card. ``slopes``: the ALiBi
    slopes of the heads this rank holds."""
    fns: Dict[Optional[int], tuple] = {}

    def attn_fns(window):
        if window not in fns:
            decode = functools.partial(mods.decode_attn, scale=cfg.attn_scale, alibi_slopes=slopes, window=window)
            prefill = functools.partial(mods.prefill_attn, scale=cfg.attn_scale, alibi_slopes=slopes,
                                        window=window)
            fns[window] = (decode, prefill)
        return fns[window]

    return attn_fns


def _without_bias(p: Dict, key: str) -> Tuple[Dict, Optional[torch.Tensor]]:
    """``p`` with ``p[key]``'s bias taken out, and that bias (None without one)."""
    if "bias" not in p[key]:
        return p, None
    return {**p, key: {k: v for k, v in p[key].items() if k != "bias"}}, p[key]["bias"]


def _transformer_layer(cfg: TransformerConfig, lp: Dict, x: torch.Tensor, k_pages_i: KVPool,
                       v_pages_i: KVPool, slot_mapping: torch.Tensor, cos, sin, positions: torch.Tensor,
                       attn_apply: Callable, mods: V2Modules, moe: bool = False,
                       tp_reduce: Optional[Callable] = None):
    """One transformer block over (B, S) tokens against this layer's page
    pool: qkv + rope + KV page write (in place) + ``attn_apply(q, kp, vp)`` +
    FFN (the MoE module for an MoE block). Returns the block's output.
    ``tp_reduce`` (tensor parallelism) sums the two row-parallel partials,
    the attention output after ``o_proj`` and the FFN or MoE output, over
    the ``tensor`` group; their biases add after it. Head and hidden
    geometry come off the arrays, so the same code runs whole or
    shard-local."""
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
    if tp_reduce is None:
        attn_out = _proj(attn, lp["attn"]["o_proj"], "bshk,hkd->bsd", dtype, qmm)
    else:
        o_p, o_bias = _without_bias(lp["attn"], "o_proj")
        attn_out = tp_reduce(_proj(attn, o_p["o_proj"], "bshk,hkd->bsd", dtype, qmm))
        if o_bias is not None:
            attn_out = attn_out + o_bias.to(dtype)

    if cfg.block_type == "parallel_shared":  # falcon-7b / phi / gpt-j
        ffn_in = h
    elif cfg.block_type == "parallel":  # gpt-neox parallel residual
        ffn_in = mods.norm(cfg, _norm_p(cfg, lp, 1), x)
    else:
        x = x + attn_out
        ffn_in = mods.norm(cfg, _norm_p(cfg, lp, 1), x)
    if tp_reduce is None:
        ffn_out = mods.moe(cfg, lp["moe"], ffn_in) if moe else mods.mlp(cfg, lp["mlp"], ffn_in)
    elif moe:
        ffn_out = tp_reduce(mods.moe(cfg, lp["moe"], ffn_in))
    else:
        mlp_p, down_bias = _without_bias(lp["mlp"], "down_proj")
        ffn_out = tp_reduce(mods.mlp(cfg, mlp_p, ffn_in))
        if down_bias is not None:
            ffn_out = ffn_out + down_bias.to(dtype)
    if cfg.block_type in ("parallel", "parallel_shared"):
        x = x + attn_out + ffn_out
    else:
        x = x + ffn_out
    return x


def _run_stack(cfg: TransformerConfig, params: Dict, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping,
               positions, mods: V2Modules, *, mixed: bool, decode: bool = False, n_dec: int = 0, chunk: int = 0):
    """The per-layer stack shared by the serving forwards. ``mixed`` selects
    the fused decode + prefill attention (``paged_attention_mixed``);
    otherwise the single-mode module routing runs with the ``decode`` flag.
    With ``mods.tp`` the stack is shard-local: this rank's heads' ALiBi
    slopes and the row-parallel reduces."""
    cos = sin = None
    if cfg.pos_emb == "rope":
        cos, sin = device_rope_tables(cfg, x.device)
    tp = mods.tp if mods.tp is not None and mods.tp.tp > 1 else None
    slopes = None
    if cfg.pos_emb == "alibi":
        slopes = tp.local_slopes(cfg.n_heads) if tp is not None else alibi_slopes(cfg.n_heads)
    tp_reduce = tp.reduce if tp is not None else None
    attn_fns = _attn_fn_builder(cfg, mods, slopes)
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
                               positions, attn_apply, mods, moe=_is_moe_layer(cfg, i), tp_reduce=tp_reduce)
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


def make_step_fns(cfg: TransformerConfig, mods: Optional[V2Modules] = None) -> Tuple[Callable, Callable]:
    """(prefill_fn, decode_fn): ``ragged_forward`` in each mode, with the
    signature ``fn(params, ids, positions, k_pages, v_pages, block_tables,
    ctx_lens, slot_mapping, last_token_idx)``."""
    mods = mods or build_modules()
    return (functools.partial(ragged_forward, cfg, decode=False, mods=mods),
            functools.partial(ragged_forward, cfg, decode=True, mods=mods))


def make_burst_fn(cfg: TransformerConfig, *, do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, mods: Optional[V2Modules] = None) -> Callable:
    """Multi-step decode (greedy or sampled) in one call.

    Runs ``steps`` paged-decode steps, ``steps`` being the leading dim of the
    (steps, B) slot table: each step's token choice on the device (argmax,
    or ``sample_logits`` from ``generator``) feeds the next step's input
    ids, and positions and context lengths advance by one a step. The host
    allocates the blocks of the whole burst up front, so the slots arrive
    precomputed. Returns the (B, steps) int32 tokens and the pools."""
    mods = mods or build_modules()

    def burst(params, ids0, positions0, k_pages, v_pages, block_tables, ctx0, slots, last,
              generator: Optional[torch.Generator]):
        # ids0/positions0 (B, 1); ctx0/last (B,); slots (steps, B)
        ids, out = ids0, []
        for off in range(slots.shape[0]):
            logits, k_pages, v_pages = ragged_forward(cfg, params, ids, positions0 + off, k_pages, v_pages,
                                                      block_tables, ctx0 + off, slots[off], last, decode=True,
                                                      mods=mods)
            nxt = sample_logits(logits, generator, do_sample, temperature, top_k, top_p).to(torch.int32)
            ids = nxt[:, None]
            out.append(nxt)
        return torch.stack(out, dim=1), k_pages, v_pages

    return burst


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


def spec_verify_forward(cfg: TransformerConfig, params: Dict, input_ids: torch.Tensor, positions: torch.Tensor,
                        k_pages: KVPool, v_pages: KVPool, block_tables: torch.Tensor, ctx_lens: torch.Tensor,
                        slot_mapping: torch.Tensor, *, chunk: int, mods: Optional[V2Modules] = None):
    """Speculative-decode verify pass: every row is a ``chunk = K+1``-token
    tail (the carry token and K drafts) of a live sequence, run as a
    chunked prefill over its context (``paged_attention_mixed`` with
    ``n_dec=0``, so only the prefill kernel launches). Acceptance needs the
    logits at every position, so the whole flat batch is unembedded.

    input_ids/positions/slot_mapping: (T,) flat, T = B * chunk;
    block_tables (B, P); ctx_lens (B,) counting the window. Returns ((T, V)
    fp32 logits, k_pages, v_pages).
    """
    mods = mods or build_modules()
    x = mods.embedding(cfg, params, input_ids[None], positions[None])  # (1, T, d)
    x, k_pages, v_pages = _run_stack(cfg, params, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping,
                                     positions[None], mods, mixed=True, n_dec=0, chunk=chunk)
    x_all = x[0][:, None, :]  # (T, 1, d): every flat position through the unembed's (batch, seq) contract
    zeros = torch.zeros((x_all.shape[0],), dtype=torch.int32, device=x.device)
    return mods.unembed(cfg, params, x_all, zeros), k_pages, v_pages


def make_spec_verify_fn(cfg: TransformerConfig, *, chunk: int, do_sample: bool = False, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0, mods: Optional[V2Modules] = None) -> Callable:
    """The K-token verify step of speculative decoding, for one (chunk,
    sampling) signature: the verify forward scores all ``chunk`` positions of
    each row, then ``select_committed`` picks each row's accepted drafts and
    its correction or bonus token in the same step. ``n_draft`` caps the
    acceptance a row, so padded draft positions never commit; the host rolls
    back the rejected tail positions after the step.

    Returns (B, chunk + 1) int32 on the device: the committed ids (B, chunk)
    with the accepted counts as the last column, one tensor (a captured step
    returns one), which is all the host reads back.
    """
    mods = mods or build_modules()

    def verify(params, ids, positions, k_pages, v_pages, block_tables, ctx, slots, n_draft,
               generator: Optional[torch.Generator]):
        # ids/positions/slots: (T,) flat, T = B * chunk; block_tables (B, P); ctx/n_draft (B,)
        logits, k_pages, v_pages = spec_verify_forward(cfg, params, ids, positions, k_pages, v_pages, block_tables,
                                                       ctx, slots, chunk=chunk, mods=mods)
        B = ctx.shape[0]
        drafts = ids.reshape(B, chunk)[:, 1:]
        committed, accepted = select_committed(logits.reshape(B, chunk, -1), drafts, n_draft, generator,
                                               do_sample=do_sample, temperature=temperature, top_k=top_k,
                                               top_p=top_p)
        return torch.cat([committed, accepted[:, None]], dim=1), k_pages, v_pages

    return verify
