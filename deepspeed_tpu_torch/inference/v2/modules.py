"""Serving modules of the v2 engine, as plain functions over the parameter tree.

Port of ``deepspeed_tpu/inference/v2/modules.py``:
- embedding(cfg, params, input_ids, positions) -> (B, S, d)
- norm(cfg, p, x) -> normed x (p is None iff cfg.norm == "layernorm_np")
- attention(cfg, q, kp, vp, block_tables, ctx_lens, positions, *, decode, ...) -> (B, S, H, D)
- mlp(cfg, p, x) -> (B, S, d)
- moe(cfg, p, x) -> (B, S, d): no-drop top-k routing and the experts'
  grouped products
- unembed(cfg, params, x, last_token_idx) -> (B, V) fp32 logits

``build_modules`` resolves them into a ``V2Modules`` bundle together with
the kernels they call (``rms_norm``, ``layer_norm``, ``quantized_matmul``,
``moe_grouped_gemm`` and the two paged-attention functions);
``build_modules(plain=True)`` binds the kernels' plain PyTorch versions
instead, which is how a caller runs the same step without the kernels. A
projection whose ``kernel`` is a ``QuantizedParam`` (weight-only quantised
serving) goes through the fused dequantise-matmul (``+gspmd`` codes, a
tensor-parallel rank's shard, through ``quantized_matmul_sharded``); MoE
gates and experts stay dense.

Tensor parallelism (``build_modules(tp=TPContext)``): ``wte`` and
``lm_head`` are vocab-sharded. The embedding looks up the ids this rank's
rows hold (the others read zeros) and sums over the ``tensor`` group, so
every rank gets the whole embedding, bits equal to one device's (one term
is non-zero). The head computes this rank's vocab columns and sums them
into a zeroed (rows, V) buffer over the group (a gather that gloo runs on
CUDA tensors too), so every rank ends the step with the same full logits
and so chooses the same token. A vocabulary that the degree does not divide
stays whole on every rank (``module_inject.load_checkpoint``) and takes
neither collective.
"""

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...models.transformer import TransformerConfig
from ...moe.sharded_moe import top_k
from ...ops.moe_grouped_gemm import moe_grouped_gemm, moe_grouped_gemm_ref
from ...ops.norms import layer_norm, layer_norm_ref, rms_norm, rms_norm_ref
from ...ops.paged_attention import (paged_attention_decode, paged_attention_decode_ref, paged_attention_prefill,
                                    paged_attention_prefill_ref)
from ...ops.quantized_matmul import quantized_matmul, quantized_matmul_ref, quantized_matmul_sharded
from ..quantization import QuantizedParam


def _norm_key(cfg: TransformerConfig) -> str:
    return "RMSNorm" if cfg.norm == "rmsnorm" else "LayerNorm"


def _norm_p(cfg: TransformerConfig, container, idx: int):
    """A norm's param dict; None ONLY for the param-free norm kind."""
    if cfg.norm == "layernorm_np":
        return None
    return container[f"{_norm_key(cfg)}_{idx}"]


def _qproj(x: torch.Tensor, qp: QuantizedParam, dtype: torch.dtype, qmm: Callable) -> torch.Tensor:
    """Apply a kgroups-quantised kernel through the fused dequantise-matmul:
    flatten x's trailing dims to the contraction size (``o_proj`` contracts
    H * Dh), restore the kernel's output dims after."""
    packed = qp.layout.startswith("kgroups_p4")
    K = qp.q.shape[0] * (2 if packed else 1)
    t, i = 1, x.dim()
    while t < K:
        i -= 1
        t *= x.shape[i]
    if t != K:
        raise ValueError(f"x {tuple(x.shape)} does not contract with quantised codes {tuple(qp.q.shape)}")
    t, j = 1, 0
    while t < K:
        t *= qp.shape[j]
        j += 1
    if qp.layout.endswith("+gspmd"):  # a tensor-parallel rank's codes: its columns, or its K rows' partial
        qmm = functools.partial(quantized_matmul_sharded, qmm=qmm)
    out2 = qmm(x.reshape(-1, K).to(dtype).contiguous(), qp.q, qp.scales, packed=packed)
    return out2.reshape(tuple(x.shape[:i]) + tuple(qp.shape[j:])).to(dtype)


def _proj(x: torch.Tensor, p: Dict[str, Any], spec: str, dtype: torch.dtype,
          qmm: Callable = quantized_matmul) -> torch.Tensor:
    """Projection with the reference's einsum spec: a dense kernel is a cuBLAS
    product on the card, a ``QuantizedParam`` kernel goes through ``qmm``."""
    w = p["kernel"]
    if isinstance(w, QuantizedParam):
        y = _qproj(x, w, dtype, qmm)
    else:
        y = torch.einsum(spec, x, w.to(dtype))
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def embedding_tpu(cfg: TransformerConfig, params: Dict[str, Any], input_ids: torch.Tensor, positions: torch.Tensor,
                  norm: Optional[Callable] = None, tp=None) -> torch.Tensor:
    """ref ``implementations/embedding/ragged_embedding.py``. With a
    vocab-sharded ``wte`` (``tp``), a masked lookup of this rank's rows and
    a sum over the group (``TPContext.embed``)."""
    wte = params["wte"]
    if tp is not None:
        x = tp.embed(wte, input_ids, cfg.vocab_size).to(cfg.dtype)
    else:
        # explicit clamp: out-of-vocab ids read the last row, the reference's single-device gather semantics
        x = wte[input_ids.long().clamp(0, wte.shape[0] - 1)].to(cfg.dtype)
    if cfg.embed_scale:  # gemma normalizer
        x = x * torch.full((), cfg.d_model**0.5, dtype=cfg.dtype, device=x.device)  # a fill, not a host copy
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][positions.long()].to(cfg.dtype)
    if cfg.embedding_norm:  # bloom
        x = (norm or norm_tpu)(cfg, _norm_p(cfg, params, 0), x)
    return x


def norm_tpu(cfg: TransformerConfig, p, x: torch.Tensor, rms: Callable = rms_norm,
             ln: Callable = layer_norm) -> torch.Tensor:
    """One norm serves the pre- and post-norm roles. ``p is None`` is the
    non-parametric layernorm (olmo), plain PyTorch as in the reference."""
    if p is None:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + cfg.norm_eps)).to(cfg.dtype)
    if "bias" in p:
        return ln(x.contiguous(), p["scale"], p["bias"], cfg.norm_eps).to(cfg.dtype)
    # the (1+w) offset must add in fp32: serving params may be bf16 and HF's
    # GemmaRMSNorm computes (1.0 + weight.float())
    w = 1.0 + p["scale"].float() if cfg.rms_offset else p["scale"]
    return rms(x, w, cfg.norm_eps).to(cfg.dtype)


_CFG_WINDOW = object()  # sentinel: caller did not pass a per-layer window


def attention_tpu(cfg: TransformerConfig, q, kp, vp, block_tables, ctx_lens, positions, *, decode: bool,
                  slopes=None, decode_attn: Optional[Callable] = None, prefill_attn: Optional[Callable] = None,
                  window=_CFG_WINDOW, **_) -> torch.Tensor:
    """ref ``implementations/attention/dense_blocked_attention.py``: the paged
    decode kernel for one-token rows, the paged prefill kernel otherwise.
    ``decode_attn``/``prefill_attn`` are bound variants (as the runner's
    ``_attn_fn_builder`` makes them); by default the kernel wrappers with
    this config's scale, ``slopes`` and ``window`` (THIS layer's window)."""
    if window is _CFG_WINDOW:
        window = cfg.sliding_window
    if decode:
        fn = decode_attn or functools.partial(paged_attention_decode, scale=cfg.attn_scale, alibi_slopes=slopes,
                                              window=window)
        return fn(q[:, 0].contiguous(), kp, vp, block_tables, ctx_lens)[:, None]
    fn = prefill_attn or functools.partial(paged_attention_prefill, scale=cfg.attn_scale, alibi_slopes=slopes,
                                           window=window)
    return fn(q, kp, vp, block_tables, ctx_lens, positions)


def mlp_tpu(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor,
            qmm: Callable = quantized_matmul) -> torch.Tensor:
    """ref ``implementations/linear/*``: the dense FFN pair."""
    dtype = cfg.dtype
    if cfg.activation in ("swiglu", "geglu"):
        g = _proj(x, p["gate_proj"], "bsd,df->bsf", dtype, qmm)
        # jax.nn.gelu defaults to the tanh approximation
        g = F.gelu(g, approximate="tanh") if cfg.activation == "geglu" else F.silu(g)
        h = g * _proj(x, p["up_proj"], "bsd,df->bsf", dtype, qmm)
    else:
        h = _proj(x, p["up_proj"], "bsd,df->bsf", dtype, qmm)
        if cfg.activation == "relu":
            h = F.relu(h)
        else:
            h = F.gelu(h, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
    return _proj(h, p["down_proj"], "bsf,fd->bsd", dtype, qmm)


def moe_route(cfg: TransformerConfig, p: Dict[str, Any], tokens: torch.Tensor):
    """The fp32 gate's top-k routing of (N, d) tokens, without a host sync:
    ``(weights (N, k) fp32, experts (N, k), order (N k,), offsets (E + 1,)
    int32)``. ``order`` sorts the flat (token, choice) pairs by expert,
    stably (tokens keep their order within an expert); ``offsets`` bounds
    each expert's rows in that order. The weights are renormalised only when
    k > 1, as the reference (top-1 gating does not renormalise)."""
    k, E = cfg.moe_top_k, cfg.moe_num_experts
    gates = torch.softmax(tokens.float() @ p["gate"]["kernel"].float(), dim=-1)
    weights, experts = top_k(gates, k)  # lax.top_k's order: ties go to the lower expert
    if k > 1:
        weights = weights / torch.clamp_min(weights.sum(dim=-1, keepdim=True), 1e-9)
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    # bincount would read the count's length back (a sync): count by scatter_add_ instead
    counts = torch.zeros((E,), dtype=torch.int32, device=tokens.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    offsets = torch.cat([counts.new_zeros((1,)), torch.cumsum(counts, dim=0, dtype=torch.int32)])
    return weights, experts, order, offsets


def moe_tpu(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor,
            gemm: Callable = moe_grouped_gemm) -> torch.Tensor:
    """ref ``implementations/moe/cutlass_multi_gemm.py``: no-drop top-k
    dispatch through three grouped products (``gemm``: the kernel, or its
    plain version) over the expert-sorted rows, then the weighted combine.
    Each token sums its k contributions in ascending expert order, the order
    of the reference's scatter-add over the sorted rows, in the serving
    dtype; no atomics, so a step repeats bit for bit. Under tensor
    parallelism each expert's ``wi`` / ``wg`` / ``wo`` hold this rank's I / tp
    hidden columns (JAX ``MOE_PARTITION_RULES``' ``tensor`` entries): the
    routing is the same on every rank (the gate and the tokens are whole),
    the grouped products run at I / tp, and the output is this rank's
    partial, which the layer's row-parallel reduce sums."""
    dtype = cfg.dtype
    B, S, d = x.shape
    k = cfg.moe_top_k
    tokens = x.reshape(-1, d)
    N = tokens.shape[0]
    weights, _, order, offsets = moe_route(cfg, p, tokens)
    xs = tokens[order // k].to(dtype)  # (N k, d) sorted by expert

    ep = p["experts"]
    h = gemm(xs, ep["wi"].to(dtype), offsets)
    if cfg.activation == "swiglu":
        h = F.silu(gemm(xs, ep["wg"].to(dtype), offsets)) * h
    elif cfg.activation == "relu":
        h = F.relu(h)
    else:
        h = F.gelu(h, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
    out_s = gemm(h, ep["wo"].to(dtype), offsets)  # (N k, d)
    contrib = out_s * weights.reshape(-1)[order].to(dtype)[:, None]

    # sorted position of each (token, choice); a token's positions rise with its experts
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0], device=x.device))
    pos = torch.sort(pos.view(N, k), dim=1).values
    out = contrib[pos[:, 0]]
    for j in range(1, k):
        out = out + contrib[pos[:, j]]
    return out.reshape(B, S, d)


def unembed_tpu(cfg: TransformerConfig, params: Dict[str, Any], x: torch.Tensor, last_token_idx: torch.Tensor,
                norm: Optional[Callable] = None, qmm: Callable = quantized_matmul, tp=None) -> torch.Tensor:
    """ref ``implementations/unembed/ragged_unembed.py``: final norm +
    last-real-token gather + head projection, fp32 logits. With a
    vocab-sharded head (``tp``), this rank's columns summed into the whole
    row over the group (``TPContext.vocab_logits``)."""
    top = 1 if cfg.embedding_norm else 0
    x = (norm or norm_tpu)(cfg, _norm_p(cfg, params, top), x)
    last = x[torch.arange(x.shape[0], device=x.device), last_token_idx.long(), :]
    if cfg.tie_embeddings:
        logits = torch.einsum("bd,vd->bv", last, params["wte"].to(cfg.dtype))
    else:
        logits = _proj(last, params["lm_head"], "bd,dv->bv", cfg.dtype, qmm)
    logits = logits.float()
    return tp.vocab_logits(logits, cfg.vocab_size) if tp is not None else logits


class V2Modules(NamedTuple):
    """Resolved module bundle (ref ``modules/heuristics.py`` result) plus the
    kernels the modules and the runner call. The engine hands the kernel
    fields that carry a ``launches`` counter to its CUDA graphs, which keep
    those counts true across warm-ups, captures and replays."""
    embedding: Callable
    norm: Callable
    attention: Callable
    mlp: Callable
    moe: Callable
    unembed: Callable
    rms_norm: Callable
    layer_norm: Callable
    quantized_matmul: Callable
    grouped_gemm: Callable
    decode_attn: Callable
    prefill_attn: Callable
    tp: Any = None  # the runner's TPContext under tensor parallelism, else None


def build_modules(plain: bool = False, tp=None) -> V2Modules:
    """The serving modules bound to the kernels, or with ``plain=True`` to the
    kernels' plain PyTorch versions; ``tp`` (a ``model_runner.TPContext``)
    makes the embedding and the head vocab-parallel and the runner reduce
    each layer's row-parallel partials over its group."""
    rms = rms_norm_ref if plain else rms_norm
    ln = layer_norm_ref if plain else layer_norm
    qmm = quantized_matmul_ref if plain else quantized_matmul
    gemm = moe_grouped_gemm_ref if plain else moe_grouped_gemm
    norm = functools.partial(norm_tpu, rms=rms, ln=ln)
    return V2Modules(embedding=functools.partial(embedding_tpu, norm=norm, tp=tp), norm=norm, attention=attention_tpu,
                     mlp=functools.partial(mlp_tpu, qmm=qmm), moe=functools.partial(moe_tpu, gemm=gemm),
                     unembed=functools.partial(unembed_tpu, norm=norm, qmm=qmm, tp=tp),
                     rms_norm=rms, layer_norm=ln, quantized_matmul=qmm, grouped_gemm=gemm,
                     decode_attn=paged_attention_decode_ref if plain else paged_attention_decode,
                     prefill_attn=paged_attention_prefill_ref if plain else paged_attention_prefill, tp=tp)
