"""Serving modules of the v2 engine, as plain functions over the parameter tree.

Port of ``deepspeed_tpu/inference/v2/modules.py`` (dense families):
- embedding(cfg, params, input_ids, positions) -> (B, S, d)
- norm(cfg, p, x) -> normed x (p is None iff cfg.norm == "layernorm_np")
- attention(cfg, q, kp, vp, block_tables, ctx_lens, positions, *, decode, ...) -> (B, S, H, D)
- mlp(cfg, p, x) -> (B, S, d)
- unembed(cfg, params, x, last_token_idx) -> (B, V) fp32 logits

``build_modules`` resolves them into a ``V2Modules`` bundle together with
the kernels they call (``rms_norm`` and the two paged-attention
functions); ``build_modules(plain=True)`` binds the kernels' plain PyTorch
versions instead, which is how a caller runs the same step without the
kernels. MoE, weight-quantized projections and ``layer_norm`` as a kernel
come with later slices.
"""

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ...models.transformer import TransformerConfig
from ...ops.norms import rms_norm, rms_norm_ref
from ...ops.paged_attention import (paged_attention_decode, paged_attention_decode_ref, paged_attention_prefill,
                                    paged_attention_prefill_ref)


def _norm_key(cfg: TransformerConfig) -> str:
    return "RMSNorm" if cfg.norm == "rmsnorm" else "LayerNorm"


def _norm_p(cfg: TransformerConfig, container, idx: int):
    """A norm's param dict; None ONLY for the param-free norm kind."""
    if cfg.norm == "layernorm_np":
        return None
    return container[f"{_norm_key(cfg)}_{idx}"]


def _proj(x: torch.Tensor, p: Dict[str, Any], spec: str, dtype: torch.dtype) -> torch.Tensor:
    """Dense projection with the reference's einsum spec (a cuBLAS product on the card)."""
    y = torch.einsum(spec, x, p["kernel"].to(dtype))
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def _layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def embedding_tpu(cfg: TransformerConfig, params: Dict[str, Any], input_ids: torch.Tensor, positions: torch.Tensor,
                  norm: Optional[Callable] = None) -> torch.Tensor:
    """ref ``implementations/embedding/ragged_embedding.py``."""
    # explicit clamp: out-of-vocab ids read the last row, the reference's
    # single-device gather semantics
    input_ids = input_ids.long().clamp(0, params["wte"].shape[0] - 1)
    x = params["wte"][input_ids].to(cfg.dtype)
    if cfg.embed_scale:  # gemma normalizer
        x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype, device=x.device)
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][positions.long()].to(cfg.dtype)
    if cfg.embedding_norm:  # bloom
        x = (norm or norm_tpu)(cfg, _norm_p(cfg, params, 0), x)
    return x


def norm_tpu(cfg: TransformerConfig, p, x: torch.Tensor, rms: Callable = rms_norm) -> torch.Tensor:
    """One norm serves the pre- and post-norm roles. ``p is None`` is the
    non-parametric layernorm (olmo)."""
    if p is None:
        return _layer_norm(x, None, None, cfg.norm_eps).to(cfg.dtype)
    if "bias" in p:
        return _layer_norm(x, p["scale"], p["bias"], cfg.norm_eps).to(cfg.dtype)
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


def mlp_tpu(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """ref ``implementations/linear/*``: the dense FFN pair."""
    dtype = cfg.dtype
    if cfg.activation in ("swiglu", "geglu"):
        g = _proj(x, p["gate_proj"], "bsd,df->bsf", dtype)
        # jax.nn.gelu defaults to the tanh approximation
        g = F.gelu(g, approximate="tanh") if cfg.activation == "geglu" else F.silu(g)
        h = g * _proj(x, p["up_proj"], "bsd,df->bsf", dtype)
    else:
        h = _proj(x, p["up_proj"], "bsd,df->bsf", dtype)
        if cfg.activation == "relu":
            h = F.relu(h)
        else:
            h = F.gelu(h, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
    return _proj(h, p["down_proj"], "bsf,fd->bsd", dtype)


def unembed_tpu(cfg: TransformerConfig, params: Dict[str, Any], x: torch.Tensor, last_token_idx: torch.Tensor,
                norm: Optional[Callable] = None) -> torch.Tensor:
    """ref ``implementations/unembed/ragged_unembed.py``: final norm +
    last-real-token gather + head projection, fp32 logits."""
    top = 1 if cfg.embedding_norm else 0
    x = (norm or norm_tpu)(cfg, _norm_p(cfg, params, top), x)
    last = x[torch.arange(x.shape[0], device=x.device), last_token_idx.long(), :]
    if cfg.tie_embeddings:
        logits = torch.einsum("bd,vd->bv", last, params["wte"].to(cfg.dtype))
    else:
        logits = _proj(last, params["lm_head"], "bd,dv->bv", cfg.dtype)
    return logits.float()


class V2Modules(NamedTuple):
    """Resolved module bundle (ref ``modules/heuristics.py`` result) plus the
    kernels the modules and the runner call."""
    embedding: Callable
    norm: Callable
    attention: Callable
    mlp: Callable
    unembed: Callable
    rms_norm: Callable
    decode_attn: Callable
    prefill_attn: Callable


def build_modules(plain: bool = False) -> V2Modules:
    """The serving modules bound to the kernels, or with ``plain=True`` to the
    kernels' plain PyTorch versions."""
    rms = rms_norm_ref if plain else rms_norm
    norm = functools.partial(norm_tpu, rms=rms)
    return V2Modules(embedding=functools.partial(embedding_tpu, norm=norm), norm=norm, attention=attention_tpu,
                     mlp=mlp_tpu, unembed=functools.partial(unembed_tpu, norm=norm), rms_norm=rms,
                     decode_attn=paged_attention_decode_ref if plain else paged_attention_decode,
                     prefill_attn=paged_attention_prefill_ref if plain else paged_attention_prefill)
