"""Decoder-only transformer family: configuration, presets, rope, init, and
the training forward.

Port of ``deepspeed_tpu/models/transformer.py``. The parameter tree keeps
the flax layout and keys of the reference (``wte``,
``layer_{i}/attn/q_proj/kernel`` of shape (d, H, Dh), ...), so weights
convert by copy (``convert.params_from_numpy``), the serving runner
contracts them with the same einsum specs, and the training forward
(``transformer_forward``, ``CausalLM.apply``/``loss_fn``: the reference's
flax ``Attention``/``MLP``/``Block``/``Transformer``) runs as plain
functions over the same dict, with the reference's dense KV caches for the
v1 engine (``CausalLM.init_kv_caches``, ``kv_caches=``). MoE blocks,
``scan_layers``, progressive layer drop and the BERT heads are not ported
(they raise).
"""

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# a layer's dense KV cache: k and v (B, max_len, KVH, Dh) and the filled length (a host int)
KVCache = Tuple[torch.Tensor, torch.Tensor, int]


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: Optional[int] = None  # < n_heads => GQA (llama-70b style)
    head_dims: Optional[int] = None  # explicit head dim (gemma: != d_model/n_heads)
    d_model: int = 128
    d_ff: Optional[int] = None  # default: 4*d_model (gelu) or 8/3*d_model (swiglu)
    max_seq_len: int = 2048
    norm: str = "layernorm"  # layernorm | rmsnorm | layernorm_np (olmo: no affine params)
    activation: str = "gelu"  # gelu (tanh approx) | gelu_exact (erf) | swiglu | geglu | relu
    pos_emb: str = "learned"  # learned | rope | alibi | none
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # fraction of head_dim rotated (gpt-neox/phi partial rotary)
    rotary_dims: Optional[int] = None  # exact rotated dim count (gpt-j rotary_dim); overrides rotary_pct
    rope_style: str = "neox"  # neox (rotate-half) | gptj (interleaved pairs)
    # HF rope_scaling variants (transformers modeling_rope_utils.py)
    rope_scaling: Optional[str] = None  # linear | dynamic | llama3 | yarn
    rope_factor: float = 1.0
    rope_orig_max_seq: Optional[int] = None  # original_max_position_embeddings
    rope_low_freq_factor: float = 1.0   # llama3
    rope_high_freq_factor: float = 4.0  # llama3
    rope_beta_fast: float = 32.0        # yarn extrapolation boundary
    rope_beta_slow: float = 1.0         # yarn interpolation boundary
    rope_attn_factor: Optional[float] = None  # yarn cos/sin scale; None = 0.1*ln(factor)+1
    clip_qkv: Optional[float] = None  # olmo: clamp q/k/v activations to [-c, c]
    # block wiring: sequential (gpt2/llama), parallel (gpt-neox), parallel_shared (falcon-7b/phi/gpt-j)
    block_type: str = "sequential"
    dense_bias: Optional[bool] = None  # default: norm == "layernorm"
    qkv_bias: Optional[bool] = None  # override for q/k/v projections only (qwen2)
    qk_norm: bool = False  # qwen3: per-head RMSNorm on q/k before rope
    attn_out_bias: Optional[bool] = None  # override for o_proj only
    lm_head_bias: bool = False  # phi / gpt-j carry a bias on the untied head
    embedding_norm: bool = False  # bloom: layernorm directly after the token embedding
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    rms_offset: bool = False  # gemma: rmsnorm weights stored zero-centered, applied as (1 + w)
    sliding_window: Optional[int] = None  # mistral: query i attends keys in (i - w, i]
    window_layers: Optional[Tuple[int, ...]] = None  # layers that apply sliding_window; None = all
    attn_scale: Optional[float] = None  # softmax scale override; None = 1/sqrt(head_dim)
    causal: bool = True  # False: bidirectional encoder
    norm_scheme: str = "pre"  # pre (gpt/llama) | post (BERT)
    type_vocab_size: int = 0  # >0: token_type embeddings added to the input
    mlm_head: bool = False  # BERT cls.predictions transform before the tied decoder
    tie_embeddings: bool = True
    dtype: Any = torch.float32  # activation/compute dtype
    norm_eps: float = 1e-5
    dropout: float = 0.0
    remat: bool = False
    scan_layers: bool = False
    # MoE: >0 experts turns MLP slots into MoE layers (served by a later slice)
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_layer_freq: int = 2  # every Nth block is MoE
    moe_aux_loss_coef: float = 0.01
    moe_min_capacity: int = 4

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def ffn_dim(self) -> int:
        if self.d_ff is not None:
            return self.d_ff
        if self.activation in ("swiglu", "geglu"):  # gated MLPs get the 8/3 sizing
            return int(8 * self.d_model / 3 + 127) // 128 * 128 if self.d_model >= 128 else 2 * self.d_model
        return 4 * self.d_model

    @property
    def head_dim(self) -> int:
        if self.head_dims is not None:
            return self.head_dims
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads

    @property
    def use_dense_bias(self) -> bool:
        return self.norm == "layernorm" if self.dense_bias is None else self.dense_bias

    @property
    def use_qkv_bias(self) -> bool:
        return self.use_dense_bias if self.qkv_bias is None else self.qkv_bias

    @property
    def use_attn_out_bias(self) -> bool:
        return self.use_dense_bias if self.attn_out_bias is None else self.attn_out_bias

    def window_for(self, layer_idx: int) -> Optional[int]:
        """Sliding-window width for one layer (None = full attention)."""
        if self.sliding_window is None:
            return None
        if self.window_layers is None:
            return self.sliding_window
        return self.sliding_window if layer_idx in self.window_layers else None

    @property
    def uniform_window(self) -> bool:
        """True when every layer shares one window config."""
        if self.sliding_window is None or self.window_layers is None:
            return True
        return set(self.window_layers) in (set(), set(range(self.n_layers)))

    @property
    def rotary_dim(self) -> int:
        # even; partial rotary rotates the leading dims
        if self.rotary_dims is not None:
            return self.rotary_dims
        return max(2, int(self.head_dim * self.rotary_pct) // 2 * 2)


# -------------------- rope / alibi --------------------
def rope_frequencies(head_dim: int, max_len: int, theta: float,
                     device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta**(torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)  # (L, D/2)
    return torch.cos(freqs), torch.sin(freqs)


def _scaled_inv_freq(cfg: TransformerConfig, rd: int) -> Tuple[np.ndarray, float]:
    """Inverse frequencies (fp64) and the cos/sin scale for ``cfg.rope_scaling``,
    with HF semantics (``transformers/modeling_rope_utils.py``)."""
    theta, factor = cfg.rope_theta, cfg.rope_factor
    inv = 1.0 / (theta**(np.arange(0, rd, 2, dtype=np.float64) / rd))
    attn_factor = 1.0
    kind = cfg.rope_scaling
    if kind == "linear":
        inv = inv / factor
    elif kind == "dynamic":
        # NTK-aware base rescale at the static max context (HF recomputes per
        # growing seq_len; a static table takes the worst case)
        orig = cfg.rope_orig_max_seq or cfg.max_seq_len
        seq_len = max(cfg.max_seq_len, orig)
        base = theta * ((factor * seq_len / orig) - (factor - 1))**(rd / (rd - 2))
        inv = 1.0 / (base**(np.arange(0, rd, 2, dtype=np.float64) / rd))
    elif kind == "llama3":
        orig = cfg.rope_orig_max_seq or cfg.max_seq_len
        low_wav = orig / cfg.rope_low_freq_factor
        high_wav = orig / cfg.rope_high_freq_factor
        wavelen = 2 * np.pi / inv
        inv_l = np.where(wavelen > low_wav, inv / factor, inv)
        smooth = (orig / wavelen - cfg.rope_low_freq_factor) / \
            (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smoothed = (1 - smooth) * inv_l / factor + smooth * inv_l
        medium = ~(wavelen < high_wav) & ~(wavelen > low_wav)
        inv = np.where(medium, smoothed, inv_l)
    elif kind == "yarn":
        orig = cfg.rope_orig_max_seq or cfg.max_seq_len

        def corr_dim(n_rot):
            return (rd * np.log(orig / (n_rot * 2 * np.pi))) / (2 * np.log(theta))

        low = max(np.floor(corr_dim(cfg.rope_beta_fast)), 0)
        high = min(np.ceil(corr_dim(cfg.rope_beta_slow)), rd - 1)
        if low == high:
            high += 0.001  # HF's singularity guard
        ramp = np.clip((np.arange(rd // 2, dtype=np.float64) - low) / (high - low), 0, 1)
        extrap_factor = 1 - ramp
        inv = (inv / factor) * (1 - extrap_factor) + inv * extrap_factor
        if cfg.rope_attn_factor is not None:
            attn_factor = cfg.rope_attn_factor
        else:
            attn_factor = 0.1 * np.log(factor) + 1.0 if factor > 1 else 1.0
    elif kind is not None:
        raise NotImplementedError(f"rope_scaling={kind!r} (supported: linear/dynamic/llama3/yarn)")
    return inv, attn_factor


@functools.lru_cache(maxsize=8)
def _rope_table_np(cfg: TransformerConfig, rd: int) -> Tuple[np.ndarray, np.ndarray]:
    inv, attn_factor = _scaled_inv_freq(cfg, rd)
    freqs = np.outer(np.arange(cfg.max_seq_len, dtype=np.float64), inv)  # (L, rd/2)
    return ((np.cos(freqs) * attn_factor).astype(np.float32),
            (np.sin(freqs) * attn_factor).astype(np.float32))


def scaled_rope_frequencies(cfg: TransformerConfig, head_dim: int,
                            device: Optional[torch.device] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 cos/sin tables (max_seq_len, head_dim/2) honoring ``cfg.rope_scaling``.
    Computed with numpy in fp64 like the reference, then cast once; the
    numpy tables are cached per (config, dim)."""
    cos, sin = _rope_table_np(cfg, head_dim)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


@functools.lru_cache(maxsize=8)
def device_rope_tables(cfg: TransformerConfig, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``scaled_rope_frequencies`` at ``cfg.rotary_dim`` on ``device``, copied
    there once per (config, device): llama3_8b's tables (131,072 positions)
    are 67 MB, too much to copy in every layer of every step."""
    return scaled_rope_frequencies(cfg, cfg.rotary_dim, device=device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor,
               rotary_dim: Optional[int] = None, style: str = "neox") -> torch.Tensor:
    """x: (B,S,H,D); positions: (B,S) absolute token positions.

    ``rotary_dim < D`` rotates only the leading dims; the tail passes
    through. ``style``: "neox" rotates half-split pairs, "gptj" adjacent
    interleaved pairs. The rotation runs in fp32 and casts back to x's type.
    """
    D = x.shape[-1]
    rd = D if rotary_dim is None else rotary_dim
    xr, xp = (x, None) if rd == D else (x[..., :rd], x[..., rd:])
    idx = positions.long()
    c = cos[idx][:, :, None, :]  # (B,S,1,rd/2)
    s = sin[idx][:, :, None, :]
    xr32 = xr.float()
    if style == "gptj":
        x1, x2 = xr32[..., 0::2], xr32[..., 1::2]
        out = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(xr.shape)
    else:
        x1, x2 = torch.chunk(xr32, 2, dim=-1)
        out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    out = out.to(x.dtype)
    return out if xp is None else torch.cat([out, xp], dim=-1)


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes: geometric sequence of 2^(-8/n) for the closest
    power of two, interpolated for non-power-of-two head counts."""
    def slopes(n: int):
        p = 2**int(np.floor(np.log2(n)))
        base = [2**(-(2.0**-(np.log2(p) - 3)) * (i + 1)) for i in range(p)]
        if p < n:
            base += slopes(2 * p)[0::2][:n - p]
        return base

    return np.asarray(slopes(n_heads), np.float32)


# -------------------- parameters --------------------
def _is_moe_layer(cfg: TransformerConfig, i: int) -> bool:
    freq = max(1, cfg.moe_layer_freq)
    return cfg.moe_num_experts > 0 and (i % freq == freq - 1)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Nested dict of parameter shapes under the flax keys of the reference
    ``CausalLM`` (decoders and post-LN blocks, without MoE).
    Leaves are ``(shape, init)`` with init "kernel" (lecun-normal, fan-in
    over the contracted dims), "embed" (normal 0.02), "ones" or "zeros"."""
    if cfg.moe_num_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet")
    if cfg.scan_layers:
        raise NotImplementedError("scan_layers (a stacked 'layers' tree) is not ported; use scan_layers=False")
    if cfg.mlm_head or cfg.type_vocab_size > 0:
        raise NotImplementedError("the BERT heads (mlm_head, type embeddings) are not ported yet")
    d, H, KVH, Dh, f = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.ffn_dim

    def norm():
        if cfg.norm == "layernorm_np":
            return None
        if cfg.norm == "rmsnorm":
            return {"scale": ((d,), "zeros" if cfg.rms_offset else "ones")}
        return {"scale": ((d,), "ones"), "bias": ((d,), "zeros")}

    norm_key = "RMSNorm" if cfg.norm == "rmsnorm" else "LayerNorm"

    def dense(shape, fan_in, bias_shape=None):
        p = {"kernel": (shape, ("kernel", fan_in))}
        if bias_shape is not None:
            p["bias"] = (bias_shape, "zeros")
        return p

    qkvb = cfg.use_qkv_bias
    out: Dict[str, Any] = {"wte": ((cfg.vocab_size, d), "embed")}
    if cfg.pos_emb == "learned":
        out["wpe"] = ((cfg.max_seq_len, d), "embed")
    n_norm = 0
    if cfg.embedding_norm and norm() is not None:
        out[f"{norm_key}_0"] = norm()
        n_norm = 1
    for i in range(cfg.n_layers):
        attn = {
            "q_proj": dense((d, H, Dh), d, (H, Dh) if qkvb else None),
            "k_proj": dense((d, KVH, Dh), d, (KVH, Dh) if qkvb else None),
            "v_proj": dense((d, KVH, Dh), d, (KVH, Dh) if qkvb else None),
            "o_proj": dense((H, Dh, d), H * Dh, (d,) if cfg.use_attn_out_bias else None),
        }
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": ((Dh,), "ones")}
            attn["k_norm"] = {"scale": ((Dh,), "ones")}
        b = (f,) if cfg.use_dense_bias else None
        mlp = {"up_proj": dense((d, f), d, b),
               "down_proj": dense((f, d), f, (d,) if cfg.use_dense_bias else None)}
        if cfg.activation in ("swiglu", "geglu"):
            mlp["gate_proj"] = dense((d, f), d, b)
        layer: Dict[str, Any] = {"attn": attn, "mlp": mlp}
        n_block_norms = 1 if cfg.block_type == "parallel_shared" else 2
        if norm() is not None:
            for j in range(n_block_norms):
                layer[f"{norm_key}_{j}"] = norm()
        out[f"layer_{i}"] = layer
    if norm() is not None and cfg.norm_scheme != "post":  # post-LN blocks end normalized
        out[f"{norm_key}_{n_norm}"] = norm()
    if not cfg.tie_embeddings:
        out["lm_head"] = dense((d, cfg.vocab_size), d, (cfg.vocab_size,) if cfg.lm_head_bias else None)
    return out


def _init_leaf(spec, generator: torch.Generator, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    shape, init = spec
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if init == "embed":
        t.normal_(0.0, 0.02, generator=generator)
    else:
        # flax lecun_normal: truncated normal on [-2, 2] sigma, std corrected
        # for the truncation (variance_scaling(1, "fan_in", "truncated_normal"))
        std = math.sqrt(1.0 / init[1]) / 0.87962566103423978
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    return t.to(dtype)


def init_params(cfg: TransformerConfig, generator: torch.Generator, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random parameters with the reference's keys, shapes and initializer
    families (lecun-normal kernels, normal(0.02) embeddings, ones for norm
    scales), drawn from ``generator`` leaf by leaf on ``device``. Each leaf is
    drawn in fp32 and stored in ``dtype`` (default fp32, as flax stores
    them). The numbers differ from a flax init with the same seed."""
    device = torch.device(device)
    dtype = dtype or torch.float32

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        return _init_leaf(tree, generator, device, dtype)

    return build(param_shapes(cfg))


# -------------------- training forward --------------------
# Plain functions over the parameter dict, one per flax module of the
# reference. Dense layers compute in ``cfg.dtype`` (the reference's
# ``dtype=cfg.dtype, param_dtype=float32``); norms keep fp32 statistics.
def _dense(x: torch.Tensor, p: Dict[str, Any], spec: str, dtype: torch.dtype) -> torch.Tensor:
    y = torch.einsum(spec, x.to(dtype), p["kernel"].to(dtype))
    return y + p["bias"].to(dtype) if "bias" in p else y


def rms_norm_fwd(x: torch.Tensor, p: Dict[str, Any], eps: float, dtype: torch.dtype,
                 offset: bool = False) -> torch.Tensor:
    """The reference ``RMSNorm``: fp32 statistics, ``(1 + w)`` when ``offset``."""
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    w = 1.0 + p["scale"] if offset else p["scale"]
    return (y * w).to(dtype)


def layer_norm_fwd(x: torch.Tensor, p: Optional[Dict[str, Any]], eps: float, dtype: torch.dtype) -> torch.Tensor:
    """The reference ``LayerNorm`` (``p`` holds scale and bias) and
    ``LayerNormNP`` (``p`` is None): fp32 statistics."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"] + p["bias"]
    return y.to(dtype)


def _norm(cfg: TransformerConfig, x: torch.Tensor, p) -> torch.Tensor:
    if cfg.norm == "rmsnorm":
        return rms_norm_fwd(x, p, cfg.norm_eps, cfg.dtype, cfg.rms_offset)
    return layer_norm_fwd(x, p, cfg.norm_eps, cfg.dtype)


def _norm_key(cfg: TransformerConfig, j: int) -> str:
    return f"{'RMSNorm' if cfg.norm == 'rmsnorm' else 'LayerNorm'}_{j}"


def _norm_params(cfg: TransformerConfig, tree: Dict[str, Any], j: int):
    return None if cfg.norm == "layernorm_np" else tree[_norm_key(cfg, j)]


def attention_fwd(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
                  layer_idx: int, kv_cache: Optional[KVCache] = None):
    """The reference ``Attention``: projections, clip, qk-norm, rope, then
    ``ops.attention`` (the flash kernels on CUDA). With a ``kv_cache``
    ``(ck, cv, cache_len)`` (the v1 engine's dense cache), k and v are written
    into the cache at ``[cache_len, cache_len + S)`` in place, attention runs
    over the cache with ``kv_len = cache_len + S`` (``attention_xla``, on CUDA
    too, as in the reference), and ``(out, (ck, cv, cache_len + S))`` is
    returned."""
    from ..ops.attention import attention

    dt = cfg.dtype
    q = _dense(x, p["q_proj"], "bsd,dhk->bshk", dt)
    k = _dense(x, p["k_proj"], "bsd,dhk->bshk", dt)
    v = _dense(x, p["v_proj"], "bsd,dhk->bshk", dt)
    if cfg.clip_qkv is not None:
        c = cfg.clip_qkv
        q, k, v = (torch.clamp(t, -c, c) for t in (q, k, v))
    if cfg.qk_norm:
        q = rms_norm_fwd(q, p["q_norm"], cfg.norm_eps, dt)
        k = rms_norm_fwd(k, p["k_norm"], cfg.norm_eps, dt)
    if cfg.pos_emb == "rope":
        rd = cfg.rotary_dim
        cos, sin = device_rope_tables(cfg, x.device)
        q = apply_rope(q, cos, sin, positions, rotary_dim=rd, style=cfg.rope_style)
        k = apply_rope(k, cos, sin, positions, rotary_dim=rd, style=cfg.rope_style)
    new_cache = kv_len = None
    if kv_cache is not None:
        ck, cv, cache_len = kv_cache
        S = x.shape[1]
        ck[:, cache_len:cache_len + S] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + S] = v.to(cv.dtype)
        k, v = ck, cv
        kv_len = cache_len + S
        new_cache = (ck, cv, kv_len)
    slopes = alibi_slopes(cfg.n_heads) if cfg.pos_emb == "alibi" else None
    out = attention(q, k, v, causal=cfg.causal, kv_len=kv_len, alibi_slopes=slopes,
                    window=cfg.window_for(layer_idx), scale=cfg.attn_scale)
    out = _dense(out, p["o_proj"], "bshk,hkd->bsd", dt)
    return (out, new_cache) if kv_cache is not None else out


def mlp_fwd(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The reference ``MLP``: gated (swiglu, geglu) or not (gelu tanh, exact gelu, relu)."""
    dt = cfg.dtype
    if cfg.activation in ("swiglu", "geglu"):
        gate = _dense(x, p["gate_proj"], "bsd,df->bsf", dt)
        up = _dense(x, p["up_proj"], "bsd,df->bsf", dt)
        act = torch.nn.functional.gelu(gate, approximate="tanh") if cfg.activation == "geglu" \
            else torch.nn.functional.silu(gate)
        h = act * up
    else:
        h = _dense(x, p["up_proj"], "bsd,df->bsf", dt)
        if cfg.activation == "relu":
            h = torch.relu(h)
        else:
            h = torch.nn.functional.gelu(h, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
    return _dense(h, p["down_proj"], "bsf,fd->bsd", dt)


def block_fwd(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
              layer_idx: int, kv_cache: Optional[KVCache] = None):
    """The reference ``Block``: sequential pre-norm, ``parallel`` (gpt-neox),
    ``parallel_shared`` (one norm feeds both branches) or post-LN. With a
    ``kv_cache``, returns ``(x, new_cache)``."""
    norm = lambda h, j: _norm(cfg, h, _norm_params(cfg, p, j))
    mlp = lambda h: mlp_fwd(cfg, p["mlp"], h)
    new_cache = None

    def attn(h):
        nonlocal new_cache
        if kv_cache is None:
            return attention_fwd(cfg, p["attn"], h, positions, layer_idx)
        out, new_cache = attention_fwd(cfg, p["attn"], h, positions, layer_idx, kv_cache)
        return out

    if cfg.block_type == "parallel_shared":
        h = norm(x, 0)
        x = x + attn(h) + mlp(h)
    elif cfg.block_type == "parallel":
        x = x + attn(norm(x, 0)) + mlp(norm(x, 1))
    elif cfg.norm_scheme == "post":
        x = norm(x + attn(x), 0)
        x = norm(x + mlp(x), 1)
    else:
        x = x + attn(norm(x, 0))
        x = x + mlp(norm(x, 1))
    return (x, new_cache) if kv_cache is not None else x


def transformer_forward(cfg: TransformerConfig, params: Dict[str, Any], input_ids: torch.Tensor,
                        positions: Optional[torch.Tensor] = None, return_hidden: bool = False,
                        kv_caches: Optional[List[KVCache]] = None, train: Optional[bool] = None):
    """The reference ``Transformer.__call__``: embeddings (learned, rope,
    ALiBi or no positions; ``embed_scale``, ``embedding_norm``), the blocks
    (``torch.utils.checkpoint`` per block when ``cfg.remat`` and there are no
    caches), the final norm, then fp32 logits through the tied or untied
    head, or the hidden states with ``return_hidden``. With ``kv_caches``
    (``CausalLM.init_kv_caches``), returns ``(logits or hidden, new_caches)``.
    ``train`` is accepted for the reference's signature (it only gates MoE
    capacity drops, and MoE is not ported)."""
    if cfg.moe_num_experts > 0 or cfg.scan_layers or cfg.mlm_head or cfg.type_vocab_size > 0:
        raise NotImplementedError("MoE, scan_layers and the BERT heads are not ported yet")
    dt = cfg.dtype
    B, S = input_ids.shape
    ids = input_ids.long()
    if positions is None:
        positions = torch.arange(S, device=ids.device).expand(B, S)
    x = torch.nn.functional.embedding(ids, params["wte"]).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dt)
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][positions.long()].to(dt)
    n_norm = 0
    if cfg.embedding_norm and cfg.norm != "layernorm_np":
        x = _norm(cfg, x, params[_norm_key(cfg, 0)])
        n_norm = 1
    elif cfg.embedding_norm:
        x = _norm(cfg, x, None)
    new_caches = [] if kv_caches is not None else None
    for i in range(cfg.n_layers):
        fn = functools.partial(block_fwd, cfg, params[f"layer_{i}"], layer_idx=i)
        if kv_caches is not None:
            x, c = fn(x, positions, kv_cache=kv_caches[i])
            new_caches.append(c)
        elif cfg.remat:
            x = torch.utils.checkpoint.checkpoint(fn, x, positions, use_reentrant=False)
        else:
            x = fn(x, positions)
    if cfg.norm_scheme != "post":
        x = _norm(cfg, x, _norm_params(cfg, params, n_norm))
    if return_hidden:
        return (x, new_caches) if kv_caches is not None else x
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["wte"].to(dt))
    else:
        logits = _dense(x, params["lm_head"], "bsd,dv->bsv", dt)
    logits = logits.float()
    return (logits, new_caches) if kv_caches is not None else logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100) -> torch.Tensor:
    """Mean CE over non-ignored positions; logits fp32 (B, S, V), labels (B, S)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    return torch.sum((logz - gold) * valid) / torch.clamp(valid.sum(), min=1)


class CausalLM:
    """Binds the transformer to the engine's ``loss_fn(params, batch, rng)``
    contract. A batch is a dict with ``input_ids`` (B, S) and optional
    ``labels`` (shifted internally when absent)."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg

    def apply(self, params, input_ids, **kwargs):
        return transformer_forward(self.cfg, params, input_ids, **kwargs)

    def init_kv_caches(self, batch_size: int, max_len: int, dtype: Optional[torch.dtype] = None,
                       device="cuda") -> List[KVCache]:
        """Preallocated per-layer dense KV caches for incremental decoding:
        ``(k (B, max_len, KVH, Dh), v (same), cache_len 0)`` in ``dtype``
        (default ``cfg.dtype``). The length is a host int, so a step reads
        nothing back; the forward writes the tensors in place."""
        from ..device import resolve_device

        cfg = self.cfg
        dev = resolve_device(device)
        shape = (batch_size, max_len, cfg.kv_heads, cfg.head_dim)
        zeros = lambda: torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev)
        return [(zeros(), zeros(), 0) for _ in range(cfg.n_layers)]

    def loss_fn(self, params, batch, rng=None) -> torch.Tensor:
        from ..ops.fused_ce import fused_cross_entropy

        cfg = self.cfg
        input_ids = batch["input_ids"]
        hidden = self.apply(params, input_ids, return_hidden=True)
        if cfg.tie_embeddings:
            w, vd, head_b = params["wte"].to(cfg.dtype), True, None
        else:
            w, vd = params["lm_head"]["kernel"].to(cfg.dtype), False
            head_b = params["lm_head"]["bias"] if cfg.lm_head_bias else None
        if "labels" in batch:
            labels = batch["labels"]
        else:
            # shift left; keep S intact (last position ignored) so the
            # sequence chunking of the fused CE stays aligned
            labels = torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], -100)], dim=1)
        return fused_cross_entropy(hidden, w, labels, vd_layout=vd, bias=head_b)


# -------------------- presets --------------------
def gpt2_tiny(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=1024, n_layers=2, n_heads=4, d_model=64, max_seq_len=256, **kw)


def gpt2_125m(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=50257, n_layers=12, n_heads=12, d_model=768, max_seq_len=1024, **kw)


def gpt2_1_3b(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=50257, n_layers=24, n_heads=32, d_model=2048, max_seq_len=1024, **kw)


def llama_tiny(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=1024, n_layers=2, n_heads=4, n_kv_heads=2, d_model=64, max_seq_len=256,
                             norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False, **kw)


def llama2_7b(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=32000, n_layers=32, n_heads=32, d_model=4096, d_ff=11008, max_seq_len=4096,
                             norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False, **kw)


def llama3_8b(**kw) -> TransformerConfig:
    """Llama-3.1-8B geometry: GQA 4:1, theta 5e5, banded rope scaling."""
    return TransformerConfig(vocab_size=128256, n_layers=32, n_heads=32, n_kv_heads=8, d_model=4096, d_ff=14336,
                             max_seq_len=131072, norm="rmsnorm", activation="swiglu", pos_emb="rope",
                             rope_theta=500000.0, rope_scaling="llama3", rope_factor=8.0,
                             rope_orig_max_seq=8192, tie_embeddings=False, **kw)

