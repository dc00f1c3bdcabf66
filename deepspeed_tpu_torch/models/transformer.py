"""Decoder-only transformer family: configuration, presets, rope, init.

Port of ``deepspeed_tpu/models/transformer.py`` for serving. The
parameter tree keeps the flax layout and keys of the reference
(``wte``, ``layer_{i}/attn/q_proj/kernel`` of shape (d, H, Dh), ...), so
weights convert by copy (``convert.params_from_numpy``) and the serving
runner contracts them with the same einsum specs. The flax training
modules (``Attention``, ``Block``, ``Transformer``, ``CausalLM.loss_fn``)
come with the training slice.
"""

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


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
    ``CausalLM`` for the serving families (pre-norm decoders without MoE).
    Leaves are ``(shape, init)`` with init "kernel" (lecun-normal, fan-in
    over the contracted dims), "embed" (normal 0.02), "ones" or "zeros"."""
    if cfg.moe_num_experts > 0:
        raise NotImplementedError("MoE layers are served by a later port slice")
    if cfg.norm_scheme != "pre" or cfg.mlm_head or cfg.type_vocab_size > 0:
        raise NotImplementedError("encoder (BERT) models are not part of the serving slice")
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
    if norm() is not None:
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

