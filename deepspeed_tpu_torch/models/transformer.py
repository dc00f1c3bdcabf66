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
v1 engine (``CausalLM.init_kv_caches``, ``kv_caches=``). MoE blocks (every
``moe_layer_freq``-th block, ``moe.MoE`` in the MLP's slot under ``moe``)
return their load-balancing losses to ``CausalLM.loss_fn``.
``CausalLM.to_pipeline`` cuts the model into a rank's pipeline stage. Under
sequence parallelism (``sequence.sequence_parallel``, entered by the
training engine) a rank holds a contiguous slice of each row: the forward
gives its tokens their global positions, and attention runs through
Ulysses (``seq``) or the ring (``context``). Under tensor parallelism
(``parallel.tensor.tensor_parallel``, entered by the training engine; or
serving's ``TPContext`` passed as ``tp``) a rank holds its slice of the
heads, of the MLP's hidden columns and of a vocab-split ``wte`` or head:
the column-parallel projections take their input through ``tp.copy``, the
row-parallel ones sum over the group (``tp.reduce``) before their bias, and
the loss is the vocab-parallel fused cross-entropy
(``ops.fused_ce.vocab_parallel_cross_entropy``).
The encoder family (BERT, DistilBERT; JAX ``Transformer.__call__``
``:450-503``): token-type embeddings (``type_vocab_size``; ``type_emb``),
post-LN blocks (``norm_scheme="post"``: no final norm), bidirectional
attention (``causal=False``) and the MLM head (``mlm_head``: ``mlm_dense``,
the activation and a norm before the tied decoder, which adds
``mlm_bias``). ``scan_layers`` (JAX ``_scan_blocks``): the blocks' trees
stacked under ``layers/block`` (each leaf (L, ...), the flax scan's layout,
so a JAX tree converts by copy); the forward runs block i on slice i, with
remat a block, and every block is JAX's scanned ``Block`` (``layer_idx`` 0:
its MoE slot and window). The refusals stay JAX's: per-layer
``window_layers``, progressive layer drop and the pipeline. Progressive
layer drop itself is not ported (it raises).
"""

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..moe.layer import MoE
from ..runtime.activation_checkpointing import checkpointing
from ..parallel.tensor import current_tensor_parallel
from ..runtime.pipe.module import PipelineStage
from ..sequence.layer import current_sequence_parallel

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
    # MoE: >0 experts turns MLP slots into MoE layers
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


def moe_block(cfg: TransformerConfig) -> MoE:
    """The MoE layer of an MoE block, with the fields the reference ``Block``
    passes (no gate noise; eval capacity at its default)."""
    return MoE(hidden_size=cfg.d_model, num_experts=cfg.moe_num_experts, k=cfg.moe_top_k,
               capacity_factor=cfg.moe_capacity_factor, min_capacity=cfg.moe_min_capacity, d_ff=cfg.ffn_dim,
               activation=cfg.activation, dtype=cfg.dtype)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """Nested dict of parameter shapes under the flax keys of the reference
    ``CausalLM`` (decoders and post-LN blocks; an MoE block holds ``moe``
    in place of ``mlp``). Leaves are ``(shape, init)`` with init "kernel"
    (lecun-normal, fan-in over the contracted dims), "embed" or "normal"
    (normal 0.02), "ones" or "zeros". With ``scan_layers`` the blocks are
    one tree under ``layers/block`` whose leaves carry a leading
    (n_layers,) axis (the fan-in stays a block's)."""
    check_scan(cfg)
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
    if cfg.type_vocab_size > 0:
        out["type_emb"] = ((cfg.type_vocab_size, d), "embed")
    n_norm = 0
    if cfg.embedding_norm and norm() is not None:
        out[f"{norm_key}_0"] = norm()
        n_norm = 1
    def block(i):
        attn = {
            "q_proj": dense((d, H, Dh), d, (H, Dh) if qkvb else None),
            "k_proj": dense((d, KVH, Dh), d, (KVH, Dh) if qkvb else None),
            "v_proj": dense((d, KVH, Dh), d, (KVH, Dh) if qkvb else None),
            "o_proj": dense((H, Dh, d), H * Dh, (d,) if cfg.use_attn_out_bias else None),
        }
        if cfg.qk_norm:
            attn["q_norm"] = {"scale": ((Dh,), "ones")}
            attn["k_norm"] = {"scale": ((Dh,), "ones")}
        layer: Dict[str, Any] = {"attn": attn}
        if _is_moe_layer(cfg, i):
            layer["moe"] = moe_block(cfg).param_shapes()
        else:
            b = (f,) if cfg.use_dense_bias else None
            mlp = {"up_proj": dense((d, f), d, b),
                   "down_proj": dense((f, d), f, (d,) if cfg.use_dense_bias else None)}
            if cfg.activation in ("swiglu", "geglu"):
                mlp["gate_proj"] = dense((d, f), d, b)
            layer["mlp"] = mlp
        n_block_norms = 1 if cfg.block_type == "parallel_shared" else 2
        if norm() is not None:
            for j in range(n_block_norms):
                layer[f"{norm_key}_{j}"] = norm()
        return layer

    if cfg.scan_layers:  # the scanned Block is JAX's layer_idx 0 for every layer
        stack = lambda t: {k: stack(v) for k, v in t.items()} if isinstance(t, dict) else ((cfg.n_layers, *t[0]), t[1])
        out["layers"] = {"block": stack(block(0))}
    else:
        for i in range(cfg.n_layers):
            out[f"layer_{i}"] = block(i)
    if norm() is not None and cfg.norm_scheme != "post":  # post-LN blocks end normalized
        out[f"{norm_key}_{n_norm}"] = norm()
        n_norm += 1
    if cfg.mlm_head:  # BERT's cls.predictions transform and the tied decoder's bias
        out["mlm_dense"] = dense((d, d), d, (d,))
        if norm() is not None:
            out[f"{norm_key}_{n_norm}"] = norm()
        out["mlm_bias"] = ((cfg.vocab_size,), "zeros")
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
    if init in ("embed", "normal"):
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


def _local_rows(b: torch.Tensor, n: int, rank: int) -> torch.Tensor:
    """Rows ``[rank n, (rank + 1) n)`` of ``b``, or ``b`` when it holds ``n`` rows already."""
    return b if b.shape[0] == n else b.narrow(0, rank * n, n)


def _col_dense(x: torch.Tensor, p: Dict[str, Any], spec: str, dtype: torch.dtype, tp=None) -> torch.Tensor:
    """A column-parallel projection (q/k/v, gate/up, a vocab-split head):
    under tensor parallelism the kernel holds this rank's heads or columns
    (its dimension 1), and a bias kept whole, as the training engine keeps
    it (JAX's rules split only the kernels), is cut to them; serving splits
    the bias with the kernel."""
    if tp is None:
        return _dense(x, p, spec, dtype)
    y = torch.einsum(spec, x.to(dtype), p["kernel"].to(dtype))
    return y + _local_rows(p["bias"], p["kernel"].shape[1], tp.rank).to(dtype) if "bias" in p else y


def _row_dense(x: torch.Tensor, p: Dict[str, Any], spec: str, dtype: torch.dtype, tp=None) -> torch.Tensor:
    """A row-parallel projection (``o_proj``, ``down_proj``): under tensor
    parallelism (``tp``: serving's ``TPContext`` or training's
    ``TensorParallel``) this rank's partial, summed over the group by
    ``tp.reduce``, then the bias, once."""
    if tp is None:
        return _dense(x, p, spec, dtype)
    y = tp.reduce(torch.einsum(spec, x.to(dtype), p["kernel"].to(dtype)))
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


def _top_norms(cfg: TransformerConfig) -> Tuple[int, int]:
    """The indices of the final norm and of the MLM head's norm among the
    top-level norms (the embedding norm, if any, is 0)."""
    final = 1 if cfg.embedding_norm and cfg.norm != "layernorm_np" else 0
    return final, final + (0 if cfg.norm_scheme == "post" or cfg.norm == "layernorm_np" else 1)


def mlm_transform(cfg: TransformerConfig, params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """BERT's ``cls.predictions.transform`` (JAX ``:486-492``): dense, the
    activation (relu, or gelu: exact for ``gelu_exact``, else tanh), norm."""
    x = _dense(x, params["mlm_dense"], "bsd,de->bse", cfg.dtype)
    if cfg.activation == "relu":
        x = torch.relu(x)
    else:
        x = torch.nn.functional.gelu(x, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
    return _norm(cfg, x, _norm_params(cfg, params, _top_norms(cfg)[1]))


def attention_fwd(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
                  layer_idx: int, kv_cache: Optional[KVCache] = None, tp=None):
    """The reference ``Attention``: projections, clip, qk-norm, rope, then
    ``ops.attention`` (the flash kernels on CUDA), or, under sequence
    parallelism, Ulysses' ``DistributedAttention`` around it (``seq``) or
    ``ring_attention`` (``context``). With a ``kv_cache``
    ``(ck, cv, cache_len)`` (the v1 engine's dense cache), k and v are written
    into the cache at ``[cache_len, cache_len + S)`` in place, attention runs
    over the cache with ``kv_len = cache_len + S`` (``attention_xla``, on CUDA
    too, as in the reference), and ``(out, (ck, cv, cache_len + S))`` is
    returned. With ``tp`` the projections hold this rank's heads (read off
    the arrays), their input passes ``tp.copy``, ALiBi takes their slopes,
    and ``o_proj`` reduces over the group."""
    from ..ops.attention import attention

    dt = cfg.dtype
    if tp is not None:
        x = tp.copy(x)
    q = _col_dense(x, p["q_proj"], "bsd,dhk->bshk", dt, tp)
    k = _col_dense(x, p["k_proj"], "bsd,dhk->bshk", dt, tp)
    v = _col_dense(x, p["v_proj"], "bsd,dhk->bshk", dt, tp)
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
    slopes = None
    if cfg.pos_emb == "alibi":
        slopes = tp.local_slopes(cfg.n_heads) if tp is not None else alibi_slopes(cfg.n_heads)
    sp = current_sequence_parallel() if kv_cache is None and tp is None else None
    if sp is not None:  # this rank holds a slice of the sequence: the exchange runs around the attention
        out = sp.attention(q, k, v, causal=cfg.causal, alibi_slopes=slopes, window=cfg.window_for(layer_idx),
                           scale=cfg.attn_scale)
    else:
        out = attention(q, k, v, causal=cfg.causal, kv_len=kv_len, alibi_slopes=slopes,
                        window=cfg.window_for(layer_idx), scale=cfg.attn_scale)
    out = _row_dense(out, p["o_proj"], "bshk,hkd->bsd", dt, tp)
    return (out, new_cache) if kv_cache is not None else out


def mlp_fwd(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor, tp=None) -> torch.Tensor:
    """The reference ``MLP``: gated (swiglu, geglu) or not (gelu tanh, exact
    gelu, relu). With ``tp``: this rank's hidden columns (the input through
    ``tp.copy``), ``down_proj`` reduced over the group."""
    dt = cfg.dtype
    if tp is not None:
        x = tp.copy(x)
    if cfg.activation in ("swiglu", "geglu"):
        gate = _col_dense(x, p["gate_proj"], "bsd,df->bsf", dt, tp)
        up = _col_dense(x, p["up_proj"], "bsd,df->bsf", dt, tp)
        act = torch.nn.functional.gelu(gate, approximate="tanh") if cfg.activation == "geglu" \
            else torch.nn.functional.silu(gate)
        h = act * up
    else:
        h = _col_dense(x, p["up_proj"], "bsd,df->bsf", dt, tp)
        if cfg.activation == "relu":
            h = torch.relu(h)
        else:
            h = torch.nn.functional.gelu(h, approximate="none" if cfg.activation == "gelu_exact" else "tanh")
    return _row_dense(h, p["down_proj"], "bsf,fd->bsd", dt, tp)


def block_fwd(cfg: TransformerConfig, p: Dict[str, Any], x: torch.Tensor, positions: torch.Tensor,
              layer_idx: int, kv_cache: Optional[KVCache] = None, train: bool = True,
              moe_aux: Optional[List] = None, tp=None):
    """The reference ``Block``: sequential pre-norm, ``parallel`` (gpt-neox),
    ``parallel_shared`` (one norm feeds both branches) or post-LN. With a
    ``kv_cache``, returns ``(x, new_cache)``. An MoE block drops tokens by
    capacity only when ``train``, and appends ``(l_aux, exp_counts)`` to
    ``moe_aux`` when one is given. ``tp``: the v1 engine's tensor-parallel
    context or training's ``TensorParallel`` (this rank's heads and hidden
    columns; in serving an MoE block's experts hold I / tp hidden columns,
    and their output reduces over the group)."""
    norm = lambda h, j: _norm(cfg, h, _norm_params(cfg, p, j))
    new_cache = None

    def mlp(h):
        if "moe" not in p:
            return mlp_fwd(cfg, p["mlp"], h, tp)
        out, l_aux, exp_counts = moe_block(cfg)(p["moe"], h, train=train)
        if moe_aux is not None:
            moe_aux.append((l_aux, exp_counts))
        return out if tp is None else tp.reduce(out)

    def attn(h):
        nonlocal new_cache
        if kv_cache is None:
            return attention_fwd(cfg, p["attn"], h, positions, layer_idx, tp=tp)
        out, new_cache = attention_fwd(cfg, p["attn"], h, positions, layer_idx, kv_cache, tp=tp)
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


def check_scan(cfg: TransformerConfig) -> None:
    """JAX ``Transformer.__call__``'s refusal: scanned blocks are one block's code."""
    if cfg.scan_layers and not cfg.uniform_window:
        raise ValueError("per-layer window_layers needs heterogeneous blocks: set scan_layers=False")


def layer_params(cfg: TransformerConfig, params: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Block i's tree: ``layer_{i}``, or slice i of the stacked ``layers/block`` tree (``scan_layers``)."""
    if not cfg.scan_layers:
        return params[f"layer_{i}"]
    take = lambda t: {k: take(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return take(params["layers"]["block"])


def _read_block_fwd(cfg, params, i: int, train: bool, x, positions, moe_aux=None, tp=None):
    """Block i, its parameters read from ``params`` on every call (a checkpoint's recompute reads them again).
    A scanned block is JAX's ``Block`` at ``layer_idx`` 0."""
    return block_fwd(cfg, layer_params(cfg, params, i), x, positions, layer_idx=0 if cfg.scan_layers else i,
                     train=train, moe_aux=moe_aux, tp=tp)


def _head_split(cfg: TransformerConfig, w: torch.Tensor, vd_layout: bool, tp) -> bool:
    """Whether the head's weight holds only this rank's vocabulary columns."""
    return tp is not None and (w.shape[0] if vd_layout else w.shape[1]) != cfg.vocab_size


def head_loss(cfg: TransformerConfig, params: Dict[str, Any], hidden: torch.Tensor, labels: torch.Tensor,
              tp=None) -> torch.Tensor:
    """The mean token CE of the tied or untied head over the final hidden
    states: the fused cross-entropy, or its vocab-parallel form where the
    head's weight holds this rank's vocabulary columns."""
    from ..ops.fused_ce import fused_cross_entropy, vocab_parallel_cross_entropy

    if cfg.tie_embeddings:
        w, vd, head_b = params["wte"].to(cfg.dtype), True, params["mlm_bias"] if cfg.mlm_head else None
    else:
        w, vd = params["lm_head"]["kernel"].to(cfg.dtype), False
        head_b = params["lm_head"]["bias"] if cfg.lm_head_bias else None
    if _head_split(cfg, w, vd, tp):
        return vocab_parallel_cross_entropy(hidden, w, labels, tp, cfg.vocab_size, vd_layout=vd, bias=head_b)
    return fused_cross_entropy(hidden, w, labels, vd_layout=vd, bias=head_b)


def transformer_forward(cfg: TransformerConfig, params: Dict[str, Any], input_ids: torch.Tensor,
                        positions: Optional[torch.Tensor] = None, return_hidden: bool = False,
                        kv_caches: Optional[List[KVCache]] = None, train: Optional[bool] = None,
                        moe_aux: Optional[List] = None, tp=None, token_type_ids: Optional[torch.Tensor] = None,
                        pld_theta=None):
    """The reference ``Transformer.__call__``: embeddings (learned, rope,
    ALiBi or no positions; ``embed_scale``, token types (``token_type_ids``,
    zeros by default), ``embedding_norm``), the blocks
    (checkpointed one by one through ``runtime.activation_checkpointing`` when
    ``cfg.remat`` and there are no caches; the block reads its parameters
    inside the checkpointed function, so ZeRO stage 3 gathers them again for
    the recompute), the final norm (none after post-LN blocks), the MLM
    transform, then fp32 logits through the tied or untied head (plus
    ``mlm_bias``), or the hidden states with ``return_hidden``. With ``kv_caches``
    (``CausalLM.init_kv_caches``), returns ``(logits or hidden, new_caches)``.
    ``train`` gates MoE capacity drops only; by default a forward without
    caches drops and one with caches never does, as in the reference. Each
    MoE block appends its ``(l_aux, exp_counts)`` to ``moe_aux`` when given.
    ``tp`` (serving's ``TPContext``; without caches the training engine's
    current ``TensorParallel`` when none is given): the blocks run on this
    rank's shard, checkpointed as without it, and a vocab-sharded ``wte`` /
    head looks up this rank's rows and sums over the group, and computes its
    vocab columns and gathers them, so every rank gets the whole logits.
    ``scan_layers`` (without caches): block i reads slice i of the stacked
    tree (``layer_params``). ``pld_theta`` (progressive layer drop) raises:
    JAX's ``ValueError`` with ``scan_layers``, else ``NotImplementedError``."""
    if pld_theta is not None and cfg.scan_layers:
        raise ValueError("progressive layer drop needs the unrolled layer loop: set scan_layers=False")
    if pld_theta is not None:
        raise NotImplementedError("progressive layer drop is not ported")
    check_scan(cfg)
    train = (kv_caches is None) if train is None else bool(train)
    if tp is None and kv_caches is None:
        tp = current_tensor_parallel()
    dt = cfg.dtype
    B, S = input_ids.shape
    ids = input_ids.long()
    if positions is None:
        sp = current_sequence_parallel() if kv_caches is None and tp is None else None
        start = sp.rank * S if sp is not None else 0  # a sequence slice's tokens sit at their global positions
        positions = torch.arange(start, start + S, device=ids.device).expand(B, S)
    if tp is not None:
        x = tp.embed(params["wte"], ids, cfg.vocab_size).to(dt)
    else:
        x = torch.nn.functional.embedding(ids, params["wte"]).to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=dt)
    if cfg.pos_emb == "learned":
        x = x + params["wpe"][positions.long()].to(dt)
    if cfg.type_vocab_size > 0:  # BERT's segment embeddings
        tti = torch.zeros_like(ids) if token_type_ids is None else torch.as_tensor(token_type_ids).to(ids.device)
        x = x + params["type_emb"][tti.long()].to(dt)
    n_norm = _top_norms(cfg)[0]
    if cfg.embedding_norm:
        x = _norm(cfg, x, _norm_params(cfg, params, 0))
    new_caches = [] if kv_caches is not None else None
    for i in range(cfg.n_layers):
        if kv_caches is not None:
            x, c = block_fwd(cfg, params[f"layer_{i}"], x, positions, layer_idx=i, train=train,
                             kv_cache=kv_caches[i], moe_aux=moe_aux, tp=tp)
            new_caches.append(c)
        elif cfg.remat:
            # the backward's recompute appends to this block's own list, which nobody reads by then
            sink: List = []
            x = checkpointing.checkpoint(functools.partial(_read_block_fwd, cfg, params, i, train, tp=tp), x,
                                         positions, moe_aux=sink)
            if moe_aux is not None:
                moe_aux.extend(sink)
        else:
            x = _read_block_fwd(cfg, params, i, train, x, positions, moe_aux=moe_aux, tp=tp)
    if cfg.norm_scheme != "post":
        x = _norm(cfg, x, _norm_params(cfg, params, n_norm))
    if cfg.mlm_head:
        x = mlm_transform(cfg, params, x)
    if return_hidden:
        return (x, new_caches) if kv_caches is not None else x
    w = params["wte"] if cfg.tie_embeddings else params["lm_head"]["kernel"]
    split = _head_split(cfg, w, cfg.tie_embeddings, tp)
    if split:
        x = tp.copy(x)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, params["wte"].to(dt))
        if cfg.mlm_head:  # BERT's cls.predictions.bias, this rank's columns of it under a split head
            logits = logits + (_local_rows(params["mlm_bias"], w.shape[0], tp.rank) if split
                               else params["mlm_bias"]).to(dt)
    else:
        logits = _col_dense(x, params["lm_head"], "bsd,dv->bsv", dt, tp if split else None)
    logits = logits.float()
    if tp is not None:
        logits = tp.vocab_logits(logits, cfg.vocab_size)
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

    def partition_rules(self):
        """(path names, spec) pairs, a spec one mesh axis (or ``None``) per
        dimension: the JAX ``CausalLM.partition_rules`` (``transformer.py:751``),
        the MoE rules first. The training planner prunes the axes of size 1:
        at ``tensor`` > 1 the kernels split over it, the biases stay whole."""
        from ..moe.layer import MOE_PARTITION_RULES

        return list(MOE_PARTITION_RULES) + [
            (("wte",), ("tensor", None)),
            (("wpe",), (None, None)),
            (("q_proj", "kernel"), (None, "tensor", None)),
            (("k_proj", "kernel"), (None, "tensor", None)),
            (("v_proj", "kernel"), (None, "tensor", None)),
            (("o_proj", "kernel"), ("tensor", None, None)),
            (("gate_proj", "kernel"), (None, "tensor")),
            (("up_proj", "kernel"), (None, "tensor")),
            (("down_proj", "kernel"), ("tensor", None)),
            (("lm_head", "kernel"), (None, "tensor")),
        ]

    def pipeline_checks(self, num_stages: int) -> int:
        """The JAX ``to_pipeline``'s refusals (``transformer.py:593-665``);
        returns the layers a stage holds."""
        cfg = self.cfg
        if cfg.n_layers % num_stages != 0:
            raise ValueError(f"n_layers={cfg.n_layers} must divide evenly into {num_stages} pipeline stages")
        if cfg.scan_layers:
            raise ValueError("disable scan_layers for pipeline (stages are stacked instead)")
        if cfg.mlm_head or cfg.type_vocab_size > 0:
            raise NotImplementedError("BERT-style models (mlm_head / token-type embeddings) are not "
                                      "pipeline-partitionable (the MLM head and segment embeddings are "
                                      "not part of the pipelined embed/loss functions)")
        lps = cfg.n_layers // num_stages
        if cfg.moe_num_experts > 0:
            freq = max(1, cfg.moe_layer_freq)
            if lps % freq != 0:
                raise ValueError(
                    f"MoE x pipeline needs a stage-uniform expert pattern: layers_per_stage="
                    f"{lps} must be a multiple of moe_layer_freq={freq} "
                    f"(pick num_stages so each stage holds whole MoE periods)")
        for j in range(lps):
            ws = {cfg.window_for(s * lps + j) for s in range(num_stages)}
            if len(ws) > 1:
                raise NotImplementedError(
                    f"per-layer window pattern is not stage-uniform (sub-layer {j} sees windows {ws} "
                    f"across stages); choose num_stages so the window pattern repeats per stage")
        return lps

    def to_pipeline(self, num_stages: int, params=None, stage_id: int = 0,
                    generator: Optional[torch.Generator] = None) -> PipelineStage:
        """Stage ``stage_id`` of ``num_stages`` (JAX ``to_pipeline``,
        ``transformer.py:593``, cut to one rank): its parameter tree and its
        embed, stage and head functions. ``params`` is the whole model's tree
        (each rank keeps its stage's leaves) or already a stage tree (the
        converter's ``pipe_params_to_stage``); without it the model is drawn
        from ``generator`` on the CPU.

        The stage tree is ``{"embed": ..., "stages": {"sub_<j>": layer
        s * L + j}, "head": ...}`` (L layers a stage): ``embed`` holds ``wte``,
        ``wpe`` and the embedding norm on the first stage; ``head`` the final
        norm and an untied ``lm_head`` on the last. A tied head reads
        ``embed/wte``, which the last stage then holds too: its two copies are
        the tied pair the engine's ``ReduceTiedGrads`` keeps equal."""
        cfg = self.cfg
        lps = self.pipeline_checks(num_stages)
        first, last = stage_id == 0, stage_id == num_stages - 1
        if params is None:
            params = init_params(cfg, generator or torch.Generator().manual_seed(0), device="cpu")
        tree = params if "stages" in params else full_to_stage_params(cfg, params, num_stages, stage_id)
        has_moe = cfg.moe_num_experts > 0
        n_norm = 1 if cfg.embedding_norm and cfg.norm != "layernorm_np" else 0

        def embed_fn(ps, input_ids):
            ep = ps["embed"]
            ids = input_ids.long()
            B, S = ids.shape
            tp = current_tensor_parallel()
            x = (tp.embed(ep["wte"], ids, cfg.vocab_size) if tp is not None
                 else torch.nn.functional.embedding(ids, ep["wte"])).to(cfg.dtype)
            if cfg.embed_scale:
                x = x * torch.tensor(cfg.d_model**0.5, dtype=cfg.dtype)
            if cfg.pos_emb == "learned":
                x = x + ep["wpe"][torch.arange(S, device=ids.device)].to(cfg.dtype)
            if cfg.embedding_norm:
                x = _norm(cfg, x, ep[_norm_key(cfg, 0)] if n_norm else None)
            return x

        def stage_fn(ps, x):
            B, S = x.shape[0], x.shape[1]
            positions = torch.arange(S, device=x.device).expand(B, S)
            aux: List = []
            tp = current_tensor_parallel()
            for j in range(lps):
                i = stage_id * lps + j  # the global index: its window and its MoE slot
                x = block_fwd(cfg, ps["stages"][f"sub_{j}"], x, positions, layer_idx=i, train=True, moe_aux=aux,
                              tp=tp)
            if has_moe:  # pre-scaled: the engine adds it to the loss and seeds its gradient
                return x, cfg.moe_aux_loss_coef * sum(l_aux.float() for l_aux, _ in aux)
            return x, None

        def head_loss_fn(ps, x, labels):
            hp = ps["head"]
            if cfg.norm_scheme != "post":
                x = _norm(cfg, x, None if cfg.norm == "layernorm_np" else hp[_norm_key(cfg, n_norm)])
            tree = {"wte": ps["embed"]["wte"]} if cfg.tie_embeddings else hp
            return head_loss(cfg, tree, x, labels, current_tensor_parallel())

        tied = {"wte": ((0, num_stages - 1), "embed/wte")} if cfg.tie_embeddings and num_stages > 1 else {}
        return PipelineStage(stage_id=stage_id, num_stages=num_stages, params=tree, stage_fn=stage_fn,
                             embed_fn=embed_fn if first else None, head_loss_fn=head_loss_fn if last else None,
                             rules=self.partition_rules(), tied=tied, token_weighted=True)

    def loss_fn(self, params, batch, rng=None) -> torch.Tensor:
        cfg = self.cfg
        input_ids = batch["input_ids"]
        moe_aux: List = []
        extra = {"token_type_ids": batch["token_type_ids"]} if cfg.type_vocab_size > 0 and "token_type_ids" in batch \
            else {}
        if batch.get("pld_theta") is not None:
            extra["pld_theta"] = batch["pld_theta"]
        hidden = self.apply(params, input_ids, return_hidden=True, moe_aux=moe_aux, **extra)
        if "labels" in batch:
            labels = batch["labels"]
        else:
            # shift left; keep S intact (last position ignored) so the
            # sequence chunking of the fused CE stays aligned
            labels = torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], -100)], dim=1)
        ce = head_loss(cfg, params, hidden, labels, current_tensor_parallel())
        if cfg.moe_num_experts == 0:
            return ce
        return ce + cfg.moe_aux_loss_coef * sum(l_aux for l_aux, _ in moe_aux)


# -------------------- pipeline stages --------------------
def _split_top(cfg: TransformerConfig, params: Dict[str, Any]):
    """(embed keys, head keys) of a whole tree's top level: the JAX
    ``to_pipeline``'s split (``transformer.py:668-690``)."""
    n_norm = 1 if cfg.embedding_norm and cfg.norm != "layernorm_np" else 0
    embed = ["wte"] + (["wpe"] if cfg.pos_emb == "learned" else []) + ([_norm_key(cfg, 0)] if n_norm else [])
    head = [k for k in params if not (k.startswith("layer_") or k in embed)]
    return embed, head


def full_to_stage_params(cfg: TransformerConfig, params: Dict[str, Any], num_stages: int,
                         stage_id: int) -> Dict[str, Any]:
    """Stage ``stage_id``'s tree (``CausalLM.to_pipeline``) from the whole
    model's: the same leaves (no copies)."""
    lps = cfg.n_layers // num_stages
    embed_keys, head_keys = _split_top(cfg, params)
    first, last = stage_id == 0, stage_id == num_stages - 1
    tree: Dict[str, Any] = {}
    if first:
        tree["embed"] = {k: params[k] for k in embed_keys}
    elif last and cfg.tie_embeddings:
        tree["embed"] = {"wte": params["wte"]}  # the tied head's copy
    tree["stages"] = {f"sub_{j}": params[f"layer_{stage_id * lps + j}"] for j in range(lps)}
    if last:
        tree["head"] = {k: params[k] for k in head_keys}
    return tree


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

