"""The inference op surface: plain functions on tensors.

Port of ``deepspeed_tpu/ops/transformer/inference_ops.py`` (the reference's
fused-inference bindings, ``qkv_gemm_``, ``mlp_gemm_``, ``softmax_``,
``softmax_context_``, the ``bias_*`` kernels, ``apply_rotary_pos_emb``, the
norms, ``moe_res_matmul``, ``einsum_sec_sm_ecm_``, ``linear_layer_`` and the
head padding), function for function with the same arguments. The norms go
through ``ops/norms.py`` (the CUDA kernels on the card, their plain versions
on the CPU) and ``softmax_context`` through ``ops/attention.attention`` (the
flash kernels on the card); the rest is PyTorch, as the JAX package leaves
it to XLA. Norms and softmax compute in fp32 and return the input's dtype.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import norms
from ..attention import attention


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.float()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------
def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return norms.layer_norm(x.contiguous(), gamma.contiguous(), beta.contiguous(), eps)


def layer_norm_residual(x: torch.Tensor, bias: Optional[torch.Tensor], residual: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-5, store_pre_ln_res: bool = False):
    """norm(x + bias + residual); with ``store_pre_ln_res`` also the pre-norm sum (the next layer's residual)."""
    s = _f32(x) + _f32(residual)
    if bias is not None:
        s = s + _f32(bias)
    out = layer_norm(s, gamma, beta, eps).to(x.dtype)
    if store_pre_ln_res:
        return out, s.to(x.dtype)
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return norms.rms_norm(x.contiguous(), gamma.contiguous(), eps)


def pre_rms_norm(x: torch.Tensor, residual: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add the residual first: (normed, new residual)."""
    s = _f32(x) + _f32(residual)
    return rms_norm(s, gamma, eps).to(x.dtype), s.to(x.dtype)


# ----------------------------------------------------------------------
# fused projection blocks
# ----------------------------------------------------------------------
def _norm(x, gamma, beta, eps, norm_type):
    return layer_norm(x, gamma, beta, eps) if norm_type == "layernorm" else rms_norm(x, gamma, eps)


def qkv_gemm(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], gamma: torch.Tensor,
             beta: Optional[torch.Tensor], eps: float = 1e-5,
             norm_type: str = "layernorm") -> Tuple[torch.Tensor, torch.Tensor]:
    """Norm, then the fused QKV projection: (qkv, the normed input)."""
    h = _norm(x, gamma, beta, eps, norm_type)
    qkv = torch.matmul(h, weight.to(h.dtype))
    if bias is not None:
        qkv = qkv + bias.to(qkv.dtype)
    return qkv, h


def mlp_gemm(x: torch.Tensor, residual: torch.Tensor, input_bias: Optional[torch.Tensor], w_inter: torch.Tensor,
             b_inter: Optional[torch.Tensor], w_out: torch.Tensor, gamma: torch.Tensor, beta: Optional[torch.Tensor],
             eps: float = 1e-5, activation: str = "gelu",
             norm_type: str = "layernorm") -> Tuple[torch.Tensor, torch.Tensor]:
    """(Residual add) -> norm -> GEMM -> activation -> GEMM: (mlp_out, the pre-norm residual)."""
    s = _f32(x) + _f32(residual)
    if input_bias is not None:
        s = s + _f32(input_bias)
    s = s.to(x.dtype)
    h = _norm(s, gamma, beta, eps, norm_type)
    inter = torch.matmul(h, w_inter.to(h.dtype))
    if b_inter is not None:
        inter = inter + b_inter.to(inter.dtype)
    if activation == "gelu":
        inter = _gelu(inter)
    elif activation == "gelu_exact":
        inter = F.gelu(inter, approximate="none")
    elif activation == "relu":
        inter = torch.relu(inter)
    elif activation == "silu":
        inter = F.silu(inter)
    else:
        raise ValueError(f"mlp_gemm: unknown activation {activation!r} "
                         "(expected gelu | gelu_exact | relu | silu)")
    return torch.matmul(inter, w_out.to(inter.dtype)), s


def fused_gemm_gelu(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor], w2: torch.Tensor) -> torch.Tensor:
    """GEMM -> bias -> gelu -> GEMM."""
    h = torch.matmul(x, w1.to(x.dtype))
    if b1 is not None:
        h = h + b1.to(h.dtype)
    return torch.matmul(_gelu(h), w2.to(x.dtype))


def linear_layer(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(y.dtype)


def vector_matmul(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The attention output / no-bias projection."""
    return torch.matmul(x, weight.to(x.dtype))


# ----------------------------------------------------------------------
# elementwise fusions
# ----------------------------------------------------------------------
def bias_add(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return x + bias.to(x.dtype)


def bias_gelu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return _gelu(x + bias.to(x.dtype))


def bias_relu(x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.relu(x + bias.to(x.dtype))


def bias_residual(x: torch.Tensor, residual: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return x + residual + bias.to(x.dtype)


def vector_add(a: torch.Tensor, b: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """a + gamma * b."""
    return a + gamma * b


def residual_add_bias(hidden: torch.Tensor, residual: torch.Tensor, attention_output: torch.Tensor,
                      attention_bias: Optional[torch.Tensor], final_bias: Optional[torch.Tensor],
                      mp_size: int = 1, mlp_after_attn: bool = True, add_bias: bool = True,
                      pre_layer_norm: bool = True) -> torch.Tensor:
    """Merge the MLP output, the attention output and their biases into the
    residual stream; under TP each partition's bias-carrying terms scale by
    1 / mp_size before the (later) all-reduce:

    - mlp_after_attn + pre_layer_norm (gpt2-style):
      (residual + attention_output + attention_bias + final_bias) / mp_size + hidden
    - mlp_after_attn + post-LN (bert-style): residual + hidden + final_bias
    - parallel attention and MLP (gptj-style): residual + hidden + attention_output
      + final_bias / mp_size (+ attention_bias / mp_size when ``add_bias``)
    """
    h32, r32, a32 = _f32(hidden), _f32(residual), _f32(attention_output)
    zero = torch.zeros((), dtype=torch.float32, device=hidden.device)
    fb = _f32(final_bias) if final_bias is not None else zero
    ab = _f32(attention_bias) if attention_bias is not None else zero
    if mlp_after_attn:
        out = (r32 + a32 + ab + fb) / mp_size + h32 if pre_layer_norm else r32 + h32 + fb
    else:
        out = r32 + h32 + a32 + fb / mp_size
        if add_bias:
            out = out + ab / mp_size
    return out.to(hidden.dtype)


def gated_activation(x: torch.Tensor, bias: Optional[torch.Tensor], mode: str = "silu") -> torch.Tensor:
    """x holds [act_in, gate] halves on the last dim: act(act_in) * gate."""
    if bias is not None:
        x = x + bias.to(x.dtype)
    a, g = torch.chunk(x, 2, dim=-1)
    act = F.silu if mode == "silu" else (torch.relu if mode == "relu" else _gelu)
    return act(a) * g


# ----------------------------------------------------------------------
# attention ops
# ----------------------------------------------------------------------
def softmax(scores: torch.Tensor, mask: Optional[torch.Tensor] = None, alibi: Optional[torch.Tensor] = None,
            scale: float = 1.0, causal: bool = False) -> torch.Tensor:
    """Scale, mask, ALiBi and (triangular) softmax over raw (B, H, Sq, Sk) scores, in fp32."""
    s = _f32(scores) * scale
    neg = torch.finfo(torch.float32).min
    if alibi is not None:
        s = s + _f32(alibi)
    if mask is not None:
        s = torch.where(torch.as_tensor(mask, device=s.device), s, neg)
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qi = torch.arange(sq, device=s.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(ki <= qi, s, neg)
    return torch.softmax(s, dim=-1).to(scores.dtype)


def softmax_context(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    scale: Optional[float] = None, kv_len=None, alibi: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q against the (cached) keys and values, (B, S, H, D); KV
    may have fewer heads (GQA / MQA). ``alibi`` is an additive bias."""
    return attention(q, k, v, causal=causal, scale=scale, kv_len=kv_len, bias=alibi)


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, rotary_dim: Optional[int] = None,
                         theta: float = 10000.0, max_len: Optional[int] = None,
                         style: str = "neox") -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k at ``positions`` (B, S); the table covers ``max_len``
    positions (default: the largest position + 1)."""
    from ...models.transformer import apply_rope, rope_frequencies

    rd = rotary_dim or q.shape[-1]
    positions = torch.as_tensor(positions, device=q.device)
    L = max_len if max_len is not None else (int(positions.max()) + 1 if positions.numel() else 1)
    cos, sin = rope_frequencies(rd, L, theta, device=q.device)
    return (apply_rope(q, cos, sin, positions, rotary_dim=rd, style=style),
            apply_rope(k, cos, sin, positions, rotary_dim=rd, style=style))


# ----------------------------------------------------------------------
# MoE helpers
# ----------------------------------------------------------------------
def moe_res_matmul(residual: torch.Tensor, coef: torch.Tensor, output: torch.Tensor) -> torch.Tensor:
    """Residual MoE's mix: residual * coef1 + output * coef2, coef's last dim holding both halves."""
    c1, c2 = torch.chunk(coef, 2, dim=-1)
    return residual * c1 + output * c2


def einsum_sec_sm_ecm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The MoE dispatch contraction."""
    return torch.einsum("sec,sm->ecm", a, b)


# ----------------------------------------------------------------------
# head padding
# ----------------------------------------------------------------------
def padded_head_size(head_size: int) -> int:
    """The reference's padding to 32 / 64 / 128 head dims (``pt_binding.cpp:1224``); larger sizes are unchanged."""
    if head_size <= 32:
        return 32
    if head_size <= 64:
        return 64
    if head_size <= 128:
        return 128
    return head_size


def add_padding(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Zero-pad (B, S, H, D) q, k, v head dims to ``padded_head_size``."""
    D = q.shape[-1]
    pd = padded_head_size(D)
    if pd == D:
        return q, k, v
    return tuple(F.pad(x, (0, pd - D)) for x in (q, k, v))


def pad_transform(qkv: torch.Tensor, heads: int):
    """A fused (B, S, 3 H D) QKV tensor as head-padded (B, S, H, pad(D)) q, k, v."""
    B, S, three_hd = qkv.shape
    D = three_hd // (3 * heads)
    q, k, v = qkv.reshape(B, S, 3, heads, D).unbind(2)
    return add_padding(q, k, v)
