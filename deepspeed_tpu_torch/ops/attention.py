"""Attention for the training forward: the plain version and the dispatch.

Port of ``deepspeed_tpu/ops/attention.py``. ``attention_xla`` is the plain
PyTorch version (the reference's XLA path): GQA by repeating KV heads,
shift-invariant ALiBi (``slope * key_pos``), an additive bias, ``kv_len``
for padded caches, causal masking with queries aligned to the end of the
keys, and a sliding window. ``attention`` sends CUDA tensors to the flash
kernels (``ops/flash_attention.py``) and CPU tensors to ``attention_xla``.
"""

from typing import Optional

import torch


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH * n_rep, D): each KV head serves n_rep query heads."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  scale: Optional[float] = None, bias: Optional[torch.Tensor] = None, segment_ids=None,
                  kv_len=None, window: Optional[int] = None, alibi_slopes=None) -> torch.Tensor:
    """Multi-head attention over (B, S, H, D); KV may have fewer heads (GQA).

    ``kv_len``: valid KV positions (queries sit at [kv_len - Sq, kv_len)).
    ``window``: query i attends keys in (i - window, i], which implies the
    causal upper bound. ``alibi_slopes``: (H,) constants, no gradient.
    Logits and softmax in fp32; the result is in q's dtype.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (got {window}); pass None to disable the sliding window")
    orig_dtype = q.dtype
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d**0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sq, sk = q.shape[1], k.shape[1]
    if alibi_slopes is not None:
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device).detach()
        key_pos = torch.arange(sk, dtype=torch.float32, device=q.device)
        logits = logits + sl[None, :, None, None] * key_pos[None, None, None, :]
    if bias is not None:
        logits = logits + bias
    neg = torch.finfo(torch.float32).min
    if causal or kv_len is not None or window is not None:
        valid = kv_len if kv_len is not None else sk
        qi = torch.arange(sq, device=q.device)[:, None] + (valid - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        mask = ki < valid
        if causal:
            mask = mask & (ki <= qi)
        if window is not None:
            mask = mask & (ki > qi - window) & (ki <= qi)
        logits = torch.where(mask[None, None], logits, neg)
    if segment_ids is not None:
        seg_q, seg_k = segment_ids if isinstance(segment_ids, tuple) else (segment_ids, segment_ids)
        mask = seg_q[:, :, None] == seg_k[:, None, :]
        logits = torch.where(mask[:, None], logits, neg)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(orig_dtype)


def attention(q, k, v, **kwargs):
    """CUDA tensors go to the flash kernels, CPU tensors to ``attention_xla``."""
    if q.is_cuda:
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, **kwargs)
    return attention_xla(q, k, v, **kwargs)
