"""Evoformer (DeepSpeed4Science) attention.

Port of ``deepspeed_tpu/ops/evoformer.py``: ``DS4Sci_EvoformerAttention(q,
k, v, [bias_1, bias_2])``, the attention with additive biases that
AlphaFold-style models call for MSA-row, MSA-column and triangle attention.
``q``, ``k`` and ``v`` are ``(*batch_dims, S, H, D)``; each bias broadcasts to
``(*batch_dims, H, Sq, Sk)`` (an MSA mask bias ``(B, N, 1, 1, Sk)``, a pair
bias ``(B, 1, H, Sq, Sk)``).

The tensors' device picks the route. CUDA tensors go through the flash
kernels (``ops/flash_attention.py``) with the biases summed in broadcast
space: lead dims that the sum broadcasts stay collapsed when they form a
full prefix, so the kernels read shared bias slices in place and the
gradient of the sum comes back in its own collapsed shape. CPU tensors take
the reference's non-kernel route: one einsum and softmax, or the chunked
online softmax (``attention_chunked``) when the logits would pass 2 GB.
``evoformer_flash`` is the kernel route on any device (on the CPU the
kernels' plain versions run under the same autograd function).
"""

from typing import Optional, Sequence, Tuple

import torch

from .attention import attention_chunked
from .flash_attention import flash_attention

HUGE_LOGITS_BYTES = int(2e9)  # past this the CPU route chunks the keys (the reference's threshold)


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def _sum_biases(biases) -> torch.Tensor:
    total = biases[0].float()
    for b in biases[1:]:
        total = total + b.float()
    return total


def _evoformer_plain(q, k, v, biases=(), scale=None) -> torch.Tensor:
    """The reference's ``_evoformer_xla``: fp32 logits, softmax, autograd backward."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1]**0.5)
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) * scale
    for b in biases:
        logits = logits + b.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", probs.to(v.dtype), v)
    return out.to(q.dtype)


def fold_biases(biases: Sequence[torch.Tensor], lead) -> Tuple[Optional[torch.Tensor], int]:
    """The biases summed in broadcast space, as (bias with the lead dims
    flattened to one batch dim, bias_repeat): lead dims that the sum
    broadcasts stay collapsed when they follow the dims it keeps (a full
    prefix: ``bias_repeat`` query batches share each bias batch); any other
    layout is expanded to the batch (the reference chunks it on the XLA path
    when it is large). ``(None, 1)`` without biases."""
    if not biases:
        return None, 1
    total = _sum_biases(biases)
    B = _prod(lead)
    tl = tuple(total.shape[:-3])  # lead dims of the summed bias
    tl = (1,) * (len(lead) - len(tl)) + tl
    split = len(tl)
    while split > 0 and tl[split - 1] == 1:
        split -= 1
    if all(tl[i] == lead[i] for i in range(split)):
        Bb = _prod(lead[:split])
        return total.reshape(Bb, *total.shape[-3:]), B // Bb
    return torch.broadcast_to(total, (*lead, *total.shape[-3:])).reshape(B, *total.shape[-3:]), 1


def evoformer_flash(q, k, v, biases: Sequence[torch.Tensor] = (), scale: Optional[float] = None) -> torch.Tensor:
    """The kernel route: lead dims flattened into the batch, the biases summed
    in broadcast space, a full-prefix layout kept collapsed (``bias_repeat``
    query batches per bias batch) and any other layout expanded to the batch."""
    *lead, Sq, H, D = q.shape
    Sk = k.shape[-3]
    B = _prod(lead)
    qf, kf, vf = q.reshape(B, Sq, H, D), k.reshape(B, Sk, H, D), v.reshape(B, Sk, H, D)
    bias, bias_repeat = fold_biases(biases, lead)
    out = flash_attention(qf, kf, vf, causal=False, scale=scale, bias=bias, bias_repeat=bias_repeat)
    return out.reshape(*lead, Sq, H, D).to(q.dtype)


def evoformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, biases: Sequence[torch.Tensor] = (),
                        scale: Optional[float] = None) -> torch.Tensor:
    """Bias-augmented, non-causal attention over any lead dims, with
    gradients for q, k, v and every bias. CUDA tensors take the flash
    kernels; CPU tensors the reference's non-kernel route."""
    if q.is_cuda:
        return evoformer_flash(q, k, v, biases, scale)
    *lead, Sq, H, D = q.shape
    Sk = k.shape[-3]
    B = _prod(lead)
    if biases and B * H * Sq * Sk * 4 > HUGE_LOGITS_BYTES:
        # the einsum route would hold (lead, H, Sq, Sk) logits and probabilities;
        # the chunked op slices a broadcast view of the bias per KV chunk
        bias = torch.broadcast_to(_sum_biases(biases), (*lead, H, Sq, Sk)).reshape(B, H, Sq, Sk)
        out = attention_chunked(q.reshape(B, Sq, H, D), k.reshape(B, Sk, H, D), v.reshape(B, Sk, H, D),
                                causal=False, scale=scale, bias=bias)
        return out.reshape(*lead, Sq, H, D).to(q.dtype)
    return _evoformer_plain(q, k, v, biases, scale)


# the reference binding's name (evoformer_attn/attention.py)
DS4Sci_EvoformerAttention = evoformer_attention
