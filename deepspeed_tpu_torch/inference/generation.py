"""Token choice over logits: filtering and sampling.

Port of ``filter_logits`` and ``sample_logits`` from
``deepspeed_tpu/inference/generation.py``. Greedy is ``argmax`` (first
maximum, as in JAX); sampling draws from an explicit ``torch.Generator`` on
the logits' device with the Gumbel-max trick (what ``jax.random.categorical``
does), so no draw syncs with the host. The two frameworks' random streams
differ, so sampled tokens match the reference only in distribution.
"""

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """Temperature/top-k/nucleus masking over (B, V) logits: the distribution
    ``sample_logits`` draws from."""
    logits = logits / max(temperature, 1e-6)
    if top_k > 0:
        vals = torch.topk(logits, top_k, dim=-1).values
        logits = torch.where(logits < vals[:, -1:], torch.full_like(logits, -float("inf")), logits)
    if top_p < 1.0:
        # nucleus: keep the smallest prefix of descending-prob tokens whose
        # mass reaches top_p (the first token always survives)
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        keep[:, 0] = True
        cutoff = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf"))).min(dim=-1).values
        logits = torch.where(logits < cutoff[:, None], torch.full_like(logits, -float("inf")), logits)
    return logits


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator], do_sample: bool,
                  temperature: float, top_k: int, top_p: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> (B,) int64 token ids: argmax, or a draw from the
    filtered distribution using ``generator``."""
    if not do_sample or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    filt = filter_logits(logits.float(), temperature, top_k, top_p)
    u = torch.rand(filt.shape, generator=generator, device=filt.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(filt + gumbel, dim=-1)
