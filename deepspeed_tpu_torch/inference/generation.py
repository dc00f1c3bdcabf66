"""Token choice over logits, and the v1 engine's KV-cache generation loop.

Port of ``deepspeed_tpu/inference/generation.py``: ``filter_logits`` and
``sample_logits``, and ``build_step_fns`` / ``_decode_step`` /
``generate_tokens`` over a preallocated dense KV cache
(``CausalLM.init_kv_caches``). Greedy is ``argmax`` (first maximum, as in
JAX); sampling draws from an explicit ``torch.Generator`` seeded from
``seed`` on the logits' device with the Gumbel-max trick (what
``jax.random.categorical`` does), so no draw syncs with the host. The two
frameworks' random streams differ, so sampled tokens match the reference
only in distribution.

PyTorch runs eagerly, so the reference's ``fused`` decode (one compiled
``lax.scan``) is the same Python loop as the unfused one, with its
semantics: no early exit, and a finished row keeps emitting ``eos``, with no
host sync in the loop. ``fused=False`` reads the finished flags back once a
step and stops when every row is done.
"""

from typing import Optional, Tuple

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


def _decode_step(apply_fn, params, token: torch.Tensor, caches):
    """THE per-token step: (B, 1) tokens at position ``cache_len`` -> (B, V)
    logits and the advanced caches."""
    B = token.shape[0]
    cache_len = caches[0][2]
    positions = torch.full((B, 1), cache_len, dtype=torch.int64, device=token.device)
    logits, caches = apply_fn(params, token, positions=positions, kv_caches=caches)
    return logits[:, -1, :], caches


def build_step_fns(model) -> Tuple:
    """(prefill, decode_step) over ``model.apply``, each writing the caches in place."""

    @torch.no_grad()
    def prefill(params, input_ids, caches):
        B, S = input_ids.shape
        positions = torch.arange(S, device=input_ids.device).expand(B, S)
        logits, caches = model.apply(params, input_ids, positions=positions, kv_caches=caches)
        return logits[:, -1, :], caches

    @torch.no_grad()
    def decode_step(params, token, caches):
        return _decode_step(model.apply, params, token, caches)

    return prefill, decode_step


@torch.no_grad()
def generate_tokens(model, params, prefill_fn, decode_fn, input_ids, *, max_new_tokens: int, cache_len: int,
                    cache_dtype: torch.dtype, do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0, eos_token_id: Optional[int] = None, seed: int = 0, fused: bool = True,
                    device="cuda") -> torch.Tensor:
    """Prefill + decode over caches of ``cache_len`` positions on ``device``;
    returns (B, S + new) int64 token ids (``S + 1`` up to ``S + new`` with
    ``fused=False`` when every row reached ``eos_token_id`` early)."""
    dev = torch.device(device)
    ids = torch.as_tensor(input_ids).to(dev, torch.int64)
    if ids.dim() == 1:
        ids = ids[None]
    B = ids.shape[0]
    caches = model.init_kv_caches(B, cache_len, dtype=cache_dtype, device=dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    logits, caches = prefill_fn(params, ids, caches)
    out = [ids]
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens):
        token = sample_logits(logits, generator, do_sample, temperature, top_k, top_p)[:, None]
        if eos_token_id is not None:
            token = torch.where(finished[:, None], eos_token_id, token)
            finished = finished | (token[:, 0] == eos_token_id)
        out.append(token)
        if not fused and eos_token_id is not None and bool(finished.all()):
            break
        if i < max_new_tokens - 1:
            logits, caches = decode_fn(params, token, caches)
    return torch.cat(out, dim=1)
