"""Speculative decoding: pluggable drafters and on-device acceptance.

Port of ``deepspeed_tpu/inference/v2/spec.py``. Decode reads every weight
from device memory to retire one token a sequence. Speculative decoding
drafts up to K next tokens on the host and verifies them in one forward of
K+1 positions a row (the carry token and the drafts) through the same paged
prefill kernel a chunked prefill runs, so one sweep over the weights can
retire up to K+1 tokens.

- **Drafters** (host side): ``propose(history, k)`` returns up to ``k``
  guesses for the next tokens. The default is n-gram **prompt lookup**:
  match the last n tokens of the prompt + generated history against an
  earlier occurrence and propose the tokens that followed it. No second
  model; strongest on templated or repetitive text.
- **Acceptance** (device side): ``select_committed`` turns the verify
  logits and the drafts into committed tokens and an accepted count per
  row, with no host sync, so it runs inside the verify step's CUDA graph.
  Greedy mode accepts the longest prefix of drafts equal to the argmax;
  sampled mode is rejection sampling for a deterministic (delta) draft
  distribution, which preserves the target distribution: accept draft
  ``d`` with probability ``p(d)``; at the first rejection draw from ``p``
  with ``d``'s mass removed; a fully accepted window draws one bonus
  token. The draws come from a ``torch.Generator`` (Gumbel-max, as
  ``sample_logits``), so sampled tokens match the JAX package only in
  distribution.

The engine speculates only on pure-decode quanta: a mixed quantum already
feeds decode's weight reads with prefill work.
"""

from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import torch

from ..generation import filter_logits


@runtime_checkable
class Drafter(Protocol):
    """Proposes up to ``k`` next-token guesses from the host-visible history
    (prompt + committed tokens). Fewer than ``k``, or none, is always legal:
    rows without proposals run as plain decode."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        ...


class NullDrafter:
    """Never proposes: speculation structurally on, effectively off."""

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        return []


class PromptLookupDrafter:
    """N-gram prompt-lookup self-speculation.

    Matches the last ``n`` history tokens (``n`` from ``max_ngram`` down to
    ``min_ngram``) against the most recent earlier occurrence of the same
    n-gram in the history and proposes the tokens that followed it.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(f"bad ngram range [{min_ngram}, {max_ngram}]")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        L = len(hist)
        if k <= 0 or L < self.min_ngram + 1:
            return []
        top = min(self.max_ngram, L - 1)
        for n in range(top, self.min_ngram - 1, -1):
            tail = hist[L - n:]
            # the most recent earlier occurrence wins
            for i in range(L - n - 1, -1, -1):
                if hist[i:i + n] == tail:
                    # only a full max_ngram match earns the whole budget; a
                    # shorter match proposes at most n tokens
                    take = k if n == top else min(k, n)
                    # overlapping copy: each copied token extends the buffer,
                    # so a cycle shorter than ``take`` fills the whole window
                    buf = hist[:]
                    out: List[int] = []
                    for j in range(i + n, i + n + take):
                        tok = int(buf[j])
                        out.append(tok)
                        buf.append(tok)
                    return out
        return []


def make_drafter(name: str) -> Drafter:
    """Drafter registry: ``prompt_lookup`` (default, alias ``ngram``) or ``null``."""
    key = (name or "prompt_lookup").lower()
    if key in ("prompt_lookup", "ngram"):
        return PromptLookupDrafter()
    if key in ("null", "none", "off"):
        return NullDrafter()
    raise ValueError(f"unknown drafter {name!r}: expected prompt_lookup | null")


def _gumbel_argmax(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (last dim), as ``sample_logits`` draws."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def select_committed(logits: torch.Tensor, drafts: torch.Tensor, n_draft: torch.Tensor,
                     generator: Optional[torch.Generator] = None, do_sample: bool = False,
                     temperature: float = 1.0, top_k: int = 0,
                     top_p: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Acceptance for one verify step, on the logits' device, without a host sync.

    ``logits``: (B, chunk, V); position ``i`` scores the token that follows
    input ``i`` of the row (input 0 is the carry token, 1..chunk-1 the
    drafts). ``drafts``: (B, chunk-1) right-padded draft ids; ``n_draft``:
    (B,) real drafts a row (padding is never accepted). ``generator``: the
    sampled mode's draws (accept, residual, plain, in that order).

    Returns ``(committed, accepted)``: ``committed`` (B, chunk) int32, of which
    row ``j``'s first ``accepted[j] + 1`` entries are the tokens to commit
    (accepted drafts, then one correction or bonus token); ``accepted`` (B,)
    int32 in [0, n_draft].
    """
    B, chunk, V = logits.shape
    K = chunk - 1
    drafts = drafts.long()
    valid = torch.arange(K, device=logits.device)[None, :] < n_draft[:, None]
    if not do_sample or temperature == 0.0:
        # a draft is accepted iff it is the argmax; the committed tokens are the argmaxes themselves,
        # so the stream is token for token what greedy decode without speculation emits
        tgt = torch.argmax(logits, dim=-1)
        match = (drafts == tgt[:, :K]) & valid
        accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        return tgt.to(torch.int32), accepted.to(torch.int32)

    flt = filter_logits(logits.reshape(B * chunk, V).float(), temperature, top_k, top_p).reshape(B, chunk, V)
    head = flt[:, :K]
    # p(d) of each draft under the filtered target, without materialising the softmax
    p_draft = torch.exp(head.gather(-1, drafts[..., None])[..., 0] - torch.logsumexp(head, dim=-1))
    u = torch.rand((B, K), generator=generator, device=logits.device, dtype=torch.float32)
    accept = (u < p_draft) & valid
    accepted = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    # the correction at the rejection position: p with the draft's mass removed and renormalised
    # (max(p - q, 0) for a delta q), by a scatter of -inf into the draft's column
    res = _gumbel_argmax(head.scatter(-1, drafts[..., None], float("-inf")), generator)
    # a plain draw at every position: the bonus token after a fully accepted window
    pln = _gumbel_argmax(flt, generator)
    idx = torch.arange(chunk, device=logits.device)[None, :]
    pad = torch.zeros((B, 1), dtype=torch.long, device=logits.device)
    d_pad = torch.cat([drafts, pad], dim=1)
    r_pad = torch.cat([res, pad], dim=1)
    acc = accepted[:, None]
    rejected_here = (idx == acc) & (acc < n_draft[:, None])
    committed = torch.where(idx < acc, d_pad, torch.where(rejected_here, r_pad, pln))
    return committed.to(torch.int32), accepted.to(torch.int32)
