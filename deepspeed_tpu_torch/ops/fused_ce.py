"""Fused (chunked) cross-entropy over a large vocabulary, in plain PyTorch.

Port of ``deepspeed_tpu/ops/fused_ce.py`` (which has no Pallas kernel):
the mean token CE of ``x @ w (+ bias)`` without keeping the fp32
``(B, S, V)`` logits for the backward. The sequence is cut into chunks;
the forward keeps only a per-token logsumexp, and the backward recomputes
each chunk's logits (the reference's ``_ce_vjp_bwd``), so the extra memory
is one ``(B, C, V)`` block. The weight gradient is accumulated in fp32
across chunks and cast to ``w``'s dtype once.

The head product runs in the input dtype. The reference asks XLA for fp32
logits from bf16 operands (``preferred_element_type``); PyTorch's matmul
returns the input dtype, so in bf16 the logits are rounded to bf16 before
the fp32 softmax. fp32 runs are unaffected.
"""

import warnings
from typing import Optional

import torch

from ..analysis import knobs

_CHUNK_TARGET = knobs.get_int("DS_TPU_CE_CHUNK")  # 0 = auto (memory-budgeted)
_BUDGET_MB = knobs.get_int("DS_TPU_CE_BUDGET_MB")


def _auto_target(S: int, B: int, V: int) -> int:
    """Largest chunk whose fp32 logits block fits the budget."""
    rows = max(1, (_BUDGET_MB << 20) // max(1, B * V * 4))
    return S if rows >= S else max(64, rows)


def _pick_chunk(S: int, target: Optional[int] = None, B: int = 8, V: int = 50257) -> int:
    target = target or _CHUNK_TARGET or _auto_target(S, B, V)
    if target <= 0:
        target = 512
    # fall back only DOWNWARD: a chunk above the requested target would
    # exceed the (B, C, V) logits-block memory the caller tuned for
    for c in (target, 512, 256, 128, 64, 32):
        if c <= target and S % c == 0 and c <= S:
            return c
    # no power-of-two-ish candidate divides S: the largest divisor of S
    # that still respects the target
    best = 1
    d = 1
    while d * d <= S:
        if S % d == 0:
            for c in (d, S // d):
                if best < c <= target:
                    best = c
        d += 1
    if best >= min(32, S):
        return best
    warnings.warn(
        f"fused CE: seq len {S} has no divisor in [32, {target}]; using a single "
        f"(B, {S}, V) logits block — set DS_TPU_CE_CHUNK or pad S to a multiple "
        "of a power of two to restore chunking", stacklevel=2)
    return S


def _project(xs: torch.Tensor, w: torch.Tensor, vd_layout: bool) -> torch.Tensor:
    """(B, C, D) x w -> (B, C, V) fp32 logits; w is (V, D) when vd_layout
    (tied embedding), else (D, V)."""
    return (xs @ (w.t() if vd_layout else w)).float()


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, b, labels, valid, vd_layout: bool, chunk: int, has_bias: bool):
        S = x.shape[1]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for c0 in range(0, S, chunk):
            logits = _project(x[:, c0:c0 + chunk], w, vd_layout)
            if has_bias:
                logits = logits + b
            lse = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, labels[:, c0:c0 + chunk, None])[..., 0]
            total = total + torch.where(valid[:, c0:c0 + chunk], lse - gold, 0.0).sum()
            lses.append(lse)
        ctx.save_for_backward(x, w, b, labels, valid, torch.cat(lses, dim=1))
        ctx.args = (vd_layout, chunk, has_bias)
        return total

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, valid, lse = ctx.saved_tensors
        vd_layout, chunk, has_bias = ctx.args
        S = x.shape[1]
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device) if has_bias else None
        dxs = []
        for c0 in range(0, S, chunk):
            xc = x[:, c0:c0 + chunk]
            logits = _project(xc, w, vd_layout)
            if has_bias:
                logits = logits + b
            # softmax minus the one-hot of the label, times the valid-masked cotangent
            dlogits = logits.sub_(lse[:, c0:c0 + chunk, None]).exp_()
            dlogits.scatter_add_(-1, labels[:, c0:c0 + chunk, None],
                                 torch.full(labels[:, c0:c0 + chunk, None].shape, -1.0, device=x.device))
            dlogits.mul_(torch.where(valid[:, c0:c0 + chunk], g, 0.0)[..., None])
            dl = dlogits.to(xc.dtype)
            if vd_layout:  # w (V, D): dx = dl @ w, dw += dl^T x
                dxs.append(dl @ w)
                dw += torch.einsum("bcv,bcd->vd", dl, xc).float()
            else:  # w (D, V): dx = dl @ w^T, dw += x^T dl
                dxs.append(dl @ w.t())
                dw += torch.einsum("bcd,bcv->dv", xc, dl).float()
            if has_bias:
                db += dlogits.sum(dim=(0, 1))
        dx = torch.cat(dxs, dim=1).to(x.dtype)
        return dx, dw.to(w.dtype), db.to(b.dtype) if has_bias else None, None, None, None, None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
                        vd_layout: bool = False, chunk: Optional[int] = None,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token CE of ``x @ w (+ bias)`` against ``labels`` without keeping
    the full logits.

    x: (B, S, D) final hidden states (compute dtype). w: (D, V), or (V, D)
    with ``vd_layout=True`` (tied input embedding). labels: (B, S) int;
    positions equal to ``ignore_index`` are masked out. bias: optional (V,)
    head bias. Matches ``models.transformer.cross_entropy_loss`` (fp32
    logits, mean over valid positions).
    """
    B, S, _ = x.shape
    V = w.shape[0] if vd_layout else w.shape[1]
    chunk = chunk or _pick_chunk(S, B=B, V=V)
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0).long()
    has_bias = bias is not None
    b = bias.float() if has_bias else torch.zeros((), dtype=torch.float32, device=x.device)
    total = _FusedCE.apply(x, w, b, safe_labels, valid, bool(vd_layout), int(chunk), has_bias)
    return total / torch.clamp(valid.sum(), min=1)
