"""Ring attention: blockwise context parallelism.

Port of ``deepspeed_tpu/sequence/ring.py`` (a superset of the reference,
which ships only Ulysses). Each of the P ranks of the ``context`` group
holds its contiguous (B, S/P, H, D) slice of q, k and v, sequence order
equal to rank order, and attends over the whole sequence by passing the KV
slices around the ring: at hop i a rank holds the slice of rank (r - i) mod
P and sends it on to rank r + 1 (``comm.batch_isend_irecv``; the next hop's
transfer runs while this hop computes). A flash-style online softmax over
the hops keeps fp32 running maxima and sums; causality is enforced per
block: an earlier rank's block is attended in full, the own block lower
triangular, a later rank's block not at all (its hop computes nothing).
GQA stays collapsed through the ring: the KV slices keep their KV heads and
the queries are grouped under them, so a hop moves KVH, not H, heads. The
block body is plain PyTorch (``torch.matmul``), as the JAX body is plain
XLA; it runs over groups of KV heads so that one fp32 block of scores stays
under ``BLOCK_BYTES`` (at llama3_8b's 4,096-token slices a KV head's block
is 268 MB).

Autograd cannot see through the exchanges, so ``_RingAttention`` is a
``torch.autograd.Function``: the forward saves q, k, v, the output and the
log-sum-exp; the backward passes the KV slices around the ring again,
recomputes each block's probabilities from the saved log-sum-exp, adds the
block's dq locally, and adds its dK / dV into accumulators that travel with
the slice; one more hop brings each accumulator home to its slice's rank.
"""

import time
from typing import List, Optional

import torch

from .. import comm as dist
from .layer import count

TAG_K, TAG_V, TAG_DK, TAG_DV = 10, 11, 12, 13
BLOCK_BYTES = 1 << 29


def _ring_ranks(group) -> List[int]:
    """The group's world ranks in group order (the ring's order)."""
    if group is None:
        return list(range(dist.get_world_size()))
    return torch.distributed.get_process_group_ranks(group)


def _rotate(tensors, tags, ranks, me: int, group):
    """Start sending each tensor to the next rank of the ring and receiving
    its successor from the previous one: (received tensors, works)."""
    P = len(ranks)
    nxt, prv = ranks[(me + 1) % P], ranks[(me - 1) % P]
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group, tag) for t, tag in zip(tensors, tags)]
    ops += [dist.P2POp(dist.irecv, r, prv, group, tag) for r, tag in zip(recv, tags)]
    return recv, dist.batch_isend_irecv(ops)


def _finish(works, tensors, stats) -> None:
    """Wait for a hop; count it in ``stats`` (``layer.new_stats``) when given."""
    t0 = time.perf_counter()
    for w in works:
        w.wait()
    count(stats, "ring_hop", sum(t.numel() * t.element_size() for t in tensors), time.perf_counter() - t0)


def _head_groups(B: int, KVH: int, rows: int, C: int):
    """KV-head ranges whose fp32 (rows x C) score blocks stay under ``BLOCK_BYTES``."""
    n = max(1, min(KVH, BLOCK_BYTES // max(1, B * rows * C * 4)))
    return [(h, min(KVH, h + n)) for h in range(0, KVH, n)]


def _block_mask(C: int, n_rep: int, device) -> torch.Tensor:
    """The own block's causal mask over (n_rep * C) grouped query rows x C keys."""
    qi = torch.arange(C, device=device).repeat(n_rep)
    return torch.arange(C, device=device)[None, :] <= qi[:, None]


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, ranks, causal, scale, stats):
        B, C, H, D = q.shape
        KVH = k.shape[2]
        n_rep = H // KVH
        P, me = len(ranks), dist.get_rank(group)
        # queries grouped under their KV head: (B, KVH, n_rep * C, D), fp32
        qg = q.float().reshape(B, C, KVH, n_rep, D).permute(0, 2, 3, 1, 4).reshape(B, KVH, n_rep * C, D)
        m = torch.full((B, KVH, n_rep * C), float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros_like(qg)
        mask = _block_mask(C, n_rep, q.device) if causal else None
        heads = _head_groups(B, KVH, n_rep * C, C)
        kc, vc = k.contiguous(), v.contiguous()
        for i in range(P):
            work = None
            if i < P - 1:
                (kn, vn), work = _rotate([kc, vc], [TAG_K, TAG_V], ranks, me, group)
            kb = (me - i) % P
            if not (causal and kb > me):
                kf = kc.float().transpose(1, 2)  # (B, KVH, C, D)
                vf = vc.float().transpose(1, 2)
                for h0, h1 in heads:
                    s = torch.matmul(qg[:, h0:h1], kf[:, h0:h1].transpose(-1, -2)) * scale
                    if causal and kb == me:
                        s = s.masked_fill(~mask, float("-inf"))
                    new_m = torch.maximum(m[:, h0:h1], s.amax(dim=-1))
                    p = torch.exp(s - new_m[..., None])
                    corr = torch.exp(m[:, h0:h1] - new_m)
                    l[:, h0:h1] = l[:, h0:h1] * corr + p.sum(dim=-1)
                    o[:, h0:h1] = o[:, h0:h1] * corr[..., None] + torch.matmul(p, vf[:, h0:h1])
                    m[:, h0:h1] = new_m
            if work is not None:
                _finish(work, [kc, vc], stats)
                kc, vc = kn, vn
        out = o / l[..., None]
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.ranks, ctx.causal, ctx.scale, ctx.stats = group, ranks, causal, scale, stats
        return out.reshape(B, KVH, n_rep, C, D).permute(0, 3, 1, 2, 4).reshape(B, C, H, D).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        group, ranks, causal, scale = ctx.group, ctx.ranks, ctx.causal, ctx.scale
        B, C, H, D = q.shape
        KVH = k.shape[2]
        n_rep = H // KVH
        P, me = len(ranks), dist.get_rank(group)
        grouped = lambda t: t.float().reshape(B, C, KVH, n_rep, D).permute(0, 2, 3, 1, 4).reshape(  # noqa: E731
            B, KVH, n_rep * C, D)
        qg, dog = grouped(q), grouped(dout)
        delta = (dog * out).sum(dim=-1)  # (B, KVH, n_rep * C)
        dq = torch.zeros_like(qg)
        mask = _block_mask(C, n_rep, q.device) if causal else None
        kc, vc = k.contiguous(), v.contiguous()
        heads = _head_groups(B, KVH, n_rep * C, C)
        dk = torch.zeros((B, KVH, C, D), dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        for i in range(P):
            kb = (me - i) % P
            if not (causal and kb > me):
                kf = kc.float().transpose(1, 2)
                vf = vc.float().transpose(1, 2)
                for h0, h1 in heads:
                    h = slice(h0, h1)
                    s = torch.matmul(qg[:, h], kf[:, h].transpose(-1, -2)) * scale
                    if causal and kb == me:
                        s = s.masked_fill(~mask, float("-inf"))
                    p = torch.exp(s - lse[:, h, :, None])
                    ds = p * (torch.matmul(dog[:, h], vf[:, h].transpose(-1, -2)) - delta[:, h, :, None])
                    dq[:, h] += torch.matmul(ds, kf[:, h]) * scale
                    dk[:, h] += torch.matmul(ds.transpose(-1, -2), qg[:, h]) * scale
                    dv[:, h] += torch.matmul(p.transpose(-1, -2), dog[:, h])
            # the slice moves on with its accumulators; after the last hop each accumulator is home
            send = [dk, dv] if i == P - 1 else [kc, vc, dk, dv]
            tags = [TAG_DK, TAG_DV] if i == P - 1 else [TAG_K, TAG_V, TAG_DK, TAG_DV]
            recv, work = _rotate(send, tags, ranks, me, group)
            _finish(work, send, ctx.stats)
            if i == P - 1:
                dk, dv = recv
            else:
                kc, vc, dk, dv = recv
        dq = dq.reshape(B, KVH, n_rep, C, D).permute(0, 3, 1, 2, 4).reshape(B, C, H, D).to(q.dtype)
        dk = dk.transpose(1, 2).to(k.dtype)
        dv = dv.transpose(1, 2).to(v.dtype)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None, causal: bool = True,
                   scale: Optional[float] = None, stats=None) -> torch.Tensor:
    """Attention over the whole sequence from this rank's (B, S/P, H, D)
    slices of q, k and v (k, v may hold fewer heads: GQA), the slices in
    rank order over ``group``. Returns the rank's (B, S/P, H, D) slice of
    the output, which matches full (unsliced) softmax attention. ``stats``
    (``layer.new_stats``) counts the hops."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    ranks = _ring_ranks(group)
    if len(ranks) == 1:
        from ..ops.attention import attention_xla

        return attention_xla(q, k, v, causal=causal, scale=scale)
    return _RingAttention.apply(q, k, v, group, ranks, causal, scale, stats)
