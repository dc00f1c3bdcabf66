"""Sequence parallelism: DeepSpeed-Ulysses, and the context the model reads.

Port of ``deepspeed_tpu/sequence/layer.py`` (reference
``deepspeed/sequence/layer.py``): ``single_all_to_all`` (:15), the
autograd-symmetric ``_SeqAllToAll`` (:44), whose backward is the inverse
exchange, and ``DistributedAttention`` (:60), which wraps any local
attention with a (sequence -> heads) all-to-all before it and the inverse
after, so that each rank attends over whole sequences for H / P of the heads
(on CUDA tensors the local attention is ``ops.attention``: the flash
kernels). The JAX package runs ``lax.all_to_all`` inside ``shard_map``;
here the exchange is ``comm.all_to_all_single`` over the ``seq`` group.

A head count that P does not divide raises ``ValueError``. KV heads that P
does not divide are each repeated just enough that it does (the attention
is unchanged: a repeated head serves the same query heads). ALiBi slopes
are cut to the rank's heads.

``SequenceParallel`` is a rank's place in its sequence group;
``sequence_parallel(sp)`` makes it current while the training engine runs
the model's forward and backward, and the model reads it
(``current_sequence_parallel``): its tokens take their global positions and
its attention runs through ``sp.attention``: Ulysses for ``seq``,
``ring_attention`` for ``context``.
"""

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import comm as dist
from ..ops.attention import attention as default_attention


def new_stats() -> Dict[str, list]:
    """Exchange counters: {"all_to_all" | "ring_hop": [calls, bytes sent, host seconds]}. The seconds are
    the host's wall time in the call (all-to-all) or in the wait (a hop), which under host-staged gloo
    covers the transfer and the copies around it."""
    return {"all_to_all": [0, 0, 0.0], "ring_hop": [0, 0, 0.0]}


def count(stats: Optional[Dict[str, list]], op: str, nbytes: int, seconds: float) -> None:
    if stats is not None:
        st = stats[op]
        st[0] += 1
        st[1] += nbytes
        st[2] += seconds


@dataclass
class SequenceParallel:
    """This rank's sequence group: ``kind`` ``"seq"`` (Ulysses) or
    ``"context"`` (the ring), its process group, size, this rank's place in
    it, and the counters of its exchanges (``new_stats``)."""
    kind: str
    group: object
    size: int
    rank: int
    stats: Dict[str, list] = field(default_factory=new_stats)

    def attention(self, q, k, v, causal: bool = True, alibi_slopes=None, window=None, scale=None):
        if self.kind == "seq":
            return DistributedAttention(default_attention, self.group, stats=self.stats)(
                q, k, v, causal=causal, alibi_slopes=alibi_slopes, window=window, scale=scale)
        from .ring import ring_attention

        if alibi_slopes is not None or window is not None:
            raise NotImplementedError("ALiBi and sliding windows under context parallelism (ring attention) are "
                                      "not ported yet")
        return ring_attention(q, k, v, group=self.group, causal=causal, scale=scale, stats=self.stats)


_CURRENT: Optional[SequenceParallel] = None


@contextlib.contextmanager
def sequence_parallel(sp: Optional[SequenceParallel]):
    """Make ``sp`` the model's sequence group inside the block (None: none)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, sp
    try:
        yield sp
    finally:
        _CURRENT = prev


def current_sequence_parallel() -> Optional[SequenceParallel]:
    return _CURRENT


def single_all_to_all(x: torch.Tensor, scatter_idx: int, gather_idx: int, group=None,
                      stats: Optional[Dict[str, list]] = None) -> torch.Tensor:
    """Split ``scatter_idx`` across the group's P ranks (chunk j to rank j)
    and gather ``gather_idx`` in rank order (reference ``sequence/layer.py:15``),
    counted in ``stats`` when given."""
    P = dist.get_world_size(group)
    if P == 1:
        return x
    n = x.shape[scatter_idx]
    if n % P:
        raise ValueError(f"dimension {scatter_idx} of size {n} does not split over {P} ranks")
    send = x.unflatten(scatter_idx, (P, n // P)).movedim(scatter_idx, 0).contiguous()
    recv = torch.empty_like(send)
    t0 = time.perf_counter()
    dist.all_to_all_single(recv, send, group=group)
    count(stats, "all_to_all", send.numel() * send.element_size(), time.perf_counter() - t0)
    return recv.movedim(0, gather_idx).flatten(gather_idx, gather_idx + 1)


class _SeqAllToAll(torch.autograd.Function):
    """The all-to-all; its backward is the inverse exchange (reference ``sequence/layer.py:44``)."""

    @staticmethod
    def forward(ctx, x, group, scatter_idx, gather_idx, stats):
        ctx.group, ctx.scatter_idx, ctx.gather_idx, ctx.stats = group, scatter_idx, gather_idx, stats
        return single_all_to_all(x, scatter_idx, gather_idx, group, stats)

    @staticmethod
    def backward(ctx, g):
        return (single_all_to_all(g.contiguous(), ctx.gather_idx, ctx.scatter_idx, ctx.group, ctx.stats), None,
                None, None, None)


class DistributedAttention:
    """Reference ``sequence/layer.py:60``: wraps a local attention
    ``(q, k, v, **kw) -> out`` over (B, S, H, D). Each rank holds the (B, S/P,
    H, D) slice of the sequence; heads are scattered and the sequence
    gathered for the attention, then the other way back."""

    def __init__(self, local_attention: Optional[Callable] = None, sequence_process_group=None,
                 scatter_idx: int = 2, gather_idx: int = 1, stats: Optional[Dict[str, list]] = None):
        self.local_attn = local_attention or default_attention
        self.group = sequence_process_group
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx
        self.stats = stats

    def __call__(self, query, key, value, *args, alibi_slopes=None, **kwargs):
        P = dist.get_world_size(self.group)
        H, KVH = query.shape[self.scatter_idx], key.shape[self.scatter_idx]
        if H % P:
            raise ValueError(f"Ulysses splits the {H} query heads over the sequence group of {P}: {P} must divide "
                             "them (an uneven head split is not ported)")
        if KVH % P:  # repeat each KV head just enough that P divides them
            rep = P // math.gcd(KVH, P)
            key = key.repeat_interleave(rep, dim=self.scatter_idx)
            value = value.repeat_interleave(rep, dim=self.scatter_idx)
        s, g = self.scatter_idx, self.gather_idx
        q = _SeqAllToAll.apply(query, self.group, s, g, self.stats)
        k = _SeqAllToAll.apply(key, self.group, s, g, self.stats)
        v = _SeqAllToAll.apply(value, self.group, s, g, self.stats)
        if alibi_slopes is not None:
            r, h = dist.get_rank(self.group), H // P
            alibi_slopes = np.asarray(alibi_slopes)[r * h:(r + 1) * h]
            kwargs["alibi_slopes"] = alibi_slopes
        out = self.local_attn(q, k, v, *args, **kwargs)
        return _SeqAllToAll.apply(out, self.group, g, s, self.stats)


def ulysses_attention(q, k, v, group=None, local_attention: Optional[Callable] = None, **kwargs):
    """Functional form of ``DistributedAttention`` over ``group``."""
    return DistributedAttention(local_attention, group)(q, k, v, **kwargs)
