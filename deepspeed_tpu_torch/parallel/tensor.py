"""Tensor parallelism in training: Megatron's region functions over the
``tensor`` group, and the context the model reads.

The JAX engine trains over a ``tensor`` axis through GSPMD: the parameters
carry ``CausalLM.partition_rules()``'s specs (column-parallel q/k/v,
gate/up and the head, row-parallel o and down, a vocab-parallel ``wte``)
and XLA inserts the collectives. Here each rank is one process holding its
slice of those leaves, and the collectives are explicit, as in the
reference's Megatron layers (``mpu/mappings.py``), as
``torch.autograd.Function``s over the ``tensor`` process group:

- ``copy`` (copy-to-region): the identity forward, a sum over the group
  backward. It stands before every column-parallel projection: each rank's
  gradient of the replicated input is its own heads' or columns' part.
- ``reduce`` (reduce-from-region): a sum over the group forward, the
  identity backward. It follows every row-parallel projection.
- ``split`` / ``gather``: this rank's 1 / tp slice of a replicated tensor
  along a dimension (its backward all-gathers the gradient) and the
  all-gather of such slices (its backward takes this rank's slice). The
  partitioned activation checkpoint keeps a block's input as a slice and
  gathers it at the recompute.
- ``embed``: the vocab-parallel embedding: this rank's rows, masked, then
  ``reduce``; a ``wte`` kept whole (a vocabulary the degree does not
  divide) is a plain lookup on every rank.

``TensorParallel`` is a rank's place in its tensor group, with the counters
of its collectives; ``tensor_parallel(tp)`` makes it current while the
training engine runs the model's forward and backward, and the model reads
it (``current_tensor_parallel``), as it reads ``sequence.layer``'s
``SequenceParallel``.
"""

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from .. import comm as dist
from ..comm import ReduceOp


def new_stats() -> Dict[str, list]:
    """The collectives' counters: {"tp_all_reduce" | "tp_all_gather": [calls, bytes, host seconds]}. The
    bytes are the all-reduced tensor's or the all-gather's output; the seconds the host's wall time in the
    call, which under host-staged gloo covers the transfer and the copies around it."""
    return {"tp_all_reduce": [0, 0, 0.0], "tp_all_gather": [0, 0, 0.0]}


@dataclass
class TensorParallel:
    """This rank's tensor group: its size, this rank's place in it, the
    process group (None: the whole world) and the counters (``new_stats``)."""
    size: int
    rank: int
    group: object = None
    stats: Dict[str, list] = field(default_factory=new_stats)

    # ---------------------------------------------------------------- the collectives, counted
    def _count(self, op: str, t: torch.Tensor, t0: float) -> None:
        st = self.stats[op]
        st[0] += 1
        st[1] += t.numel() * t.element_size()
        st[2] += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        """A new tensor: ``x`` reduced over the group (a sum, or ``op``)."""
        out = x.contiguous().clone()
        t0 = time.perf_counter()
        dist.all_reduce(out, op=op, group=self.group)
        self._count("tp_all_reduce", out, t0)
        return out

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's slices of ``x`` along ``dim``, in rank order."""
        x = x.contiguous()
        recv = torch.empty((self.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        t0 = time.perf_counter()
        dist.all_gather_into_tensor(recv.view(-1), x.view(-1), group=self.group)
        self._count("tp_all_gather", recv, t0)
        return torch.cat(list(recv.unbind(0)), dim=dim)

    def slice(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's 1 / size of ``x`` along ``dim`` (a view)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    # ---------------------------------------------------------------- the region functions
    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToRegion.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromRegion.apply(x, self)

    def split(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _SplitToRegion.apply(x, self, dim)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherFromRegion.apply(x, self, dim)

    # ---------------------------------------------------------------- the model's seams
    def embed(self, wte: torch.Tensor, ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """Embedding rows of ``ids``: from a vocab-split ``wte`` this rank's
        rows (zeros for ids it does not hold), summed over the group; from a
        whole one a plain lookup. Ids clamp to the vocabulary, as in
        serving's ``TPContext.embed``."""
        ids = ids.long().clamp(0, vocab_size - 1)
        n = wte.shape[0]
        if n == vocab_size:
            return torch.nn.functional.embedding(ids, wte)
        local = ids - self.rank * n
        mine = ((local >= 0) & (local < n))[..., None]
        rows = torch.nn.functional.embedding(local.clamp(0, n - 1), wte)
        return self.reduce(torch.where(mine, rows, torch.zeros((), dtype=wte.dtype, device=wte.device)))

    def vocab_logits(self, logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
        """Whole rows of logits from this rank's vocab columns (an all-gather;
        whole columns pass as they are)."""
        if logits.shape[-1] == vocab_size:
            return logits
        return self.gather(logits, logits.dim() - 1)

    def local_slopes(self, n_heads: int) -> np.ndarray:
        """This rank's heads' ALiBi slopes."""
        from ..models.transformer import alibi_slopes

        hs = n_heads // self.size
        return alibi_slopes(n_heads)[self.rank * hs:(self.rank + 1) * hs]


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (``_CopyToModelParallelRegion``)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g), None


class _ReduceFromRegion(torch.autograd.Function):
    """A sum over the group forward; the identity backward (``_ReduceFromModelParallelRegion``)."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitToRegion(torch.autograd.Function):
    """This rank's slice forward (own storage); the gradient all-gathered (``_ScatterToModelParallelRegion``)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.slice(x, dim).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_gather(g, ctx.dim), None, None


class _GatherFromRegion(torch.autograd.Function):
    """The slices all-gathered forward; the gradient's own slice backward (``_GatherFromModelParallelRegion``)."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return tp.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.slice(g, ctx.dim).contiguous(), None, None


_CURRENT: Optional[TensorParallel] = None


@contextlib.contextmanager
def tensor_parallel(tp: Optional[TensorParallel]):
    """Make ``tp`` the model's tensor group inside the block (None: none)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, tp
    try:
        yield tp
    finally:
        _CURRENT = prev


def current_tensor_parallel() -> Optional[TensorParallel]:
    return _CURRENT
