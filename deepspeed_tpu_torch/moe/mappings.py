"""Expert-TP token redistribution over the ``tensor`` axis.

Port of ``deepspeed_tpu/moe/mappings.py`` (reference ``moe/mappings.py``:
``drop_tokens`` / ``gather_tokens``). Under tensor parallelism the
activations outside the MoE block are whole on every rank of a ``tensor``
group; ``drop_tokens`` keeps this rank's 1/tp slice of the tokens along a
dimension and ``gather_tokens`` puts the slices back together on every
rank. The JAX functions change a sharding constraint; here each rank is a
process, so the slice is a view and the gather a collective: the slices
summed into a zeroed whole over the group (an all-reduce, which gloo also
runs on CUDA tensors), exact because every element has one non-zero term.
Both are no-ops at tp 1. The serving path does not call them (every rank
routes the same tokens and holds I / tp of each expert's hidden dim); they
are the reference's utilities.
"""

from typing import Optional

import torch

from .. import comm as dist


def _tp(topo):
    from ..parallel.mesh import get_mesh_topology

    topo = topo if topo is not None else get_mesh_topology(required=False)
    return (topo, topo.model_parallel_size) if topo is not None else (None, 1)


def drop_tokens(x: torch.Tensor, dim: int = 1, topo=None) -> torch.Tensor:
    """This rank's 1/tp slice of ``x`` along ``dim`` (a ``dim`` that tp does not divide raises)."""
    topo, tp = _tp(topo)
    if tp <= 1:
        return x
    if x.shape[dim] % tp:
        raise ValueError(f"drop_tokens: dim {dim} of shape {tuple(x.shape)} not divisible by tp={tp}")
    n = x.shape[dim] // tp
    return x.narrow(dim, topo.axis_rank("tensor") * n, n)


def gather_tokens(x: torch.Tensor, dim: int = 1, topo=None, group: Optional[object] = None) -> torch.Tensor:
    """Every rank's slices of ``x`` along ``dim``, in rank order, on every rank."""
    topo, tp = _tp(topo)
    if tp <= 1:
        return x
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * tp
    out = x.new_zeros(shape)
    out.narrow(dim, topo.axis_rank("tensor") * n, n).copy_(x)
    dist.all_reduce(out, group=group if group is not None else topo.process_group("tensor"))
    return out
