"""ZeRO's partition planner.

Port of ``deepspeed_tpu/runtime/zero/partition.py``. The JAX package states
each stage as where every pytree leaf lives on the mesh and lets XLA insert
the collectives; here the same plan says which dimension of each leaf a
rank holds a chunk of, and the engine (``runtime/engine.py`` with
``sharded.py``) moves the chunks over ``torch.distributed``:

- stage 0: params, gradients and optimizer state whole on every rank;
- stage 1: the optimizer state sharded over the ZeRO axis;
- stage 2: also the gradient-accumulation buffer;
- stage 3: also the fp32 master parameters, except leaves under
  ``stage3_param_persistence_threshold`` elements.

A leaf is sharded on the largest dimension that the ZeRO axis's size
divides (the first of equal ones), or not at all when it is smaller than
that size or no dimension divides: the choice of the JAX
``shard_leaf_spec``. The ZeRO axis is ``fsdp`` when it exceeds 1, else
``data``; with both above 1 the ``data`` groups hold replicas. A plan is a
tree of ``Optional[int]`` (the sharded dimension, or ``None``) shaped like
the parameters.
"""

import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...checkpoint.utils import flatten_tree

BLOCK_KEY = re.compile(r"layer_\d+$")  # a transformer block's subtree: stage 3 gathers it alone


def zero_axes_for(topo) -> Tuple[str, ...]:
    """Mesh axes that carry ZeRO shards."""
    return ("fsdp",) if topo.axis_size("fsdp") > 1 else ("data",)


def zero_size_for(topo) -> int:
    return int(np.prod([topo.axis_size(a) for a in zero_axes_for(topo)]))


def shard_leaf_dim(shape: Tuple[int, ...], axes_size: int, min_size: int = 0) -> Optional[int]:
    """The dimension to shard over ``axes_size`` ranks: the largest that
    ``axes_size`` divides, or ``None`` for a leaf smaller than
    ``max(min_size, axes_size)`` elements or with no such dimension (JAX
    ``shard_leaf_spec`` without tensor-parallel rules)."""
    size = int(np.prod(shape)) if shape else 0
    if not shape or size < max(min_size, axes_size):
        return None
    for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[dim] % axes_size == 0:
            return dim
    return None


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def plan_param_specs(param_shapes, config, topo):
    """The sharded dimension of each fp32 master (stage 3 only)."""
    size = zero_size_for(topo)
    zc = config.zero_config
    if zc.stage == 3 and size > 1:
        return _tree_map(lambda leaf: shard_leaf_dim(_shape(leaf), size, zc.stage3_param_persistence_threshold),
                         param_shapes)
    return _tree_map(lambda leaf: None, param_shapes)


def plan_grad_specs(param_shapes, param_specs, config, topo):
    """Gradient-accumulation buffers: sharded from stage 2 up (a leaf kept
    whole at stage 3 still has its gradient sharded)."""
    size = zero_size_for(topo)
    if config.zero_config.stage >= 2 and size > 1:
        return _tree_map(lambda leaf, spec: spec if spec is not None else shard_leaf_dim(_shape(leaf), size),
                         param_shapes, param_specs)
    return param_specs


def plan_opt_state_specs(param_shapes, param_specs, config, topo):
    """Every parameter-shaped optimizer state (moments, accumulators): sharded
    from stage 1 up; the optimizer's scalars stay whole."""
    size = zero_size_for(topo)
    if config.zero_config.stage >= 1 and size > 1:
        return _tree_map(lambda leaf, spec: spec if spec is not None else shard_leaf_dim(_shape(leaf), size),
                         param_shapes, param_specs)
    return param_specs


@dataclass(frozen=True)
class LeafPlan:
    """One leaf's plan: its full shape and the dimension sharded (or ``None``)
    of its master, its gradient buffer and its optimizer state."""
    path: str
    shape: Tuple[int, ...]
    param_dim: Optional[int]
    grad_dim: Optional[int]
    opt_dim: Optional[int]

    @property
    def group(self) -> str:
        """The top-level key the leaf lives under: stage 3 gathers by it."""
        return self.path.split("/", 1)[0]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclass
class ZeroPlan:
    """Every leaf's ``LeafPlan`` in flattened order, with the stage and this
    rank's place on the ZeRO axis (``size`` ranks, this one ``rank``)."""
    stage: int
    axis: str
    size: int
    rank: int
    leaves: List[LeafPlan]

    def shard_shape(self, leaf: LeafPlan, dim: Optional[int]) -> Tuple[int, ...]:
        if dim is None:
            return leaf.shape
        s = list(leaf.shape)
        s[dim] //= self.size
        return tuple(s)

    def shard(self, t: torch.Tensor, dim: Optional[int], rank: Optional[int] = None) -> torch.Tensor:
        """Rank ``rank``'s (default: this rank's) chunk of a full tensor along
        ``dim`` as a contiguous tensor with its own storage (the whole
        tensor when ``dim`` is ``None``)."""
        if dim is None:
            return t
        n = t.shape[dim] // self.size
        r = self.rank if rank is None else rank
        return t.narrow(dim, r * n, n).clone(memory_format=torch.contiguous_format)


def plan_zero(param_shapes, config, topo) -> ZeroPlan:
    """The three plans of ``param_shapes`` (a dict tree of tensors, arrays or
    shapes) side by side, leaf by leaf."""
    pspec = plan_param_specs(param_shapes, config, topo)
    gspec = plan_grad_specs(param_shapes, pspec, config, topo)
    ospec = plan_opt_state_specs(param_shapes, pspec, config, topo)
    leaves = [LeafPlan(path, _shape(leaf), p, g, o) for (path, leaf), (_, p), (_, g), (_, o)
              in zip(flatten_tree(param_shapes), flatten_tree(pspec), flatten_tree(gspec), flatten_tree(ospec))]
    axis = zero_axes_for(topo)[0]
    return ZeroPlan(config.zero_config.stage, axis, zero_size_for(topo), topo.axis_rank(axis), leaves)
