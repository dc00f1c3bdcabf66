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

The model's partition rules (``CausalLM.partition_rules``: (path names,
spec) pairs, a spec a tuple of axis names or ``None`` per dimension, the
JAX package's ``PartitionSpec`` entries) give each leaf its base spec; axes
of size 1 are pruned from it (JAX ``prune_spec``), so at ``tensor`` 1 only
``expert`` survives. An expert leaf (its first dimension over ``expert``)
holds E / ep experts on each rank, and the ZeRO dimension is then chosen
among its other dimensions: every shape the engine chunks is that local
shape (``LeafPlan.local_shape``).
"""

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...checkpoint.utils import flatten_tree, unflatten_tree

BLOCK_KEY = re.compile(r"layer_\d+$")  # a transformer block's subtree: stage 3 gathers it alone


def zero_axes_for(topo) -> Tuple[str, ...]:
    """Mesh axes that carry ZeRO shards."""
    return ("fsdp",) if topo.axis_size("fsdp") > 1 else ("data",)


def zero_size_for(topo) -> int:
    return int(np.prod([topo.axis_size(a) for a in zero_axes_for(topo)]))


def shard_leaf_dim(shape: Tuple[int, ...], axes_size: int, min_size: int = 0,
                   taken: Optional[int] = None) -> Optional[int]:
    """The dimension to shard over ``axes_size`` ranks: the largest that
    ``axes_size`` divides, other than ``taken`` (a dimension the base spec
    already shards, the expert one), or ``None`` for a leaf smaller than
    ``max(min_size, axes_size)`` elements or with no such dimension (JAX
    ``shard_leaf_spec``)."""
    size = int(np.prod(shape)) if shape else 0
    if not shape or size < max(min_size, axes_size):
        return None
    for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if dim != taken and shape[dim] % axes_size == 0:
            return dim
    return None


def match_partition_rule(path: Sequence[str], rules) -> Optional[tuple]:
    """The first rule whose key names all appear, in order, in the path (JAX ``match_partition_rule``)."""
    for key, spec in rules:
        it = iter(path)
        if all(any(k == p for p in it) for k in key):
            return tuple(spec)
    return None


def prune_spec(spec: Optional[tuple], topo) -> tuple:
    """Drop axes of size 1 from a spec and its trailing ``None``s (JAX ``prune_spec``)."""
    if spec is None:
        return ()

    def keep(entry):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        names = tuple(a for a in names if a is not None and topo.axis_size(a) > 1)
        return None if not names else names if len(names) > 1 else names[0]

    out = [keep(e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def expert_dims(param_shapes, topo, rules=None):
    """The dimension each leaf's pruned spec puts on ``expert`` (``None`` for
    the rest); any other axis left in a spec is one the port does not run."""
    rules = rules or []

    def dim(path, leaf):
        spec = prune_spec(match_partition_rule(path.split("/"), rules), topo)
        out = None
        for i, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if any(n not in (None, "expert") for n in names):
                raise NotImplementedError(f"{path}: partition spec {spec} shards over {names}; the port runs "
                                          "the expert axis only")
            if "expert" in names:
                if _shape(leaf)[i] % topo.axis_size("expert"):
                    raise ValueError(f"{path}: dimension {i} of {_shape(leaf)} is not divisible by the expert "
                                     f"axis {topo.axis_size('expert')}")
                out = i
        return out

    return unflatten_tree((path, dim(path, leaf)) for path, leaf in flatten_tree(param_shapes))


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def plan_param_specs(param_shapes, config, topo, rules=None):
    """The ZeRO-sharded dimension of each fp32 master (stage 3 only), never
    the one the rules put on ``expert`` (JAX ``plan_param_specs`` with the
    model's rules)."""
    size = zero_size_for(topo)
    zc = config.zero_config
    edims = expert_dims(param_shapes, topo, rules)
    if zc.stage == 3 and size > 1:
        return _tree_map(lambda leaf, e: shard_leaf_dim(_shape(leaf), size, zc.stage3_param_persistence_threshold,
                                                        taken=e), param_shapes, edims)
    return _tree_map(lambda leaf: None, param_shapes)


def _more_specs(param_shapes, param_specs, topo, rules):
    size = zero_size_for(topo)
    edims = expert_dims(param_shapes, topo, rules)
    return _tree_map(lambda leaf, spec, e: spec if spec is not None else shard_leaf_dim(_shape(leaf), size, taken=e),
                     param_shapes, param_specs, edims)


def plan_grad_specs(param_shapes, param_specs, config, topo, rules=None):
    """Gradient-accumulation buffers: sharded from stage 2 up (a leaf kept
    whole at stage 3 still has its gradient sharded)."""
    if config.zero_config.stage >= 2 and zero_size_for(topo) > 1:
        return _more_specs(param_shapes, param_specs, topo, rules)
    return param_specs


def plan_opt_state_specs(param_shapes, param_specs, config, topo, rules=None):
    """Every parameter-shaped optimizer state (moments, accumulators): sharded
    from stage 1 up; the optimizer's scalars stay whole."""
    if config.zero_config.stage >= 1 and zero_size_for(topo) > 1:
        return _more_specs(param_shapes, param_specs, topo, rules)
    return param_specs


@dataclass(frozen=True)
class LeafPlan:
    """One leaf's plan: its full shape, the dimension sharded (or ``None``)
    of its master, its gradient buffer and its optimizer state, and the
    dimension split over ``ep`` expert ranks (``expert_dim``)."""
    path: str
    shape: Tuple[int, ...]
    param_dim: Optional[int]
    grad_dim: Optional[int]
    opt_dim: Optional[int]
    expert_dim: Optional[int] = None
    ep: int = 1

    @property
    def group(self) -> str:
        """The top-level key the leaf lives under: stage 3 gathers by it."""
        return self.path.split("/", 1)[0]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The shape this rank's expert coordinate holds: E / ep experts of an expert leaf."""
        if self.expert_dim is None:
            return self.shape
        s = list(self.shape)
        s[self.expert_dim] //= self.ep
        return tuple(s)

    @property
    def local_numel(self) -> int:
        return self.numel // (self.ep if self.expert_dim is not None else 1)


@dataclass
class ZeroPlan:
    """Every leaf's ``LeafPlan`` in flattened order, with the stage, this
    rank's place on the ZeRO axis (``size`` ranks, this one ``rank``) and on
    the expert axis (``ep_size``, ``ep_rank``)."""
    stage: int
    axis: str
    size: int
    rank: int
    leaves: List[LeafPlan]
    ep_size: int = 1
    ep_rank: int = 0

    def shard_shape(self, leaf: LeafPlan, dim: Optional[int]) -> Tuple[int, ...]:
        if dim is None:
            return leaf.local_shape
        s = list(leaf.local_shape)
        s[dim] //= self.size
        return tuple(s)

    def shard(self, t: torch.Tensor, dim: Optional[int], rank: Optional[int] = None) -> torch.Tensor:
        """Rank ``rank``'s (default: this rank's) chunk of a (local) tensor
        along ``dim`` as a contiguous tensor with its own storage (the whole
        tensor when ``dim`` is ``None``)."""
        if dim is None:
            return t
        n = t.shape[dim] // self.size
        r = self.rank if rank is None else rank
        return t.narrow(dim, r * n, n).clone(memory_format=torch.contiguous_format)

    def local(self, t: torch.Tensor, leaf: LeafPlan) -> torch.Tensor:
        """This rank's experts of a whole leaf (the leaf itself when it has no expert dimension)."""
        if leaf.expert_dim is None or leaf.ep == 1:
            return t
        n = t.shape[leaf.expert_dim] // leaf.ep
        return t.narrow(leaf.expert_dim, self.ep_rank * n, n)

    def chunk(self, t: torch.Tensor, leaf: LeafPlan, dim: Optional[int]) -> torch.Tensor:
        """This rank's chunk along ``dim`` of its experts of a whole leaf."""
        local = self.local(t, leaf)
        return self.shard(local, dim) if dim is not None else local


def plan_zero(param_shapes, config, topo, rules=None) -> ZeroPlan:
    """The three plans of ``param_shapes`` (a dict tree of tensors, arrays or
    shapes) side by side, leaf by leaf, under the model's partition rules."""
    pspec = plan_param_specs(param_shapes, config, topo, rules)
    gspec = plan_grad_specs(param_shapes, pspec, config, topo, rules)
    ospec = plan_opt_state_specs(param_shapes, pspec, config, topo, rules)
    edims = expert_dims(param_shapes, topo, rules)
    ep = topo.axis_size("expert")
    leaves = [LeafPlan(path, _shape(leaf), p, g, o, e, ep if e is not None else 1)
              for (path, leaf), (_, p), (_, g), (_, o), (_, e)
              in zip(flatten_tree(param_shapes), flatten_tree(pspec), flatten_tree(gspec), flatten_tree(ospec),
                     flatten_tree(edims))]
    axis = zero_axes_for(topo)[0]
    return ZeroPlan(config.zero_config.stage, axis, zero_size_for(topo), topo.axis_rank(axis), leaves, ep,
                    topo.axis_rank("expert"))
