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
of size 1 are pruned from it (JAX ``prune_spec``). An expert leaf (its
first dimension over ``expert``) holds E / ep experts on each rank; a leaf
with a dimension over ``tensor`` (the column- and row-parallel kernels, the
vocab-parallel ``wte`` and head) holds 1 / tp of it on each tensor rank.
The ZeRO dimension is then chosen among the other dimensions, by the whole
leaf's sizes as JAX ``shard_leaf_spec`` picks it, and every shape the
engine chunks is the local one (``LeafPlan.local_shape``). A dimension on
``tensor`` that the degree does not divide raises, as JAX's ``device_put``
does, except on the vocabulary leaves (``VOCAB_LEAVES``), which then stay
whole on every tensor rank (GPT-2's 50,257).

A leaf the rules keep whole but whose every tensor rank uses only its own
slice (``TENSOR_PARTIAL_RULES``: the biases of the column-parallel
projections and of a vocab-parallel head) has a gradient that is this
rank's part of the whole one: ``LeafPlan.tp_partial`` marks it, and the
engine sums its gradient over ``tensor``.
"""

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...checkpoint.utils import flatten_tree, unflatten_tree

BLOCK_KEY = re.compile(r"layer_\d+$")  # a transformer block's subtree: stage 3 gathers it alone
VOCAB_LEAVES = ("wte", "lm_head")  # vocab-parallel leaves: whole on every tensor rank where tp does not divide V
# whole leaves of which each tensor rank reads its heads' or columns' slice (where the sibling kernel is split)
TENSOR_PARTIAL_RULES = (("q_proj", "bias"), ("k_proj", "bias"), ("v_proj", "bias"), ("gate_proj", "bias"),
                        ("up_proj", "bias"), ("lm_head", "bias"))
PORTED_SPEC_AXES = ("expert", "tensor")


def zero_axes_for(topo) -> Tuple[str, ...]:
    """Mesh axes that carry ZeRO shards."""
    return ("fsdp",) if topo.axis_size("fsdp") > 1 else ("data",)


def zero_size_for(topo) -> int:
    return int(np.prod([topo.axis_size(a) for a in zero_axes_for(topo)]))


def shard_leaf_dim(shape: Tuple[int, ...], axes_size: int, min_size: int = 0,
                   taken: Sequence[Optional[int]] = ()) -> Optional[int]:
    """The dimension to shard over ``axes_size`` ranks: the largest that
    ``axes_size`` divides, other than those in ``taken`` (dimensions the base
    spec already shards: the expert one, the tensor one), or ``None`` for a
    leaf smaller than ``max(min_size, axes_size)`` elements or with no such
    dimension (JAX ``shard_leaf_spec``, on the whole leaf's shape)."""
    size = int(np.prod(shape)) if shape else 0
    if not shape or size < max(min_size, axes_size):
        return None
    for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if dim not in taken and shape[dim] % axes_size == 0:
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


def spec_dims(param_shapes, topo, rules=None):
    """Each leaf's (expert dimension, tensor dimension) under its pruned spec
    (``None`` for a dimension it does not split); an axis other than these
    two left in a spec is one the port does not run."""
    rules = rules or []

    def dims(path, leaf):
        names_path = path.split("/")
        spec = prune_spec(match_partition_rule(names_path, rules), topo)
        shape = _shape(leaf)
        out = {"expert": None, "tensor": None}
        for i, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if any(n not in (None,) + PORTED_SPEC_AXES for n in names) or len(names) > 1:
                raise NotImplementedError(f"{path}: partition spec {spec} shards over {names}; the port runs the "
                                          "expert and tensor axes, one a dimension")
            axis = names[0]
            if axis is None:
                continue
            if shape[i] % topo.axis_size(axis):
                if axis == "tensor" and any(n in VOCAB_LEAVES for n in names_path):
                    continue  # a vocabulary tp does not divide: the leaf stays whole on every tensor rank
                raise ValueError(f"{path}: dimension {i} of {shape} is not divisible by the {axis} axis "
                                 f"{topo.axis_size(axis)}")
            out[axis] = i
        return out["expert"], out["tensor"]

    return unflatten_tree((path, dims(path, leaf)) for path, leaf in flatten_tree(param_shapes))


def tensor_partial(paths: Sequence[str], tdims: Sequence[Optional[int]]) -> List[bool]:
    """For each leaf (``paths`` and their tensor dimensions, in one order):
    whether it is a whole leaf that each tensor rank reads a slice of
    (``TENSOR_PARTIAL_RULES``, where the sibling kernel is tensor-split)."""
    split = {path for path, t in zip(paths, tdims) if t is not None}
    return [t is None and tuple(path.split("/")[-2:]) in TENSOR_PARTIAL_RULES
            and path.rsplit("/", 1)[0] + "/kernel" in split for path, t in zip(paths, tdims)]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(n) for n in (leaf.shape if hasattr(leaf, "shape") else leaf))


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def plan_param_specs(param_shapes, config, topo, rules=None):
    """The ZeRO-sharded dimension of each fp32 master (stage 3 only), never
    one the rules put on ``expert`` or ``tensor`` (JAX ``plan_param_specs``
    with the model's rules)."""
    size = zero_size_for(topo)
    zc = config.zero_config
    sdims = spec_dims(param_shapes, topo, rules)
    if zc.stage == 3 and size > 1:
        return _tree_map(lambda leaf, d: shard_leaf_dim(_shape(leaf), size, zc.stage3_param_persistence_threshold,
                                                        taken=d), param_shapes, sdims)
    return _tree_map(lambda leaf: None, param_shapes)


def _more_specs(param_shapes, param_specs, topo, rules):
    size = zero_size_for(topo)
    sdims = spec_dims(param_shapes, topo, rules)
    return _tree_map(lambda leaf, spec, d: spec if spec is not None else shard_leaf_dim(_shape(leaf), size, taken=d),
                     param_shapes, param_specs, sdims)


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
    of its master, its gradient buffer and its optimizer state, the
    dimension split over ``ep`` expert ranks (``expert_dim``) and the one
    split over ``tp`` tensor ranks (``tensor_dim``); ``tp_partial``: a whole
    leaf whose gradient each tensor rank holds a part of."""
    path: str
    shape: Tuple[int, ...]
    param_dim: Optional[int]
    grad_dim: Optional[int]
    opt_dim: Optional[int]
    expert_dim: Optional[int] = None
    ep: int = 1
    tensor_dim: Optional[int] = None
    tp: int = 1
    tp_partial: bool = False

    @property
    def group(self) -> str:
        """The top-level key the leaf lives under: stage 3 gathers by it."""
        return self.path.split("/", 1)[0]

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The shape this rank's expert and tensor coordinates hold: E / ep
        experts of an expert leaf, 1 / tp of a tensor-split dimension."""
        s = list(self.shape)
        if self.expert_dim is not None:
            s[self.expert_dim] //= self.ep
        if self.tensor_dim is not None:
            s[self.tensor_dim] //= self.tp
        return tuple(s)

    @property
    def local_numel(self) -> int:
        return int(np.prod(self.local_shape)) if self.shape else 1


@dataclass
class ZeroPlan:
    """Every leaf's ``LeafPlan`` in flattened order, with the stage, this
    rank's place on the ZeRO axis (``size`` ranks, this one ``rank``), on
    the expert axis (``ep_size``, ``ep_rank``) and on the tensor axis
    (``tp_size``, ``tp_rank``)."""
    stage: int
    axis: str
    size: int
    rank: int
    leaves: List[LeafPlan]
    ep_size: int = 1
    ep_rank: int = 0
    tp_size: int = 1
    tp_rank: int = 0

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
        """This rank's experts and tensor slice of a whole leaf (the leaf
        itself when it splits over neither)."""
        if leaf.expert_dim is not None and leaf.ep > 1:
            n = t.shape[leaf.expert_dim] // leaf.ep
            t = t.narrow(leaf.expert_dim, self.ep_rank * n, n)
        if leaf.tensor_dim is not None and leaf.tp > 1:
            n = t.shape[leaf.tensor_dim] // leaf.tp
            t = t.narrow(leaf.tensor_dim, self.tp_rank * n, n)
        return t

    def chunk(self, t: torch.Tensor, leaf: LeafPlan, dim: Optional[int]) -> torch.Tensor:
        """This rank's chunk along ``dim`` of its local part of a whole leaf."""
        local = self.local(t, leaf)
        return self.shard(local, dim) if dim is not None else local


def plan_zero(param_shapes, config, topo, rules=None) -> ZeroPlan:
    """The three plans of ``param_shapes`` (a dict tree of tensors, arrays or
    shapes) side by side, leaf by leaf, under the model's partition rules."""
    pspec = plan_param_specs(param_shapes, config, topo, rules)
    gspec = plan_grad_specs(param_shapes, pspec, config, topo, rules)
    ospec = plan_opt_state_specs(param_shapes, pspec, config, topo, rules)
    sdims = [d for _, d in flatten_tree(spec_dims(param_shapes, topo, rules))]
    paths = [path for path, _ in flatten_tree(param_shapes)]
    partial = tensor_partial(paths, [t for _, t in sdims])
    ep, tp = topo.axis_size("expert"), topo.axis_size("tensor")
    leaves = [LeafPlan(path, _shape(leaf), p, g, o, e, ep if e is not None else 1, t, tp if t is not None else 1, pt)
              for (path, leaf), (_, p), (_, g), (_, o), (e, t), pt
              in zip(flatten_tree(param_shapes), flatten_tree(pspec), flatten_tree(gspec), flatten_tree(ospec),
                     sdims, partial)]
    axis = zero_axes_for(topo)[0]
    return ZeroPlan(config.zero_config.stage, axis, zero_size_for(topo), topo.axis_rank(axis), leaves, ep,
                    topo.axis_rank("expert"), tp, topo.axis_rank("tensor"))
