"""Tensor-parallel layouts of a serving parameter tree.

Port of the part of ``deepspeed_tpu/module_inject/load_checkpoint.py`` that
tensor-parallel serving needs (``tp_shardings`` :1172, ``shard_params``
:1200). The JAX package device-puts the whole tree with a ``NamedSharding``
per leaf; here each rank is one process and keeps only its slice: along
every dimension that a leaf's rule puts on ``tensor``, rank ``r`` of ``tp``
takes the ``r``-th of ``tp`` equal parts, which is the JAX shard of the
same ``tensor`` index. The rules are the model's ``partition_rules()``
(``CausalLM``: column-parallel q/k/v, gate and up, row-parallel o and down,
vocab-parallel ``wte`` and ``lm_head``, the MoE rules first: each expert's
hidden dim on ``tensor``). Axes other than ``tensor`` have size 1 on a
serving mesh and cut nothing.

A dimension that ``tp`` does not divide raises, as the JAX ``device_put``
does, except on the vocab-parallel leaves (``VOCAB_LEAVES``): there the
leaf stays whole on every rank (GPT-2's vocabulary of 50,257 is odd) and
the serving modules read from its shape that it is not sharded.

``SERVING_BIAS_RULES`` are the port's own: the biases of the
column-parallel projections split with their outputs, so that a rank adds
the bias of its own heads or columns. The JAX package leaves every bias
whole (its GSPMD partitioner splits the add); the serving engine appends
these rules, ``shard_params`` alone does not.
"""

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

from ..runtime.zero.partition import match_partition_rule

TP_AXIS = "tensor"
VOCAB_LEAVES = ("wte", "lm_head")
SERVING_BIAS_RULES = [
    (("q_proj", "bias"), (TP_AXIS, None)),
    (("k_proj", "bias"), (TP_AXIS, None)),
    (("v_proj", "bias"), (TP_AXIS, None)),
    (("gate_proj", "bias"), (TP_AXIS,)),
    (("up_proj", "bias"), (TP_AXIS,)),
    (("lm_head", "bias"), (TP_AXIS,)),
]


def get_tp_rules(model=None) -> list:
    """The model's partition rules (``CausalLM.partition_rules``); a
    ``TransformerConfig`` or an object with ``.cfg`` gets ``CausalLM``'s."""
    if hasattr(model, "partition_rules"):
        return list(model.partition_rules())
    from ..models.transformer import CausalLM, TransformerConfig

    cfg = model if isinstance(model, TransformerConfig) else getattr(model, "cfg", None)
    if cfg is None:
        raise ValueError("tensor-parallel serving needs a CausalLM, a TransformerConfig or a model with .cfg")
    return CausalLM(cfg).partition_rules()


def _is_tp(axis) -> bool:
    return axis == TP_AXIS or (isinstance(axis, tuple) and TP_AXIS in axis)


def leaf_spec(keys: Tuple[str, ...], shape: Sequence[int], rules: Sequence, tp: int) -> tuple:
    """A leaf's spec (one mesh axis or None a dimension, trailing Nones
    dropped) at ``tensor`` = ``tp``: its rule's, or ``()`` (whole) at tp 1,
    without a rule, or for a vocab-parallel leaf that ``tp`` does not divide.
    Any other dimension on ``tensor`` that ``tp`` does not divide raises."""
    if tp <= 1:
        return ()
    s = list(match_partition_rule(keys, rules) or ())
    while s and s[-1] is None:
        s.pop()
    for dim, axis in enumerate(s):
        if _is_tp(axis) and shape[dim] % tp:
            if keys and keys[0] in VOCAB_LEAVES:
                return ()
            raise ValueError(f"{'/'.join(keys)}: dimension {dim} of {tuple(shape)} does not split over "
                             f"tensor_parallel={tp}")
    return tuple(s)


def tp_shardings(params: Dict[str, Any], model=None, tp_size: int = 1,
                 rules: Optional[Sequence] = None) -> Dict[str, Any]:
    """The spec of every leaf (``leaf_spec``) under the TP rules: the JAX
    ``tp_shardings``' ``PartitionSpec``s, as tuples."""
    rules = get_tp_rules(model) if rules is None else rules

    def build(tree, keys=()):
        if isinstance(tree, dict):
            return {k: build(v, keys + (str(k),)) for k, v in tree.items()}
        return leaf_spec(keys, tuple(getattr(tree, "shape", ())), rules, tp_size)

    return build(params)


def shard_leaf(leaf: torch.Tensor, spec: Iterable, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``leaf`` along each dimension ``spec`` puts on
    ``tensor`` (``leaf_spec``): a fresh contiguous tensor, so that the whole
    leaf can be freed; the leaf itself when nothing is on ``tensor``."""
    out = leaf
    for dim, axis in enumerate(spec):
        if _is_tp(axis):
            n = leaf.shape[dim] // tp
            out = out.narrow(dim, rank * n, n)
    if out is leaf:
        return leaf
    return out.clone(memory_format=torch.contiguous_format)


def shard_params(params: Dict[str, Any], model=None, tp_size: int = 1, rank: int = 0,
                 rules: Optional[Sequence] = None) -> Dict[str, Any]:
    """This rank's slice of every leaf under the TP rules (the JAX
    ``shard_params``' shard at ``tensor`` index ``rank``); at ``tp_size`` 1
    the tree as it is."""
    if tp_size <= 1:
        return params
    rules = get_tp_rules(model) if rules is None else rules
    specs = tp_shardings(params, rules=rules, tp_size=tp_size)

    def build(tree, spec_tree, keys=()):
        if isinstance(tree, dict):
            return {k: build(v, spec_tree[k], keys + (str(k),)) for k, v in tree.items()}
        return shard_leaf(tree, spec_tree, tp_size, rank) if isinstance(tree, torch.Tensor) else tree

    return build(params, specs)
