"""Canonical flat names for parameter trees.

Port of ``deepspeed_tpu/checkpoint/utils.py`` for the nested dicts the port
keeps: a leaf's name is its keys joined by ``/`` (``"layer_0/attn/q_proj/
kernel"``) and leaves come in sorted-key order, the order in which JAX
flattens a dict pytree. The engine's plan, its checkpoint files and the
universal layout all name leaves this way, so a universal checkpoint's
parameter names are the same in both packages. (The JAX module's
normalisation of optax states through flax has no counterpart: the port's
optimizer state is kept per leaf.)
"""

from typing import Any, Dict, Iterable, List, Tuple

SEP = "/"


def flatten_tree(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_tree(tree[k], f"{prefix}{SEP}{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def unflatten_tree(pairs: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    """The nested dict of (name, leaf) pairs (or of a ``{name: leaf}`` dict)."""
    out: Dict[str, Any] = {}
    for name, leaf in (pairs.items() if isinstance(pairs, dict) else pairs):
        node = out
        *parents, last = name.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out
