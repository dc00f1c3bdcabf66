"""AutoTP: tensor-parallel rules inferred from a parameter tree.

Port of ``deepspeed_tpu/module_inject/auto_tp.py`` over the port's nested
dict of tensors: the same name patterns (JAX ``:20-31``) and shape
heuristics give the same ``(path, spec)`` rules, in the same order (the
JAX tree flattens a dict in sorted key order, and so does ``tp_parser``).
A spec is a tuple of mesh axis names or ``None``, one a dimension, as
``load_checkpoint.leaf_spec`` reads them (JAX: a ``PartitionSpec``).
``get_tp_rules`` prefers the model's own ``partition_rules()`` (JAX
``:94-100``).
"""

import logging
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

Spec = Tuple[Optional[str], ...]

# column-parallel: output features sharded (the last dim(s) of a flax kernel)
COLUMN_PATTERNS = [
    "q_proj", "k_proj", "v_proj", "query", "key", "value", "c_attn", "query_key_value", "gate_proj", "up_proj",
    "w1", "w3", "wi", "fc1", "fc_in", "dense_h_to_4h", "in_proj", "qkv_proj",
]
# row-parallel: input features sharded (the first dim), an all-reduce after
ROW_PATTERNS = [
    "o_proj", "out_proj", "c_proj", "down_proj", "w2", "wo", "fc2", "fc_out", "dense_4h_to_h", "attention.dense",
]
# vocab-sharded embeddings and unembeddings
EMBED_PATTERNS = ["wte", "embed_tokens", "word_embeddings", "tok_embeddings", "lm_head", "embed_out"]
# never sharded
SKIP_PATTERNS = ["wpe", "position_embedding", "norm", "ln_", "layernorm", "bias", "scale", "gate.kernel"]


def _name_matches(path_str: str, patterns: Sequence[str]) -> bool:
    return any(p in path_str for p in patterns)


def _flatten_sorted(tree, keys=()):
    """(path names, leaf) pairs in the JAX flattening order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_sorted(tree[k], keys + (str(k),))
    else:
        yield keys, tree


class AutoTP:
    """``tp_parser`` yields the rules (reference ``auto_tp.py``'s class)."""

    def __init__(self, tp_size: int, tp_axis: str = "tensor"):
        self.tp_size = tp_size
        self.tp_axis = tp_axis

    def _kernel_spec(self, shape: Tuple[int, ...], column: bool) -> Optional[Spec]:
        ax = self.tp_axis
        nd = len(shape)
        if nd < 2:
            return None
        if column:  # a Dense kernel (in, out); an attention kernel (in, H, Dh)
            if nd == 2 and shape[1] % self.tp_size == 0:
                return (None, ax)
            if nd == 3 and shape[1] % self.tp_size == 0:
                return (None, ax, None)  # the heads
            if nd == 3 and shape[2] % self.tp_size == 0:
                return (None, None, ax)
        else:
            if nd == 2 and shape[0] % self.tp_size == 0:
                return (ax, None)
            if nd == 3 and shape[0] % self.tp_size == 0:
                return (ax, None, None)  # o_proj (H, Dh, out)
        return None

    def tp_parser(self, params) -> List[Tuple[Tuple[str, ...], Spec]]:
        """(path, spec) rules inferred from a nested dict of tensors."""
        rules: List[Tuple[Tuple[str, ...], Spec]] = []
        for names, leaf in _flatten_sorted(params):
            path_str = ".".join(names).lower()
            shape = tuple(getattr(leaf, "shape", ()))
            if _name_matches(path_str, SKIP_PATTERNS) or len(shape) < 2:
                continue
            spec: Optional[Spec] = None
            if _name_matches(path_str, EMBED_PATTERNS):
                dim = 0 if shape[0] >= shape[-1] else len(shape) - 1  # the vocabulary is the larger dim
                if shape[dim] % self.tp_size == 0:
                    entries: List[Optional[str]] = [None] * len(shape)
                    entries[dim] = self.tp_axis
                    spec = tuple(entries)
            elif _name_matches(path_str, ROW_PATTERNS):
                spec = self._kernel_spec(shape, column=False)
            elif _name_matches(path_str, COLUMN_PATTERNS):
                spec = self._kernel_spec(shape, column=True)
            if spec is not None:
                rules.append((names, spec))
        logger.info("AutoTP: inferred %d tensor-parallel rules (tp=%d)", len(rules), self.tp_size)
        return rules


def get_tp_rules(params, tp_size: int, model=None) -> list:
    """The model's ``partition_rules()`` when it has them (the injection
    policy's path), else AutoTP's inference over ``params``."""
    if model is not None and hasattr(model, "partition_rules"):
        return model.partition_rules()
    return AutoTP(tp_size).tp_parser(params)
