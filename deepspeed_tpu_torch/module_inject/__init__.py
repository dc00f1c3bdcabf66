"""The tensor-parallel layouts of serving parameter trees (``load_checkpoint.py``).
The JAX package's Hugging Face loaders and AutoTP parser are not ported."""

from .load_checkpoint import SERVING_BIAS_RULES, get_tp_rules, leaf_spec, shard_leaf, shard_params, tp_shardings

__all__ = ["shard_params", "shard_leaf", "tp_shardings", "get_tp_rules", "leaf_spec", "SERVING_BIAS_RULES"]
