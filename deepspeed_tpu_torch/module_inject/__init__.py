"""Hugging Face checkpoints into the port (``load_checkpoint.py``), AutoTP's
rules (``auto_tp.py``) and the tensor-parallel layouts of serving trees."""

from .auto_tp import AutoTP, get_tp_rules
from .load_checkpoint import (SERVING_BIAS_RULES, config_from_hf, convert_hf_state_dict, leaf_spec, load_hf_checkpoint,
                              load_hf_model, load_hf_state_dict, model_tp_rules, shard_leaf, shard_params, tp_shardings)

__all__ = ["AutoTP", "get_tp_rules", "config_from_hf", "convert_hf_state_dict", "load_hf_checkpoint", "load_hf_model",
           "load_hf_state_dict", "shard_params", "tp_shardings", "shard_leaf", "leaf_spec", "model_tp_rules",
           "SERVING_BIAS_RULES"]
