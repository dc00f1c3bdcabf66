"""Universal checkpoints and zero_to_fp32 (the JAX package's ``checkpoint``;
reference ``deepspeed/checkpoint/`` and ``utils/zero_to_fp32.py``)."""

from .universal import (UNIVERSAL_CHECKPOINT_INFO, inspect_universal_checkpoint, load_universal_checkpoint,
                        save_universal_checkpoint)
from .zero_to_fp32 import (convert_zero_checkpoint_to_fp32_state_dict, get_fp32_flat_state_dict_from_zero_checkpoint,
                           get_fp32_state_dict_from_zero_checkpoint)

__all__ = ["UNIVERSAL_CHECKPOINT_INFO", "save_universal_checkpoint", "load_universal_checkpoint",
           "inspect_universal_checkpoint", "get_fp32_state_dict_from_zero_checkpoint",
           "get_fp32_flat_state_dict_from_zero_checkpoint", "convert_zero_checkpoint_to_fp32_state_dict"]
