"""Block-sparse attention (port of ``deepspeed_tpu/ops/sparse_attention/``)."""

from .sparse_self_attention import (SparseSelfAttention, layout_to_token_mask, sparse_attention,
                                    sparse_attention_xla)
from .sparsity_config import (BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
                              FixedSparsityConfig, SparsityConfig, VariableSparsityConfig)

__all__ = ["SparseSelfAttention", "sparse_attention", "sparse_attention_xla", "layout_to_token_mask",
           "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig", "BSLongformerSparsityConfig",
           "BigBirdSparsityConfig", "VariableSparsityConfig"]
