"""The training transformer layer and the inference op surface.

Port of ``deepspeed_tpu/ops/transformer``: ``DeepSpeedTransformerConfig`` /
``DeepSpeedTransformerLayer`` (``transformer_layer.py``) and the functions of
``inference_ops.py``, with the JAX package's names and argument order.
"""

from .inference_ops import (add_padding, apply_rotary_pos_emb, bias_add, bias_gelu, bias_relu, bias_residual,
                            einsum_sec_sm_ecm, fused_gemm_gelu, gated_activation, layer_norm, layer_norm_residual,
                            linear_layer, mlp_gemm, moe_res_matmul, pad_transform, padded_head_size, pre_rms_norm,
                            qkv_gemm, residual_add_bias, rms_norm, softmax, softmax_context, vector_add,
                            vector_matmul)
from .transformer_layer import DeepSpeedTransformerConfig, DeepSpeedTransformerLayer

__all__ = [
    "DeepSpeedTransformerConfig", "DeepSpeedTransformerLayer", "add_padding", "apply_rotary_pos_emb", "bias_add",
    "bias_gelu", "bias_relu", "bias_residual", "einsum_sec_sm_ecm", "fused_gemm_gelu", "gated_activation",
    "layer_norm", "layer_norm_residual", "linear_layer", "mlp_gemm", "moe_res_matmul", "pad_transform",
    "padded_head_size", "pre_rms_norm", "qkv_gemm", "residual_add_bias", "rms_norm", "softmax", "softmax_context",
    "vector_add", "vector_matmul",
]
