"""Kernels of the port: hand-written CUDA (``csrc/``) with plain PyTorch versions.

``norms.rms_norm``, ``norms.layer_norm``, ``quantized_matmul.quantized_matmul``,
``paged_attention.paged_attention_decode``,
``paged_attention.paged_attention_prefill``, ``flash_attention.flash_fwd``,
``flash_attention.flash_bwd_dq``, ``flash_attention.flash_bwd_dq_collapsed``,
``flash_attention.flash_bwd_dkv``, ``fused_adam.fused_adam``,
``fused_lamb.lamb_direction``, ``quantization.quantize_groupwise``,
``quantization.dequantize_groupwise`` and
``sparse_attention.sparse_self_attention.sparse_fwd`` / ``sparse_bwd_dq`` /
``sparse_bwd_dkv`` each carry a ``launches`` counter that rises by one per
kernel launch. ``evoformer.DS4Sci_EvoformerAttention`` is the
DeepSpeed4Science entry point over the flash kernels' additive-bias
variants; ``sparse_attention.SparseSelfAttention`` is DeepSpeed's
block-sparse attention over the sparse kernels.
"""

from . import evoformer

__all__ = ["evoformer"]
