"""Kernels of the port: hand-written CUDA (``csrc/``) with plain PyTorch versions.

``norms.rms_norm``, ``norms.layer_norm``, ``quantized_matmul.quantized_matmul``,
``paged_attention.paged_attention_decode``,
``paged_attention.paged_attention_prefill``, ``flash_attention.flash_fwd``,
``flash_attention.flash_bwd_dq``, ``flash_attention.flash_bwd_dq_collapsed``,
``flash_attention.flash_bwd_dkv`` and ``fused_adam.fused_adam`` each carry a
``launches`` counter that rises by one per kernel launch.
``evoformer.DS4Sci_EvoformerAttention`` is the DeepSpeed4Science entry point
over the flash kernels' additive-bias variants.
"""

from . import evoformer

__all__ = ["evoformer"]
