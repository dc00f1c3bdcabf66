"""Kernels of the port: hand-written CUDA (``csrc/``) with plain PyTorch versions.

``norms.rms_norm``, ``paged_attention.paged_attention_decode`` and
``paged_attention.paged_attention_prefill`` each carry a ``launches``
counter that rises by one per kernel launch.
"""
