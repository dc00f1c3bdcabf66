"""Mixture of Experts at one device: port of ``deepspeed_tpu/moe`` (without
expert parallelism and the expert-TP token mappings)."""

from .layer import Experts, MoE
from .sharded_moe import combine_output, gate_and_dispatch, multiplicative_jitter, top1gating, top_k, topkgating

__all__ = ["MoE", "Experts", "top1gating", "topkgating", "gate_and_dispatch", "combine_output",
           "multiplicative_jitter", "top_k"]
