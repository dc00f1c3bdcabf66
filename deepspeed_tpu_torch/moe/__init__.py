"""Mixture of Experts: port of ``deepspeed_tpu/moe``, with expert parallelism
over the mesh's ``expert`` axis inside the training engine, and the
expert-TP token mappings over the ``tensor`` axis (``mappings.py``)."""

from .layer import MOE_PARTITION_RULES, ExpertParallel, Experts, MoE, expert_parallel
from .mappings import drop_tokens, gather_tokens
from .sharded_moe import combine_output, gate_and_dispatch, multiplicative_jitter, top1gating, top_k, topkgating

__all__ = ["MoE", "Experts", "top1gating", "topkgating", "gate_and_dispatch", "combine_output",
           "multiplicative_jitter", "top_k", "MOE_PARTITION_RULES", "ExpertParallel", "expert_parallel", "drop_tokens", "gather_tokens"]
