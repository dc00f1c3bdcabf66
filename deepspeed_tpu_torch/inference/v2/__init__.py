"""Inference v2 — ragged continuous-batching serving (the fused SplitFuse path).

Port of ``deepspeed_tpu/inference/v2``: ``InferenceEngineV2`` over the
paged-KV bookkeeping of ``ragged/`` and the ``RaggedBatchScheduler``.
"""

from .ragged import BlockedAllocator, DSSequenceDescriptor, DSStateManager, PrefixCache, RaggedBatchConfig
from .scheduler import FusedQuantum, RaggedBatchScheduler, RaggedRequest
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig

__all__ = ["BlockedAllocator", "DSSequenceDescriptor", "DSStateManager", "PrefixCache", "RaggedBatchConfig",
           "FusedQuantum", "RaggedBatchScheduler", "RaggedRequest", "InferenceEngineV2",
           "RaggedInferenceEngineConfig"]
