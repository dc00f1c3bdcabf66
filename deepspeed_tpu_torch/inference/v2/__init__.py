"""Inference v2 — ragged continuous-batching serving.

Port of ``deepspeed_tpu/inference/v2``: ``InferenceEngineV2`` (the fused
SplitFuse loop and the unfused loop, ``put``) over the paged-KV bookkeeping
of ``ragged/`` and the ``RaggedBatchScheduler``; speculative decoding's
drafters and on-device acceptance (``spec``); one captured CUDA graph per
step key on the card (``graphs``); the SLA load harness (``sla``); the host
spill tier behind the prefix cache (``ragged/host_tier``); the replay harness
for recorded serving journals (``replay``).
"""

from .ragged import BlockedAllocator, DSSequenceDescriptor, DSStateManager, PrefixCache, RaggedBatchConfig
from .scheduler import FusedQuantum, RaggedBatchScheduler, RaggedRequest
from .spec import Drafter, NullDrafter, PromptLookupDrafter, make_drafter, select_committed
from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig

__all__ = ["BlockedAllocator", "DSSequenceDescriptor", "DSStateManager", "PrefixCache", "RaggedBatchConfig",
           "FusedQuantum", "RaggedBatchScheduler", "RaggedRequest", "InferenceEngineV2",
           "RaggedInferenceEngineConfig", "Drafter", "NullDrafter", "PromptLookupDrafter", "make_drafter",
           "select_committed"]
