"""Sequence parallelism (JAX ``deepspeed_tpu/sequence``): Ulysses'
all-to-all attention (``layer.py``) and ring attention (``ring.py``)."""

from .layer import (DistributedAttention, SequenceParallel, current_sequence_parallel, sequence_parallel,
                    single_all_to_all, ulysses_attention)
from .ring import ring_attention

__all__ = ["DistributedAttention", "single_all_to_all", "ulysses_attention", "ring_attention", "SequenceParallel",
           "sequence_parallel", "current_sequence_parallel"]
