from .blocked_allocator import BlockedAllocator
from .sequence_descriptor import DSSequenceDescriptor
from .prefix_cache import PrefixCache
from .manager import DSStateManager, RaggedBatchConfig

__all__ = ["BlockedAllocator", "DSSequenceDescriptor", "PrefixCache", "DSStateManager", "RaggedBatchConfig"]
