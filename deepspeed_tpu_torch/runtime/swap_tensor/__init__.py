from .async_swapper import AsyncTensorSwapper
from .optimizer_swapper import PartitionedOptimizerSwapper

__all__ = ["AsyncTensorSwapper", "PartitionedOptimizerSwapper"]
