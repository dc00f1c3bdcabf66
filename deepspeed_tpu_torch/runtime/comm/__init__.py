"""Compressed collectives over ``torch.distributed`` process groups (``compressed.py``)."""

from .compressed import (all_to_all_quant_reduce, all_to_all_quant_reduce_coalesced, compress_1bit,
                         compressed_allreduce, reduce_scatter_coalesced)

__all__ = ["compress_1bit", "compressed_allreduce", "all_to_all_quant_reduce", "all_to_all_quant_reduce_coalesced",
           "reduce_scatter_coalesced"]
