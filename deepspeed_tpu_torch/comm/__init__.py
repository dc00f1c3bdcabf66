"""``deepspeed_tpu_torch.comm as dist``: the communication facade on
``torch.distributed`` (``comm.py``: collectives and point-to-point
transfers), and ``collectives.tp_all_reduce``, the
tensor-parallel serving reduce of the JAX package's ``comm/collectives.py``."""

from .comm import (P2POp, Work, all_gather_into_tensor, all_to_all_single, all_gather_object, all_reduce, backend_for,
                   barrier, batch_isend_irecv, broadcast, broadcast_object_list, destroy_process_group, get_local_rank,
                   get_rank, get_world_size, inference_all_reduce, init_distributed, irecv, is_initialized, isend,
                   named_backend, new_group, recv, reduce_scatter_tensor, send)
from .reduce_op import ReduceOp

__all__ = ["init_distributed", "is_initialized", "get_rank", "get_world_size", "get_local_rank", "barrier",
           "all_reduce", "all_gather_into_tensor", "all_to_all_single", "reduce_scatter_tensor", "broadcast", "all_gather_object",
           "broadcast_object_list", "destroy_process_group", "new_group", "backend_for", "ReduceOp",
           "inference_all_reduce", "named_backend", "send", "recv", "isend", "irecv", "P2POp", "batch_isend_irecv",
           "Work"]
