"""The communication facade on ``torch.distributed``.

Port of the part of ``deepspeed_tpu/comm/comm.py`` (reference
``deepspeed/comm/comm.py``) that the training engine and the checkpoints
call. One process drives one device; a rank's collectives run on its
device's tensors over explicit process groups (``group=None`` is the
world):

- ``init_distributed``: explicit ``rank`` / ``world_size`` /
  ``init_method``, then the ``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE``
  environment (``init_method="env://"``), then a single process on an
  in-memory store. The backend follows the device: ``"nccl"`` for CUDA,
  ``"gloo"`` for ``device="cpu"``. A single process on a machine with CUDA
  gets both (``"cpu:gloo,cuda:nccl"``), so engines on either device share
  its world of one. A collective on a tensor whose device the group does
  not serve with that backend (a CUDA tensor on gloo, a CPU tensor on NCCL)
  raises instead of falling back. One exception, which the caller names:
  ``init_distributed(device="cuda", backend="gloo")`` runs CUDA tensors on
  gloo (gloo stages them through the host), so that several ranks can
  share one GPU, which NCCL refuses; ``named_backend()`` reports it.
- ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_to_all_single``, ``broadcast``, ``all_gather_object``, ``broadcast_object_list``,
  ``barrier``: ``torch.distributed``'s own, with that check;
  ``inference_all_reduce``: the tensor-parallel serving reduce (reference
  ``comm.py:500``), over the ``tensor`` group by default.
- ``send``, ``recv``, ``isend``, ``irecv``, ``P2POp`` and
  ``batch_isend_irecv``: point-to-point transfers between two ranks
  (reference ``comm.py``), which the pipeline's stages and the ring of
  context parallelism use where the JAX package rolls a buffer along a mesh
  axis. ``dst`` / ``src`` are ranks of the world, as in ``torch.distributed``.

gloo's point-to-point transfers and its all-to-all read and write the
tensor's memory from the host, so on CUDA tensors under
``init_distributed(device="cuda", backend="gloo")`` these functions stage
them through pinned host buffers: a send copies the tensor to the host
first, a receive lands on the host and ``wait()`` copies it to the tensor.
That is the transport the caller named, not a fallback.
"""

import logging
import os
from datetime import timedelta
from typing import Any, List, Optional, Union

import torch
import torch.distributed as tdist

from .reduce_op import ReduceOp

logger = logging.getLogger(__name__)

_OPS = {ReduceOp.SUM: tdist.ReduceOp.SUM, ReduceOp.PRODUCT: tdist.ReduceOp.PRODUCT, ReduceOp.MIN: tdist.ReduceOp.MIN,
        ReduceOp.MAX: tdist.ReduceOp.MAX, ReduceOp.BAND: tdist.ReduceOp.BAND, ReduceOp.BOR: tdist.ReduceOp.BOR,
        ReduceOp.BXOR: tdist.ReduceOp.BXOR, ReduceOp.AVG: tdist.ReduceOp.AVG}


def backend_for(device: Union[str, torch.device]) -> str:
    """The process-group backend of a device: NCCL for CUDA, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


_NAMED_BACKEND: Optional[str] = None  # a backend the caller named against the device's own (CUDA on gloo)


def named_backend() -> Optional[str]:
    """``"gloo"`` when ``init_distributed`` was asked to run CUDA tensors on
    gloo, else None (each device on its own backend)."""
    return _NAMED_BACKEND


def init_distributed(dist_backend: Optional[str] = None, verbose: bool = True, timeout: Optional[timedelta] = None,
                     init_method: Optional[str] = None, dist_init_required: Optional[bool] = None, config=None,
                     rank: int = -1, world_size: int = -1, device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None) -> None:
    """Bring up the default process group (reference ``comm.py:604``). A
    group that is already up is kept, and must have the device's backend
    (or, for a CUDA device with no backend named, gloo named for CUDA by an
    earlier call).
    ``backend`` (or ``dist_backend``) names the backend; ``"gloo"`` with a
    CUDA ``device`` makes gloo serve CUDA tensors, only then."""
    global _NAMED_BACKEND
    named = backend or dist_backend
    backend = named or backend_for(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"dist_backend must be 'nccl' (CUDA) or 'gloo' (CPU), got {backend!r}")
    cuda_on_gloo = backend == "gloo" and torch.device(device).type == "cuda"
    if backend != backend_for(device) and not cuda_on_gloo:
        raise ValueError(f"backend {backend!r} does not drive device {device}: use {backend_for(device)!r}")
    if cuda_on_gloo:
        dev = torch.device(device)
        if dev.index is not None:
            torch.cuda.set_device(dev)
        if not is_initialized():
            kw = {"timeout": timeout} if timeout is not None else {}
            if init_method is None and world_size < 1:
                raise ValueError("init_distributed(backend='gloo') on CUDA needs rank, world_size and init_method")
            tdist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world_size, **kw)
        elif _backends().get("cuda") != "gloo":
            raise RuntimeError(f"torch.distributed is initialized with {tdist.get_backend_config()!r}, which does "
                               "not run gloo for CUDA tensors")
        _NAMED_BACKEND = "gloo"
        if verbose:
            logger.info("init_distributed: rank %d of %d runs CUDA tensors on gloo (named by the caller; host-staged)",
                        get_rank(), get_world_size())
        return
    if is_initialized():
        if named is None and torch.device(device).type == "cuda" and _NAMED_BACKEND == "gloo":
            return  # this process named gloo for its CUDA tensors: an engine that names nothing keeps it
        have = _backends().get(torch.device(device).type)
        if have != backend:
            raise RuntimeError(f"torch.distributed is initialized with {tdist.get_backend_config()!r}, which does "
                               f"not run {backend!r} for device {device}")
        return
    if backend == "nccl":
        dev = torch.device(device)
        torch.cuda.set_device(dev.index if dev.index is not None else get_local_rank())
    kw = {"timeout": timeout} if timeout is not None else {}
    if init_method is not None or world_size > 0:
        if world_size < 1 or rank < 0:
            raise ValueError("init_distributed: an explicit rendezvous needs rank >= 0 and world_size >= 1")
        if init_method is None:
            if world_size != 1:
                raise ValueError("init_distributed: world_size > 1 needs an init_method (e.g. tcp://host:port)")
            tdist.init_process_group(backend, store=tdist.HashStore(), rank=0, world_size=1, **kw)
        else:
            tdist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size, **kw)
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        tdist.init_process_group(backend, init_method="env://", rank=int(os.environ.get("RANK", "0")),
                                 world_size=int(os.environ["WORLD_SIZE"]), **kw)
    else:
        # one process: an in-memory store, so the collectives run (over a world of one) with no rendezvous
        both = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else backend
        tdist.init_process_group(both, store=tdist.HashStore(), rank=0, world_size=1, **kw)
    if verbose and get_rank() == 0:
        logger.info(f"init_distributed: backend={backend} world_size={get_world_size()}")


def get_rank(group=None) -> int:
    return tdist.get_rank(group) if is_initialized() else 0


def get_world_size(group=None) -> int:
    return tdist.get_world_size(group) if is_initialized() else 1


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def new_group(ranks: List[int], backend: Optional[str] = None):
    """A process group over ``ranks``: every rank of the world must call it, in the same order."""
    return tdist.new_group(ranks, backend=backend)


def _backends(group=None) -> dict:
    """{device type: backend} of a group, from its backend config
    (``"cpu:gloo,cuda:gloo"`` for a gloo group, ``"cuda:nccl"`` for NCCL)."""
    cfg = tdist.get_backend_config(group)
    if ":" not in cfg:
        return {"cuda": cfg} if cfg == "nccl" else {"cpu": cfg, "cuda": cfg}
    return dict(part.split(":") for part in cfg.split(","))


def _check(tensor: torch.Tensor, group) -> None:
    have = _backends(group).get(tensor.device.type)
    if tensor.device.type == "cuda" and have == "gloo" and _NAMED_BACKEND == "gloo":
        return  # the caller named gloo for CUDA tensors (init_distributed(device="cuda", backend="gloo"))
    if have != backend_for(tensor.device):
        raise RuntimeError(f"a {have} collective on a {tensor.device} tensor: the port runs NCCL on CUDA tensors "
                           "and gloo on CPU tensors, and never falls back from one to the other")


def all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM, group=None, async_op: bool = False):
    _check(tensor, group)
    return tdist.all_reduce(tensor, op=_OPS[op], group=group, async_op=async_op)


def inference_all_reduce(tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM, group=None, async_op: bool = False):
    """The tensor-parallel serving reduce (reference ``comm.py:500``), in place;
    ``group`` is the ``tensor`` axis's group (None: the world)."""
    return all_reduce(tensor, op=op, group=group, async_op=async_op)


def all_gather_into_tensor(output: torch.Tensor, tensor: torch.Tensor, group=None, async_op: bool = False):
    """``output`` holds the group's ``tensor``s in rank order."""
    _check(tensor, group)
    return tdist.all_gather_into_tensor(output, tensor, group=group, async_op=async_op)


def reduce_scatter_tensor(output: torch.Tensor, tensor: torch.Tensor, op: ReduceOp = ReduceOp.SUM, group=None,
                          async_op: bool = False):
    """Rank r's ``output`` is the reduction of chunk r of every rank's ``tensor``."""
    _check(tensor, group)
    return tdist.reduce_scatter_tensor(output, tensor, op=_OPS[op], group=group, async_op=async_op)


def _staged(tensor: torch.Tensor) -> bool:
    """A CUDA tensor on gloo named by the caller: staged through the host."""
    return tensor.device.type == "cuda" and _NAMED_BACKEND == "gloo"


def _pinned(like: torch.Tensor) -> torch.Tensor:
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _to_host(tensor: torch.Tensor) -> torch.Tensor:
    host = _pinned(tensor)
    host.copy_(tensor)
    return host


class Work:
    """A pending transfer: ``wait()`` completes it, and for a staged receive
    copies the host buffer into the device tensor. Keeps the host buffers alive."""

    def __init__(self, work, host: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None):
        self._work, self._host, self._out = work, host, out

    def wait(self) -> bool:
        if self._work is not None:
            self._work.wait()
            self._work = None
        if self._out is not None:
            self._out.copy_(self._host)
            self._out = None
        self._host = None
        return True

    def is_completed(self) -> bool:
        return self._work is None or self._work.is_completed()


def all_to_all_single(output: torch.Tensor, tensor: torch.Tensor, group=None, async_op: bool = False):
    """Equal splits along dimension 0: chunk j of ``tensor`` goes to rank j,
    and chunk i of ``output`` comes from rank i."""
    _check(tensor, group)
    if _staged(tensor):
        host_out = _pinned(output)
        work = tdist.all_to_all_single(host_out, _to_host(tensor.contiguous()), group=group, async_op=True)
        done = Work(work, host_out, output)
        if async_op:
            return done
        done.wait()
        return None
    return tdist.all_to_all_single(output, tensor, group=group, async_op=async_op)


def isend(tensor: torch.Tensor, dst: int, group=None, tag: int = 0) -> Work:
    """Start sending ``tensor`` to world rank ``dst``; it must not change until ``wait()``."""
    _check(tensor, group)
    src = _to_host(tensor) if _staged(tensor) else tensor.contiguous()
    return Work(tdist.isend(src, dst, group=group, tag=tag), host=src)


def irecv(tensor: torch.Tensor, src: int, group=None, tag: int = 0) -> Work:
    """Start receiving into ``tensor`` from world rank ``src``; it holds the data after ``wait()``."""
    _check(tensor, group)
    if _staged(tensor):
        host = _pinned(tensor)
        return Work(tdist.irecv(host, src, group=group, tag=tag), host, tensor)
    if not tensor.is_contiguous():
        raise ValueError("irecv needs a contiguous tensor")
    return Work(tdist.irecv(tensor, src, group=group, tag=tag))


def send(tensor: torch.Tensor, dst: int, group=None, tag: int = 0) -> None:
    isend(tensor, dst, group, tag).wait()


def recv(tensor: torch.Tensor, src: int, group=None, tag: int = 0) -> None:
    irecv(tensor, src, group, tag).wait()


class P2POp:
    """One transfer of ``batch_isend_irecv`` (reference ``comm.py`` ``P2POp``):
    ``op`` is ``isend`` or ``irecv`` of this module, ``peer`` a world rank."""

    def __init__(self, op, tensor: torch.Tensor, peer: int, group=None, tag: int = 0):
        if op not in (isend, irecv):
            raise ValueError("P2POp's op must be comm.isend or comm.irecv")
        self.op, self.tensor, self.peer, self.group, self.tag = op, tensor, peer, group, tag


def batch_isend_irecv(p2p_op_list: List[P2POp]) -> List[Work]:
    """Start every transfer of the list; returns their ``Work`` in order."""
    return [p.op(p.tensor, p.peer, p.group, p.tag) for p in p2p_op_list]


def broadcast(tensor: torch.Tensor, src: int = 0, group=None, async_op: bool = False):
    _check(tensor, group)
    return tdist.broadcast(tensor, src=src, group=group, async_op=async_op)


def all_gather_object(obj: Any, group=None) -> List[Any]:
    out = [None] * get_world_size(group)
    tdist.all_gather_object(out, obj, group=group)
    return out


def broadcast_object_list(object_list: List[Any], src: int = 0, group=None, device=None) -> List[Any]:
    tdist.broadcast_object_list(object_list, src=src, group=group, device=device)
    return object_list


def barrier(group=None, device: Optional[Union[str, torch.device]] = None) -> None:
    """Wait for every rank of ``group``: an all-reduce of one element on
    ``device`` (so it runs on that device's backend), or
    ``torch.distributed.barrier`` without one."""
    if device is None:
        tdist.barrier(group=group)
        return
    all_reduce(torch.zeros(1, device=device), group=group)


def destroy_process_group(group=None) -> None:
    global _NAMED_BACKEND
    if is_initialized():
        tdist.destroy_process_group(group)
    if group is None:
        _NAMED_BACKEND = None
