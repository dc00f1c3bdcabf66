"""Activation checkpointing.

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``
(reference ``runtime/activation_checkpointing/checkpointing.py``: the
Megatron-style ``checkpoint()`` :990, ``CheckpointFunction`` :485,
activation partitioning over the tensor ranks :374, CPU checkpointing, the
model-parallel RNG tracker :123).

- ``checkpoint(fn, *args)`` is ``torch.utils.checkpoint.checkpoint(...,
  use_reentrant=False)``: the function's activations are dropped after the
  forward and recomputed in the backward. The model's ``remat`` checkpoints
  each transformer block through it, reading the block's parameters inside
  the function, so ZeRO stage 3 gathers them again for the recompute.
- ``cpu_checkpointing`` keeps the saved residuals in host memory instead of
  recomputing them (``torch.autograd.graph.save_on_cpu``, pinned when the
  arguments are on a card): no recompute, no device memory for them.
- ``partition_activations`` shards the checkpoint's saved inputs over the
  tensor axis (reference :374, JAX :116-132): under the training engine's
  tensor parallelism (``parallel.tensor``, ``tensor`` > 1) each
  floating-point input keeps this rank's 1 / tp along the sequence
  dimension (else the first dimension the degree divides), and the
  checkpointed function all-gathers it back, in the forward and again at
  the recompute. Over a tensor axis of 1 it changes nothing.
- The model-parallel RNG tracker is a logged no-op: the port's model takes
  explicit ``torch.Generator`` arguments, and non-reentrant checkpoint
  restores the global RNG state for the recompute.

``configure`` sets the flags from a ``DeepSpeedConfig``'s
``activation_checkpointing`` section and from its arguments; every engine
calls it, so one engine's flags never leak into the next.
"""

import functools
import logging
from typing import Optional

import torch
import torch.utils.checkpoint

from ...parallel.tensor import current_tensor_parallel

logger = logging.getLogger(__name__)

_CONFIG = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "contiguous_memory_optimization": False,  # no counterpart: the caching allocator owns layout
    "synchronize_checkpoint_boundary": False,
    "profile": False,
}
_CONFIGURED = False


def configure(mpu_=None, deepspeed_config=None, partition_activations: Optional[bool] = None,
              contiguous_checkpointing: Optional[bool] = None, checkpoint_in_cpu: Optional[bool] = None,
              synchronize: Optional[bool] = None, profile: Optional[bool] = None):
    """Reference ``checkpointing.configure``: flags from a config carrying
    ``activation_checkpointing`` and from the arguments (which win)."""
    global _CONFIGURED
    ac = getattr(deepspeed_config, "activation_checkpointing", None)
    if ac is not None:
        _CONFIG["partition_activations"] = bool(getattr(ac, "partition_activations", False))
        _CONFIG["cpu_checkpointing"] = bool(getattr(ac, "cpu_checkpointing", False))
        _CONFIG["contiguous_memory_optimization"] = bool(getattr(ac, "contiguous_memory_optimization", False))
        _CONFIG["synchronize_checkpoint_boundary"] = bool(getattr(ac, "synchronize_checkpoint_boundary", False))
        _CONFIG["profile"] = bool(getattr(ac, "profile", False))
    if partition_activations is not None:
        _CONFIG["partition_activations"] = bool(partition_activations)
    if checkpoint_in_cpu is not None:
        _CONFIG["cpu_checkpointing"] = bool(checkpoint_in_cpu)
    if contiguous_checkpointing is not None:
        _CONFIG["contiguous_memory_optimization"] = bool(contiguous_checkpointing)
    if synchronize is not None:
        _CONFIG["synchronize_checkpoint_boundary"] = bool(synchronize)
    if profile is not None:
        _CONFIG["profile"] = bool(profile)
    _CONFIGURED = True


def is_configured() -> bool:
    return _CONFIGURED


def reset():
    global _CONFIGURED
    _CONFIGURED = False
    _CONFIG.update(partition_activations=False, cpu_checkpointing=False, contiguous_memory_optimization=False,
                   synchronize_checkpoint_boundary=False, profile=False)


def _on_card(args) -> bool:
    return any(torch.is_tensor(a) and a.device.type == "cuda" for a in args)


def checkpoint(function, *args, **kwargs):
    """Reference ``checkpoint(function, *args)`` (:990): ``function(*args,
    **kwargs)`` with its activations recomputed in the backward (or, under
    ``cpu_checkpointing``, kept in host memory); under
    ``partition_activations`` and tensor parallelism with its inputs kept as
    this rank's slices."""
    if _CONFIG["cpu_checkpointing"]:
        with torch.autograd.graph.save_on_cpu(pin_memory=_on_card(args)):
            return function(*args, **kwargs)
    if _CONFIG["partition_activations"]:
        return _partitioned(function, args, kwargs, seq_dim=1)
    return torch.utils.checkpoint.checkpoint(function, *args, use_reentrant=False, **kwargs)


def _partition_dim(x, size: int, seq_dim: int):
    """The dimension a saved input splits along over ``size`` ranks (JAX
    ``_partition_arg``): ``seq_dim`` where the size divides it, else the
    first that it divides; None for what is not a floating-point tensor or
    does not split."""
    if not (torch.is_tensor(x) and x.is_floating_point() and x.dim() > 0):
        return None
    for d in [seq_dim] + [d for d in range(x.dim()) if d != seq_dim]:
        if d < x.dim() and x.shape[d] % size == 0:
            return d
    return None


def _partitioned(function, args, kwargs, seq_dim: int):
    """``function`` checkpointed with each splittable input held as this
    tensor rank's slice (``tp.split``: its gradient all-gathers) and
    all-gathered inside the checkpointed function (``tp.gather``), so the
    checkpoint keeps 1 / tp of it and the recompute gathers it again."""
    tp = current_tensor_parallel()
    if tp is None or tp.size == 1:
        return torch.utils.checkpoint.checkpoint(function, *args, use_reentrant=False, **kwargs)
    dims = [_partition_dim(a, tp.size, seq_dim) for a in args]
    parts = [a if d is None else tp.split(a, d) for a, d in zip(args, dims)]

    def whole(*held, **kw):
        return function(*(a if d is None else tp.gather(a, d) for a, d in zip(held, dims)), **kw)

    return torch.utils.checkpoint.checkpoint(whole, *parts, use_reentrant=False, **kwargs)


def partitioned_checkpoint(function, axis: str = "tensor", seq_dim: int = 1):
    """Decorator form (reference :374 / :265): ``function`` checkpointed with
    its saved inputs sharded over the current tensor group (``axis`` names
    it, as in the JAX package; ``seq_dim`` is the dimension tried first)."""

    @functools.wraps(function)
    def wrapped(*args, **kwargs):
        return _partitioned(function, args, kwargs, seq_dim)

    return wrapped


class CheckpointFunction:
    """API shim for the reference ``CheckpointFunction`` (:485): ``apply``
    routes through ``checkpoint`` (the reentrant autograd function it names
    is ``torch.utils.checkpoint``'s business)."""

    @staticmethod
    def apply(run_function, *args):
        return checkpoint(run_function, *args)


def model_parallel_cuda_manual_seed(seed: int):
    """Reference :200: seeds one device RNG stream per tensor rank. The port's
    model takes explicit generators (its training forward draws no random
    numbers under tensor parallelism), so there is nothing to seed; seed the
    generator you pass the model instead."""
    logger.info("model_parallel_cuda_manual_seed: a no-op (the port's model takes explicit generators)")
    return None
