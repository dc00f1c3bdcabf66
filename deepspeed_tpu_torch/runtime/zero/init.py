"""zero.Init: build a model straight into its ZeRO-3 chunks.

Port of ``deepspeed_tpu/runtime/zero/init.py`` (reference ``zero.Init``,
``partition_parameters.py:783``). The JAX package traces the init function
abstractly and runs it under ``jit`` with sharded outputs. Here
``materialize`` runs the init function on the host (the CPU) and moves
only this rank's chunk of each leaf to the device, leaf by leaf, so the
device never holds the whole tree; the result is a ``ShardedParams`` that
``initialize(model_parameters=...)`` takes as the masters of an engine with
the same config and mesh.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from ...checkpoint.utils import flatten_tree, unflatten_tree
from .partition import plan_zero


@dataclass
class ShardedParams:
    """This rank's chunk of every leaf (``tree``) and every leaf's full shape (``shapes``)."""
    tree: Dict[str, Any]
    shapes: Dict[str, Any]


class Init:

    def __init__(self, config=None, topology=None, device="cuda", partition_rules=None, **unused_reference_kwargs):
        from ...device import resolve_device
        from ...parallel.mesh import initialize_mesh
        from ..config import DeepSpeedConfig

        if config is None:
            # a bare ``with zero.Init():``: stage-3 sharding over the current mesh (the reference's default)
            config = {"train_micro_batch_size_per_gpu": 1, "zero_optimization": {"stage": 3}}
        self.config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        self.topology = topology or initialize_mesh(self.config.mesh)
        self.device = resolve_device(device)
        self.partition_rules = partition_rules  # the model's (CausalLM.partition_rules()): an MoE's expert leaves

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def materialize(self, init_fn: Callable, *args, **kwargs) -> ShardedParams:
        """Run ``init_fn(*args, device="cpu", **kwargs)`` (e.g.
        ``models.init_params(cfg, generator)``) and keep this rank's planned
        chunk of each leaf on the device."""
        host = init_fn(*args, device="cpu", **kwargs)
        plan = plan_zero(host, self.config, self.topology, self.partition_rules)
        chunks = []
        for lf, (path, leaf) in zip(plan.leaves, flatten_tree(host)):
            chunks.append((path, plan.chunk(torch.as_tensor(leaf), lf, lf.param_dim).clone().to(self.device)))
        shapes = unflatten_tree((lf.path, lf.shape) for lf in plan.leaves)
        return ShardedParams(unflatten_tree(chunks), shapes)
