"""Optimizer-state NVMe swapper with pipelined prefetch.

Port of ``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``
(reference ``runtime/swap_tensor/partitioned_optimizer_swapper.py`` and
``pipelined_optimizer_swapper.py``). States are grouped per parameter,
``{param_name: {state_name: tensor}}``, one file each; ``fetch`` of
parameter i+1 is issued before parameter i steps, so the AIO threads
overlap with the optimizer arithmetic.
"""

from typing import Dict, List

import torch

from .async_swapper import AsyncTensorSwapper


class PartitionedOptimizerSwapper:

    def __init__(self, swap_folder: str, num_threads: int = 4, pipeline: bool = True):
        self._swapper = AsyncTensorSwapper(swap_folder, num_threads=num_threads)
        self.pipeline = pipeline
        self._inflight: Dict[str, Dict[str, torch.Tensor]] = {}

    def initialize(self, name: str, states: Dict[str, torch.Tensor]) -> None:
        """Write a parameter's initial optimizer states to disk."""
        for sname, t in states.items():
            self._swapper.swap_out(f"{name}.{sname}", t)
        self._swapper.synchronize()

    def prefetch(self, name: str, state_names: List[str]) -> None:
        """Begin an async read of a parameter's states (overlaps with compute)."""
        if name in self._inflight:
            return
        self._inflight[name] = {s: self._swapper.swap_in(f"{name}.{s}") for s in state_names}

    def fetch(self, name: str, state_names: List[str]) -> Dict[str, torch.Tensor]:
        """Blocking read (or the end of an earlier prefetch)."""
        self.prefetch(name, state_names)
        self._swapper.synchronize()
        return self._inflight.pop(name)

    def commit(self, name: str, states: Dict[str, torch.Tensor], blocking: bool = False) -> None:
        """Write back updated states (async unless ``blocking``)."""
        for sname, t in states.items():
            self._swapper.swap_out(f"{name}.{sname}", t)
        if blocking:
            self._swapper.synchronize()

    def synchronize(self) -> None:
        self._swapper.synchronize()

    def close(self) -> None:
        self._swapper.close()
