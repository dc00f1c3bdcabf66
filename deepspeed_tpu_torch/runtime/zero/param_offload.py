"""ZeRO-3 parameter offload: host-resident masters streamed to the device per block.

Port of ``deepspeed_tpu/runtime/zero/param_offload.py`` (reference
ZeRO-Infinity parameter offload: ``swap_tensor/partitioned_param_swapper.py:36``
wired at ``runtime/zero/stage3.py:583``). At stage 3 every leaf of at least
``stage3_param_persistence_threshold`` elements keeps its fp32 master (this
rank's chunk) in host memory, pinned on a card, instead of in device memory;
smaller leaves stay on the device (the persistence contract of reference
``parameter_offload.py:242``). ``Stage3Params`` gathers a group through
``ParamStream``: the group's host chunks are copied to the device on a side
stream, the next block's copy issued ahead of its use, and the device copies
are dropped once the gathered compute-dtype buffer is built.

The JAX module has two modes, ``"jit"`` (XLA streams the host-kind leaves
inside the compiled step) and ``"eager"``, and a compile probe to choose
between them: both are XLA's. The port has one mode, this one.
"""

import logging
from typing import Dict, Iterable, List, Optional

import torch

logger = logging.getLogger(__name__)


def plan_param_offload(config, plan) -> Optional[List[bool]]:
    """Which leaves keep their master on the host (``None``: parameter offload
    is off), with the JAX engine's decisions and messages."""
    zc = config.zero_config
    off = zc.offload_param
    if off.device not in ("cpu", "nvme"):
        return None
    if zc.stage != 3:
        logger.warning(f"offload_param.device={off.device} requires ZeRO stage 3 (got stage {zc.stage}): "
                       "parameters stay in device memory")
        return None
    if off.device == "nvme" and zc.offload_optimizer.device != "nvme":
        logger.warning("offload_param.device=nvme: the file-backed master store rides the host optimizer's "
                       "NVMe offload; without offload_optimizer.device=nvme the fp32 masters stay in pinned host "
                       "memory (streamed as for device=cpu)")
    threshold = zc.stage3_param_persistence_threshold
    mask = [lf.numel >= threshold for lf in plan.leaves]
    if not any(mask):
        logger.info(f"offload_param: every parameter is below stage3_param_persistence_threshold ({threshold}): "
                    "nothing to offload")
        return None
    nbytes = sum(lf.numel * 4 for lf, m in zip(plan.leaves, mask) if m)
    logger.info(f"ZeRO-3 param offload ({off.device}): {sum(mask)} leaves, {nbytes / 1e6:.1f} MB of fp32 masters in "
                f"host memory, streamed to the device per block (persistence threshold {threshold})")
    return mask


class ParamStream:
    """Host->device copies of offloaded masters for ``Stage3Params``.

    ``masters`` is the engine's list (host tensors where ``offloaded[i]``);
    ``prefetch(indices)`` issues the copies of those leaves on a side stream
    (on the CPU a plain copy), ``take(i)`` hands leaf i's device copy to the
    caller (the current stream waits for it) and forgets it. ``copies`` and
    ``bytes`` count what crossed."""

    def __init__(self, masters: List[torch.Tensor], offloaded: List[bool], device: torch.device):
        self.masters = masters
        self.offloaded = offloaded
        self.device = device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._pending: Dict[int, tuple] = {}  # leaf -> (device copy, its event or None)
        self.copies = 0
        self.bytes = 0

    def prefetch(self, indices: Iterable[int]) -> None:
        todo = [i for i in indices if self.offloaded[i] and i not in self._pending]
        if not todo:
            return
        if self._stream is None:
            for i in todo:
                self._pending[i] = (self.masters[i].detach().clone(), None)
        else:
            # allocated on the current stream, written on the side stream: the current stream waits on the event
            # before any use, so the block is never handed back to the allocator while the copy runs
            outs = [torch.empty(self.masters[i].shape, dtype=torch.float32, device=self.device) for i in todo]
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                for i, t in zip(todo, outs):
                    t.copy_(self.masters[i].detach(), non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self._stream)
            for i, t in zip(todo, outs):
                self._pending[i] = (t, ev)
        self.copies += len(todo)
        self.bytes += sum(self.masters[i].numel() * 4 for i in todo)

    def take(self, i: int) -> torch.Tensor:
        if i not in self._pending:
            self.prefetch([i])
        t, ev = self._pending.pop(i)
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        return t

    def clear(self) -> None:
        """Drop copies issued ahead and never taken (their values may be stale after a step)."""
        for t, ev in self._pending.values():
            if ev is not None:
                torch.cuda.current_stream(self.device).wait_event(ev)
        self._pending.clear()
