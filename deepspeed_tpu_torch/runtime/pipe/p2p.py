"""Activations and gradients between neighbouring pipeline stages.

Port of the reference's ``runtime/pipe/p2p.py`` (``send`` :46, ``recv``
:67), where the JAX package rolls stage-stacked buffers along the ``pipe``
mesh axis inside one program. A stage sends its output activation to the
next stage and its input gradient to the previous one over the process
group of that pair of stages (``PipelineParallelGrid.pair_group``). The
first activation sent carries a one-time meta message ahead of it, its
shape and dtype (reference ``pipe/engine.py:915,979``), from which the
receiver allocates every later activation; a gradient has its activation's
shape. Sends are started and left running (``comm.isend``), so two
neighbours that both send before they receive, as 1F1B's steady state has
them do, never wait on each other; ``wait_sends`` completes them before the
optimizer step. Receives block, and their wall time is counted
(``recv_seconds``: the bubble plus the transport).
"""

import time
from typing import List

import torch

from ... import comm as dist

TAG_ACT, TAG_GRAD, TAG_META = 0, 1, 2
META_LEN = 8
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]


class StageExchange:
    """This rank's transfers with the stages before and after it."""

    def __init__(self, grid, device: torch.device):
        self.stage, self.num_stages = grid.stage_id, grid.pipe_parallel_size
        self.device = device
        first, last = self.stage == 0, self.stage == self.num_stages - 1
        self.prev = None if first else grid.stage_to_global(self.stage - 1)
        self.next = None if last else grid.stage_to_global(self.stage + 1)
        self.prev_group = None if first else grid.pair_group(self.stage - 1)
        self.next_group = None if last else grid.pair_group(self.stage)
        self._pending: List[dist.Work] = []
        self._meta_sent = False
        self._act = None  # (shape, dtype) of the activations this stage receives
        self.recv_seconds = 0.0
        self.sent_bytes = 0

    def _isend(self, t: torch.Tensor, dst: int, group, tag: int) -> None:
        self.sent_bytes += t.numel() * t.element_size()
        self._pending.append(dist.isend(t, dst, group=group, tag=tag))

    def _recv(self, t: torch.Tensor, src: int, group, tag: int) -> torch.Tensor:
        t0 = time.perf_counter()
        dist.recv(t, src, group=group, tag=tag)
        self.recv_seconds += time.perf_counter() - t0
        return t

    def send_activation(self, y: torch.Tensor) -> None:
        if not self._meta_sent:
            if y.dim() > META_LEN - 2:
                raise ValueError(f"an activation of {y.dim()} dimensions: the meta message holds {META_LEN - 2}")
            meta = torch.zeros(META_LEN, dtype=torch.int64)
            meta[0], meta[1] = y.dim(), _DTYPES.index(y.dtype)
            meta[2:2 + y.dim()] = torch.tensor(y.shape)
            self._isend(meta.to(self.device), self.next, self.next_group, TAG_META)
            self._meta_sent = True
        self._isend(y.detach().contiguous(), self.next, self.next_group, TAG_ACT)

    def recv_activation(self) -> torch.Tensor:
        if self._act is None:
            meta = self._recv(torch.zeros(META_LEN, dtype=torch.int64, device=self.device), self.prev,
                              self.prev_group, TAG_META).cpu()
            nd = int(meta[0])
            self._act = (tuple(int(n) for n in meta[2:2 + nd]), _DTYPES[int(meta[1])])
        shape, dtype = self._act
        return self._recv(torch.empty(shape, dtype=dtype, device=self.device), self.prev, self.prev_group, TAG_ACT)

    def send_grad(self, g: torch.Tensor) -> None:
        self._isend(g.detach().contiguous(), self.prev, self.prev_group, TAG_GRAD)

    def recv_grad(self, shape, dtype) -> torch.Tensor:
        return self._recv(torch.empty(shape, dtype=dtype, device=self.device), self.next, self.next_group, TAG_GRAD)

    def wait_sends(self) -> None:
        for w in self._pending:
            w.wait()
        self._pending.clear()
