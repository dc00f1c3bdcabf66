"""One captured CUDA graph per serving bucket.

The JAX engine dispatches one compiled program per padded bucket
(``deepspeed_tpu/inference/v2/engine_v2.py`` ``_fused_for``, ``_burst_for``
and the jitted prefill and decode steps). On CUDA the counterpart is CUDA-graph
replay, the mechanism upstream DeepSpeed uses to hide per-step launch latency
(its ``inference/engine.py``): the step of a bucket is captured once as a
``torch.cuda.CUDAGraph`` and each later quantum of that bucket replays it, so
the host launches one graph instead of every kernel of every layer.

- A step is a function ``fn(*inputs, generator) -> tensor`` over int32 device
  inputs; everything else it reads (weights, KV pools) must keep its storage
  for as long as the graph lives, since the graph holds their addresses.
- The inputs are static: views of one flat int32 device buffer per graph,
  filled before each replay by one host-to-device copy from pinned staging.
- Before capture the step runs once on a side stream with every input zero
  (the caller's contract: an all-zero input is harmless, as the serving
  engine's slot 0 and block 0 are its garbage page) and a throwaway
  generator. That run loads the lazily built kernels, creates the cuBLAS
  handle and workspace of the stream, and fills the wrappers' host-side
  caches, so nothing of that happens inside the capture.
- A sampling step's generator is registered with its graph, so each replay
  draws as the eager step would from the generator's state at that time.
- The kernel wrappers count their launches in Python, which runs at capture
  only. Each graph records the counts its capture added, takes the warm-up's
  and the capture's counts back out, and adds its own on every replay.
- All graphs share one memory pool. Replays run one after another on the
  caller's stream and each output is cloned out of the graph's static output
  before the next replay, so no graph reads what another wrote there.
- The cache holds at most ``capacity`` graphs and evicts the least recently
  used; eviction frees the graph.
- A capture is the port's counterpart of the reference's compile. It runs
  under the span ``infer/graph_capture`` (the graph key), whose two timed
  parts are the spans ``infer/graph_capture/warmup`` (the zero-input run)
  and ``infer/graph_capture/record`` (the capture itself), so a profile or
  a span dump names that host time.

There is no eager fallback: a capture or replay that fails raises.
"""

import time
from collections import OrderedDict
from typing import Callable, Hashable, List, Optional, Sequence

import numpy as np
import torch

from ...telemetry import span as telemetry_span


class CapturedStep:
    """One step captured as a CUDA graph over static int32 inputs shaped like
    ``arrays``. ``counters`` are the kernel wrappers whose ``launches`` the
    step moves."""

    def __init__(self, fn: Callable, arrays: Sequence[np.ndarray], generator: Optional[torch.Generator], pool,
                 stream: torch.cuda.Stream, counters: Sequence[Callable]):
        dev = stream.device
        self._shapes = [tuple(a.shape) for a in arrays]
        sizes = [int(np.prod(s)) for s in self._shapes]
        self._flat = torch.zeros((sum(sizes),), dtype=torch.int32, device=dev)
        self.inputs: List[torch.Tensor] = []
        off = 0
        for shape, n in zip(self._shapes, sizes):
            self.inputs.append(self._flat[off:off + n].view(shape))
            off += n
        self._counters = list(counters)
        before = [c.launches for c in self._counters]
        main = torch.cuda.current_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            with telemetry_span("infer/graph_capture/warmup"):
                fn(*self.inputs, torch.Generator(device=dev))  # warm-up on zero inputs: not counted, not kept
            warm = [c.launches for c in self._counters]
            with telemetry_span("infer/graph_capture/record"):
                self.graph = torch.cuda.CUDAGraph()
                if generator is not None:
                    self.graph.register_generator_state(generator)
                self.graph.capture_begin(pool=pool)
                self.out = fn(*self.inputs, generator)
                self.graph.capture_end()
        main.wait_stream(stream)
        self._deltas = [c.launches - w for c, w in zip(self._counters, warm)]
        for c, b in zip(self._counters, before):
            c.launches = b

    def replay(self, arrays: Sequence[np.ndarray], head: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fill the inputs from ``arrays`` (then the first ``head.numel()``
        entries of the first input from the device tensor ``head``), replay,
        and return a clone of the output."""
        if [tuple(a.shape) for a in arrays] != self._shapes:
            raise ValueError(f"captured step: inputs {[a.shape for a in arrays]} do not fit {self._shapes}")
        flat = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in arrays])
        self._flat.copy_(torch.from_numpy(flat).pin_memory(), non_blocking=True)
        if head is not None:
            self.inputs[0].view(-1)[:head.numel()].copy_(head)
        self.graph.replay()
        for c, d in zip(self._counters, self._deltas):
            c.launches += d
        return self.out.clone()


class StepGraphs:
    """LRU cache of ``CapturedStep`` per key on one CUDA device, with one
    shared memory pool and one capture stream. ``captures``, ``capture_s``
    (host seconds spent in warm-up and capture), ``replays`` and
    ``evictions`` count since the cache was made."""

    def __init__(self, device: torch.device, capacity: int, counters: Sequence[Callable]):
        self._capacity = max(1, int(capacity))
        self._counters = list(counters)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(device)
        self._steps: "OrderedDict[Hashable, CapturedStep]" = OrderedDict()
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._steps)

    def run(self, key: Hashable, fn: Callable, arrays: Sequence[np.ndarray], generator: Optional[torch.Generator],
            head: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Replay the graph of ``key`` over ``arrays`` (``CapturedStep.replay``),
        capturing ``fn`` first if the key has no graph. ``generator`` is the
        sampling generator, None for a step that draws nothing."""
        step = self._steps.get(key)
        if step is None:
            if len(self._steps) >= self._capacity:
                _, old = self._steps.popitem(last=False)
                old.graph.reset()
                self.evictions += 1
            t0 = time.perf_counter()
            with telemetry_span("infer/graph_capture", key=repr(key)):
                step = CapturedStep(fn, arrays, generator, self._pool, self._stream, self._counters)
            self.capture_s += time.perf_counter() - t0
            self.captures += 1
            self._steps[key] = step
        else:
            self._steps.move_to_end(key)
        self.replays += 1
        return step.replay(arrays, head)
