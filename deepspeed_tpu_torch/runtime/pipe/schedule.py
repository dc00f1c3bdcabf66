"""Pipeline schedules.

Port of ``deepspeed_tpu/runtime/pipe/schedule.py`` (reference
``runtime/pipe/schedule.py``): declarative schedule generators yielding
per-step instruction lists, which ``PipelineEngine._exec_schedule``
interprets on each stage. The instruction taxonomy matches the reference
(:327-489); the 1F1B ``TrainSchedule`` is the textbook PipeDream-flush order
expressed per stage: ``min(M, S-1-s)`` warmup forwards, then paired fwd/bwd
steady state, then drain, then tied-grad/DP reduction and the optimizer
step. ``GPipeSchedule`` (this package's; the JAX engine runs GPipe as one
compiled program instead) yields every forward, then every backward.
"""

from abc import ABC, abstractmethod
from typing import Iterator, List


class PipeInstruction:
    def __init__(self, **kwargs):
        self.name = self.__class__.__name__
        self.kwargs = kwargs
        for k, v in kwargs.items():
            setattr(self, k, v)

    def __repr__(self):
        if not self.kwargs:
            return self.name
        args = ", ".join(f"{k}={v}" for k, v in sorted(self.kwargs.items()))
        return f"{self.name}({args})"

    def __eq__(self, other):
        return isinstance(other, PipeInstruction) and self.name == other.name and self.kwargs == other.kwargs

    def __hash__(self):
        return hash((self.name, tuple(sorted(self.kwargs.items()))))


class OptimizerStep(PipeInstruction):
    """Run the optimizer on accumulated gradients."""


class ReduceGrads(PipeInstruction):
    """Data-parallel gradient reduction."""


class ReduceTiedGrads(PipeInstruction):
    """All-reduce gradients of tied layers across the stages sharing them
    (reference ``pipe/engine.py:264``)."""


class BufferOpInstruction(PipeInstruction):
    def __init__(self, buffer_id: int, **kwargs):
        super().__init__(buffer_id=buffer_id, **kwargs)


class LoadMicroBatch(BufferOpInstruction):
    """First/last stage pulls a micro-batch from the data loader."""


class ForwardPass(BufferOpInstruction):
    """Run forward on the activation buffer."""


class BackwardPass(BufferOpInstruction):
    """Run backward; produces input-grad for the previous stage."""


class SendActivation(BufferOpInstruction):
    """p2p send of output activations to the next stage."""


class RecvActivation(BufferOpInstruction):
    """p2p receive of activations from the previous stage."""


class SendGrad(BufferOpInstruction):
    """p2p send of input-grads to the previous stage."""


class RecvGrad(BufferOpInstruction):
    """p2p receive of output-grads from the next stage."""


class PipeSchedule(ABC):
    """Reference ``schedule.py:11``: yields lists of instructions per step
    for one stage of the pipeline."""

    def __init__(self, micro_batches: int, stages: int, stage_id: int):
        assert 0 <= stage_id < stages
        self.micro_batches = micro_batches
        self.stages = stages
        self.stage_id = stage_id
        self.prev_stage = stage_id - 1
        self.next_stage = stage_id + 1

    @abstractmethod
    def steps(self) -> Iterator[List[PipeInstruction]]:
        ...

    def num_pipe_buffers(self) -> int:
        return self.micro_batches

    @property
    def stage(self) -> int:
        return self.stage_id

    @property
    def num_stages(self) -> int:
        return self.stages

    @property
    def num_micro_batches(self) -> int:
        return self.micro_batches

    @property
    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    @property
    def is_last_stage(self) -> bool:
        return self.stage_id == self.stages - 1

    def __iter__(self):
        return iter(self.steps())


class InferenceSchedule(PipeSchedule):
    """Forward-only pipeline (reference ``schedule.py:135``)."""

    def num_pipe_buffers(self) -> int:
        return max(2, min(self.stages, self.micro_batches))

    def steps(self):
        nbuf = self.num_pipe_buffers()
        for mb in range(self.micro_batches):
            cmds: List[PipeInstruction] = []
            buf = mb % nbuf
            if self.is_first_stage:
                cmds.append(LoadMicroBatch(buf))
            else:
                cmds.append(RecvActivation(buf))
            cmds.append(ForwardPass(buf))
            if not self.is_last_stage:
                cmds.append(SendActivation(buf))
            yield cmds


class TrainSchedule(PipeSchedule):
    """1F1B (PipeDream-flush). Reference ``schedule.py:189``."""

    def num_pipe_buffers(self) -> int:
        return max(2, min(self.stages - self.stage_id, self.micro_batches))

    def _fwd_cmds(self, mb: int) -> List[PipeInstruction]:
        buf = mb % self.num_pipe_buffers()
        cmds: List[PipeInstruction] = []
        if self.is_first_stage:
            cmds.append(LoadMicroBatch(buf, micro_batch_id=mb))
        else:
            cmds.append(RecvActivation(buf, micro_batch_id=mb))
        if self.is_last_stage:
            # loss stages also need the labels for this micro-batch
            cmds.append(LoadMicroBatch(buf, micro_batch_id=mb))
        cmds.append(ForwardPass(buf, micro_batch_id=mb))
        if not self.is_last_stage:
            cmds.append(SendActivation(buf, micro_batch_id=mb))
        return cmds

    def _bwd_cmds(self, mb: int) -> List[PipeInstruction]:
        buf = mb % self.num_pipe_buffers()
        cmds: List[PipeInstruction] = []
        if not self.is_last_stage:
            cmds.append(RecvGrad(buf, micro_batch_id=mb))
        cmds.append(BackwardPass(buf, micro_batch_id=mb))
        if not self.is_first_stage:
            cmds.append(SendGrad(buf, micro_batch_id=mb))
        return cmds

    def steps(self):
        M, S, s = self.micro_batches, self.stages, self.stage_id
        warmup = min(M, S - 1 - s)
        fwd_i = 0
        bwd_i = 0
        for _ in range(warmup):
            yield self._fwd_cmds(fwd_i)
            fwd_i += 1
        for _ in range(M - warmup):
            yield self._fwd_cmds(fwd_i)
            fwd_i += 1
            yield self._bwd_cmds(bwd_i)
            bwd_i += 1
        while bwd_i < M:
            yield self._bwd_cmds(bwd_i)
            bwd_i += 1
        yield [ReduceTiedGrads(), ReduceGrads(), OptimizerStep()]


class GPipeSchedule(TrainSchedule):
    """Every micro-batch's forward, then every backward in the same order,
    then the reductions and the step: the stash holds all M micro-batches."""

    def num_pipe_buffers(self) -> int:
        return max(1, self.micro_batches)

    def steps(self):
        for mb in range(self.micro_batches):
            yield self._fwd_cmds(mb)
        for mb in range(self.micro_batches):
            yield self._bwd_cmds(mb)
        yield [ReduceTiedGrads(), ReduceGrads(), OptimizerStep()]


class DataParallelSchedule(PipeSchedule):
    """Pure DP schedule through the instruction interpreter
    (reference ``schedule.py:301``)."""

    def num_pipe_buffers(self) -> int:
        return 1

    def steps(self):
        for mb in range(self.micro_batches):
            cmds: List[PipeInstruction] = [LoadMicroBatch(0, micro_batch_id=mb), ForwardPass(0, micro_batch_id=mb),
                                           BackwardPass(0, micro_batch_id=mb)]
            yield cmds
        yield [ReduceGrads(), OptimizerStep()]
