"""Pipeline parallelism (JAX ``deepspeed_tpu/runtime/pipe``): the schedules'
instruction streams (``schedule.py``), the model description
(``module.py``), the stage-to-stage transfers (``p2p.py``) and the engine
(``engine.py``, imported from there: it needs the training engine)."""

from .module import LayerSpec, PipelineModule, PipelineStage, TiedLayerSpec, partition_balanced, partition_uniform
from .schedule import (BackwardPass, DataParallelSchedule, ForwardPass, GPipeSchedule, InferenceSchedule,
                       LoadMicroBatch, OptimizerStep, PipeSchedule, RecvActivation, RecvGrad, ReduceGrads,
                       ReduceTiedGrads, SendActivation, SendGrad, TrainSchedule)

__all__ = ["PipelineModule", "LayerSpec", "TiedLayerSpec", "PipeSchedule", "TrainSchedule", "InferenceSchedule",
           "DataParallelSchedule", "ForwardPass", "BackwardPass", "SendActivation", "RecvActivation", "SendGrad",
           "RecvGrad", "LoadMicroBatch", "ReduceGrads", "ReduceTiedGrads", "OptimizerStep", "GPipeSchedule",
           "PipelineStage", "partition_uniform", "partition_balanced"]
