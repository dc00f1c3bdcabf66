"""The training config: the part of ``DeepSpeedConfig`` this slice runs.

Port of ``deepspeed_tpu/runtime/config.py`` and the keys of
``runtime/constants.py`` that the engine reads: the three batch sizes and
their triangulation (data-parallel size 1), ``optimizer``, ``scheduler``,
``fp16``, ``bf16``, ``zero_optimization.stage``, ``gradient_clipping``,
``fused_step``, ``steps_per_print`` and ``data_types.grad_accum_dtype``.
A section the port does not implement raises ``NotImplementedError`` when
the config enables it: it is never silently ignored.
"""

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Union

import torch

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

# sections whose "enabled": true this slice cannot honour
_UNPORTED_ENABLED = ("hybrid_engine", "progressive_layer_drop", "curriculum_learning", "random_ltd", "eigenvalue",
                     "flops_profiler", "tensorboard", "wandb", "csv_monitor", "comms_logger", "autotuning",
                     "elasticity")
# sections that are on whenever they are present and not empty
_UNPORTED_PRESENT = ("compression_training", "data_efficiency", "pipeline")


def _from_dict(cls, data: Optional[Dict[str, Any]]):
    names = {f.name for f in fields(cls)}
    return cls(**{k: v for k, v in (data or {}).items() if k in names})


@dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class OptimizerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


def _load_config_dict(config: Union[str, Dict, None]) -> Dict:
    if config is None:
        return {}
    if isinstance(config, dict):
        return dict(config)
    if isinstance(config, str):
        if not os.path.exists(config):
            raise FileNotFoundError(f"DeepSpeed config path does not exist: {config}")
        with open(config) as f:
            return json.load(f)
    raise TypeError(f"Expected dict or path to JSON config, got {type(config)}")


def _check_ported(d: Dict) -> None:
    """Raise for every enabled section the port has no code for."""
    zero = d.get("zero_optimization", {}) or {}
    if int(zero.get("stage", 0)) > 0:
        raise NotImplementedError("zero_optimization.stage > 0 is not ported yet (stage 0 only)")
    for key in ("offload_optimizer", "offload_param"):
        if (zero.get(key) or {}).get("device", "none") not in ("none", None):
            raise NotImplementedError(f"zero_optimization.{key} is not ported yet")
    if zero.get("cpu_offload") or zero.get("cpu_offload_params"):
        raise NotImplementedError("ZeRO offload is not ported yet")
    mesh = d.get("mesh", {}) or {}
    big = {axis: n for axis, n in mesh.items() if axis != "axis_order" and n not in (-1, 0, 1)}
    if big:
        raise NotImplementedError(f"mesh axes {big}: the port trains on one device (data-parallel size 1)")
    for key in _UNPORTED_ENABLED:
        section = d.get(key) or {}
        if isinstance(section, dict) and section.get("enabled", False):
            raise NotImplementedError(f"config section {key!r} is not ported yet")
    for key in _UNPORTED_PRESENT:
        if d.get(key):
            raise NotImplementedError(f"config section {key!r} is not ported yet")


class DeepSpeedConfig:
    """Parsed top-level config (reference ``runtime/config.py:705``)."""

    def __init__(self, config: Union[str, Dict, None]):
        d = _load_config_dict(config)
        _check_ported(d)
        self.train_batch_size = d.get(TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = d.get(TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = d.get(GRADIENT_ACCUMULATION_STEPS)
        self.optimizer = _from_dict(OptimizerConfig, d.get("optimizer"))
        self.scheduler = _from_dict(SchedulerConfig, d.get("scheduler"))
        self.fp16 = _from_dict(FP16Config, d.get("fp16"))
        self.bf16 = _from_dict(BF16Config, d.get("bf16", d.get("bfloat16")))
        self.zero_stage = int((d.get("zero_optimization") or {}).get("stage", 0))
        self.gradient_clipping = float(d.get("gradient_clipping", 0.0))
        fused = d.get("fused_step", True)
        if not isinstance(fused, bool):
            raise ValueError(f"fused_step must be a boolean, got {fused!r}")
        # an XLA dispatch detail in the reference; here forward/backward/step
        # run the same way whatever its value
        self.fused_step = fused
        self.steps_per_print = int(d.get("steps_per_print", 10))
        self.gradient_accumulation_dtype = (d.get("data_types") or {}).get("grad_accum_dtype")
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")

    def resolve_batch_sizes(self, dp_world_size: int = 1):
        """micro x gas x dp == global (reference ``runtime/config.py:765``)."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp_world_size)
        elif train is not None and gas is not None:
            micro = train // (gas * dp_world_size)
        elif micro is not None and gas is not None:
            train = micro * gas * dp_world_size
        elif train is not None:
            gas = 1
            micro = train // dp_world_size
        elif micro is not None:
            gas = 1
            train = micro * dp_world_size
        else:
            train, micro, gas = dp_world_size, 1, 1
        self.train_batch_size, self.train_micro_batch_size_per_gpu, self.gradient_accumulation_steps = train, micro, gas
        if train != micro * gas * dp_world_size or min(train, micro, gas) < 1:
            raise ValueError(
                f"Batch sizes inconsistent: train_batch_size={train} != micro_batch={micro} * "
                f"gradient_accumulation_steps={gas} * dp_world_size={dp_world_size}")

    @property
    def precision_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
