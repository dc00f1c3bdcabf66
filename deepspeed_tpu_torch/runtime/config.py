"""The training config: the part of ``DeepSpeedConfig`` the port runs.

Port of ``deepspeed_tpu/runtime/config.py`` and the keys of
``runtime/constants.py`` that the engine reads: the three batch sizes and
their triangulation against the data-parallel size (``data`` x ``fsdp``),
``optimizer``, ``scheduler``, ``fp16``, ``bf16``, ``zero_optimization``
(stages 0-3 and the reference's keys, ZeRO++ and MiCS's shard size),
``mesh`` (``pipe``, ``data``, ``fsdp``, ``expert``, ``seq``, ``context`` and
``tensor``), ``pipeline`` (the pipeline engine's knobs),
``checkpoint``, ``gradient_clipping``, ``fused_step``, ``steps_per_print``,
``data_types.grad_accum_dtype``, the monitor sections (``tensorboard``,
``wandb``, ``csv_monitor``), ZeRO-Offload (``zero_optimization.offload_optimizer``
and ``offload_param``, with the reference's ``cpu_offload`` /
``cpu_offload_params`` aliases), ``aio`` and ``activation_checkpointing``.
A section or key the port does not implement raises
``NotImplementedError`` when the config enables it (``pipe`` with ``seq``
or ``context``, ``seq`` with ``context``, ``tensor`` with ``seq``,
``context``, ``expert``, an MoE model or ZeRO-Offload: ``check_tensor``,
...): it is never silently ignored.
"""

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Union

import torch

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

# sections whose "enabled": true this slice cannot honour
_UNPORTED_ENABLED = ("hybrid_engine", "progressive_layer_drop", "curriculum_learning", "random_ltd", "eigenvalue",
                     "flops_profiler", "comms_logger", "autotuning", "elasticity")
# sections that are on whenever they are present and not empty
_UNPORTED_PRESENT = ("compression_training", "data_efficiency")
PIPE_SCHEDULES = ("1f1b", "gpipe")


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
class TensorBoardConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class WandbConfig:
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@dataclass
class CSVConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class OptimizerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


OFFLOAD_DEVICES = ("none", "cpu", "nvme")


@dataclass
class ZeroOffloadParamConfig:
    """Reference ``runtime/zero/offload_config.py`` (the JAX
    ``ZeroOffloadParamConfig``): ``device`` and ``nvme_path`` act, at stage 3;
    the buffer keys are read and ignored (the port streams each block)."""
    device: str = "none"  # none | cpu | nvme
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False


@dataclass
class ZeroOffloadOptimizerConfig:
    """The JAX ``ZeroOffloadOptimizerConfig``: ``device``, ``nvme_path`` and
    ``pipeline_read`` / ``pipeline_write`` (either pipelines the NVMe swapper)
    act; the rest are read and ignored. The host buffers are pinned whenever
    the engine runs on a card, whatever ``pin_memory`` says."""
    device: str = "none"  # none | cpu | nvme
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0


def _offload_section(cls, d, key: str):
    cfg = _from_dict(cls, d)
    if cfg.device is None:
        cfg.device = "none"
    if cfg.device not in OFFLOAD_DEVICES:
        raise ValueError(f"zero_optimization.{key}.device must be one of {OFFLOAD_DEVICES}, got {cfg.device!r}")
    return cfg


@dataclass
class ZeroConfig:
    """Reference ``runtime/zero/config.py:82`` (the JAX ``ZeroConfig``). Every
    key of the reference is accepted; these act: ``stage``,
    ``reduce_bucket_size`` (elements a flat gradient bucket),
    ``stage3_param_persistence_threshold`` (leaves with fewer elements stay
    whole at stage 3) and ``stage3_gather_16bit_weights_on_model_save``.
    ``contiguous_gradients`` and ``overlap_comm`` name the reference's hook
    machinery and change nothing here (the buckets are always contiguous;
    the collectives run in the order the backward frees the gradients);
    ``offload_optimizer`` and ``offload_param`` are ZeRO-Offload's sections
    (``cpu_offload`` / ``cpu_offload_params`` map onto their devices as in
    the JAX config); ZeRO++'s ``zero_quantized_weights`` (qwZ),
    ``zero_quantized_gradients`` (qgZ) and ``zero_hpz_partition_size`` (hpZ)
    act at stage 3 over an fsdp axis (``zero/zeropp.py``);
    ``mics_shard_size`` sizes the mesh's fsdp axis (``DeepSpeedConfig``);
    the other keys are read and ignored (``mics_hierarchical_params_gather``
    and ``zero_quantized_nontrainable_weights`` too, as in the JAX
    package)."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False
    offload_param: ZeroOffloadParamConfig = field(default_factory=ZeroOffloadParamConfig)
    offload_optimizer: ZeroOffloadOptimizerConfig = field(default_factory=ZeroOffloadOptimizerConfig)
    cpu_offload: Optional[bool] = None
    cpu_offload_params: Optional[bool] = None

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "ZeroConfig":
        d = dict(d or {})
        param = _offload_section(ZeroOffloadParamConfig, d.pop("offload_param", None), "offload_param")
        optim = _offload_section(ZeroOffloadOptimizerConfig, d.pop("offload_optimizer", None), "offload_optimizer")
        cfg = _from_dict(cls, d)
        cfg.offload_param, cfg.offload_optimizer = param, optim
        # the reference's deprecated aliases (the JAX ZeroConfig.validate)
        if cfg.cpu_offload is not None and optim.device == "none":
            optim.device = "cpu" if cfg.cpu_offload else "none"
        if cfg.cpu_offload_params is not None and param.device == "none":
            param.device = "cpu" if cfg.cpu_offload_params else "none"
        if not 0 <= int(cfg.stage) <= 3:
            raise ValueError(f"zero_optimization.stage must be 0, 1, 2 or 3, got {cfg.stage}")
        cfg.stage = int(cfg.stage)
        if cfg.reduce_bucket_size < 1:
            raise ValueError(f"zero_optimization.reduce_bucket_size must be positive, got {cfg.reduce_bucket_size}")
        if int(cfg.zero_hpz_partition_size) < 1:
            raise ValueError(f"zero_optimization.zero_hpz_partition_size must be >= 1, got "
                             f"{cfg.zero_hpz_partition_size}")
        cfg.zero_hpz_partition_size = int(cfg.zero_hpz_partition_size)
        cfg.mics_shard_size = int(cfg.mics_shard_size)
        if cfg.overlap_comm is None:
            cfg.overlap_comm = cfg.stage == 3
        return cfg


MESH_AXES = ("pipe", "data", "fsdp", "expert", "seq", "context", "tensor")


@dataclass
class PipelineConfig:
    """The pipeline engine's knobs (JAX ``runtime/config.py:192``):
    ``schedule`` is ``"1f1b"`` (the stash holds at most the schedule's
    ``num_pipe_buffers()`` micro-batches) or ``"gpipe"`` (every forward,
    then every backward); ``activation_checkpoint_interval`` > 0 makes each
    stage keep only its input and recompute its forward in the backward.
    ``stages``, ``partition``, ``seed_layers``, ``pipe_partitioned``,
    ``grad_partitioned`` and ``use_reentrant`` are read and ignored, as in
    the JAX package (the stages are the mesh's ``pipe`` axis; a
    ``PipelineModule`` carries its own partition method)."""
    stages: Any = "auto"
    partition: str = "best"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True
    use_reentrant: bool = True
    schedule: str = "1f1b"

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "PipelineConfig":
        cfg = _from_dict(cls, d)
        if int(cfg.activation_checkpoint_interval) < 0:
            raise ValueError(f"pipeline.activation_checkpoint_interval must be >= 0, got "
                             f"{cfg.activation_checkpoint_interval}")
        cfg.activation_checkpoint_interval = int(cfg.activation_checkpoint_interval)
        if str(cfg.schedule).lower() not in PIPE_SCHEDULES:
            raise ValueError(f"pipeline.schedule must be '1f1b' or 'gpipe', got {cfg.schedule!r}")
        cfg.schedule = str(cfg.schedule).lower()
        return cfg


@dataclass
class MeshConfig:
    """Named axis sizes over the process world (the JAX ``MeshConfig``): -1 on
    one axis takes what the others leave. The port trains over ``pipe``
    (the pipeline engine's stages), ``data``, ``fsdp`` (ZeRO's shards live on
    ``fsdp`` when it exceeds 1, else on ``data``), ``expert`` (each rank
    holds E / expert of an MoE layer's experts), ``seq`` (Ulysses) and
    ``context`` (ring attention); ``tensor`` serves
    (``parallel.mesh.serving_mesh``) but does not train."""
    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    context: int = 1
    axis_order: List[str] = field(default_factory=lambda: list(MESH_AXES))

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "MeshConfig":
        return _from_dict(cls, d)


@dataclass
class CheckpointConfig:
    """``checkpoint``: ``load_universal`` routes ``load_checkpoint`` through the
    universal layout; ``async_save`` writes on a background thread; ``engine``
    is ``"torch"`` (or ``"auto"``, the same: the JAX package's msgpack and
    orbax engines have no counterpart here). The reference's other keys are
    read and ignored."""
    load_universal: bool = False
    async_save: bool = False
    engine: str = "auto"


@dataclass
class AIOConfig:
    """Reference ``runtime/swap_tensor/aio_config.py`` (the JAX ``AIOConfig``):
    ``thread_count`` sizes the host I/O pool of NVMe offload; the rest are
    read and ignored (the pool issues whole-buffer pread / pwrite)."""
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True
    use_gds: bool = False


@dataclass
class ActivationCheckpointingConfig:
    """Reference ``runtime/activation_checkpointing/checkpointing.py``'s block
    (the JAX ``ActivationCheckpointingConfig``), applied by
    ``activation_checkpointing.configure`` when an engine is built."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


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
    """Raise for every enabled section or key the port has no code for."""
    mesh = d.get("mesh", {}) or {}
    big = {axis for axis, n in mesh.items() if axis != "axis_order" and n not in (0, 1)}
    if {"seq", "context"} <= big:
        raise NotImplementedError("mesh axes seq and context both above 1: Ulysses inside a ring (2D sequence "
                                  "parallelism) is not ported yet; use one of them")
    if "pipe" in big and big & {"seq", "context"}:
        raise NotImplementedError(f"mesh axes pipe with {sorted(big & {'seq', 'context'})}: sequence parallelism "
                                  "inside pipeline stages is not ported yet")
    pld = d.get("progressive_layer_drop") or {}
    if "pipe" in big and isinstance(pld, dict) and pld.get("enabled", False):
        # the JAX PipelineEngine's refusal (runtime/pipe/engine.py:93-95), ahead of PLD's own
        raise ValueError("progressive_layer_drop is not supported under the pipeline engine (stage functions run "
                         "fixed layer stacks); disable PLD or the pipe mesh")
    for key in _UNPORTED_ENABLED:
        section = d.get(key) or {}
        if isinstance(section, dict) and section.get("enabled", False):
            raise NotImplementedError(f"config section {key!r} is not ported yet")
    for key in _UNPORTED_PRESENT:
        if d.get(key):
            raise NotImplementedError(f"config section {key!r} is not ported yet")


def check_tensor(axis_sizes: Dict[str, int], zero_config: "ZeroConfig", moe: bool = False) -> None:
    """Refuse what tensor-parallel training (``tensor`` > 1) does not run in
    the port yet: sequence parallelism beside it, the expert axis or an MoE
    model (the JAX rules split each expert's hidden dim over ``tensor``),
    and ZeRO-Offload. ``axis_sizes``: the mesh's (a -1 wildcard counts as
    above 1); ``moe``: the model has MoE layers."""
    big = lambda a: axis_sizes.get(a, 1) not in (0, 1)  # noqa: E731
    if not big("tensor"):
        return
    seq = [a for a in ("seq", "context") if big(a)]
    if seq:
        raise NotImplementedError(f"mesh axes tensor with {seq}: sequence parallelism beside tensor parallelism is "
                                  "not ported yet")
    if big("expert"):
        raise NotImplementedError("mesh axes tensor and expert both above 1: expert parallelism beside tensor "
                                  "parallelism is not ported yet")
    if moe:
        raise NotImplementedError("an MoE model under tensor parallelism (mesh.tensor > 1) is not ported yet (the "
                                  "JAX rules split each expert's hidden dim over tensor)")
    if {zero_config.offload_optimizer.device, zero_config.offload_param.device} & {"cpu", "nvme"}:
        raise NotImplementedError("ZeRO-Offload (offload_optimizer / offload_param) under tensor parallelism "
                                  "(mesh.tensor > 1) is not ported yet")


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
        self.zero_config = ZeroConfig.from_dict(d.get("zero_optimization"))
        self.mesh = MeshConfig.from_dict(d.get("mesh"))
        # MiCS (reference runtime/zero/mics.py, JAX config.py:364-369): mics_shard_size=k is the mesh
        # {fsdp: k, data: replica groups}; it sizes fsdp unless the mesh names it
        if self.zero_config.mics_shard_size > 0 and "fsdp" not in (d.get("mesh") or {}):
            self.mesh.fsdp = self.zero_config.mics_shard_size
        check_tensor({a: int(getattr(self.mesh, a)) for a in MESH_AXES}, self.zero_config)
        self.checkpoint_config = _from_dict(CheckpointConfig, d.get("checkpoint"))
        self.aio = _from_dict(AIOConfig, d.get("aio"))
        self.activation_checkpointing = _from_dict(ActivationCheckpointingConfig, d.get("activation_checkpointing"))
        self.pipeline = PipelineConfig.from_dict(d.get("pipeline"))
        self.gradient_clipping = float(d.get("gradient_clipping", 0.0))
        fused = d.get("fused_step", True)
        if not isinstance(fused, bool):
            raise ValueError(f"fused_step must be a boolean, got {fused!r}")
        # an XLA dispatch detail in the reference; here forward/backward/step
        # run the same way whatever its value
        self.fused_step = fused
        self.steps_per_print = int(d.get("steps_per_print", 10))
        self.tensorboard = _from_dict(TensorBoardConfig, d.get("tensorboard"))
        self.wandb = _from_dict(WandbConfig, d.get("wandb"))
        self.csv_monitor = _from_dict(CSVConfig, d.get("csv_monitor"))
        self.gradient_accumulation_dtype = (d.get("data_types") or {}).get("grad_accum_dtype")
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")

    @property
    def zero_stage(self) -> int:
        return self.zero_config.stage

    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    def resolve_batch_sizes(self, dp_world_size: int = 1):
        """micro x gas x dp == global, dp = data x fsdp (reference
        ``runtime/config.py:765``)."""
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
