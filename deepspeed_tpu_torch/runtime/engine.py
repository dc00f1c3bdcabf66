"""The training engine: data parallelism and ZeRO stages 0-3 over
``torch.distributed``.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``,
``initialize``, the checkpoints). The contract is the reference's:

    engine, optimizer, loader, scheduler = initialize(model=..., model_parameters=..., config=...)
    loss = engine(batch); engine.backward(loss); engine.step()     # or engine.train_batch(data_iter)

Each rank is one process on one device (NCCL on CUDA, gloo on the CPU;
``comm.init_distributed`` brings the world up, a single process included);
the ``mesh`` section (or ``mesh=``) lays ``data`` x ``fsdp`` x ``expert``
over the world, and every rank takes its data-parallel rank's rows of each
global micro-batch (the ranks of an expert group the same rows). The model's
loss is a rank's mean over its valid tokens; the engine weighs it by the
rank's share of the global batch's valid tokens (rows for a model that is
not a ``CausalLM``), so the summed gradients and the reported loss are
those of the mean over the global batch, as in the JAX engine.

The ZeRO stages follow the planner (``runtime/zero/partition.py``): the
optimizer state (stage 1), the gradient buffer (2) and the fp32 masters (3)
hold this rank's chunk of each sharded leaf. Stage 0 all-reduces the
accumulated gradients once a step, in flat buckets of ``reduce_bucket_size``
elements; stage 1 reduce-scatters them into the chunks the optimizer owns;
stage 2 reduce-scatters each micro-batch's gradients into the chunk-sized
buffer; stage 3 gathers each block's leaves in the compute dtype when the
model reads them and reduce-scatters their gradients in the backward
(``runtime/zero/sharded.py``). The optimizer updates chunks (one
``fused_adam_multi`` launch over them; LAMB's trust ratio from whole-leaf
norms), and stages 1 and 2 all-gather the updated chunks into the full
masters. The global gradient norm is the square root of the all-reduced
squared partial sums; overflow and clipping follow from it, on the device.
The engine counts its collectives (``comm_stats``: calls and bytes by op).

Sequence parallelism (``mesh.seq`` for Ulysses, ``mesh.context`` for ring
attention, JAX ``_put_batch`` ``engine.py:575-581``): the ranks of a
sequence group read the same rows, and each keeps its contiguous slice
``[r S / P, (r + 1) S / P)`` of the sequence dimension, the labels shifted
on the whole row first. The model runs under ``sequence.sequence_parallel``
(global positions, the exchange around its attention); the loss is the
whole batch's token mean (the ranks' weights count their valid tokens over
data x fsdp x seq x context); the sequence ranks hold replicas of the
parameters, so their partial gradients are summed over the group after the
data-parallel reduction and before the norm, whatever the ZeRO stage (the
plan shards over data x fsdp, and the sequence group shares each shard).
``seq`` and ``context`` together, MoE under either, and ALiBi or a sliding
window under ``context`` raise ``NotImplementedError``.

Tensor parallelism (``mesh.tensor``, JAX's GSPMD over
``CausalLM.partition_rules()``): each rank holds its tensor slice of the
split leaves (the engine cuts the whole initial tree; the planner puts
ZeRO's chunk on top of that slice, ``LeafPlan.tensor_dim``), and the model
runs under ``parallel.tensor.tensor_parallel`` (Megatron's explicit
collectives, the vocab-parallel embedding and cross-entropy). The ranks of
a tensor group read the same rows; tokens are weighed over data x fsdp
only. A whole leaf that each tensor rank reads a slice of (a
column-parallel bias) has its gradient summed over ``tensor`` after the
data-parallel reduction; the global norm counts a split leaf's squares on
every tensor rank and a whole one's on tensor rank 0, summed over the
group, and LAMB's trust ratio takes a split leaf's norms over the group.
The checkpoints gather the tensor slices into whole leaves, so the
universal layout crosses tensor degrees. Sequence parallelism, the expert
axis, MoE models and ZeRO-Offload beside ``tensor`` raise
``NotImplementedError`` (``config.check_tensor``).

``initialize`` returns the pipeline engine (``runtime/pipe/engine.py``) for
a ``PipelineModule``, or for ``mesh.pipe`` > 1 with a model that has
``to_pipeline`` (JAX ``engine.py:1253-1259``).

Expert parallelism follows the model's partition rules
(``partition_rules()``): an expert leaf holds this rank's E / ep experts,
and its ZeRO chunking, gradient reduction (over the data x fsdp ranks at
this expert coordinate, like every leaf) and optimizer state are those of
that local leaf; the engine enters ``moe.expert_parallel`` around the
forward and backward so MoE layers run over the expert and data-parallel
groups (``moe/layer.py``). The global norm counts an expert leaf's squares
on every expert rank and a shared leaf's on expert rank 0, summed over the
expert group. ZeRO++ (``zero/zeropp.py``) switches stage 3's collectives to
its wire formats where ``zeropp_applicable`` allows, and MiCS's
``mics_shard_size`` is checked against the mesh (``zero/mics.py``).

ZeRO-Offload follows the JAX engine (``engine.py:147-205``, ``:700-730``):
with ``zero_optimization.offload_optimizer.device`` ``cpu`` or ``nvme``, a
ZeRO stage above 0, a config-defined Adam-family optimizer and no client
optimizer, the optimizer state leaves the device (``zero/offload.py``: the
host C++ Adam over this rank's chunks, the overflow read on the host every
step); otherwise the engine warns and keeps the state on the device. With
``offload_param`` at stage 3 the masters of leaves of at least
``stage3_param_persistence_threshold`` elements live on the host and reach
the device block by block (``zero/param_offload.py``); below stage 3 it
warns and keeps them on the device. ``offload_stats`` counts the bytes and
seconds that crossed. Activation checkpointing is configured from the
config's ``activation_checkpointing`` section on every engine (the model's
``remat`` checkpoints each block through ``activation_checkpointing``),
stage 3 included.

Mixed precision is the reference's: fp32 masters, the forward casts them to
the compute dtype inside autograd, gradients accumulate over
``gradient_accumulation_steps`` micro-batches in ``grad_accum_dtype`` with
the loss scaled by ``loss_scale / gas``, and the step unscales, checks for
overflow, clips and updates. Under a static loss scale (bf16, fp32) an
overflowed step is skipped on the device without a host sync; dynamic fp16
scaling reads the flag back once per step, as in the reference. PyTorch
runs eagerly, so the reference's ``fused_step`` has nothing to fuse: the
key is accepted and changes nothing.

Checkpoints use the upstream DeepSpeed layout: ``<dir>/<tag>/
mp_rank_00_model_states.pt`` (rank 0: the module's fp32 masters, counters,
loss scaler, lr scheduler, client state), one ``zero_pp_rank_<r>_mp_rank_00_
optim_states.pt`` a rank (its chunks of the masters, its moments, the
optimizer's scalars) and ``latest``. They resume at the same world size and
stage only; ``checkpoint/universal.py`` moves between sizes and stages, and
between this package and the JAX one, and ``checkpoint/zero_to_fp32.py``
merges the rank files into one fp32 state dict.

Telemetry is the reference's: the ``train_*`` counters and gauges, the
spans ``train/forward``, ``train/backward`` and ``train/step``, the
``train_mfu`` gauge (a model config's FLOPs from shapes, ``telemetry/
costs.py``, over the host's step-to-step wall time against
``resolve_peaks``), the non-finite-loss and grad-norm-spike detectors fed
only where a host sync already happens (the periodic report and the
monitor flush), the registry flushed into the ``tensorboard`` / ``wandb`` /
``csv_monitor`` writers through the ``MonitorBridge``, and the ops plane and
flight recorder when their knobs are set. Each optimizer step is a quantum
boundary for the device profiler (``train_step``).
"""

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import comm as dist
from ..analysis import knobs
from ..device import resolve_device
from ..parallel.mesh import MeshTopology, initialize_mesh
from ..telemetry import MonitorBridge, get_registry as get_telemetry_registry
from ..telemetry import profiler as device_profiler
from ..telemetry import span as telemetry_span
from ..telemetry.costs import attention_macs, forward_macs, resolve_peaks
from ..telemetry.flight import maybe_attach_flight_recorder
from ..telemetry.health import GradNormSpikeDetector, NonFiniteLossDetector, get_health_monitor
from ..telemetry.ops_plane import maybe_start_ops_server
from .checkpoint_engine import AsyncCheckpointEngine, create_checkpoint_engine
from .config import DeepSpeedConfig, check_tensor
from .dataloader import DeepSpeedDataLoader
from .fp16.loss_scaler import create_loss_scaler
from .lr_schedules import create_lr_scheduler
from .optimizers import DeviceOptimizer, create_optimizer
from .zero.init import ShardedParams
from ..checkpoint.utils import flatten_tree, unflatten_tree
from .zero.offload import HostOffloadOptimizer, host_empty
from .zero.param_offload import ParamStream, plan_param_offload
from .zero.mics import validate_mics_mesh
from .zero.partition import plan_zero
from .zero.sharded import Collectives, Stage3Params
from .zero.zeropp import check_hpz, zeropp_applicable, zeropp_requested
from ..moe.layer import ExpertParallel, expert_parallel
from ..parallel.tensor import TensorParallel, tensor_parallel
from ..sequence.layer import SequenceParallel, sequence_parallel

logger = logging.getLogger(__name__)

_ACC_DTYPES = {None: torch.float32, "fp32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
               "bfloat16": torch.bfloat16, "fp16": torch.float16, "float16": torch.float16, "half": torch.float16}
IGNORE_INDEX = -100  # the label CausalLM's loss ignores


def _squared_norm(g: torch.Tensor) -> torch.Tensor:
    """A gradient's squared L2 norm in fp32: ``vector_norm``'s tree reduction on the card; on the CPU the sum of
    squares, whose cascade summation keeps a large leaf to fp32 precision (``vector_norm`` there accumulates
    in order: 1.3 % low over 131 M elements, phi-2's ``wte``)."""
    if g.is_cuda:
        return torch.linalg.vector_norm(g, dtype=torch.float32).square()
    g = g.float()
    return (g * g).sum()

LATEST_FILENAME = "latest"
MODEL_STATES_FILENAME = "mp_rank_00_model_states.pt"


def optim_states_filename(rank: int) -> str:
    return f"zero_pp_rank_{rank}_mp_rank_00_optim_states.pt"


def _batch_tokens(batch) -> int:
    """Token count of a micro-batch from shape metadata only (never reads
    device data)."""
    ids = batch.get("input_ids") if isinstance(batch, dict) else None
    shape = getattr(ids, "shape", None)
    if shape is not None and len(shape) >= 2:
        return int(shape[0]) * int(shape[1])
    return 0


def _batch_rows(batch) -> int:
    """The rows of a micro-batch: the first dimension of its first array."""
    if isinstance(batch, dict):
        return _batch_rows(next(iter(batch.values())))
    if isinstance(batch, (tuple, list)):
        return _batch_rows(batch[0])
    return int(batch.shape[0]) if getattr(batch, "ndim", 0) else 1


def train_flops(cfg, batch: int, seq: int, tp: int = 1) -> int:
    """Model FLOPs of one training micro-batch of ``batch`` x ``seq`` tokens
    of a ``TransformerConfig``: the forward's products (every position
    reaches the LM head) and causal attention over the visible pairs, times
    three for forward and backward; under tensor parallelism over ``tp``
    ranks a rank's share, 1 / tp of them."""
    macs = forward_macs(cfg, batch * seq, batch * seq) + attention_macs(cfg, [seq] * batch, [seq] * batch)
    return 3 * 2 * macs // tp


class DeepSpeedEngine:
    """Wraps a model (a loss function over a parameter dict) with its training
    state on this rank."""

    def __init__(self, model=None, optimizer=None, model_parameters=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, config=None, device="cuda", mesh=None, dist_init_required=None):
        self.config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        self.device = resolve_device(device)
        if dist_init_required is False and not dist.is_initialized():
            raise RuntimeError("dist_init_required=False, but torch.distributed is not initialized: call "
                               "deepspeed_tpu_torch.comm.init_distributed first")
        dist.init_distributed(device=self.device, verbose=False)
        if mesh is not None:
            if not isinstance(mesh, MeshTopology):
                raise TypeError("mesh must be a deepspeed_tpu_torch.parallel.MeshTopology")
            if mesh.n_devices != dist.get_world_size():
                raise ValueError(f"the mesh covers {mesh.n_devices} ranks, the world has {dist.get_world_size()}")
            self.topology = mesh
        else:
            self.topology = initialize_mesh(self.config.mesh)
        validate_mics_mesh(self.config, self.topology)
        self.dp_world_size = self.topology.data_parallel_size
        self.dp_rank = self.topology.data_parallel_rank  # this rank's rows of each global micro-batch
        self.global_rank = dist.get_rank()  # names its checkpoint file
        self.config.resolve_batch_sizes(self.dp_world_size)
        self._model_cfg = getattr(model, "cfg", None)  # a TransformerConfig prices the MFU gauge
        if callable(getattr(model, "loss_fn", None)):
            self._loss_fn = model.loss_fn
        elif callable(model):
            self._loss_fn = model
        else:
            raise TypeError("model must be callable (params, batch, rng) -> loss, or expose .loss_fn")
        # a CausalLM's loss is a mean over valid tokens: weigh ranks by tokens, other losses by rows
        self._token_weighted = self._model_cfg is not None and callable(getattr(model, "loss_fn", None))
        if model_parameters is None:
            raise ValueError("model_parameters (the parameter dict) is required")
        if self.topology.axis_size("pipe") > 1 and type(self) is DeepSpeedEngine:
            raise NotImplementedError("mesh.pipe > 1 pipelines a PipelineModule or a model with to_pipeline "
                                      "(models.CausalLM); this model has neither")
        self._sp = self._sequence_parallel(model)
        self._tp = self._tensor_parallel()
        # the model's (path, spec) rules: the planner keeps the expert dimension of an MoE layer's experts
        self._partition_rules = model.partition_rules() if callable(getattr(model, "partition_rules", None)) else []

        self.compute_dtype = self.config.precision_dtype
        acc_name = self.config.gradient_accumulation_dtype
        if acc_name not in _ACC_DTYPES:
            raise ValueError(f"data_types.grad_accum_dtype must be one of "
                             f"{sorted(k for k in _ACC_DTYPES if k)}, got {acc_name!r}")
        self._grad_acc_dtype = _ACC_DTYPES[acc_name]
        self._init_zeropp()
        self._init_zero(model_parameters, self._host_offload_wanted(optimizer))

        if optimizer is not None:
            if not isinstance(optimizer, DeviceOptimizer):
                raise TypeError("a client optimizer must be a deepspeed_tpu_torch optimizer (runtime/optimizers.py) "
                                "built over engine.parameters()")
            if self.plan.stage > 0:
                raise NotImplementedError("a client optimizer runs at ZeRO stage 0 only: give the optimizer in the "
                                          "config's optimizer section")
        self.optimizer = optimizer if optimizer is not None else create_optimizer(
            self.config.optimizer.type, self.config.optimizer.params, self._opt_params)
        sharded = [p for lf, p in zip(self.plan.leaves, self._opt_params)
                   if lf.opt_dim is not None and lf.ep == 1 and lf.tp == 1]
        if sharded:
            self.optimizer.set_sharded(sharded, self.coll.all_reduce)
        for chunked in (False, True):  # a tensor slice's norm: its chunks over the ZeRO group, then over tensor
            split = [p for lf, p in zip(self.plan.leaves, self._opt_params)
                     if lf.tp > 1 and (lf.opt_dim is not None) == chunked]
            if split:
                self.optimizer.set_sharded(split, lambda t, c=chunked: self.coll.all_reduce(
                    self.coll.all_reduce(t) if c else t, "tensor"))
        experts = [p for lf, p in zip(self.plan.leaves, self._opt_params) if lf.ep > 1]
        if experts:  # an expert leaf's norm: its chunks over the ZeRO group (a no-op when whole), then its experts
            self.optimizer.set_sharded(experts, lambda t: self.coll.all_reduce(self.coll.all_reduce(t), "expert"))

        # reference engine wires checkpointing.configure too; unconditional, so a previous engine's flags never
        # leak into this one through the module's state
        from .activation_checkpointing import configure as configure_checkpointing

        configure_checkpointing(deepspeed_config=self.config)

        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is None and self.config.scheduler.type:
            self.lr_scheduler = create_lr_scheduler(self.config.scheduler.type, self.config.scheduler.params)
        self._base_lr = self.config.optimizer.params.get("lr", 1e-3) if self.config.optimizer.params else 1e-3
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "set_base_lr"):
            self.lr_scheduler.set_base_lr(self._base_lr)

        self.loss_scaler = create_loss_scaler(self.config.fp16, self.compute_dtype)
        self.micro_steps = 0
        self.global_steps = 0
        self._skipped_host = 0
        self._skipped_dev = None  # device count of overflow-skipped steps (static scale)
        self._last_overflow = None
        self._lr_override = None
        self._accum_base = 0
        self._grad_acc: Optional[List[Optional[torch.Tensor]]] = None
        self._pending: Optional[torch.Tensor] = None  # the weighted loss of the forward that backward() takes
        self._global_grad_norm = None
        self.gradient_accumulation_steps = self.config.gradient_accumulation_steps
        self.train_batch_size = self.config.train_batch_size
        self.train_micro_batch_size_per_gpu = self.config.train_micro_batch_size_per_gpu
        self.collate_fn = collate_fn
        self.checkpoint_engine = create_checkpoint_engine(self.config)
        self.training_dataloader = self.deepspeed_io(training_data) if training_data is not None else None
        self._last_loss = None
        self._configure_telemetry()

    # ------------------------------------------------------------------ ZeRO state
    def _sequence_parallel(self, model) -> Optional[SequenceParallel]:
        """This rank's sequence group at ``seq`` or ``context`` > 1 (None below),
        with the refusals of what the port cannot split."""
        topo = self.topology
        axis = next((a for a in ("seq", "context") if topo.axis_size(a) > 1), None)
        if axis is None:
            return None
        cfg = self._model_cfg
        if cfg is None or not hasattr(cfg, "n_heads"):
            raise NotImplementedError(f"mesh.{axis} > 1 splits a CausalLM's sequences: this model is not one")
        if cfg.moe_num_experts > 0:
            raise NotImplementedError(f"MoE under sequence parallelism (mesh.{axis} > 1) is not ported yet")
        if axis == "context" and (cfg.pos_emb == "alibi" or cfg.sliding_window is not None):
            raise NotImplementedError("ALiBi and sliding windows under context parallelism (ring attention) are "
                                      "not ported yet")
        return SequenceParallel(axis, topo.process_group(axis), topo.axis_size(axis), topo.axis_rank(axis))

    def _tensor_parallel(self) -> Optional[TensorParallel]:
        """This rank's tensor group at ``tensor`` > 1 (None below), after the
        refusals of what the port does not run beside it."""
        topo, cfg = self.topology, self._model_cfg
        check_tensor(topo.axis_sizes, self.config.zero_config, moe=getattr(cfg, "moe_num_experts", 0) > 0)
        if topo.axis_size("tensor") == 1:
            return None
        return TensorParallel(topo.axis_size("tensor"), topo.axis_rank("tensor"), topo.process_group("tensor"))

    def _host_offload_wanted(self, optimizer) -> bool:
        """The JAX engine's decision (``engine.py:176-188``): the optimizer state
        goes to the host only under ZeRO, for a config-defined Adam-family
        optimizer; otherwise warn and keep it on the device."""
        off = self.config.zero_config.offload_optimizer
        if off.device not in ("cpu", "nvme"):
            return False
        name = (self.config.optimizer.type or "adamw").lower()
        if optimizer is not None:
            logger.warning("offload_optimizer requires a config-defined adam-family optimizer; a client optimizer "
                           "object was passed: keeping optimizer states on device")
        elif self.config.zero_config.stage == 0:
            logger.warning("offload_optimizer requires ZeRO (zero_optimization.stage >= 1): keeping optimizer "
                           "states on device")
        elif "adam" not in name:
            logger.warning(f"offload_optimizer supports adam-family optimizers; got {name}: keeping optimizer "
                           "states on device")
        else:
            return True
        return False

    def _init_zeropp(self) -> None:
        """ZeRO++ where it applies (JAX ``engine.py:151-160``, ``:411-418``):
        otherwise the fallback is logged with the JAX package's reason and
        the engine trains plain ZeRO; a parameter offload under ZeRO++ is
        refused with a warning."""
        use, reason = zeropp_applicable(self.config, self.topology)
        self.zeropp_active, self.zeropp_reason = use, reason
        zc = self.config.zero_config
        self._hpz = 1
        if zeropp_requested(self.config) and not use:
            logger.warning(f"ZeRO++ requested but falling back to plain ZeRO: {reason}")
        if not use:
            return
        self._hpz = check_hpz(self.config, self.topology)
        if zc.offload_param.device in ("cpu", "nvme"):
            logger.warning("offload_param is incompatible with ZeRO++'s wire formats: parameters stay in device "
                           "memory")
            zc.offload_param.device = "none"
        logger.info(f"ZeRO++: qwZ={zc.zero_quantized_weights} qgZ={zc.zero_quantized_gradients} hpZ={self._hpz} "
                    f"over fsdp={self.topology.axis_size('fsdp')} data={self.topology.axis_size('data')}")

    def _init_zero(self, model_parameters, host_offload: bool) -> None:
        """The plan, this rank's fp32 masters (chunks where stage 3 shards them;
        on the host where ZeRO-3 parameter offload keeps them), the host
        optimizer under ZeRO-Offload, the tensors the device optimizer
        updates and the collectives."""
        given = model_parameters.tree if isinstance(model_parameters, ShardedParams) else model_parameters
        shapes = model_parameters.shapes if isinstance(model_parameters, ShardedParams) else given
        self.plan = plan = plan_zero(shapes, self.config, self.topology, self._partition_rules)
        self._paths = [lf.path for lf in plan.leaves]
        mask = plan_param_offload(self.config, plan)
        self._param_offloaded: List[bool] = mask or [False] * len(plan.leaves)
        pin = self.device.type == "cuda"
        self._masters: List[torch.Tensor] = []
        for lf, off, (path, leaf) in zip(plan.leaves, self._param_offloaded, flatten_tree(given)):
            t = torch.as_tensor(leaf).detach()
            if isinstance(model_parameters, ShardedParams):
                if tuple(t.shape) != plan.shard_shape(lf, lf.param_dim):
                    raise ValueError(f"{path}: zero.Init made a chunk of shape {tuple(t.shape)}, this engine's plan "
                                     f"wants {plan.shard_shape(lf, lf.param_dim)}: build both from one config")
            else:
                t = plan.chunk(t, lf, lf.param_dim)
            if off:  # ZeRO-3 parameter offload: the master stays on the host
                host = host_empty(tuple(t.shape), pin)
                host.copy_(t)
                self._masters.append(host)
            else:
                self._masters.append(t.to(self.device, torch.float32, copy=True).contiguous().requires_grad_(True))
        topo = self.topology
        replica = plan.axis == "fsdp" and topo.axis_size("data") > 1
        self.coll = Collectives(plan, topo.process_group(plan.axis), topo.process_group("data") if replica else None,
                                topo.axis_size("data") if replica else 1, self.config.zero_config.reduce_bucket_size,
                                dp_group=topo.process_group("expert_data"), expert_group=topo.process_group("expert"),
                                hpz_group=topo.hpz_group(self._hpz) if self._hpz > 1 else None, hpz_size=self._hpz)
        if self._sp is not None:  # the tokens of a step lie over data x fsdp x the sequence axis
            self.coll.groups["seq"] = self._sp.group
            self.coll.groups["dp_seq"] = topo.process_group("dp_seq")
        if self._tp is not None:
            self.coll.groups["tensor"] = self._tp.group
        ep, dp = topo.axis_size("expert"), self.dp_world_size
        self._moe_groups = None if ep == 1 and dp == 1 else ExpertParallel(
            ep, topo.axis_rank("expert"), topo.process_group("expert"), dp, self.dp_rank,
            topo.process_group("expert_data"))
        # the device optimizer's tensor of each leaf: the master where its chunk is the master's, else a
        # chunk-shaped device tensor whose storage exists only inside step(), filled from the master and written
        # back after (``_staged``: gathered into a device master; ``_staged_host``: copied to a host master)
        self._opt_params: List[torch.Tensor] = []
        self._staged: List[int] = []
        self._staged_host: List[int] = []
        for i, (lf, m) in enumerate(zip(plan.leaves, self._masters)):
            if self._param_offloaded[i] or not (lf.opt_dim is None or lf.param_dim == lf.opt_dim):
                t = torch.empty(plan.shard_shape(lf, lf.opt_dim), dtype=torch.float32, device=self.device)
                t.untyped_storage().resize_(0)
                self._opt_params.append(t)
                (self._staged_host if self._param_offloaded[i] else self._staged).append(i)
            else:
                self._opt_params.append(m)
        self._host_opt: Optional[HostOffloadOptimizer] = None
        if host_offload:
            zc = self.config.zero_config
            off, off_p = zc.offload_optimizer, zc.offload_param
            self._host_opt = HostOffloadOptimizer(
                [self._opt_view(i) for i in range(len(plan.leaves))], self.config.optimizer.params, self.device,
                offload_device=off.device, nvme_path=off.nvme_path, aio_threads=self.config.aio.thread_count,
                pipeline=off.pipeline_read or off.pipeline_write,
                params_on_nvme=off_p.device == "nvme" and mask is not None, params_nvme_path=off_p.nvme_path,
                shared=self._param_offloaded, rank=dist.get_rank())
            for i, off_i in enumerate(self._param_offloaded):
                if off_i:  # the host optimizer's master is the store (a file under offload_param nvme)
                    self._masters[i] = self._host_opt.master[i]
        self._stage3 = None
        if plan.stage == 3:
            stream = ParamStream(self._masters, self._param_offloaded, self.device) if mask else None
            zc = self.config.zero_config
            zpp = self.zeropp_active
            self._stage3 = Stage3Params(plan, self._masters, self.coll, self.compute_dtype, self._grad_acc_dtype,
                                        self._accumulate, self.device, stream,
                                        qwz=zpp and zc.zero_quantized_weights,
                                        qgz=zpp and zc.zero_quantized_gradients, hpz=self._hpz)

    def _opt_view(self, i: int) -> torch.Tensor:
        """Leaf i's optimizer chunk of its master (a view; the master itself where they coincide)."""
        lf, m = self.plan.leaves[i], self._masters[i].detach()
        if lf.opt_dim is None or lf.param_dim == lf.opt_dim:
            return m
        n = lf.local_shape[lf.opt_dim] // self.plan.size
        return m.narrow(lf.opt_dim, self.plan.rank * n, n)

    @property
    def offload_stats(self) -> Dict[str, Any]:
        """What ZeRO-Offload moved so far: the host optimizer's bytes and seconds
        (device->host gradients, the host step, host->device masters) and the
        parameter stream's copies and bytes."""
        out: Dict[str, Any] = {}
        if self._host_opt is not None:
            out.update(self._host_opt.stats, host_bytes=self._host_opt.host_bytes(),
                       offload_device=self._host_opt.offload_device)
        s = self._stage3
        if s is not None and s.stream is not None:
            out.update(param_copies=s.stream.copies, param_h2d_bytes=s.stream.bytes,
                       offloaded_leaves=sum(self._param_offloaded),
                       offloaded_param_bytes=sum(m.numel() * 4 for m, o in zip(self._masters, self._param_offloaded)
                                                 if o))
        return out

    @property
    def comm_stats(self) -> Dict[str, List[int]]:
        """The engine's collectives so far: ``{op: [calls, bytes]}``; under
        tensor parallelism the model's own (``tp_all_reduce``,
        ``tp_all_gather``; their host seconds in ``engine._tp.stats``)."""
        tp = {} if self._tp is None else {op: v[:2] for op, v in self._tp.stats.items() if v[0]}
        return {**self.coll.stats, **tp}

    @property
    def zero_gathered_bytes(self) -> Tuple[int, int]:
        """Stage 3's gathered copies: (bytes now, peak bytes); (0, 0) below stage 3."""
        s = self._stage3
        return (0, 0) if s is None else (s.gathered_bytes, s.peak_gathered_bytes)

    def _accumulate(self, idx, tensors) -> None:
        if self._grad_acc is None:
            self._grad_acc = [None] * len(self._masters)
        for i, t in zip(idx, tensors):
            a = self._grad_acc[i]
            if a is None:
                self._grad_acc[i] = t.to(self._grad_acc_dtype)
            else:
                a.add_(t.to(a.dtype))

    # ------------------------------------------------------------------ telemetry
    def _configure_telemetry(self) -> None:
        """Handles resolved once; per-step cost is attribute checks and float
        adds. Gauges that need a device-to-host sync (loss, grad norm) are
        set only where a sync already happens (``_report``, monitor flush)."""
        tele = get_telemetry_registry()
        self.telemetry = tele
        self._m_steps = tele.counter("train_steps_total")
        self._m_micro = tele.counter("train_microbatches_total")
        self._m_samples = tele.counter("train_samples_total")
        self._m_tokens = tele.counter("train_tokens_total")
        self._m_overflow = tele.counter("train_overflow_steps_total")
        self._m_loss_scale = tele.gauge("train_loss_scale")
        self._m_lr = tele.gauge("train_lr")
        self._m_loss = tele.gauge("train_loss")
        self._m_gnorm = tele.gauge("train_grad_norm")
        self._m_tps = tele.gauge("train_tokens_per_sec")
        self._m_mfu = tele.gauge("train_mfu")
        self._m_heartbeat = tele.gauge("last_step_completed_unix")
        # the reference's estimate: the gradient tree in the accumulation dtype a step when dp > 1
        self._m_grad_sync_bytes = tele.counter("comm_bytes_total", op="grad_sync_estimated")
        self._last_microbatch_tokens = 0
        self._last_step_pc = None
        self._step_flops = 0  # model FLOPs of one micro-batch, from shapes; 0: unknown and the MFU gauge stays 0
        self._step_flops_shape = None
        self._peak_flops: Optional[float] = None
        self.global_samples = 0
        self.monitor = self._configure_monitor()
        self._monitor_bridge = MonitorBridge(tele, self.monitor,
                                             every_n_steps=knobs.get_int("DS_TPU_TELEMETRY_FLUSH_STEPS"))
        self.health = get_health_monitor()
        self.health.ensure_detector(NonFiniteLossDetector())
        self.health.ensure_detector(GradNormSpikeDetector())
        maybe_start_ops_server()
        maybe_attach_flight_recorder(self.health)

    def _note_step_flops(self, batch) -> None:
        """Price a micro-batch when its (batch, seq) shape changes (shapes only)."""
        ids = batch.get("input_ids") if isinstance(batch, dict) else None
        shape = tuple(getattr(ids, "shape", ()))
        if shape == self._step_flops_shape or len(shape) < 2 or not knobs.get_int("DS_TPU_PERF_ACCOUNT"):
            return
        self._step_flops_shape = shape
        cfg = self._model_cfg
        tp = 1 if self._tp is None else self._tp.size
        self._step_flops = train_flops(cfg, shape[0], shape[1], tp) if hasattr(cfg, "n_layers") else 0

    # ------------------------------------------------------------------ data
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None) -> DeepSpeedDataLoader:
        """A loader of this rank's rows of each global micro-batch over ``dataset``."""
        return DeepSpeedDataLoader(dataset, batch_size=batch_size or self.train_micro_batch_size_per_gpu,
                                   collate_fn=collate_fn or self.collate_fn, rank=self.dp_rank,
                                   num_replicas=self.dp_world_size)

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(v) for v in batch)
        if isinstance(batch, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(batch).to(self.device, non_blocking=True)
        return batch

    def _put_batch(self, batch):
        batch = self._to_device(batch)
        return self._sequence_slice(batch) if self._sp is not None else batch

    def _sequence_slice(self, batch):
        """This rank's slice of every (rows, S) array of the batch, the labels
        shifted on the whole row first (JAX ``_put_batch``)."""
        ids = batch["input_ids"]
        S, P, r = ids.shape[1], self._sp.size, self._sp.rank
        if S % P:
            raise ValueError(f"sequence length {S} does not split over mesh.{self._sp.kind}={P} ranks")
        if "labels" not in batch:
            batch = dict(batch, labels=torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], IGNORE_INDEX)], dim=1))
        n = S // P
        return {k: v[:, r * n:(r + 1) * n] if torch.is_tensor(v) and v.dim() >= 2 and v.shape[1] == S else v
                for k, v in batch.items()}

    def parameters(self) -> List[torch.Tensor]:
        """This rank's fp32 masters (chunks where stage 3 shards them), in plan order."""
        return list(self._masters)

    def _compute_params(self):
        return unflatten_tree((path, leaf.to(self.compute_dtype)) for path, leaf in zip(self._paths, self._masters))

    def _local_loss(self, batch) -> torch.Tensor:
        # MoE layers route the data-parallel batch over the expert group; a sequence slice attends over its group;
        # a tensor rank runs its heads and columns
        with expert_parallel(self._moe_groups), sequence_parallel(self._sp), tensor_parallel(self._tp):
            if self._stage3 is None:
                return self._loss_fn(self._compute_params(), batch, None)
            params = self._stage3
            try:
                with params.saved_tensors_hooks():
                    return self._loss_fn(params, batch, None)
            finally:
                params.end_forward(torch.is_grad_enabled())

    def _weigh(self, loss: torch.Tensor, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(this rank's weight, the global loss): the weight is the rank's share
        of the global batch's valid tokens (rows for a loss that is not a
        CausalLM's), from one all-reduce of (count, count x loss)."""
        if self._token_weighted and isinstance(batch, dict) and "labels" in batch:
            n = (batch["labels"] != IGNORE_INDEX).sum().to(torch.float32)
        else:
            n = torch.full((), float(_batch_rows(batch)), dtype=torch.float32, device=self.device)
        both = torch.stack([n, loss.detach().float() * n])
        # the ranks of an expert group hold the same rows: count them once; a sequence group's ranks hold
        # different tokens of them
        self.coll.all_reduce(both, "dp" if self._sp is None else "dp_seq")
        total = torch.clamp(both[0], min=1.0)
        return n / total, both[1] / total

    # ------------------------------------------------------------------ train loop
    def forward(self, batch):
        """The global loss of one micro-batch (this rank's rows in ``batch``);
        the rank's weighted loss is kept for ``backward``."""
        with telemetry_span("train/forward"):
            self._last_microbatch_tokens = _batch_tokens(batch) * self.dp_world_size
            self._note_step_flops(batch)
            batch = self._put_batch(batch)
            loss = self._local_loss(batch)
            weight, global_loss = self._weigh(loss, batch)
            self._pending = loss * weight
        self._last_loss = global_loss  # read back only where a sync already happens
        return global_loss

    __call__ = forward

    def backward(self, loss=None, retain_graph: bool = False):
        """Back-propagate the paired forward's weighted loss times
        ``loss_scale / gas`` and accumulate the gradients (in
        ``grad_accum_dtype``; from stage 2 up each micro-batch's gradients are
        reduce-scattered into this rank's chunks)."""
        if self._pending is None:
            raise RuntimeError("backward() needs a preceding forward() (it back-propagates that forward's loss)")
        with telemetry_span("train/backward"):
            scale = self.loss_scaler.loss_scale / self.gradient_accumulation_steps
            if self._stage3 is not None:
                self._stage3.in_backward = True
            try:
                # a checkpointed block's recompute runs in here
                with expert_parallel(self._moe_groups), sequence_parallel(self._sp), tensor_parallel(self._tp):
                    (self._pending.float() * scale).backward(retain_graph=retain_graph)
            finally:
                if self._stage3 is not None:
                    self._stage3.in_backward = False
            if not retain_graph:
                self._pending = None
            if self._stage3 is None:
                grads = []
                for p in self._masters:
                    grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
                    p.grad = None
                if self.plan.stage == 2:
                    grads = self.coll.reduce([(g, lf.grad_dim) for lf, g in zip(self.plan.leaves, grads)])
                self._accumulate(range(len(grads)), grads)
            self.micro_steps += 1
            samples = self.train_micro_batch_size_per_gpu * self.dp_world_size
            self.global_samples += samples
            self._m_micro.inc()
            self._m_samples.inc(samples)
            if self._last_microbatch_tokens:
                self._m_tokens.inc(self._last_microbatch_tokens)
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        done = self.micro_steps - self._accum_base
        return done % self.gradient_accumulation_steps == 0 and done > 0

    def _reduced_grads(self) -> List[torch.Tensor]:
        """The step's gradients summed over the data-parallel world, each as
        the optimizer holds its leaf (this rank's chunk, or whole)."""
        acc = self._grad_acc or [None] * len(self._masters)
        grad_dims = [lf.grad_dim for lf in self.plan.leaves]
        acc = [a if a is not None else torch.zeros(self.plan.shard_shape(lf, d), dtype=self._grad_acc_dtype,
                                                   device=self.device)
               for a, lf, d in zip(acc, self.plan.leaves, grad_dims)]
        if self.plan.stage <= 1:  # stage 2 and 3 reduced each micro-batch over the ZeRO group
            dims = [lf.opt_dim if self.plan.stage == 1 else None for lf in self.plan.leaves]
            acc = self.coll.reduce(list(zip(acc, dims)))
        s3 = self._stage3
        # under ZeRO++ qgZ the sharded leaves were reduced over data too, each micro-batch
        self.coll.reduce_replicas([a for a, lf in zip(acc, self.plan.leaves)
                                   if not (s3 is not None and s3.qgz and lf.param_dim is not None)])
        if self._sp is not None:  # the sequence ranks' partial gradients of their replicas
            self.coll.sum_in_place(acc, "seq")
        partial = [a for a, lf in zip(acc, self.plan.leaves) if lf.tp_partial]
        if partial:  # each tensor rank's part of a whole leaf it reads a slice of
            self.coll.sum_in_place(partial, "tensor")
        return acc

    def _norm_owned(self) -> List[bool]:
        """Whether leaf i's squares count in this rank's share of the global
        norm: a chunk, or a whole leaf on ZeRO rank 0; a leaf every expert
        rank holds alike only on expert rank 0, and one every tensor rank
        holds alike only on tensor rank 0."""
        p = self.plan
        return [(lf.opt_dim is not None or p.rank == 0) and (lf.expert_dim is not None or p.ep_rank == 0)
                and (lf.tensor_dim is not None or p.tp_rank == 0) for lf in p.leaves]

    def _norm_sum(self, sq: torch.Tensor) -> torch.Tensor:
        """The ranks' shares of the squared norm summed: over the ZeRO group,
        then over the expert group and the tensor group."""
        self.coll.all_reduce(sq)
        if self.plan.ep_size > 1:
            self.coll.all_reduce(sq, "expert")
        if self.plan.tp_size > 1:
            self.coll.all_reduce(sq, "tensor")
        return sq

    @torch.no_grad()
    def _apply_updates(self, grads: List[torch.Tensor], inv_scale: float, lr: float):
        """Unscale, overflow check, global norm, clip and update; returns the
        (device) global norm and overflow flag. A gradient whose squared norm
        overflows fp32 counts as overflow too. The norm sums each rank's
        squared chunk norms (whole leaves once, on ZeRO rank 0) over the ZeRO
        group."""
        owned = [g for own, g in zip(self._norm_owned(), grads) if own]
        squares = torch.stack([_squared_norm(g) for g in owned]) if owned \
            else torch.zeros(1, dtype=torch.float32, device=self.device)
        sq = self._norm_sum(squares.sum().reshape(1))
        gnorm = sq[0].sqrt() * inv_scale
        finite = torch.isfinite(gnorm)
        mult = torch.full((), inv_scale, dtype=torch.float32, device=self.device)
        clip = self.config.gradient_clipping
        if clip > 0:
            mult = mult * torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        for i in self._staged + self._staged_host:
            p = self._opt_params[i]
            p.untyped_storage().resize_(p.numel() * p.element_size())
            p.copy_(self._opt_view(i))
        for p, g in zip(self._opt_params, grads):
            p.grad = g.float()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step(grad_mult=mult, finite=finite)
        for p in self._opt_params:
            p.grad = None
        for i in self._staged_host:
            self._masters[i].copy_(self._opt_params[i])
        if self._staged:
            self.coll.gather([(self._opt_params[i], self.plan.leaves[i].opt_dim, self._masters[i].detach())
                              for i in self._staged])
        for i in self._staged + self._staged_host:
            self._opt_params[i].untyped_storage().resize_(0)
        return gnorm, ~finite

    @torch.no_grad()
    def _host_updates(self, grads: List[torch.Tensor], inv_scale: float, lr: float):
        """The ZeRO-Offload step (JAX ``engine.py:707-713``): the host optimizer
        takes the reduced gradients and returns the updated masters to the
        device tensors that hold them; returns the (host) global norm and
        overflow flag."""
        plan = self.plan
        staged = set(self._staged)
        out = []
        for i, lf in enumerate(plan.leaves):
            if self._param_offloaded[i]:
                out.append(None)  # the host master is the store stage 3 gathers from
            elif i in staged:
                out.append(torch.empty(plan.shard_shape(lf, lf.opt_dim), dtype=torch.float32, device=self.device))
            else:
                out.append(self._masters[i].detach())
        reduce = None
        if plan.size > 1 or plan.ep_size > 1:
            def reduce(x: float) -> float:
                return float(self._norm_sum(torch.tensor([x], dtype=torch.float64, device=self.device))[0])
        owned = self._norm_owned()
        gnorm, overflow = self._host_opt.step(grads, lr, inv_scale, self.config.gradient_clipping, out=out,
                                              owned=owned, norm_reduce=reduce)
        if not overflow and self._staged:
            self.coll.gather([(out[i], plan.leaves[i].opt_dim, self._masters[i].detach()) for i in self._staged])
        return gnorm, overflow

    def step(self):
        if not self.is_gradient_accumulation_boundary():
            self._last_overflow = None  # no-op step (reference was_step_applied contract)
            return
        with telemetry_span("train/step"):
            lr = self._next_lr()
            if self._stage3 is not None and self._stage3.stream is not None:
                self._stage3.stream.clear()  # no copy issued ahead may outlive the masters it read
            # grads were pre-scaled by loss_scale / gas; undo loss_scale here (the
            # 1 / gas factor stays: the summed micro-gradients become the mean)
            update = self._apply_updates if self._host_opt is None else self._host_updates
            gnorm, overflow = update(self._reduced_grads(), 1.0 / self.loss_scaler.loss_scale, lr)
            self._grad_acc = None
            self._global_grad_norm = gnorm
            self._last_overflow = overflow
            if self.loss_scaler.dynamic or self._host_opt is not None:
                # dynamic fp16 scaling needs the flag on the host now: the scale
                # feeds the next step (the reference pays the same sync); the
                # host optimizer has it there already
                overflow_host = bool(overflow)
                self.loss_scaler.update_scale(overflow_host)
                if overflow_host:
                    self._skipped_host += 1
                    self._m_overflow.inc()
                    logger.info(f"step {self.global_steps}: grad overflow — step skipped, "
                                f"loss scale -> {self.loss_scaler.loss_scale}")
            else:
                self._skipped_dev = overflow.to(torch.int32) if self._skipped_dev is None \
                    else self._skipped_dev + overflow.to(torch.int32)
            self.global_steps += 1
            if self.dp_world_size > 1:
                self._m_grad_sync_bytes.inc(sum(lf.numel for lf in self.plan.leaves)
                                            * torch.empty((), dtype=self._grad_acc_dtype).element_size())
        self._step_telemetry(lr)

    def _step_telemetry(self, lr: float) -> None:
        """Dispatch-boundary telemetry: counters, gauges, heartbeat, no device
        read; the loss and grad-norm gauges and detectors update where a sync
        already happens (``_report``, the monitor flush)."""
        self._m_steps.inc()
        self._m_loss_scale.set(self.loss_scaler.loss_scale)
        self._m_lr.set(lr)
        self._m_heartbeat.set(time.time())
        now_pc = time.perf_counter()
        if self._last_step_pc is not None and now_pc > self._last_step_pc and self._last_microbatch_tokens:
            # dispatch rate, not device rate: honest once the host runs no further ahead of the device than its
            # queue allows
            dt = now_pc - self._last_step_pc
            self._m_tps.set(self._last_microbatch_tokens * self.gradient_accumulation_steps / dt)
            if self._step_flops:
                if self._peak_flops is None:
                    self._peak_flops = resolve_peaks()[0]
                if self._peak_flops > 0:
                    self._m_mfu.set(self._step_flops * self.gradient_accumulation_steps / dt / self._peak_flops)
        self._last_step_pc = now_pc
        if self.global_steps % self.config.steps_per_print == 0:
            self._report(lr)
        if self.monitor is not None:
            # registry -> monitor bridge; the legacy Train/Samples/* series ride along verbatim
            extra = [("Train/Samples/lr", lr, self.global_samples)]
            if self._last_loss is not None:
                loss_host = float(self._last_loss)
                self._m_loss.set(loss_host)
                self.health.observe_loss(loss_host)
                extra.append(("Train/Samples/train_loss", loss_host, self.global_samples))
            self._monitor_bridge.maybe_flush(self.global_steps, extra_events=extra)
        device_profiler.note_quantum("train_step", step=self.global_steps)

    def _report(self, lr: float) -> None:
        """The periodic log line (every ``steps_per_print`` steps): the one
        place besides the monitor flush that reads the loss and the grad
        norm back, and so where their gauges and detectors update."""
        loss = float(self._last_loss) if self._last_loss is not None else float("nan")
        skipped = self.skipped_steps
        self._m_loss.set(loss)
        if self._last_loss is not None:
            self.health.observe_loss(loss)
        gnorm = float(self._global_grad_norm) if self._global_grad_norm is not None else float("nan")
        if self._global_grad_norm is not None:
            self._m_gnorm.set(gnorm)
            self.health.observe_grad_norm(gnorm)
        skip_note = f" skipped={skipped}" if skipped else ""
        logger.info(f"step={self.global_steps} loss={loss:.4f} lr={lr:.3e} "
                    f"loss_scale={self.loss_scaler.loss_scale:.0f} gnorm={gnorm:.3f}{skip_note}")

    def _next_lr(self) -> float:
        lr = float(self._base_lr)
        if self.lr_scheduler is not None:
            # consume-then-step (reference engine.py:801): an optimizer step
            # runs at the lr the PREVIOUS scheduler step installed; the first
            # one at the pre-schedule value
            if getattr(self.lr_scheduler, "_last_lr", None) is not None:
                lr = float(self.lr_scheduler.get_last_lr()[0])
            else:
                init = getattr(self.lr_scheduler, "initial_lr", lambda: None)()
                if init is not None:
                    lr = float(init)
            self.lr_scheduler.step()
        if self._lr_override is not None:
            lr, self._lr_override = self._lr_override, None
        return lr

    def train_batch(self, data_iter=None) -> torch.Tensor:
        """One optimizer step over ``gas`` micro-batches; returns the mean loss
        (a device tensor)."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs a data_iter or training_data at initialize()")
            data_iter = iter(self.training_dataloader)
        losses = []
        for _ in range(self.gradient_accumulation_steps):
            loss = self.forward(next(data_iter))
            self.backward(loss)
            losses.append(loss.detach())
        self.step()
        return torch.stack(losses).mean()

    @torch.no_grad()
    def eval_batch(self, batch) -> torch.Tensor:
        """The global loss of ``batch`` (this rank's rows), without gradients."""
        batch = self._put_batch(batch)
        return self._weigh(self._local_loss(batch), batch)[1]

    def zero_grad(self):
        """Drop a partial accumulation window; the next step applies exactly gas fresh micro-batches."""
        self._grad_acc = None
        self._pending = None
        for p in self._masters:
            p.grad = None
        self._accum_base = self.micro_steps

    # ------------------------------------------------------------------ accessors
    @property
    def skipped_steps(self) -> int:
        """Overflow-skipped steps. Reading it syncs the device counter once."""
        dev = 0 if self._skipped_dev is None else int(self._skipped_dev)
        return self._skipped_host + dev

    @skipped_steps.setter
    def skipped_steps(self, value: int):
        self._skipped_host = int(value)
        self._skipped_dev = None

    def zero_optimization_stage(self) -> int:
        return self.plan.stage

    def zero_optimization(self) -> bool:
        return self.plan.stage > 0

    def zero_gather_16bit_weights_on_model_save(self) -> bool:
        return bool(self.config.zero_config.stage3_gather_16bit_weights_on_model_save)

    def gradient_clipping(self) -> float:
        return self.config.gradient_clipping

    def get_world_size(self) -> int:
        return dist.get_world_size()

    def get_lr(self):
        if self._lr_override is not None:
            return [self._lr_override]
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "_last_lr"):
            return self.lr_scheduler.get_last_lr()
        return [self._base_lr]

    def set_lr(self, lr: float):
        """The manual value drives the NEXT optimizer step; a scheduler resumes
        control after its next recomputation."""
        self._base_lr = float(lr)
        self._lr_override = float(lr)

    def get_global_grad_norm(self) -> Optional[float]:
        return None if self._global_grad_norm is None else float(self._global_grad_norm)

    def was_step_applied(self) -> bool:
        """True iff the latest ``step()`` changed the parameters (syncs the flag)."""
        if self._last_overflow is None:
            return False
        return not bool(self._last_overflow)

    def _gather_dim(self, t: torch.Tensor, dim: int, n: int, group: str) -> torch.Tensor:
        recv = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=self.device)
        self.coll._count("all_gather", recv)
        dist.all_gather_into_tensor(recv.view(-1), t.to(self.device).contiguous().view(-1),
                                    group=self.coll.groups[group])
        return torch.cat(list(recv.unbind(0)), dim=dim)

    def _whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Leaf i's tensor of this rank's experts and tensor slice all-gathered
        over the expert and tensor groups into the whole leaf (``t`` itself
        for a leaf split over neither)."""
        lf = self.plan.leaves[i]
        if not torch.is_tensor(t) or tuple(t.shape) != lf.local_shape:
            return t
        if lf.expert_dim is not None and lf.ep > 1:
            t = self._gather_dim(t, lf.expert_dim, lf.ep, "expert")
        if lf.tensor_dim is not None and lf.tp > 1:
            t = self._gather_dim(t, lf.tensor_dim, lf.tp, "tensor")
        return t

    @torch.no_grad()
    def full_masters(self) -> List[torch.Tensor]:
        """Every fp32 master whole, in plan order (stage 3 all-gathers its
        chunks, expert and tensor parallelism their slices: every rank must
        call it)."""
        out = [m.detach() for m in self._masters]
        items = []
        for i, lf in enumerate(self.plan.leaves):
            if lf.param_dim is not None:
                full = torch.empty(lf.local_shape, dtype=torch.float32, device=self.device)
                items.append((out[i].to(self.device), lf.param_dim, full))
                out[i] = full
        if items:
            self.coll.gather(items)
        return [self._whole(i, t) for i, t in enumerate(out)]

    def module_state_dict(self) -> Dict[str, Any]:
        """The fp32 masters, whole, as a nested dict of detached tensors (a
        collective at stage 3)."""
        return unflatten_tree(zip(self._paths, self.full_masters()))

    @torch.no_grad()
    def full_optimizer_state(self) -> List[Dict[str, torch.Tensor]]:
        """Each leaf's optimizer state tensors, whole (all-gathered over the
        ZeRO group where stage >= 1 shards them: every rank must call it)."""
        out, items = [], []
        for i, (lf, p) in enumerate(zip(self.plan.leaves, self._opt_params)):
            st = {}
            for k, v in self._leaf_state(i).items():
                if lf.opt_dim is None or not torch.is_tensor(v) or v.shape != p.shape:
                    st[k] = v
                else:
                    st[k] = torch.empty(lf.local_shape, dtype=v.dtype, device=self.device)
                    items.append((v.to(self.device), lf.opt_dim, st[k]))
            out.append(st)
        if items:
            self.coll.gather(items)
        return [{k: self._whole(i, v) for k, v in st.items()} for i, st in enumerate(out)]

    def _leaf_state(self, i: int) -> Dict[str, Any]:
        """Leaf i's optimizer state tensors as the optimizer holds them (host ones under ZeRO-Offload)."""
        if self._host_opt is not None:
            return self._host_opt.leaf_state(i)
        return self.optimizer.state.get(self._opt_params[i], {})

    def state_names(self) -> Tuple[str, ...]:
        """The names of a leaf's optimizer state tensors, in the order a universal checkpoint numbers them."""
        return self._host_opt.state_names() if self._host_opt is not None else self.optimizer.state_names()

    @property
    def optimizer_step_count(self) -> int:
        """The optimizer's applied steps (overflow-skipped ones do not count)."""
        if self._host_opt is not None:
            return self._host_opt.step_count
        c = self.optimizer._count
        return 0 if c is None else int(c)

    def set_optimizer_step_count(self, n: int) -> None:
        if self._host_opt is not None:
            self._host_opt.step_count = int(n)
        else:
            self.optimizer._count = torch.tensor(int(n), dtype=torch.int32, device=self.device)

    def _configure_monitor(self):
        from ..monitor.monitor import MonitorMaster

        m = MonitorMaster(self.config)
        return m if m.enabled else None

    # ------------------------------------------------------------------ checkpoints
    def _layout(self) -> Dict[str, Any]:
        """What a rank file must match to resume at this world size and stage."""
        axes = ("data", "fsdp", "expert") + tuple(a for a in ("seq", "context", "tensor")
                                                  if self.topology.axis_size(a) > 1)
        return {"zero_stage": self.plan.stage, "dp_world_size": self.dp_world_size,
                "mesh": {a: self.topology.axis_size(a) for a in axes}}

    def _check_layout(self, saved: Dict[str, Any], where: str) -> None:
        want = self._layout()
        got = {k: saved.get(k) for k in want}
        if got != want:
            raise ValueError(f"{where} was saved at {got}, this engine runs {want}: a checkpoint resumes only at "
                             "its own world size, mesh and ZeRO stage. Save a universal checkpoint "
                             "(engine.save_universal_checkpoint) and load it with load_universal_checkpoint, or "
                             "set checkpoint.load_universal")

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu", copy=True)

    def save_checkpoint(self, save_dir: str, tag=None, client_state: Optional[Dict] = None, save_latest: bool = True,
                        exclude_frozen_parameters: bool = False) -> bool:
        """Write ``<save_dir>/<tag>/``: the model states on rank 0 and one
        optim-states file a rank (every rank must call it), then ``latest``
        after a barrier. With ``checkpoint.async_save`` the files are written
        on a background thread (``checkpoint_engine.wait()`` makes them
        durable; ``latest`` follows rank 0's files)."""
        tag = str(tag) if tag is not None else f"global_step{self.global_steps}"
        d = os.path.join(save_dir, tag)
        eng = self.checkpoint_engine
        eng.makedirs(d)
        eng.create(tag)
        module = {path: self._host(t) for path, t in zip(self._paths, self.full_masters())}
        if self.global_rank == 0:
            eng.save({"module": module, "global_steps": self.global_steps, "micro_steps": self.micro_steps,
                      "global_samples": self.global_samples, "skipped_steps": self.skipped_steps,
                      "accum_base": self._accum_base, "base_lr": self._base_lr,
                      "loss_scaler": self.loss_scaler.state_dict(),
                      "lr_scheduler": self.lr_scheduler.state_dict() if self.lr_scheduler is not None else None,
                      "client_state": client_state or {}, **self._layout()},
                     os.path.join(d, MODEL_STATES_FILENAME))
        del module
        eng.save(self._optim_states(), os.path.join(d, optim_states_filename(self.global_rank)))
        if save_latest:
            if not isinstance(eng, AsyncCheckpointEngine):  # written now: every rank's files are down
                dist.barrier(device=self.device)
            if self.global_rank == 0:
                eng.save_text(tag, os.path.join(save_dir, LATEST_FILENAME))
        eng.commit(tag)
        return True

    def _optim_states(self) -> Dict[str, Any]:
        """This rank's file: its chunk of each master and of each optimizer
        state tensor (whole where the leaf is not sharded), and the
        optimizer's scalars."""
        plan, fp32, state = self.plan, {}, {}
        for i, lf in enumerate(plan.leaves):
            fp32[lf.path] = self._host(self._opt_view(i))
            state[lf.path] = {k: self._host(v) if torch.is_tensor(v) else v for k, v in self._leaf_state(i).items()}
        replica_rank = self.topology.axis_rank("data") if plan.axis == "fsdp" else 0
        return {**self._layout(), "zero_axis": plan.axis, "zero_size": plan.size, "zero_rank": plan.rank,
                "replica_rank": replica_rank, "ep_size": plan.ep_size, "ep_rank": plan.ep_rank,
                "expert_dims": [lf.expert_dim for lf in plan.leaves], "tp_size": plan.tp_size,
                "tp_rank": plan.tp_rank, "tensor_dims": [lf.tensor_dim for lf in plan.leaves],
                "leaves": [(lf.path, lf.shape, lf.opt_dim) for lf in plan.leaves], "fp32": fp32, "state": state,
                "optimizer": {"count": self.optimizer_step_count, "state_names": self.state_names(),
                              "param_groups": [{k: v for k, v in g.items() if k != "params"}
                                               for g in self.optimizer.param_groups]}}

    @torch.no_grad()
    def load_full_masters(self, full: Dict[str, Any], strict: bool = True) -> None:
        """Set the masters from whole fp32 leaves (a dict path -> tensor or
        array): each rank keeps its chunk."""
        missing = [p for p in self._paths if p not in full]
        extra = [p for p in full if p not in set(self._paths)]
        if missing or (strict and extra):
            raise KeyError(f"checkpoint module does not match the model: missing {missing[:5]}, unexpected "
                           f"{extra[:5]}")
        for lf, m in zip(self.plan.leaves, self._masters):
            t = torch.as_tensor(full[lf.path])
            if tuple(t.shape) != lf.shape:
                raise ValueError(f"{lf.path}: checkpoint shape {tuple(t.shape)}, model {lf.shape}")
            m.copy_(self.plan.chunk(t, lf, lf.param_dim))
        if self._host_opt is not None:
            # keep the host masters in step even when no optimizer state is loaded (JAX engine.py:1158-1161)
            self._host_opt.set_master([self._opt_view(i) for i in range(len(self._masters))])

    @torch.no_grad()
    def load_optimizer_state(self, per_leaf: List[Dict[str, Any]], step_count: int,
                             whole: bool = False) -> None:
        """Install each leaf's optimizer state tensors (this rank's chunks, or
        whole tensors it takes its chunk of when ``whole``) and the step count."""
        for i, (lf, p, st) in enumerate(zip(self.plan.leaves, self._opt_params, per_leaf)):
            new = {}
            for k, v in st.items():
                if torch.is_tensor(v) or isinstance(v, np.ndarray):
                    v = torch.as_tensor(v)
                    if whole:
                        v = self.plan.chunk(v, lf, lf.opt_dim)
                    v = v.to("cpu" if self._host_opt is not None else self.device, copy=True)
                new[k] = v
            if self._host_opt is not None:
                self._host_opt.set_leaf_state(i, new)
            elif new:
                self.optimizer.state[p] = new
            else:
                self.optimizer.state.pop(p, None)
        self.set_optimizer_step_count(step_count)

    def load_checkpoint(self, load_dir: str, tag=None, load_module_strict: bool = True,
                        load_optimizer_states: bool = True, load_lr_scheduler_states: bool = True,
                        load_module_only: bool = False):
        """Resume from ``save_checkpoint``'s files at the same world size,
        mesh and stage (a universal checkpoint with ``checkpoint.load_universal``).
        Returns (path, client_state), or (None, {}) without a ``latest``."""
        if self.config.checkpoint_config.load_universal:
            from ..checkpoint.universal import load_universal_checkpoint

            if load_module_only:
                load_optimizer_states = load_lr_scheduler_states = False
            if tag is None and not os.path.exists(os.path.join(load_dir, LATEST_FILENAME)):
                logger.warning(f"no 'latest' file at {load_dir}; nothing loaded")
                return None, {}
            return load_universal_checkpoint(self, load_dir, tag, load_optimizer_states=load_optimizer_states,
                                             load_lr_scheduler_states=load_lr_scheduler_states), {}
        eng = self.checkpoint_engine
        eng.wait()
        if tag is None:
            latest = os.path.join(load_dir, LATEST_FILENAME)
            if not os.path.exists(latest):
                logger.warning(f"no 'latest' file at {load_dir}; nothing loaded")
                return None, {}
            with open(latest) as f:
                tag = f.read().strip()
        d = os.path.join(load_dir, str(tag))
        model = eng.load(os.path.join(d, MODEL_STATES_FILENAME))
        self._check_layout(model, d)
        self.load_full_masters(model["module"], strict=load_module_strict)
        client_state = {}
        if not load_module_only:
            if load_optimizer_states:
                opt = eng.load(os.path.join(d, optim_states_filename(self.global_rank)))
                self._check_layout(opt, d)
                if [tuple(x[:2]) for x in opt["leaves"]] != [(lf.path, lf.shape) for lf in self.plan.leaves]:
                    raise ValueError(f"{d}: the optimizer states' leaves do not match the model")
                self.load_optimizer_state([opt["state"][lf.path] for lf in self.plan.leaves],
                                          opt["optimizer"]["count"])
                for g, saved in zip(self.optimizer.param_groups, opt["optimizer"]["param_groups"]):
                    g.update(saved)
                self.loss_scaler.load_state_dict(model["loss_scaler"])
                if load_lr_scheduler_states and self.lr_scheduler is not None and model["lr_scheduler"] is not None:
                    self.lr_scheduler.load_state_dict(model["lr_scheduler"])
                self.global_steps = int(model["global_steps"])
                self.micro_steps = int(model["micro_steps"])
                self.global_samples = int(model["global_samples"])
                self.skipped_steps = int(model["skipped_steps"])
                self._accum_base = min(int(model.get("accum_base", 0)), self.micro_steps)
                self._base_lr = float(model.get("base_lr", self._base_lr))
            client_state = model.get("client_state", {})
        self._grad_acc = None
        self._pending = None
        return d, client_state

    def save_16bit_model(self, save_dir: str, save_filename: str = "pytorch_model.bin"):
        """The whole model in bf16 as one ``torch.save`` file of ``/``-joined
        parameter paths, written by rank 0 (reference ``engine.py:3547``; the
        JAX package writes safetensors, which the card's machine lacks). At
        stage 3 only with ``stage3_gather_16bit_weights_on_model_save``."""
        from .checkpoint_engine import TorchCheckpointEngine

        if self.plan.stage == 3 and not self.zero_gather_16bit_weights_on_model_save():
            logger.info(f"Did not save the model {os.path.join(save_dir, save_filename)} because "
                        "`stage3_gather_16bit_weights_on_model_save` is False")
            return False
        out = os.path.join(save_dir, save_filename)
        weights = {path: self._host(t.to(torch.bfloat16)) for path, t in zip(self._paths, self.full_masters())}
        if self.global_rank == 0:
            TorchCheckpointEngine().save(weights, out)
        dist.barrier(device=self.device)
        return out

    def save_universal_checkpoint(self, save_dir: str, tag=None) -> str:
        """The degree-independent layout, written directly (the JAX package's
        layout: either package resumes it at any world size and stage)."""
        from ..checkpoint.universal import save_universal_checkpoint

        return save_universal_checkpoint(self, save_dir, tag)

    def load_universal_checkpoint(self, load_dir: str, tag=None, load_optimizer_states: bool = True,
                                  load_lr_scheduler_states: bool = True) -> str:
        from ..checkpoint.universal import load_universal_checkpoint

        return load_universal_checkpoint(self, load_dir, tag, load_optimizer_states=load_optimizer_states,
                                         load_lr_scheduler_states=load_lr_scheduler_states)


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None, lr_scheduler=None,
               mesh=None, mpu=None, dist_init_required=None, collate_fn=None, config=None, device="cuda"):
    """Reference ``deepspeed/__init__.py:70``: returns (engine, optimizer,
    dataloader, lr_scheduler). ``device`` is "cuda" unless the caller asks
    for "cpu"; ``mesh`` a ``parallel.MeshTopology`` over the process world
    (default: the config's ``mesh`` section). A ``PipelineModule``, or
    ``mesh.pipe`` > 1 with a model that has ``to_pipeline``, gets the
    pipeline engine (JAX ``engine.py:1253-1259``). An ``mpu`` is accepted
    and unused, as in the JAX package (``engine.py:101``): the mesh section
    lays out the tensor (model-parallel) axis. The hybrid-engine section
    raises."""
    from .pipe.module import PipelineModule

    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    cfg = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
    pipe = mesh.axis_size("pipe") if isinstance(mesh, MeshTopology) else cfg.mesh.pipe
    cls = DeepSpeedEngine
    if isinstance(model, PipelineModule) or (pipe not in (0, 1) and hasattr(model, "to_pipeline")):
        from .pipe.engine import PipelineEngine as cls
    engine = cls(model=model, optimizer=optimizer, model_parameters=model_parameters, training_data=training_data,
                 lr_scheduler=lr_scheduler, collate_fn=collate_fn, config=cfg, device=device, mesh=mesh,
                 dist_init_required=dist_init_required)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
