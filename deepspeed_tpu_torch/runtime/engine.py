"""The training engine on one device.

Port of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``,
``initialize``) for data-parallel size 1 and ZeRO stage 0. The contract is
the reference's:

    engine, optimizer, loader, scheduler = initialize(model=..., model_parameters=..., config=...)
    loss = engine(batch); engine.backward(loss); engine.step()     # or engine.train_batch(data_iter)

Mixed precision follows it too: fp32 master parameters on the device, the
forward casts them to the compute dtype inside autograd (so gradients land
in fp32 on the masters), gradients are accumulated over
``gradient_accumulation_steps`` micro-batches in ``grad_accum_dtype`` with
the loss scaled by ``loss_scale / gas``, and the step unscales, checks
for overflow, takes the global norm, clips and runs the optimizer. Under a
static loss scale (bf16, fp32) an overflowed step is skipped on the device
without a host sync; dynamic fp16 scaling reads the flag back once per step,
as in the reference.

PyTorch runs eagerly, so the reference's ``fused_step`` (one XLA program for
forward, backward and update) has nothing to fuse: the key is accepted and
the step runs the same way with it on or off.

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
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis import knobs
from ..device import resolve_device
from ..telemetry import MonitorBridge, get_registry as get_telemetry_registry
from ..telemetry import profiler as device_profiler
from ..telemetry import span as telemetry_span
from ..telemetry.costs import attention_macs, forward_macs, resolve_peaks
from ..telemetry.flight import maybe_attach_flight_recorder
from ..telemetry.health import GradNormSpikeDetector, NonFiniteLossDetector, get_health_monitor
from ..telemetry.ops_plane import maybe_start_ops_server
from .config import DeepSpeedConfig
from .dataloader import DeepSpeedDataLoader
from .fp16.loss_scaler import create_loss_scaler
from .lr_schedules import create_lr_scheduler
from .optimizers import DeviceOptimizer, create_optimizer

logger = logging.getLogger(__name__)

_ACC_DTYPES = {None: torch.float32, "fp32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
               "bfloat16": torch.bfloat16, "fp16": torch.float16, "float16": torch.float16, "half": torch.float16}


def _batch_tokens(batch) -> int:
    """Token count of a micro-batch from shape metadata only (never reads
    device data)."""
    ids = batch.get("input_ids") if isinstance(batch, dict) else None
    shape = getattr(ids, "shape", None)
    if shape is not None and len(shape) >= 2:
        return int(shape[0]) * int(shape[1])
    return 0


def train_flops(cfg, batch: int, seq: int) -> int:
    """Model FLOPs of one training micro-batch of ``batch`` x ``seq`` tokens
    of a ``TransformerConfig``: the forward's products (every position
    reaches the LM head) and causal attention over the visible pairs, times
    three for forward and backward."""
    macs = forward_macs(cfg, batch * seq, batch * seq) + attention_macs(cfg, [seq] * batch, [seq] * batch)
    return 3 * 2 * macs


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order (the order of a flattened pytree)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def _unflatten(pairs) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


class DeepSpeedEngine:
    """Wraps a model (a loss function over a parameter dict) with its training state."""

    def __init__(self, model=None, optimizer=None, model_parameters=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, config=None, device="cuda"):
        self.config = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        self.config.resolve_batch_sizes(1)
        self.device = resolve_device(device)
        self._model_cfg = getattr(model, "cfg", None)  # a TransformerConfig prices the MFU gauge
        if callable(getattr(model, "loss_fn", None)):
            self._loss_fn = model.loss_fn
        elif callable(model):
            self._loss_fn = model
        else:
            raise TypeError("model must be callable (params, batch, rng) -> loss, or expose .loss_fn")
        if model_parameters is None:
            raise ValueError("model_parameters (the parameter dict) is required")

        # fp32 master parameters on the device, in flattened-tree order
        pairs = _flatten(model_parameters)
        self._paths = [path for path, _ in pairs]
        self._leaves = [torch.as_tensor(leaf).detach().to(self.device, torch.float32, copy=True).requires_grad_(True)
                        for _, leaf in pairs]

        if optimizer is not None and not isinstance(optimizer, DeviceOptimizer):
            raise TypeError("a client optimizer must be a deepspeed_tpu_torch optimizer (runtime/optimizers.py) "
                            "built over engine.parameters()")
        self.optimizer = optimizer if optimizer is not None else create_optimizer(
            self.config.optimizer.type, self.config.optimizer.params, self._leaves)

        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is None and self.config.scheduler.type:
            self.lr_scheduler = create_lr_scheduler(self.config.scheduler.type, self.config.scheduler.params)
        self._base_lr = self.config.optimizer.params.get("lr", 1e-3) if self.config.optimizer.params else 1e-3
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "set_base_lr"):
            self.lr_scheduler.set_base_lr(self._base_lr)

        self.compute_dtype = self.config.precision_dtype
        self.loss_scaler = create_loss_scaler(self.config.fp16, self.compute_dtype)
        acc_name = self.config.gradient_accumulation_dtype
        if acc_name not in _ACC_DTYPES:
            raise ValueError(f"data_types.grad_accum_dtype must be one of "
                             f"{sorted(k for k in _ACC_DTYPES if k)}, got {acc_name!r}")
        self._grad_acc_dtype = _ACC_DTYPES[acc_name]

        self.micro_steps = 0
        self.global_steps = 0
        self._skipped_host = 0
        self._skipped_dev = None  # device count of overflow-skipped steps (static scale)
        self._last_overflow = None
        self._lr_override = None
        self._accum_base = 0
        self._grad_acc: Optional[List[torch.Tensor]] = None
        self._global_grad_norm = None
        self.gradient_accumulation_steps = self.config.gradient_accumulation_steps
        self.train_micro_batch_size_per_gpu = self.config.train_micro_batch_size_per_gpu
        self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn) \
            if training_data is not None else None
        self._last_loss = None
        self._configure_telemetry()

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
        # one device: no gradient sync, so the counter stays 0 (the reference's name, for the same dashboards)
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

    def _configure_monitor(self):
        from ..monitor.monitor import MonitorMaster

        m = MonitorMaster(self.config)
        return m if m.enabled else None

    def _note_step_flops(self, batch) -> None:
        """Price a micro-batch when its (batch, seq) shape changes (shapes only)."""
        ids = batch.get("input_ids") if isinstance(batch, dict) else None
        shape = tuple(getattr(ids, "shape", ()))
        if shape == self._step_flops_shape or len(shape) < 2 or not knobs.get_int("DS_TPU_PERF_ACCOUNT"):
            return
        self._step_flops_shape = shape
        cfg = self._model_cfg
        self._step_flops = train_flops(cfg, shape[0], shape[1]) if hasattr(cfg, "n_layers") else 0

    # ------------------------------------------------------------------ data
    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None) -> DeepSpeedDataLoader:
        """A loader of micro-batches over ``dataset`` (data-parallel size 1)."""
        return DeepSpeedDataLoader(dataset, batch_size=batch_size or self.train_micro_batch_size_per_gpu,
                                   collate_fn=collate_fn)

    def _put_batch(self, batch):
        if isinstance(batch, dict):
            return {k: self._put_batch(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._put_batch(v) for v in batch)
        if isinstance(batch, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(batch).to(self.device, non_blocking=True)
        return batch

    def parameters(self) -> List[torch.Tensor]:
        """The fp32 master parameters, in the order the optimizer holds them."""
        return list(self._leaves)

    def _compute_params(self):
        return _unflatten((path, leaf.to(self.compute_dtype)) for path, leaf in zip(self._paths, self._leaves))

    # ------------------------------------------------------------------ train loop
    def forward(self, batch):
        """The loss of one micro-batch, with the graph kept for ``backward``."""
        with telemetry_span("train/forward"):
            self._last_microbatch_tokens = _batch_tokens(batch)
            self._note_step_flops(batch)
            loss = self._loss_fn(self._compute_params(), self._put_batch(batch), None)
        self._last_loss = loss.detach()  # read back only where a sync already happens
        return loss

    __call__ = forward

    def backward(self, loss, retain_graph: bool = False):
        """Back-propagate ``loss * loss_scale / gas`` and accumulate the fp32
        master gradients (in ``grad_accum_dtype``)."""
        with telemetry_span("train/backward"):
            scale = self.loss_scaler.loss_scale / self.gradient_accumulation_steps
            (loss.float() * scale).backward(retain_graph=retain_graph)
            grads = []
            for p in self._leaves:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                p.grad = None
                grads.append(g)
            if self._grad_acc is None:
                self._grad_acc = [g.to(self._grad_acc_dtype) for g in grads]
            else:
                for a, g in zip(self._grad_acc, grads):
                    a.add_(g.to(a.dtype))
            self.micro_steps += 1
            self.global_samples += self.train_micro_batch_size_per_gpu
            self._m_micro.inc()
            self._m_samples.inc(self.train_micro_batch_size_per_gpu)
            if self._last_microbatch_tokens:
                self._m_tokens.inc(self._last_microbatch_tokens)
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        done = self.micro_steps - self._accum_base
        return done % self.gradient_accumulation_steps == 0 and done > 0

    def _apply_updates(self, grads: List[torch.Tensor], inv_scale: float, lr: float):
        """Unscale, overflow check, global norm, clip and update; returns the
        (device) global norm and overflow flag. A gradient whose squared norm
        overflows fp32 counts as overflow too."""
        norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])
        gnorm = torch.linalg.vector_norm(norms) * inv_scale
        finite = torch.isfinite(gnorm)
        mult = torch.full((), inv_scale, dtype=torch.float32, device=self.device)
        clip = self.config.gradient_clipping
        if clip > 0:
            mult = mult * torch.clamp(clip / (gnorm + 1e-6), max=1.0)
        for p, g in zip(self._leaves, grads):
            p.grad = g.float()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step(grad_mult=mult, finite=finite)
        for p in self._leaves:
            p.grad = None
        return gnorm, ~finite

    def step(self):
        if not self.is_gradient_accumulation_boundary():
            self._last_overflow = None  # no-op step (reference was_step_applied contract)
            return
        with telemetry_span("train/step"):
            lr = self._next_lr()
            # grads were pre-scaled by loss_scale / gas; undo loss_scale here (the
            # 1 / gas factor stays: the summed micro-gradients become the mean)
            gnorm, overflow = self._apply_updates(self._grad_acc, 1.0 / self.loss_scaler.loss_scale, lr)
            self._grad_acc = None
            self._global_grad_norm = gnorm
            self._last_overflow = overflow
            if self.loss_scaler.dynamic:
                # dynamic fp16 scaling needs the flag on the host now: the scale
                # feeds the next step (the reference pays the same sync)
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
        return self._loss_fn(self._compute_params(), self._put_batch(batch), None)

    def zero_grad(self):
        """Drop a partial accumulation window; the next step applies exactly gas fresh micro-batches."""
        self._grad_acc = None
        for p in self._leaves:
            p.grad = None
        self._accum_base = self.micro_steps

    # ------------------------------------------------------------------ accessors
    @property
    def skipped_steps(self) -> int:
        """Overflow-skipped steps. Reading it syncs the device counter once."""
        dev = 0 if self._skipped_dev is None else int(self._skipped_dev)
        return self._skipped_host + dev

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

    def module_state_dict(self) -> Dict[str, Any]:
        """The fp32 master parameters as a nested dict of detached tensors."""
        return _unflatten((path, leaf.detach()) for path, leaf in zip(self._paths, self._leaves))


def initialize(args=None, model=None, optimizer=None, model_parameters=None, training_data=None, lr_scheduler=None,
               mesh=None, mpu=None, dist_init_required=None, collate_fn=None, config=None, device="cuda"):
    """Reference ``deepspeed/__init__.py:70``: returns (engine, optimizer,
    dataloader, lr_scheduler). ``device`` is "cuda" unless the caller asks
    for "cpu". A mesh or mpu, and the config's pipeline and hybrid-engine
    sections, raise: the port trains on one device with this engine."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if mesh is not None or mpu is not None:
        raise NotImplementedError("mesh/mpu: the port trains on one device (data-parallel size 1)")
    engine = DeepSpeedEngine(model=model, optimizer=optimizer, model_parameters=model_parameters,
                             training_data=training_data, lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                             config=config, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler
