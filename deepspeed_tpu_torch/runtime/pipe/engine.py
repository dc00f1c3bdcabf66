"""Pipeline-parallel training engine.

Port of ``deepspeed_tpu/runtime/pipe/engine.py`` (reference
``runtime/pipe/engine.py``, ``PipelineEngine``). The JAX engine runs all
stages as one compiled program over stage-stacked parameters; here, as in
the reference, each rank is one stage: it holds only its stage's
parameters (``model.to_pipeline(num_stages, params, stage_id)``), and
interprets its schedule's instruction stream (``_exec_schedule``, reference
``pipe/engine.py:1418``), one method per instruction: ``LoadMicroBatch``,
``ForwardPass``, ``BackwardPass``, ``Send/RecvActivation``,
``Send/RecvGrad`` (``p2p.StageExchange``), ``ReduceTiedGrads``,
``ReduceGrads`` and ``OptimizerStep``.

What it computes is the JAX engine's (``runtime/pipe/engine.py:81-465``):

- ``gradient_accumulation_steps`` is the number M of micro-batches a
  ``train_batch`` pipelines, and the engine then steps every
  ``train_batch`` (gas 1);
- the loss is the mean over the M micro-batches of each one's loss plus its
  MoE stages' pre-scaled aux losses; a micro-batch's loss is its own token
  mean over the data-parallel ranks (each rank's share weighted by its valid
  tokens, as the JAX engine's global micro-batch). The last stage computes
  it, and the pipe group's all-reduce of (loss sum, aux sum) gives it to
  every stage;
- ``schedule: "1f1b"`` (``TrainSchedule``) keeps at most the schedule's
  ``num_pipe_buffers()`` micro-batches in flight on a stage, whatever M is
  (``peak_stash``); ``"gpipe"`` runs every forward, then every backward.
  With ``activation_checkpoint_interval`` > 0, the model's ``remat`` or
  ``partition_activations`` (JAX ``:119-120``) a stage stashes only its
  input and recomputes its forward in the backward;
- tied parameters (the embedding on the first and the last stage) hold one
  copy on each stage; ``ReduceTiedGrads`` sums their gradients over the
  stages that share them (reference ``pipe/engine.py:264``), so the copies
  step alike;
- the global gradient norm (clipping, the overflow flag,
  ``get_global_grad_norm``) sums every stage's squares over the pipe group,
  a tied leaf counted once, on the first stage that holds it;
- under ``tensor`` > 1 (pipe x tensor, JAX ``test_pipe.py:521``) each stage
  runs on its tensor group over the mesh's ``PipeModelDataParallelTopology``
  layout: the stage functions read the engine's ``TensorParallel``
  (``parallel.tensor``), the activations and gradients travel between the
  ranks of one tensor coordinate, and the tied groups are formed per tensor
  coordinate (every line of the pipe axis has its own);
- ZeRO above stage 1 raises ``ValueError`` (reference ``engine.py:1481``),
  as progressive layer drop does (the config refuses it); ZeRO-Offload, the
  ``expert`` axis and checkpoints are not ported under the pipeline and
  raise ``NotImplementedError``.

``train_batch`` and ``eval_batch`` are the entry points; ``forward``,
``backward`` and ``step`` raise, as in the reference.
"""

import logging
import time
from typing import Dict, List

import numpy as np
import torch

from ... import comm as dist
from ...device import resolve_device
from ...moe.layer import expert_parallel
from ...parallel.mesh import MeshTopology, initialize_mesh
from ...parallel.topology import PipelineParallelGrid
from ...parallel.tensor import tensor_parallel
from ..config import DeepSpeedConfig, check_tensor
from ..engine import IGNORE_INDEX, DeepSpeedEngine
from . import schedule as sched
from .p2p import StageExchange

logger = logging.getLogger(__name__)


class _StageModel:
    """The base engine's model contract over one stage (the engine never calls its loss)."""

    cfg = None

    def __init__(self, rules):
        self._rules = rules

    def loss_fn(self, params, batch, rng=None):
        raise RuntimeError("a pipeline stage has no whole-model loss: use PipelineEngine.train_batch")

    def partition_rules(self):
        return self._rules


def shifted_labels(ids: torch.Tensor) -> torch.Tensor:
    """Next-token labels of each row, the last position ignored (``CausalLM.loss_fn``'s shift)."""
    return torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], IGNORE_INDEX)], dim=1)


class PipelineEngine(DeepSpeedEngine):
    def __init__(self, model=None, optimizer=None, model_parameters=None, training_data=None, lr_scheduler=None,
                 collate_fn=None, config=None, device="cuda", mesh=None, dist_init_required=None):
        cfg = config if isinstance(config, DeepSpeedConfig) else DeepSpeedConfig(config)
        if cfg.zero_config.stage > 1:
            raise ValueError("PipelineEngine supports ZeRO stages 0-1 (reference engine.py:1481 contract)")
        zc = cfg.zero_config
        if zc.offload_optimizer.device != "none" or zc.offload_param.device != "none":
            raise NotImplementedError("ZeRO-Offload under the pipeline engine is not ported yet")
        if not hasattr(model, "to_pipeline"):
            raise TypeError("pipeline model must implement to_pipeline(num_stages, params, stage_id) "
                            "(models.CausalLM and pipe.PipelineModule both do)")
        dev = resolve_device(device)
        if dist_init_required is False and not dist.is_initialized():
            raise RuntimeError("dist_init_required=False, but torch.distributed is not initialized: call "
                               "deepspeed_tpu_torch.comm.init_distributed first")
        dist.init_distributed(device=dev, verbose=False)
        topo = mesh if isinstance(mesh, MeshTopology) else initialize_mesh(cfg.mesh)
        if topo.axis_size("expert") > 1:
            raise NotImplementedError("expert parallelism inside pipeline stages is not ported yet (mesh.expert "
                                      "with mesh.pipe)")
        check_tensor(topo.axis_sizes, zc, moe=getattr(getattr(model, "cfg", None), "moe_num_experts", 0) > 0)
        cfg.resolve_batch_sizes(topo.data_parallel_size)
        self.num_stages = topo.pipe_parallel_size
        self.stage_id = topo.axis_rank("pipe")
        self.num_microbatches = cfg.gradient_accumulation_steps
        self._parts = model.to_pipeline(self.num_stages, params=model_parameters, stage_id=self.stage_id)
        self._client_model = model
        super().__init__(model=_StageModel(self._parts.rules), optimizer=optimizer,
                         model_parameters=self._parts.params, training_data=training_data,
                         lr_scheduler=lr_scheduler, collate_fn=collate_fn, config=cfg, device=dev, mesh=topo,
                         dist_init_required=dist_init_required)
        # the pipeline averages its M micro-batches itself: one engine step per train_batch
        self.gradient_accumulation_steps = 1
        self._token_weighted = self._parts.token_weighted
        self.schedule_name = cfg.pipeline.schedule
        mcfg = getattr(model, "cfg", None)
        self._recompute = bool(cfg.activation_checkpointing.partition_activations
                               or cfg.pipeline.activation_checkpoint_interval > 0 or getattr(mcfg, "remat", False))
        self.grid = PipelineParallelGrid(self.topology.topology, self.global_rank)
        self.grid.build_groups([stages for stages, _ in self._parts.tied.values()])
        self.p2p = StageExchange(self.grid, self.device)
        self.coll.groups["pipe"] = self.topology.process_group("pipe") if self.num_stages > 1 else None
        # tied leaves: (leaf indices, their stages' group, whether this stage counts them in the norm)
        self._tied = []
        for stages, key in self._parts.tied.values():
            idx = [i for i, p in enumerate(self._paths) if p == key or p.startswith(key + "/")]
            self._tied.append((idx, self.grid.tied_group(stages), self.stage_id == stages[0]))
        self.peak_stash = 0
        self.tied_reduce_seconds = 0.0  # host wall time in ReduceTiedGrads
        logger.info(f"PipelineEngine: stage {self.stage_id} of {self.num_stages}, micro-batches "
                    f"{self.num_microbatches}, schedule {self.schedule_name}, recompute {self._recompute}")

    # ------------------------------------------------------------------ the global norm over stages
    def _norm_owned(self) -> List[bool]:
        owned = super()._norm_owned()
        for idx, _, counts in self._tied:
            for i in idx:
                owned[i] = owned[i] and counts
        return owned

    def _norm_sum(self, sq: torch.Tensor) -> torch.Tensor:
        super()._norm_sum(sq)
        if self.num_stages > 1:
            self.coll.all_reduce(sq, "pipe")
        return sq

    # ------------------------------------------------------------------ the schedule
    def _micro(self, batch) -> Dict[str, torch.Tensor]:
        """What this stage needs of a micro-batch: the ids on the first stage, the labels on the last."""
        out = {}
        ids = batch["input_ids"] if "input_ids" in batch else None
        if self.stage_id == 0:
            out["input_ids"] = torch.as_tensor(np.asarray(ids)).to(self.device)
        if self.stage_id == self.num_stages - 1:
            if "labels" in batch:
                out["labels"] = torch.as_tensor(np.asarray(batch["labels"])).to(self.device)
            elif self._parts.needs_labels:
                raise ValueError("PipelineModule batches must carry 'labels' — its loss_fn(outputs, labels) does no "
                                 "implicit next-token shift (add labels to each batch dict)")
            else:
                out["labels"] = shifted_labels(torch.as_tensor(np.asarray(ids)).to(self.device))
        return out

    def _run(self, x: torch.Tensor):
        """The stage's forward from its input: (output, aux loss or None)."""
        ps = self._params
        if self._parts.embed_fn is not None:
            x = self._parts.embed_fn(ps, x)
        return self._parts.stage_fn(ps, x)

    def _exec_schedule(self, schedule: sched.PipeSchedule, micro_batches, train: bool) -> torch.Tensor:
        self._mbs = [self._micro(b) for b in micro_batches]
        self._train = train
        self._bufs: Dict[int, Dict] = {}
        self._live = set()
        self._fwd_i = self._bwd_i = 0
        self._sums = torch.zeros(2, dtype=torch.float32, device=self.device)  # (sum of losses, sum of aux losses)
        self._nbuf = schedule.num_pipe_buffers()
        with torch.set_grad_enabled(train):
            self._params = self._compute_params()
        with expert_parallel(self._moe_groups), tensor_parallel(self._tp):
            for step in schedule:
                for cmd in step:
                    self._INSTRUCTION_MAP[type(cmd)](self, cmd)
        self.p2p.wait_sends()
        self._params = self._bufs = self._mbs = None
        if self.num_stages > 1:
            self.coll.all_reduce(self._sums, "pipe")
        loss = self._sums.sum() / self.num_microbatches
        self._last_loss = loss
        return loss

    def _exec_load_micro_batch(self, cmd) -> None:
        self._bufs.setdefault(cmd.buffer_id, {})

    def _exec_recv_activation(self, cmd) -> None:
        self._bufs.setdefault(cmd.buffer_id, {})["x"] = self.p2p.recv_activation()

    def _exec_forward_pass(self, cmd) -> None:
        b = self._bufs.setdefault(cmd.buffer_id, {})
        mb = cmd.kwargs.get("micro_batch_id", self._fwd_i)
        self._fwd_i += 1
        b["mb"] = mb
        first = self.stage_id == 0
        x = self._mbs[mb]["input_ids"] if first else b.pop("x")
        keep_graph = self._train and not self._recompute
        if keep_graph and not first:
            x.requires_grad_(True)
        with torch.set_grad_enabled(keep_graph):
            y, aux = self._run(x)
            loss = self._head(b, y) if self.stage_id == self.num_stages - 1 else None
        if aux is not None:
            self._sums[1] += aux.detach().float()
        b.update(y=y, x_in=x, aux=aux, loss=loss, shape=(tuple(y.shape), y.dtype))
        if self._train:
            self._live.add(cmd.buffer_id)
            self.peak_stash = max(self.peak_stash, len(self._live))

    def _head(self, b: Dict, y: torch.Tensor) -> torch.Tensor:
        """The last stage's micro-batch loss; its weight among the data-parallel ranks is kept for the backward."""
        labels = self._mbs[b["mb"]]["labels"]
        local = self._parts.head_loss_fn(self._params, y, labels)
        weight, global_loss = self._weigh(local, {"labels": labels} if self._token_weighted else labels)
        b["weight"] = weight
        self._sums[0] += global_loss
        return local

    def _exec_send_activation(self, cmd) -> None:
        b = self._bufs[cmd.buffer_id]
        self.p2p.send_activation(b["y"])
        if not self._train or self._recompute:
            b["y"] = None  # the send holds it until it completes; the backward recomputes it

    def _exec_recv_grad(self, cmd) -> None:
        b = self._bufs[cmd.buffer_id]
        b["g"] = self.p2p.recv_grad(*b["shape"])

    def _exec_backward_pass(self, cmd) -> None:
        b = self._bufs[cmd.buffer_id]
        first, last = self.stage_id == 0, self.stage_id == self.num_stages - 1
        x, y, aux, loss = b["x_in"], b["y"], b["aux"], b["loss"]
        if self._recompute:
            x = x if first else x.detach().requires_grad_(True)
            with torch.enable_grad():
                y, aux = self._run(x)
                if last:
                    loss = self._parts.head_loss_fn(self._params, y, self._mbs[b["mb"]]["labels"])
        scale = self.loss_scaler.loss_scale / self.num_microbatches
        aux_seed = scale / self.dp_world_size  # the aux loss is global over the data-parallel ranks: each seeds its share
        if last:
            total = loss.float() * (b["weight"] * scale)
            if aux is not None:
                total = total + aux.float() * aux_seed
            total.backward()
        else:
            tensors, grads = [y], [b["g"]]
            if aux is not None:
                tensors.append(aux)
                grads.append(torch.full_like(aux, aux_seed))
            torch.autograd.backward(tensors, grads)
        self._bwd_i += 1
        self._live.discard(cmd.buffer_id)
        gx = None if first else x.grad
        self._bufs[cmd.buffer_id] = {"gx": gx}

    def _exec_send_grad(self, cmd) -> None:
        self.p2p.send_grad(self._bufs.pop(cmd.buffer_id)["gx"])

    def _collect_grads(self) -> None:
        grads = []
        for p in self._masters:
            grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
            p.grad = None
        self._accumulate(range(len(grads)), grads)

    def _exec_reduce_tied_grads(self, cmd) -> None:
        """Sum each tied leaf's gradient over the stages that hold it (reference ``pipe/engine.py:264``)."""
        self._collect_grads()
        t0 = time.perf_counter()
        for idx, group, _ in self._tied:
            for i in idx:
                self.coll._count("all_reduce", self._grad_acc[i])
                dist.all_reduce(self._grad_acc[i], group=group)
        self.tied_reduce_seconds += time.perf_counter() - t0

    def _exec_reduce_grads(self, cmd) -> None:
        """The data-parallel reduction runs in the step (``_reduced_grads``: all-reduce, or ZeRO-1's reduce-scatter)."""

    def _exec_optimizer_step(self, cmd) -> None:
        self.p2p.wait_sends()
        self.micro_steps += 1
        samples = self.train_micro_batch_size_per_gpu * self.dp_world_size * self.num_microbatches
        self.global_samples += samples
        self._m_micro.inc(self.num_microbatches)
        self._m_samples.inc(samples)
        DeepSpeedEngine.step(self)

    _INSTRUCTION_MAP = {
        sched.LoadMicroBatch: _exec_load_micro_batch,
        sched.RecvActivation: _exec_recv_activation,
        sched.ForwardPass: _exec_forward_pass,
        sched.SendActivation: _exec_send_activation,
        sched.RecvGrad: _exec_recv_grad,
        sched.BackwardPass: _exec_backward_pass,
        sched.SendGrad: _exec_send_grad,
        sched.ReduceTiedGrads: _exec_reduce_tied_grads,
        sched.ReduceGrads: _exec_reduce_grads,
        sched.OptimizerStep: _exec_optimizer_step,
    }

    # ------------------------------------------------------------------ entry points
    def _schedule(self, train: bool) -> sched.PipeSchedule:
        if not train:
            return sched.InferenceSchedule(self.num_microbatches, self.num_stages, self.stage_id)
        cls = sched.TrainSchedule if self.schedule_name == "1f1b" else sched.GPipeSchedule
        return cls(self.num_microbatches, self.num_stages, self.stage_id)

    def train_batch(self, data_iter=None) -> torch.Tensor:
        """Reference ``pipe/engine.py:325``: one optimizer step over M
        pipelined micro-batches (this rank's rows of each); returns the mean
        loss (a device tensor, the same on every stage)."""
        if data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs a data_iter or training_data at initialize()")
            data_iter = iter(self.training_dataloader)
        mbs = [next(data_iter) for _ in range(self.num_microbatches)]
        return self._exec_schedule(self._schedule(True), mbs, train=True)

    def eval_batch(self, data_iter) -> torch.Tensor:
        """The mean loss of M micro-batches through the forward-only schedule:
        ``data_iter`` yields them, or is one dict of arrays stacked (M, rows, ...)."""
        if isinstance(data_iter, dict):
            mbs = [{k: v[m] for k, v in data_iter.items()} for m in range(self.num_microbatches)]
        else:
            mbs = [next(data_iter) for _ in range(self.num_microbatches)]
        return self._exec_schedule(self._schedule(False), mbs, train=False).detach()

    def is_gradient_accumulation_boundary(self) -> bool:
        return self.micro_steps > 0

    def forward(self, *args, **kwargs):
        raise RuntimeError("PipelineEngine runs whole batches: use train_batch() or eval_batch()")

    __call__ = forward

    def backward(self, *args, **kwargs):
        raise RuntimeError("PipelineEngine runs whole batches: use train_batch()")

    def step(self):
        raise RuntimeError("PipelineEngine steps inside train_batch()")

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("pipeline checkpoints (one stage's files a rank) are not ported yet")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError("pipeline checkpoints (one stage's files a rank) are not ported yet")

    @property
    def module(self):
        return self._client_model

    @property
    def recv_seconds(self) -> float:
        """Wall seconds this stage spent blocked in receives (the bubble plus the transport)."""
        return self.p2p.recv_seconds
