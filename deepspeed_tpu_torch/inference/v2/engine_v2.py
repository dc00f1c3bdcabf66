"""InferenceEngineV2 — continuous-batching ragged serving.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py``, both serving loops:
- fused (the default): ``generate`` -> ``_generate_fused`` ->
  ``RaggedBatchScheduler.schedule_fused`` -> ``_run_fused`` -> the step of
  ``make_fused_step_fn``, one step per scheduler quantum;
- unfused (``fused_step=False`` or ``DS_TPU_SERVE_FUSED=0``):
  ``_generate_unfused`` -> ``schedule`` -> ``put`` (one prefill step per
  chunk-length bucket, one decode step for the single-token rows), with
  pure-decode stretches run as multi-step bursts (``_run_decode_burst``).
  ``put`` is also the engine's public one-step API.

- The KV cache is a stacked page pool ``(layers, blocks, block_size, KVH,
  D)`` pair on the device, updated in place (the JAX engine donates it).
  With ``kv_quant_bits=8`` each pool is int8 codes plus fp32 scale planes
  ``(layers, blocks, block_size, KVH)``, quantised on append.
- With ``quant_bits`` 8 or 4 the matmul weights are quantised after they are
  placed on the device (``quantize_for_serving``) and every projection goes
  through the fused dequantise-matmul.
- Block 0 of the pool is a garbage page: padded tokens of a bucket write
  their KV there, so padding never corrupts live sequences.
- Quanta pad to the (decode rows, prefill rows, chunk) bucket ladder of the
  reference, and pure-decode quanta between admission waves extend to
  multi-step bursts inside the same step.
- With no EOS cut and no streaming callback (deferred mode) the token carry
  stays on the device between quanta, and the only host sync of a
  ``generate`` is the final fetch.
- On a CUDA engine every step runs as the captured CUDA graph of its bucket
  (``graphs.StepGraphs``, LRU-bounded by ``DS_TPU_PROGRAM_CACHE``), the
  counterpart of the JAX engine's one jitted program per bucket. A CPU
  engine runs each step eagerly; so does a CUDA engine whose private
  ``_eager_steps`` is set, which only the card tests and ``chip_smoke.py``
  do, to hold the graphs to the eager steps.
- Speculative decoding (``spec_decode=True`` or ``DS_TPU_SPEC_DECODE=1``):
  once every live sequence decodes, each quantum first tries a draft ->
  verify step (``_run_spec_step``): a drafter (``spec.py``) proposes up to
  ``spec_k`` tokens a row on the host, one step verifies them all (a
  ``K+1``-token chunked prefill a row, then ``select_committed`` on the
  device; on the card the captured graph of its own key), and the rejected
  tail is rolled back (``DSStateManager.rollback_tokens``). A row with no
  proposal runs as plain decode. Both serving loops and ``sla.run_load``
  take it; the drafter reads token values, so the token carry stays on the
  host (no deferred mode). ``spec_proposed``, ``spec_accepted``,
  ``decode_steps`` and ``decode_tokens`` count on the engine (verify steps
  count as decode steps).
- The host spill tier (``kv_spill=True`` or ``DS_TPU_KV_SPILL=1``, with the
  prefix cache on): the prefix cache demotes LRU evictions to a host pool of
  ``DS_TPU_KV_HOST_POOL_MB`` (``ragged/host_tier.py``; page-locked on the
  card, d2h on a stream of its own) and re-admits radix matches with an h2d
  copy instead of a prefill. The block snapshot (``_gather_block``) and the
  re-admission (``_readmit_block``) are plain copies on the stream the steps
  run on, between steps, as the reference does them in XLA; the serving loops
  pre-spill between steps (``DSStateManager.spill_tick``).
- Telemetry: the ``infer_*``, ``kv_*``, ``spec_*`` and ``sched_*`` metrics
  and the request-lifecycle events of the reference, under its names, from
  host numbers the loop already has (nothing reads the device for them);
  the spans ``infer/prefill``, ``infer/decode``, ``infer/decode_burst``,
  ``infer/fused_step`` and ``infer/spec_verify`` around each step's
  dispatch. The perf accountant (``telemetry/costs.py``) wraps the step
  dispatch (``_dispatch``): one cost card per graph key, FLOPs and bytes
  from the model config and the bucket (``_step_cost``), each step's wall
  window attributed after its readback, the COW copy, the spill gather and
  the re-admission wrapped untimed. The device profiler marks each step's
  readback boundary (``note_quantum``). The health monitor runs the
  queue-stall, SLO-burn and HBM-pressure detectors (polled each loop turn);
  the HBM gauges (``_update_hbm_gauges``) come from known sizes and the
  caching allocator's statistics, at construction and after each
  ``generate``, with one scalar readback there on an int8 pool
  (``kv_quant_dequant_error``). ``DS_TPU_OPS_PORT`` starts the ops plane
  and ``DS_TPU_FLIGHT_DIR`` attaches the flight recorder (with this
  engine's residency as a manifest section). ``DS_TPU_KV_SANITIZE=1``
  checks every step's block table and writes
  (``DSStateManager.sanitize_write``). With a journal installed
  (``DS_TPU_JOURNAL=1`` or ``telemetry.set_journal``) ``generate`` records
  its session (``_journal_fingerprint``, requests, quanta, commits,
  ``_journal_run_summary``) for ``replay.py``.

- Tensor parallelism (``tensor_parallel = tp`` or ``DS_TPU_TP`` where the
  config leaves it at 1; JAX ``engine_v2.py:130-151``, ``:293-324``): one
  process a rank, the ranks over the ``tensor`` axis of the port's mesh
  (``parallel.mesh.serving_mesh``, so a world of tp ranks). Every rank runs
  this same host loop over the same global block ids and the same inputs,
  and holds 1/tp of the heads, of the MLP or expert hidden dim and of the
  pool's KV heads (``module_inject.shard_params``; a leaf given already at
  its shard's shape is kept, so a caller can build the tree leaf by leaf
  and keep its slice). Each layer's two row-parallel partials go through
  ``tp_all_reduce`` (``DS_TPU_TP_ALLREDUCE_BITS`` 0, 8 or 4); the embedding
  and head are vocab-parallel, so every rank ends each step with the same
  full logits and chooses the same token (a draw: from generators seeded
  alike). Weights quantise after sharding. ``kv_quant_bits`` and
  ``kv_spill`` refuse TP, as in the JAX package. The shard signature
  (``TPContext.signature()``, ``"tp1"`` at tp 1) ends every step key, and
  the journal fingerprint carries the topology. On CUDA under a gloo group
  (``comm.init_distributed(device="cuda", backend="gloo")``: several ranks
  on one GPU) the steps run eagerly, because a gloo collective cannot be
  captured in a CUDA graph; the flight manifest's ``tensor_parallel``
  section (``tp_manifest``) says so. Under NCCL the steps keep their
  graphs. At tp 1 the engine takes no process group.

The engine runs on ``config.device`` (default ``"cuda"``, which raises
without a GPU).
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...analysis import knobs
from ...comm import named_backend
from ...device import resolve_device
from ...models.transformer import TransformerConfig
from ...ops.paged_attention import kv_pool_shard_shape, make_kv_pool
from ...telemetry import get_event_log, get_journal, get_registry as get_telemetry_registry
from ...telemetry import profiler as device_profiler
from ...telemetry import span as telemetry_span
from ...telemetry.costs import attention_macs, forward_macs, get_perf_accountant
from ...telemetry.flight import maybe_attach_flight_recorder
from ...telemetry.health import HBMPressureDetector, QueueStallDetector, SLOBurnRateDetector, get_health_monitor
from ...telemetry.journal import resolved_knobs
from ...telemetry.ops_plane import maybe_start_ops_server
from ..generation import sample_logits
from ..quantization import QuantizedParam, quantize_for_serving
from .graphs import StepGraphs
from .model_runner import TPContext, make_burst_fn, make_fused_step_fn, make_spec_verify_fn, make_step_fns
from .modules import build_modules
from .ragged.manager import DSStateManager, RaggedBatchConfig
from .scheduler import FusedQuantum, RaggedBatchScheduler, RaggedRequest
from .spec import make_drafter


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _tree_bytes(tree) -> int:
    """Device bytes of a parameter tree (a quantised leaf: codes and scales),
    from shape metadata."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, QuantizedParam):
        return _tree_bytes(tree.q) + _tree_bytes(tree.scales)
    return tree.numel() * tree.element_size()


@dataclass
class RaggedInferenceEngineConfig:
    """Parity: reference ``inference/v2/config_v2.py`` (the fused slice's fields)."""
    state_manager: RaggedBatchConfig = field(default_factory=RaggedBatchConfig)
    dtype: str = "bfloat16"
    device: str = "cuda"  # "cuda" (raises without a GPU) or "cpu" (the kernels' plain versions)
    decode_burst: Optional[int] = None  # max fused decode steps per quantum; None: DS_TPU_DECODE_BURST
    fused_step: Optional[bool] = None  # one step per scheduler quantum (SplitFuse); False: the unfused
    # loop (a prefill step per chunk bucket and a decode step). None: on unless DS_TPU_SERVE_FUSED=0
    enable_prefix_cache: Optional[bool] = None  # None: DS_TPU_PREFIX_CACHE
    spec_decode: Optional[bool] = None  # speculative decoding: draft K tokens a decode row, verify them in one
    # step. None: off unless DS_TPU_SPEC_DECODE=1
    spec_k: Optional[int] = None  # max draft tokens a row a step. None: DS_TPU_SPEC_K (default 4)
    spec_drafter: str = "prompt_lookup"  # drafter registry name (spec.py)
    min_decode_bucket: Optional[int] = None  # padded decode batch floor; None: DS_TPU_MIN_DECODE_BUCKET
    # weight-only quantisation: matmul kernels stored as int8 codes, dequantised in the matmul kernel
    quant_bits: int = 0  # 0 = off; 8, or 4 (packed int4 storage, 2 codes per byte)
    quant_group_size: int = 128
    quant_min_size: int = 4096  # leave smaller weights dense
    kv_quant_bits: Optional[int] = None  # 8 = int8 K/V pages + per-slot-per-head scales; None: DS_TPU_KV_QUANT
    kv_spill: Optional[bool] = None  # spill prefix-cache evictions to host RAM and re-admit matches with an h2d
    # copy. None: off unless DS_TPU_KV_SPILL=1
    tensor_parallel: int = 1  # ranks over the mesh's tensor axis; 1 (the default) defers to DS_TPU_TP

    @classmethod
    def from_dict(cls, d: Dict) -> "RaggedInferenceEngineConfig":
        d = dict(d or {})
        sm = d.pop("state_manager", {})
        if isinstance(sm, dict):
            sm = RaggedBatchConfig(**sm)
        return cls(state_manager=sm, **d)


class InferenceEngineV2:

    def __init__(self, model, params, config: Optional[RaggedInferenceEngineConfig] = None):
        """``model`` is a ``TransformerConfig`` or anything exposing ``.cfg``;
        ``params`` the nested parameter dict (``init_params`` or
        ``params_from_numpy``). Floating parameters are cast to the engine
        dtype and placed on the engine device, then quantised there when
        ``config.quant_bits`` is set."""
        if config is None:
            config = RaggedInferenceEngineConfig()
        elif isinstance(config, dict):
            config = RaggedInferenceEngineConfig.from_dict(config)
        self._config = config
        self.device = resolve_device(config.device)
        if config.decode_burst is None:
            config.decode_burst = knobs.get_int("DS_TPU_DECODE_BURST")
        if config.min_decode_bucket is None:
            config.min_decode_bucket = max(1, knobs.get_int("DS_TPU_MIN_DECODE_BUCKET"))
        fused = config.fused_step
        if fused is None:
            fused = knobs.get_bool("DS_TPU_SERVE_FUSED")
        self._fused_enabled = bool(fused)
        spec = config.spec_decode
        if spec is None:
            spec = knobs.get_bool("DS_TPU_SPEC_DECODE")
        self._spec_enabled = bool(spec)
        spec_k = config.spec_k
        if spec_k is None:
            spec_k = knobs.get_int("DS_TPU_SPEC_K")
        self._spec_k = max(1, int(spec_k))
        self._drafter = make_drafter(config.spec_drafter)
        self.model = model
        cfg: TransformerConfig = model if isinstance(model, TransformerConfig) else model.cfg
        self.cfg = cfg
        self.dtype = torch.bfloat16 if config.dtype in ("bfloat16", "bf16") else torch.float32

        self._tp = int(config.tensor_parallel)
        if self._tp <= 1:
            # DS_TPU_TP applies only when the config left TP at the default: an explicit config (replay
            # rebuilding a recorded engine, a test pinning a degree) wins over the environment
            self._tp = max(1, knobs.get_int("DS_TPU_TP") or 1)
            config.tensor_parallel = self._tp
        tp_bits = knobs.get_int("DS_TPU_TP_ALLREDUCE_BITS")
        if tp_bits not in (0, 4, 8):
            raise ValueError(f"DS_TPU_TP_ALLREDUCE_BITS must be 0, 4 or 8, got {tp_bits}")
        self._tp_bits = int(tp_bits)
        self._mesh_topo = None
        if self._tp > 1:
            from ...parallel.mesh import serving_mesh

            self._mesh_topo = serving_mesh(self._tp)
            if self._mesh_topo.model_parallel_size != self._tp:
                raise ValueError(f"mesh tensor axis {self._mesh_topo.model_parallel_size} != tensor_parallel "
                                 f"{self._tp}")
            if cfg.kv_heads % self._tp or cfg.n_heads % self._tp:
                raise ValueError(f"n_heads {cfg.n_heads} and kv_heads {cfg.kv_heads} must be divisible by "
                                 f"tp={self._tp}")

        smc = config.state_manager
        if smc.max_context > cfg.max_seq_len:
            # positions past max_seq_len would index past the rope table: cap
            # the KV contract to the model's window
            smc = dataclasses.replace(smc, max_context=cfg.max_seq_len)
            config.state_manager = smc
        run_cfg = dataclasses.replace(cfg, dtype=self.dtype)
        if run_cfg.window_layers is not None and len(run_cfg.window_layers) == 0:
            run_cfg = dataclasses.replace(run_cfg, sliding_window=None, window_layers=None)
        if (run_cfg.uniform_window and run_cfg.sliding_window is not None
                and run_cfg.sliding_window >= smc.max_context):
            # the window can never mask inside this engine's context budget
            run_cfg = dataclasses.replace(run_cfg, sliding_window=None, window_layers=None)
        self._run_cfg = run_cfg

        kvq = config.kv_quant_bits
        if kvq is None:
            kvq = knobs.get_int("DS_TPU_KV_QUANT")
        if kvq not in (0, 8):
            raise ValueError(f"kv_quant_bits must be 0 or 8, got {kvq}")
        self._kv_quant_bits = int(kvq)
        kv_spill = config.kv_spill
        if kv_spill is None:
            kv_spill = knobs.get_bool("DS_TPU_KV_SPILL")
        self._kv_spill = bool(kv_spill)
        if self._tp > 1 and (self._kv_quant_bits or self._kv_spill):
            # the int8 pool is a (codes, scales) pair and the spill tier's slabs assume whole pools: both would
            # need per-shard layouts (the JAX package refuses the same combination)
            raise ValueError(f"kv_quant_bits / kv_spill do not compose with tensor_parallel={self._tp} yet")
        n_blocks = smc.num_kv_blocks
        if n_blocks is None:
            # int8 pages: one byte per element plus a 4-byte fp32 scale per
            # (slot, kv head), so head_dim + 4 bytes per slot-head
            slot_head_bytes = (cfg.head_dim + 4) if self._kv_quant_bits == 8 else \
                cfg.head_dim * torch.empty((), dtype=self.dtype).element_size()
            bytes_per_block = 2 * cfg.n_layers * smc.kv_block_size * cfg.kv_heads * slot_head_bytes
            n_blocks = max(8, int(smc.memory_gb * (1 << 30) // bytes_per_block))
        self.state = DSStateManager(smc, n_blocks, enable_prefix_cache=config.enable_prefix_cache)
        self._n_kv_blocks = int(n_blocks)
        quantum_tokens = knobs.get_int("DS_TPU_MAX_BATCH_TOKENS") or smc.max_ragged_batch_size
        self.scheduler = RaggedBatchScheduler(self.state, max_batch_tokens=int(quantum_tokens),
                                              max_sequences=smc.max_ragged_sequence_count,
                                              prefill_chunk=knobs.get_int("DS_TPU_PREFILL_CHUNK"),
                                              shard_degree=self._tp)

        tele = get_telemetry_registry()
        self._m_requests = tele.counter("infer_requests_total")
        self._m_prefill_tokens = tele.counter("infer_prefill_tokens_total")
        self._m_decode_tokens = tele.counter("infer_decode_tokens_total")
        self._m_decode_steps = tele.counter("infer_decode_steps_total")
        self._m_bursts = tele.counter("infer_decode_bursts_total")
        self._m_decode_fill = tele.gauge("infer_decode_batch_fill")
        self._m_prefill_fill = tele.gauge("infer_prefill_batch_fill")
        self._m_dispatches = tele.counter("infer_dispatches_total")
        self._m_fused_quanta = tele.counter("infer_fused_quanta_total")
        self._m_fused_fill = tele.gauge("infer_fused_batch_fill")
        self._m_spec_proposed = tele.counter("spec_tokens_proposed_total")
        self._m_spec_accepted = tele.counter("spec_tokens_accepted_total")
        self._m_spec_rate = tele.gauge("spec_acceptance_rate")
        self._m_cow_bytes = tele.counter("kv_cow_bytes_total")
        self._m_quant_err = tele.gauge("kv_quant_dequant_error")  # expected RMS dequant error of an int8 pool
        # tensor-parallel serving: the degree, and the bytes its row-parallel reduces move (host arithmetic)
        self._m_tp_degree = tele.gauge("tp_degree")
        self._m_tp_degree.set(float(self._tp))
        self._m_tp_bytes = tele.counter("infer_tp_allreduce_bytes_total")
        self._events = get_event_log()
        # serving health detectors; the perf accountant (cost cards per graph key, the goodput ledger, the HBM
        # pool gauges feeding the pressure detector)
        self._health = get_health_monitor()
        self._health.ensure_detector(QueueStallDetector())
        self._health.ensure_detector(SLOBurnRateDetector())
        self._health.ensure_detector(HBMPressureDetector())
        self._acct = get_perf_accountant()
        self._runners: Dict[str, object] = {}  # step family -> accounted dispatch
        self._static_costs: Dict[tuple, Dict[str, int]] = {}  # graph key -> shape part of its cost
        # the ops plane (DS_TPU_OPS_PORT) and the flight recorder (DS_TPU_FLIGHT_DIR): both off by default
        maybe_start_ops_server()
        rec = maybe_attach_flight_recorder(self._health)
        if rec is not None:
            rec.register_provider("residency", self._residency_summary)
            rec.register_provider("tensor_parallel", self.tp_manifest)
            rec.register_provider("jit_cache", lambda: {"enabled": False})  # no JIT on the port: no auditor
        # the device-timeline profiler: DS_TPU_PROFILE=1 arms a one-shot capture
        device_profiler.maybe_arm_profiler()

        # garbage page for padded-token KV writes (allocator's first pop is 0)
        self._garbage_block = self.state._allocator.allocate(1)[0]
        assert self._garbage_block == 0
        self.state.register_sanitizer_root(self._garbage_block)

        L, bs = cfg.n_layers, smc.kv_block_size
        pool_shape = (L, n_blocks, bs, cfg.kv_heads, cfg.head_dim)
        if self._tp > 1:  # this rank's KV heads of every global block (JAX shard_kv_pool)
            pool_shape = kv_pool_shard_shape(pool_shape, self._tp)
        self.k_pages = make_kv_pool(pool_shape, self.dtype, self.device, self._kv_quant_bits)
        self.v_pages = make_kv_pool(pool_shape, self.dtype, self.device, self._kv_quant_bits)
        self._max_blocks_per_seq = -(-smc.max_context // bs)
        # K+V bytes one block holds across every layer and every rank (codes + scales for an int8 pool): the
        # unit of COW copy traffic and of host-tier slot sizing; a rank holds 1/tp of it
        self._block_bytes = sum(t.numel() * t.element_size() for t in self._pool_leaves()) * self._tp // n_blocks
        # what a cost card's signature adds to a graph key: engines of other models share the process's accountant
        self._cost_sig = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.ffn_dim, cfg.vocab_size,
                          cfg.moe_num_experts, str(self.dtype), config.quant_bits, self._kv_quant_bits)
        # copies between steps, accounted in bytes: untimed, as they run inside another step's window
        block_cost = {"arg_bytes": self._block_bytes, "out_bytes": self._block_bytes}
        self._copy_block = self._acct.wrap("cow_copy", self._copy_block, timed=False,
                                           signature=lambda *a: self._cost_sig, cost=lambda *a: block_cost)
        self._gather_block = self._acct.wrap("kv_spill_gather", self._gather_block, timed=False,
                                             signature=lambda *a: self._cost_sig, cost=lambda *a: block_cost)
        self._readmit_block = self._acct.wrap("kv_readmit", self._readmit_block, timed=False,
                                              signature=lambda *a: self._cost_sig, cost=lambda *a: block_cost)
        # host spill tier: the prefix cache demotes LRU evictions to a host pool with a d2h copy and
        # re-admits radix matches with an h2d copy
        self._spill_mgr = None
        if self._kv_spill and self.state.prefix_cache is not None:
            from .ragged.host_tier import HostKVPool, SpillManager

            leaves = self._pool_leaves()
            host_pool = HostKVPool(
                max(1, (knobs.get_int("DS_TPU_KV_HOST_POOL_MB") << 20) // max(1, self._block_bytes)),
                [t.shape[:1] + t.shape[2:] for t in leaves],  # drop the block axis
                [t.dtype for t in leaves], pin=self.device.type == "cuda")
            self._spill_mgr = SpillManager(host_pool, self._gather_block, self.device)
            self.state.prefix_cache.attach_spill_tier(
                self._spill_mgr, self._readmit_block,
                watermark_blocks=int(knobs.get_float("DS_TPU_KV_SPILL_WATERMARK") * n_blocks))

        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            if isinstance(tree, QuantizedParam):  # quantised beforehand: codes and scales move as they are
                return dataclasses.replace(tree, q=tree.q.to(self.device), scales=tree.scales.to(self.device))
            t = torch.as_tensor(tree)
            return t.to(self.device, self.dtype) if t.is_floating_point() else t.to(self.device)

        self._tp_ctx = None
        specs = None
        if self._tp > 1:
            from ...parallel.mesh import mesh_signature

            params, specs = self._tp_shard(params)
            topo = self._mesh_topo
            self._tp_ctx = TPContext(tp=self._tp, rank=topo.axis_rank("tensor"), group=topo.process_group("tensor"),
                                     bits=self._tp_bits, interleave=self._tp, mesh=mesh_signature(topo))
        # the sharding signature ends every step key and sits in the journal fingerprint: toggling TP (or the
        # reduce's mode) never reaches a step built for another layout, nor replays across topologies
        self._shard_sig = self._tp_ctx.signature() if self._tp_ctx is not None else "tp1"
        self.params = place(params)
        if config.quant_bits:
            # quantise AFTER sharding (the reference's order): K-groups align to the shard edge
            self.params = quantize_for_serving(self.params, num_bits=config.quant_bits,
                                               group_size=config.quant_group_size, min_size=config.quant_min_size,
                                               specs=specs, tp=self._tp)
        self._weight_bytes = _tree_bytes(self.params)
        self._mods = build_modules(tp=self._tp_ctx)
        self._prefill_fn, self._decode_fn = make_step_fns(run_cfg, mods=self._mods)
        self._max_program_variants = max(1, knobs.get_int("DS_TPU_PROGRAM_CACHE"))
        self._bursts: Dict[tuple, object] = {}  # sampling signature -> burst function
        self._fused_fns: Dict[tuple, object] = {}  # (bucket shape, sampling) -> step function
        self._spec_fns: Dict[tuple, object] = {}  # (verify window, sampling) -> verify step function
        self._sampling = None  # (do_sample, temperature, top_k, top_p) during generate()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)
        # one captured graph per step key on the card; the pools and weights keep their storage for the
        # engine's life (the graphs hold their addresses). A gloo collective cannot be captured: under a gloo
        # group on CUDA the steps run eagerly
        self._tp_backend = None
        if self._tp > 1:
            self._tp_backend = "gloo" if named_backend() == "gloo" else "nccl" if self.device.type == "cuda" else "gloo"
        self._eager_steps = self.device.type != "cuda" or (self._tp > 1 and self._tp_backend == "gloo")
        self.graphs = None
        if self.device.type == "cuda":
            self.graphs = StepGraphs(self.device, self._max_program_variants,
                                     [f for f in self._mods if hasattr(f, "launches")])
        self.dispatches = 0  # steps run: graph replays, or eager step calls
        self.fused_quanta = 0
        self.decode_steps = 0  # decode steps run (a burst of k counts k; a verify step counts 1)
        self.decode_tokens = 0  # tokens those steps retired
        self.spec_proposed = 0  # draft tokens sent to verify steps
        self.spec_accepted = 0  # of those, accepted
        self._update_hbm_gauges()

    def _tp_shard(self, params) -> Tuple[Dict, Dict]:
        """This rank's slice of every leaf (``module_inject.shard_params``, with
        the column-parallel biases split too: ``SERVING_BIAS_RULES``) and the
        specs of the tree. A leaf that is already at its shard's shape is
        kept; any other shape than the whole or the shard's raises."""
        from ...module_inject.load_checkpoint import SERVING_BIAS_RULES, model_tp_rules, shard_to_rank

        rules = model_tp_rules(self.model) + SERVING_BIAS_RULES
        return shard_to_rank(params, self.cfg, rules, self._tp, self._mesh_topo.axis_rank("tensor"))

    # ---------------------------------------------------------- feasibility
    def query(self, uid: int, max_request_length: int) -> Tuple[int, int]:
        """(max new tokens schedulable, free KV blocks)."""
        seq = self.state.get_sequence(uid)
        free_tokens = self.state.available_blocks * self.state.block_size
        if seq is not None:
            free_tokens += seq.max_context - seq.seen_tokens
        return min(max_request_length, free_tokens), self.state.free_blocks

    def can_put(self, uid: int, tokens: Sequence[int]) -> bool:
        seq = self.state.get_sequence(uid)
        bs = self.state.block_size
        if seq is None:
            need = -(-len(tokens) // bs)
        else:
            need = seq.blocks_needed(len(tokens))
        return self.state.can_allocate(need)

    # ---------------------------------------------------------- core step
    def put(self, batch_uids: Sequence[int], batch_tokens: Sequence[Sequence[int]], return_tokens: bool = False,
            _defer: bool = False):
        """Run one engine step over a ragged batch; returns next-token logits
        (B, V) as numpy.

        Sequences with several tokens run as (chunked) prefill, one step per
        padded length bucket; known sequences with a single token join one
        paged-decode step. ``return_tokens=True`` chooses the tokens on the
        device (argmax, or a draw during a sampling ``generate``) and returns
        (B,) ids. ``_defer`` (the serving loop's): the same routing, but token
        entries may be 0-d device tensors and the return is a list of per-row
        device tensors, with no host sync.
        """
        if len(batch_uids) != len(batch_tokens):
            raise ValueError("uids and token lists must align")
        if len(set(batch_uids)) != len(batch_uids):
            # two chunks of one sequence in one step would read the same start position and overwrite each
            # other's KV slots: the scheduler never emits this
            raise ValueError("duplicate uid in one put() batch: submit a sequence's chunks in separate steps")
        by_idx: Dict[int, object] = {}
        decode_idx: List[int] = []
        prefill_groups: Dict[int, List[int]] = {}  # padded length bucket -> indices
        for i, (uid, toks) in enumerate(zip(batch_uids, batch_tokens)):
            seq = self.state.get_sequence(uid)
            if seq is not None and len(toks) == 1:
                decode_idx.append(i)
            else:
                prefill_groups.setdefault(max(16, _next_pow2(len(toks))), []).append(i)

        # prefills sharing a length bucket run as one step
        for S, idxs in prefill_groups.items():
            rows = self._run_prefill_batch([batch_uids[i] for i in idxs], [list(batch_tokens[i]) for i in idxs], S,
                                           return_tokens=return_tokens, defer=_defer)
            for j, i in enumerate(idxs):
                by_idx[i] = rows[j]

        if decode_idx:
            uids = [batch_uids[i] for i in decode_idx]
            carried = [batch_tokens[i][0] for i in decode_idx]
            if _defer:
                # device scalars stack into the input ids without a host sync
                head = self._ids_from_carry(carried, self._decode_bucket(len(uids)))
                out = self._run_decode(uids, [0] * len(uids), return_tokens=return_tokens, ids_dev=head, defer=True)
            else:
                out = self._run_decode(uids, [int(t) for t in carried], return_tokens=return_tokens)
            for j, i in enumerate(decode_idx):
                by_idx[i] = out[j]
        if _defer:
            return [by_idx[i] for i in range(len(batch_uids))]
        return np.stack([by_idx[i] for i in range(len(batch_uids))])

    def flush(self, uids: Sequence[int]) -> None:
        for uid in uids:
            self.state.flush_sequence(uid)

    # ---------------------------------------------------------- internals
    def _seq_block_row(self, seq) -> np.ndarray:
        return self.state.block_table_row(seq, self._max_blocks_per_seq, self._garbage_block)

    def _garbage_slots(self, n: int) -> np.ndarray:
        # round-robin within the garbage page so padded writes stay cheap
        return (self._garbage_block * self.state.block_size + np.arange(n) % self.state.block_size).astype(np.int32)

    def _copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write page copy: duplicate block ``src`` into ``dst`` across
        every layer's K/V pool, in place (the pools keep their storage). An
        int8 pool copies the block's scale plane with its codes, so the copy
        dequantises to the same values."""
        idx = torch.tensor([dst], dtype=torch.long, device=self.device)
        for t in self._pool_leaves():
            t.index_copy_(1, idx, t[:, src:src + 1].clone())
        self._m_cow_bytes.inc(self._block_bytes)
        self._acct.note_cow(self._block_bytes)

    def _cow_ready(self, seq, start_pos: int) -> None:
        self.state.ensure_writable(seq, start_pos, self._copy_block)

    def _pool_leaves(self) -> List[torch.Tensor]:
        """The K/V pool tensors in the reference's leaf order: K then V, each
        one plain tensor or int8 codes then fp32 scales."""
        return [t for pool in (self.k_pages, self.v_pages) for t in (pool if isinstance(pool, tuple) else (pool,))]

    # ----------------------------------------------------- host spill tier
    def _gather_block(self, block: int) -> List[torch.Tensor]:
        """Snapshot of one block's pages across every pool leaf: one
        contiguous ``(L, 1, ...)`` copy a leaf, on the stream the steps run
        on, so a later step's in-place write to the pools cannot race the
        d2h that reads it (the reference's gather, ``engine_v2.py:582``)."""
        return [t[:, block:block + 1].clone() for t in self._pool_leaves()]

    def _readmit_block(self, block: int, host_leaves: Sequence[torch.Tensor]) -> None:
        """Re-admission h2d: copy one host-tier block's leaves back into the
        device pools at ``block`` (the reference's scatter,
        ``engine_v2.py:597``), on the stream the steps run on. The prefix
        cache frees the host slot right after; the slot's next write is
        ordered after this copy (``HostKVPool.free_slot``)."""
        cuda = self.device.type == "cuda"
        for t, h in zip(self._pool_leaves(), host_leaves):
            t[:, block].copy_(h.to(self.device, non_blocking=cuda))

    def _to_device(self, *arrays: np.ndarray) -> List[torch.Tensor]:
        """int32 host arrays -> device tensors of the same shapes, in one copy."""
        flat = np.concatenate([np.asarray(a, np.int32).reshape(-1) for a in arrays])
        buf = torch.from_numpy(flat)
        if self.device.type == "cuda":
            buf = buf.pin_memory()
        buf = buf.to(self.device, non_blocking=True)
        out, off = [], 0
        for a in arrays:
            out.append(buf[off:off + a.size].view(a.shape))
            off += a.size
        return out

    def _dispatch(self, key: tuple, step, arrays: Sequence[np.ndarray], rows: Tuple[np.ndarray, np.ndarray],
                  sampled: bool = False, head: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run ``step(*inputs, generator)`` over the int32 host ``arrays``; the
        first ``head.numel()`` entries of the first input come from the device
        tensor ``head`` instead (the deferred token carry). A CUDA engine
        replays the captured graph of ``key`` (capturing ``step`` the first
        time); a CPU engine, or one with ``_eager_steps`` set, calls ``step``.
        ``sampled``: the step draws from the engine's generator. ``rows``
        (query counts, context ends) of the real rows price the step's
        attention (``_step_cost``). The perf accountant's card of the step
        is the graph key's; its wall window opens here and closes at the
        caller's ``attribute``."""
        self.dispatches += 1
        self._m_dispatches.inc()
        run = self._runners.get(key[0])
        if run is None:
            run = self._runners[key[0]] = self._acct.wrap(
                key[0], self._run_step, signature=lambda key, *a: key + self._cost_sig,
                cost=lambda key, step, arrays, rows, *a: self._step_cost(key, arrays, rows))
        return run(key, step, arrays, rows, sampled, head)

    def _run_step(self, key: tuple, step, arrays: Sequence[np.ndarray], rows, sampled: bool,
                  head: Optional[torch.Tensor]) -> torch.Tensor:
        if self._eager_steps:
            inputs = self._to_device(*arrays)
            if head is not None:
                inputs[0].view(-1)[:head.numel()] = head
            return step(*inputs, self._generator)
        return self.graphs.run(key, step, arrays, self._generator if sampled else None, head)

    def _step_cost(self, key: tuple, arrays: Sequence[np.ndarray], rows: Tuple[np.ndarray, np.ndarray]) -> Dict:
        """A step's cost from shapes: the forward passes its graph key implies
        (token rows through the layers, rows through the LM head;
        ``forward_macs``), attention over the real rows' visible pairs
        (``attention_macs``: ``rows`` holds each row's query count and context
        end), the bytes of the weights and inputs read and of the output
        and new KV written. No device value is read."""
        cfg = self.cfg
        static = self._static_costs.get(key)
        if static is None:
            kind = key[0]
            vocab_out = cfg.vocab_size * 4  # fp32 logits a row
            if kind == "prefill":
                B, S = key[1], key[2]
                passes, out = [(B * S, B)], B * vocab_out
            elif kind == "decode":
                B = key[1]
                passes, out = [(B, B)], B * vocab_out
            elif kind == "burst":
                B, steps = key[1], key[2]
                passes, out = [(B, B)] * steps, B * steps * 4
            elif kind == "fused":
                D, P, S, steps = key[1:5]
                N = D + P
                passes, out = [(D + P * S, N)] + [(N, N)] * (steps - 1), N * steps * 4
            else:  # spec: every position of the verify window reaches the head
                B, chunk = key[1], key[2]
                passes, out = [(B * chunk, B * chunk)], B * (chunk + 1) * 4
            macs = sum(forward_macs(cfg, t, h) for t, h in passes)
            kv_token_bytes = self._block_bytes // self.state.block_size
            static = self._static_costs[key] = {
                "flops": 2 * macs, "macs": macs,
                "arg_bytes": self._weight_bytes + sum(int(np.asarray(a).nbytes) for a in arrays),
                "out_bytes": out + kv_token_bytes * sum(t for t, _ in passes)}
        return dict(static, attn_flops=2 * attention_macs(cfg, *rows))

    def _account_tp_allreduce(self, tokens: int) -> None:
        """The bytes of one step's row-parallel reduces (JAX
        ``_account_tp_allreduce``): every padded token crosses the two reduces
        of each layer, d_model elements each, at the quantised width when
        ``DS_TPU_TP_ALLREDUCE_BITS`` is set, else at the activation dtype's.
        Host arithmetic; nothing at tp 1."""
        if self._tp <= 1 or tokens <= 0:
            return
        nbits = self._tp_bits or torch.empty((), dtype=self.dtype).element_size() * 8
        self._m_tp_bytes.inc(tokens * self.cfg.d_model * 2 * self.cfg.n_layers * nbits // 8)

    def tp_manifest(self) -> Dict:
        """The tensor-parallel section of the flight manifest: the degree, this
        rank, the backend the reduces run on (named gloo on CUDA: host-staged),
        and whether the steps replay CUDA graphs or run eagerly (always eagerly
        under gloo, which a graph cannot capture)."""
        return {"tensor_parallel": self._tp, "rank": self._tp_ctx.rank if self._tp_ctx is not None else 0,
                "backend": self._tp_backend, "allreduce_bits": self._tp_bits, "shard_sig": self._shard_sig,
                "steps": "eager" if self._eager_steps else "graphs"}

    def _residency_summary(self) -> Dict:
        """Allocator / prefix-cache / host-tier residency: the flight
        recorder's view of where every KV block lives at capture time. Under
        tensor parallelism a rank holds 1/tp of each block's bytes (block
        tables are the same on every rank)."""
        pc = self.state.prefix_cache
        return {"kv_blocks_total": self._n_kv_blocks, "kv_blocks_free": int(self.state.free_blocks),
                "block_bytes": int(self._block_bytes), "tp_degree": int(self._tp),
                "block_bytes_per_shard": int(self.state.shard_geometry(self._block_bytes,
                                                                         self._tp)["block_bytes_per_shard"]),
                "kv_quant_bits": int(self._kv_quant_bits),
                "prefix_cached_blocks": int(pc.cached_blocks) if pc is not None else 0,
                "host_tier_bytes": int(pc.host_tier_bytes) if pc is not None else 0}

    def _update_hbm_gauges(self) -> None:
        """Refresh the per-pool HBM gauges (weights, paged KV, prefix-held
        blocks, host-tier bytes) and feed the pressure detector: host
        arithmetic over known sizes; on the card the limit is the card's
        memory and the caching allocator's statistics ride along. No device
        sync, except the one-scalar ``kv_quant_dequant_error`` readback on an
        int8 pool (at construction and once per ``generate``)."""
        if not self._acct.enabled:
            return
        weights = self._weight_bytes
        pages = sum(t.numel() * t.element_size() for t in self._pool_leaves())
        pc = self.state.prefix_cache
        prefix = pc.cached_blocks * self._block_bytes if pc is not None else 0
        host_spill = pc.host_tier_bytes if pc is not None else 0
        limit, alloc = 0, {}
        if self.device.type == "cuda":
            limit = torch.cuda.get_device_properties(self.device).total_memory
            stats = torch.cuda.memory_stats(self.device)
            alloc = {"allocator_allocated": stats.get("allocated_bytes.all.current", 0),
                     "allocator_reserved": stats.get("reserved_bytes.all.current", 0),
                     "allocator_peak": stats.get("allocated_bytes.all.peak", 0)}
        pressure = self._acct.set_hbm(limit=limit, weights=weights, kv_pages=pages, prefix=prefix,
                                      host_spill=host_spill, **alloc)
        self._health.observe_hbm(pressure, weights_bytes=weights, kv_pages_bytes=pages)
        if self._kv_quant_bits == 8:
            # expected RMS dequant error of live pages: a uniform quantiser with step = scale has RMS error
            # scale / sqrt(12); averaged over written (scale > 0; scales are never negative) slot-heads of both pools
            sk, sv = self.k_pages[1], self.v_pages[1]
            live = torch.count_nonzero(sk) + torch.count_nonzero(sv)
            err = (sk.sum() + sv.sum()) / torch.clamp_min(live, 1) / (12.0 ** 0.5)
            self._m_quant_err.set(float(err))  # one scalar, once per generate

    def _sampling_key(self) -> tuple:
        return self._sampling or (False, 1.0, 0, 1.0)

    def _choose_tokens_dev(self, logits: torch.Tensor) -> torch.Tensor:
        """Token choice on the device for (n, V) logits: argmax, or a draw from
        the engine's generator during a sampling ``generate``. Returns (n,)
        int32 on the device."""
        if self._sampling is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        do, t, k, p = self._sampling
        return sample_logits(logits, self._generator, do, t, k, p).to(torch.int32)

    def _choose_tokens(self, logits: torch.Tensor) -> np.ndarray:
        # the unfused loop's per-step fetch: n ints, not n * V logits
        return self._choose_tokens_dev(logits).cpu().numpy()

    def _run_prefill_batch(self, uids: List[int], token_lists: List[List[int]], S: int, return_tokens: bool = False,
                           defer: bool = False):
        """Prefill a bucket of sequence chunks (each possibly with prior
        context) in one step; the batch pads to a power of two. Padded rows
        write their KV to the garbage page and their outputs are dropped."""
        n = len(uids)
        B = _next_pow2(n)
        bs = self.state.block_size
        # validate the WHOLE bucket before mutating any state
        total_need = 0
        for uid, tokens in zip(uids, token_lists):
            seq = self.state.get_sequence(uid)
            seen = (seq.seen_tokens + seq.in_flight_tokens) if seq is not None else 0
            if seen + len(tokens) > self.state.max_context:
                raise RuntimeError(f"sequence {uid}: {seen + len(tokens)} tokens exceeds max_context "
                                   f"{self.state.max_context}")
            if seq is not None:
                total_need += seq.blocks_needed(len(tokens)) + seq.cow_blocks_needed(seen)
            else:
                total_need += -(-len(tokens) // bs)
        if not self.state.can_allocate(total_need):
            raise RuntimeError(f"prefill bucket needs {total_need} KV blocks, {self.state.free_blocks} free")
        ids = np.zeros((B, S), np.int32)
        positions = np.zeros((B, S), np.int32)
        slots = np.tile(self._garbage_slots(S), B).reshape(B, S)
        ctx = np.ones((B,), np.int32)
        bt = np.full((B, self._max_blocks_per_seq), self._garbage_block, np.int32)
        last = np.zeros((B,), np.int32)
        seqs = []
        for j, (uid, tokens) in enumerate(zip(uids, token_lists)):
            seq = self.state.get_or_create_sequence(uid)
            self._cow_ready(seq, seq.seen_tokens)
            self.state.allocate_for(seq, len(tokens))
            self.state.sanitize_write(seq, seq.seen_tokens, len(tokens))
            seq.record_tokens(tokens)
            seq.pre_forward(len(tokens))
            start, m = seq.seen_tokens, len(tokens)
            ids[j, :m] = tokens
            pos = start + np.arange(m)
            positions[j, :m] = pos
            slots[j, :m] = np.asarray(seq.blocks, np.int32)[pos // bs] * bs + pos % bs
            ctx[j] = start + m
            bt[j] = self._seq_block_row(seq)
            last[j] = m - 1
            seqs.append(seq)

        fn, params, kp, vp = self._prefill_fn, self.params, self.k_pages, self.v_pages

        def step(ids, positions, bt, ctx, slots, last, generator):
            return fn(params, ids, positions, kp, vp, bt, ctx, slots, last)[0]

        useful = sum(len(t) for t in token_lists)
        with telemetry_span("infer/prefill", bucket=S, rows=n):
            logits = self._dispatch(("prefill", B, S, self._shard_sig), step, [ids, positions, bt, ctx, slots.reshape(-1), last],
                                    rows=(last[:n] + 1, ctx[:n]))
        self._m_prefill_tokens.inc(useful)
        self._m_prefill_fill.set(n / B)
        self._account_tp_allreduce(B * S)
        for seq in seqs:
            seq.post_forward()
        if defer:
            out_dev = self._choose_tokens_dev(logits[:n])  # device (n,) ids, no readback
            self._acct.attribute(useful, B * S)
            device_profiler.note_quantum("prefill", rows=n, bucket=S, tokens=useful)
            return out_dev
        out = self._choose_tokens(logits[:n]) if return_tokens else logits[:n].cpu().numpy()
        # the attribution window closes after the readback: the wall time covers the device's work
        self._acct.attribute(useful, B * S)
        device_profiler.note_quantum("prefill", rows=n, bucket=S, tokens=useful)
        return [out[j] for j in range(n)]

    def _decode_bucket(self, n: int) -> int:
        return max(self._config.min_decode_bucket, _next_pow2(n))

    def _assemble_decode(self, uids: List[int], tokens: List[int], steps: int):
        """Decode-batch assembly for single steps and bursts: allocates
        ``steps`` KV tokens per sequence and builds the padded (ids,
        positions, ctx, block tables, (steps, B) slot table, last) arrays;
        padded rows write every step's KV into the garbage page."""
        n = len(uids)
        B = self._decode_bucket(n)
        bs = self.state.block_size
        ids = np.zeros((B, 1), np.int32)
        positions = np.zeros((B, 1), np.int32)
        ctx = np.zeros((B,), np.int32)
        bt = np.full((B, self._max_blocks_per_seq), self._garbage_block, np.int32)
        slots = np.tile(self._garbage_slots(B)[None], (steps, 1))
        seqs = []
        step_idx = np.arange(steps)
        for j, (uid, tok) in enumerate(zip(uids, tokens)):
            seq = self.state.get_sequence(uid)
            self._cow_ready(seq, seq.seen_tokens)
            self.state.allocate_for(seq, steps)
            self.state.sanitize_write(seq, seq.seen_tokens, steps)
            seq.record_tokens(None)  # decode ids may be device-side: freeze the log
            seq.pre_forward(steps)
            pos0 = seq.seen_tokens
            ids[j, 0] = tok
            positions[j, 0] = pos0
            ctx[j] = pos0 + 1
            bt[j] = self._seq_block_row(seq)
            p = pos0 + step_idx
            slots[:, j] = np.asarray(seq.blocks, np.int32)[p // bs] * bs + p % bs
            seqs.append(seq)
        last = np.zeros((B,), np.int32)
        return ids, positions, ctx, bt, slots, last, seqs, n

    def _ids_from_carry(self, carried, B: int) -> torch.Tensor:
        """(B,) int32 decode input ids on the device from per-sequence device
        scalars, padded with zeros (padded rows feed the garbage page): the
        deferred loop's stand-in for writing host ints into the ids."""
        col = [torch.as_tensor(t, dtype=torch.int32, device=self.device).reshape(()) for t in carried]
        col.extend([torch.zeros((), dtype=torch.int32, device=self.device)] * (B - len(carried)))
        return torch.stack(col)

    def _run_decode(self, uids: List[int], tokens: List[int], return_tokens: bool = False,
                    ids_dev: Optional[torch.Tensor] = None, defer: bool = False):
        ids, positions, ctx, bt, slots, last, seqs, n = self._assemble_decode(uids, tokens, steps=1)
        fn, params, kp, vp = self._decode_fn, self.params, self.k_pages, self.v_pages

        def step(ids, positions, bt, ctx, slots, last, generator):
            return fn(params, ids, positions, kp, vp, bt, ctx, slots, last)[0]

        with telemetry_span("infer/decode", rows=n):
            logits = self._dispatch(("decode", len(ctx), self._shard_sig), step, [ids, positions, bt, ctx, slots[0], last],
                                    rows=(np.ones(n, np.int64), ctx[:n]), head=ids_dev)
        self.decode_steps += 1
        self.decode_tokens += n
        self._account_tp_allreduce(len(ctx))
        self._m_decode_steps.inc()
        self._m_decode_tokens.inc(n)
        self._m_decode_fill.set(n / len(ctx))
        if self._events.enabled:
            q = self.scheduler.last_quantum_id
            for uid in uids:
                self._events.emit("decode", uid, q=q, k=1)
        for seq in seqs:
            seq.post_forward()
        if defer:
            out_dev = self._choose_tokens_dev(logits[:n])  # device (n,) ids, no readback
            self._acct.attribute(n, len(ctx))
            device_profiler.note_quantum("decode", rows=n)
            return out_dev
        out = self._choose_tokens(logits[:n]) if return_tokens else logits[:n].cpu().numpy()
        self._acct.attribute(n, len(ctx))
        device_profiler.note_quantum("decode", rows=n)
        return out

    def _burst_steps(self, live: Dict[int, int], remaining: int) -> int:
        """Largest power-of-two burst length every live sequence can take
        (0: no burst)."""
        if self._config.decode_burst < 2 or not live:
            return 0
        cap = min(remaining, self._config.decode_burst,
                  *(self._config.state_manager.max_context - self.state.get_sequence(u).seen_tokens
                    for u in live))
        k = 1
        while k * 2 <= cap:
            k *= 2
        while k >= 2:
            need = sum(self.state.get_sequence(u).blocks_needed(k) for u in live)
            if self.state.can_allocate(need):
                return k
            k //= 2
        return 0

    def _step_fn(self, family: Dict[tuple, object], key: tuple, make):
        """The step function of ``key`` in one family's cache (``make()`` builds
        it on a miss), LRU-bounded by ``DS_TPU_PROGRAM_CACHE``."""
        if key in family:
            family[key] = family.pop(key)  # LRU touch
        else:
            if len(family) >= self._max_program_variants:
                family.pop(next(iter(family)))
            family[key] = make()
        return family[key]

    def _burst_for(self, sampling):
        """The burst function per sampling signature (greedy = None); None when
        bursting is off."""
        if self._config.decode_burst < 2:
            return None
        do, t, k, p = sampling = sampling or (False, 1.0, 0, 1.0)
        return self._step_fn(self._bursts, sampling + (self._shard_sig,), lambda: make_burst_fn(
            self._run_cfg, do_sample=do, temperature=t, top_k=k, top_p=p, mods=self._mods))

    def _run_decode_burst(self, uids: List[int], tokens: List[int], steps: int, ids_dev: Optional[torch.Tensor] = None,
                          defer: bool = False):
        """``steps`` decode steps in one step function; returns (len(uids),
        steps) tokens (a device tensor when ``defer``, numpy otherwise)."""
        ids, positions, ctx, bt, slots, last, seqs, n = self._assemble_decode(uids, tokens, steps)
        fn, params, kp, vp = self._burst_for(self._sampling), self.params, self.k_pages, self.v_pages

        def step(ids, positions, bt, ctx, slots, last, generator):
            return fn(params, ids, positions, kp, vp, bt, ctx, slots, last, generator)[0]

        with telemetry_span("infer/decode_burst", rows=n, steps=steps):
            toks = self._dispatch(("burst", len(ctx), steps) + self._sampling_key() + (self._shard_sig,), step,
                                  [ids, positions, bt, ctx, slots, last], rows=(np.full(n, steps), ctx[:n] + steps - 1),
                                  sampled=self._sampling is not None, head=ids_dev)
        self.decode_steps += steps
        self.decode_tokens += n * steps
        self._account_tp_allreduce(len(ctx) * steps)
        self._m_bursts.inc()
        self._m_decode_steps.inc(steps)
        self._m_decode_tokens.inc(n * steps)
        self._m_decode_fill.set(n / len(ctx))
        # out-of-band burst: claims its own quantum id (no schedule call)
        q = self.scheduler.next_quantum()
        if self._events.enabled:
            for uid in uids:
                self._events.emit("decode", uid, q=q, k=steps)
        journal = get_journal()
        if journal is not None and journal.active:
            journal.record_quantum(q, uids, [], steps=steps)
        for seq in seqs:
            seq.post_forward()
        out = toks[:n] if defer else toks[:n].cpu().numpy()  # deferred: device (n, steps), no readback
        self._acct.attribute(n * steps, len(ctx) * steps)
        device_profiler.note_quantum("decode_burst", rows=n, steps=steps)
        return out

    # ---------------------------------------------------------- fused quantum
    def _fused_bucket(self, n_dec: int, n_pre: int, max_chunk: int) -> Tuple[int, int, int]:
        """Padded (decode rows, prefill rows, chunk) bucket for a quantum: the
        decode segment rides the decode bucket floor, prefill rows pad to a
        power of two, the chunk pads like the prefill buckets (single-token
        tail chunks keep chunk == 1: they are decode-shaped)."""
        D = self._decode_bucket(n_dec) if n_dec else 0
        P = _next_pow2(n_pre) if n_pre else 0
        if n_pre == 0:
            S = 0
        elif max_chunk == 1:
            S = 1
        else:
            S = max(16, _next_pow2(max_chunk))
        return D, P, S

    def _fused_for(self, n_dec: int, n_pre: int, chunk: int, sampling):
        """The step function of a padded bucket shape and sampling signature."""
        do, t, k, p = sampling = sampling or (False, 1.0, 0, 1.0)
        return self._step_fn(self._fused_fns, (n_dec, n_pre, chunk) + sampling + (self._shard_sig,), lambda: make_fused_step_fn(
            self._run_cfg, n_dec=n_dec, n_pre=n_pre, chunk=chunk, do_sample=do, temperature=t, top_k=k, top_p=p,
            mods=self._mods))

    def _run_fused(self, quantum: FusedQuantum, decode_carry: List, steps: int, defer: bool,
                   eos_token_id: Optional[int]) -> Dict[int, object]:
        """One step for a whole scheduler quantum: decode rows and chunked-
        prefill rows run as one flat ragged batch, then the batch advances
        ``steps - 1`` more decode steps (pure-decode quanta only). On the card
        the step is the captured graph of (bucket, ``steps``, EOS id,
        sampling).

        Returns uid -> (steps,) token row (device tensor when ``defer``, numpy
        otherwise), or None for a mid-prompt prefill chunk.
        """
        dec_uids = quantum.decode_uids
        prefills = quantum.prefills
        n_dec, n_pre = len(dec_uids), len(prefills)
        assert steps == 1 or n_pre == 0, "multi-step bursts are pure-decode"
        max_chunk = max((len(p.tokens) for p in prefills), default=0)
        D, P, S = self._fused_bucket(n_dec, n_pre, max_chunk)
        T = D + P * S
        N = D + P
        bs = self.state.block_size

        # validate the WHOLE quantum before mutating any state
        total_need = 0
        for uid in dec_uids:
            seq = self.state.get_sequence(uid)
            if seq.seen_tokens + seq.in_flight_tokens + steps > self.state.max_context:
                raise RuntimeError(f"sequence {uid}: {seq.seen_tokens + steps} tokens exceeds "
                                   f"max_context {self.state.max_context}")
            total_need += seq.blocks_needed(steps) + seq.cow_blocks_needed(seq.seen_tokens)
        for pf in prefills:
            seq = self.state.get_sequence(pf.uid)
            seen = (seq.seen_tokens + seq.in_flight_tokens) if seq is not None else 0
            if seen + len(pf.tokens) > self.state.max_context:
                raise RuntimeError(f"sequence {pf.uid}: {seen + len(pf.tokens)} tokens exceeds "
                                   f"max_context {self.state.max_context}")
            if seq is not None:
                total_need += seq.blocks_needed(len(pf.tokens)) + seq.cow_blocks_needed(seen)
            else:
                total_need += -(-len(pf.tokens) // bs)
        if not self.state.can_allocate(total_need):
            raise RuntimeError(f"fused quantum needs {total_need} KV blocks, {self.state.free_blocks} free")

        ids = np.zeros((T,), np.int32)
        positions = np.zeros((T,), np.int32)
        slots0 = self._garbage_slots(T)
        ctx = np.ones((N,), np.int32)
        bt = np.full((N, self._max_blocks_per_seq), self._garbage_block, np.int32)
        last = np.zeros((N,), np.int32)
        gslots = self._garbage_slots(N)
        adv = np.tile(gslots[None], (steps - 1, 1))
        step_idx = np.arange(1, steps)
        seqs = []

        for j, uid in enumerate(dec_uids):
            seq = self.state.get_sequence(uid)
            self._cow_ready(seq, seq.seen_tokens)
            self.state.allocate_for(seq, steps)
            self.state.sanitize_write(seq, seq.seen_tokens, steps)
            seq.record_tokens(None)  # decode ids may be device-side: freeze the log
            seq.pre_forward(steps)
            pos0 = seq.seen_tokens
            blocks = np.asarray(seq.blocks, np.int32)
            if not defer:
                ids[j] = int(decode_carry[j])
            positions[j] = pos0
            ctx[j] = pos0 + 1
            bt[j] = self._seq_block_row(seq)
            last[j] = j
            slots0[j] = blocks[pos0 // bs] * bs + pos0 % bs
            if steps > 1:
                p = pos0 + step_idx
                adv[:, j] = blocks[p // bs] * bs + p % bs
            seqs.append(seq)

        for r, pf in enumerate(prefills):
            seq = self.state.get_or_create_sequence(pf.uid)
            m = len(pf.tokens)
            self._cow_ready(seq, seq.seen_tokens)
            self.state.allocate_for(seq, m)
            self.state.sanitize_write(seq, seq.seen_tokens, m)
            seq.record_tokens(pf.tokens)
            seq.pre_forward(m)
            start = seq.seen_tokens
            blocks = np.asarray(seq.blocks, np.int32)
            base, row = D + r * S, D + r
            ids[base:base + m] = pf.tokens
            pos = start + np.arange(m)
            positions[base:base + m] = pos
            slots0[base:base + m] = blocks[pos // bs] * bs + pos % bs
            ctx[row] = start + m
            bt[row] = self._seq_block_row(seq)
            last[row] = base + m - 1
            seqs.append(seq)

        # device token scalars from the previous quantum stack into the decode
        # segment without a host sync; padded rows feed the garbage page
        head = self._ids_from_carry(decode_carry, D) if n_dec and defer else None
        fn, params, kp, vp = self._fused_for(D, P, S, self._sampling), self.params, self.k_pages, self.v_pages
        eos = -1 if eos_token_id is None else int(eos_token_id)

        def step(ids, positions, bt, ctx, slots0, last, adv, gslots, generator):
            return fn(params, ids, positions, kp, vp, bt, ctx, slots0, last, adv, gslots, eos, generator)[0]

        q_lens = np.concatenate([np.full(n_dec, steps), [len(p.tokens) for p in prefills]]).astype(np.int64)
        ctx_end = np.concatenate([ctx[:n_dec] + steps - 1, ctx[D:D + n_pre]])
        with telemetry_span("infer/fused_step", rows=N, tokens=T, steps=steps):
            toks = self._dispatch(("fused", D, P, S, steps, eos) + self._sampling_key() + (self._shard_sig,), step,
                                  [ids, positions, bt, ctx, slots0, last, adv, gslots], rows=(q_lens, ctx_end),
                                  sampled=self._sampling is not None, head=head)
        self.fused_quanta += 1
        self._m_fused_quanta.inc()
        self._account_tp_allreduce(D * steps + P * S)
        real = n_dec * steps + sum(len(p.tokens) for p in prefills)
        self._m_fused_fill.set(real / max(1, D * steps + P * S))
        if self._events.enabled and dec_uids:
            q = self.scheduler.last_quantum_id
            for uid in dec_uids:
                self._events.emit("decode", uid, q=q, k=steps)
        if n_dec:
            self.decode_steps += steps
            self.decode_tokens += n_dec * steps
            self._m_decode_steps.inc(steps)
            self._m_decode_tokens.inc(n_dec * steps)
        if prefills:
            self._m_prefill_tokens.inc(sum(len(p.tokens) for p in prefills))
        for seq in seqs:
            seq.post_forward()

        # non-deferred mode fetches the quantum's tokens in ONE readback
        toks_host = None if defer else toks.cpu().numpy()
        self._acct.attribute(real, D * steps + P * S)
        device_profiler.note_quantum("fused_step", rows=N, tokens=real, steps=steps)
        out: Dict[int, object] = {}
        for j, uid in enumerate(dec_uids):
            out[uid] = toks[j] if defer else toks_host[j]
        for r, pf in enumerate(prefills):
            if pf.final:
                out[pf.uid] = toks[D + r] if defer else toks_host[D + r]
            else:
                out[pf.uid] = None
        return out

    # ---------------------------------------------------------- speculative decode
    def _spec_for(self, chunk: int, sampling):
        """The verify step function of a verify window and sampling signature
        (the padded row count is part of the graph key only)."""
        do, t, k, p = sampling = sampling or (False, 1.0, 0, 1.0)
        return self._step_fn(self._spec_fns, (chunk,) + sampling + (self._shard_sig,), lambda: make_spec_verify_fn(
            self._run_cfg, chunk=chunk, do_sample=do, temperature=t, top_k=k, top_p=p, mods=self._mods))

    def _run_spec_step(self, uids: List[int], carries: List[int], histories: List[Sequence[int]],
                       budgets: List[int]) -> Optional[Dict[int, List[int]]]:
        """One draft -> verify quantum over pure-decode rows.

        The drafter proposes up to K tokens a row from its prompt + generated
        history (at most ``budget - 1`` and what ``max_context`` leaves); the
        verify window is ``chunk = min(K, next_pow2(longest draft)) + 1``
        (carry token + drafts), so short drafts take a small window. One step
        runs every admitted row as a ``chunk``-token chunked prefill that
        writes the window's KV, and ``select_committed`` picks each row's
        accepted prefix and bonus token on the device; the host reads back
        one (B, chunk + 1) int32 block. The rejected tail positions roll back
        (``DSStateManager.rollback_tokens``).

        Returns uid -> committed tokens (1..chunk each) for the rows that
        ran, or None when no row drafted anything or none was admitted: the
        caller then runs a plain decode step.
        """
        K = self._spec_k
        drafts: List[List[int]] = []
        for uid, hist, budget in zip(uids, histories, budgets):
            seq = self.state.get_sequence(uid)
            cap = min(K, budget - 1, self.state.max_context - seq.seen_tokens - 1)
            d = self._drafter.propose(hist, cap) if cap > 0 else []
            drafts.append([int(t) for t in d[:max(0, cap)]])
        kmax = max((len(d) for d in drafts), default=0)
        if kmax == 0:
            return None  # nothing to verify: plain decode is cheaper
        chunk = min(K, _next_pow2(kmax)) + 1
        admitted, q = self.scheduler.schedule_spec(uids, chunk)
        if not admitted:
            return None
        by_uid = {u: i for i, u in enumerate(uids)}
        n = len(admitted)
        B = self._decode_bucket(n)
        T = B * chunk
        bs = self.state.block_size

        ids = np.zeros((T,), np.int32)
        positions = np.tile(np.arange(chunk, dtype=np.int32), B)
        slots = self._garbage_slots(T)
        ctx = np.full((B,), chunk, np.int32)  # padded rows attend inside the garbage page
        bt = np.full((B, self._max_blocks_per_seq), self._garbage_block, np.int32)
        n_draft = np.zeros((B,), np.int32)
        seqs = []
        for j, uid in enumerate(admitted):
            i = by_uid[uid]
            seq = self.state.get_sequence(uid)
            self._cow_ready(seq, seq.seen_tokens)
            self.state.allocate_for(seq, chunk)
            self.state.sanitize_write(seq, seq.seen_tokens, chunk)
            seq.record_tokens(None)  # the committed tokens are known only after the verify
            seq.pre_forward(chunk)
            pos0 = seq.seen_tokens
            blocks = np.asarray(seq.blocks, np.int32)
            d = drafts[i]
            base = j * chunk
            ids[base] = int(carries[i])
            ids[base + 1:base + 1 + len(d)] = d
            pos = pos0 + np.arange(chunk)
            positions[base:base + chunk] = pos
            slots[base:base + chunk] = blocks[pos // bs] * bs + pos % bs
            ctx[j] = pos0 + chunk
            bt[j] = self._seq_block_row(seq)
            n_draft[j] = len(d)
            seqs.append(seq)

        fn, params, kp, vp = self._spec_for(chunk, self._sampling), self.params, self.k_pages, self.v_pages

        def step(ids, positions, bt, ctx, slots, n_draft, generator):
            return fn(params, ids, positions, kp, vp, bt, ctx, slots, n_draft, generator)[0]

        with telemetry_span("infer/spec_verify", rows=n, k=chunk - 1):
            packed = self._dispatch(("spec", B, chunk) + self._sampling_key() + (self._shard_sig,), step,
                                    [ids, positions, bt, ctx, slots, n_draft], rows=(np.full(n, chunk), ctx[:n]),
                                    sampled=self._sampling is not None)
        self._m_decode_steps.inc()
        self._m_decode_fill.set(n / B)
        self._account_tp_allreduce(B * chunk)
        packed = packed[:n].cpu().numpy()  # committed ids and the accepted count: the whole readback
        for seq in seqs:
            seq.post_forward()

        out: Dict[int, List[int]] = {}
        total_acc = 0
        for j, uid in enumerate(admitted):
            acc = int(packed[j, chunk])
            self.state.rollback_tokens(seqs[j], chunk - acc - 1)
            out[uid] = [int(t) for t in packed[j, :acc + 1]]
            total_acc += acc
            self._events.emit("decode", uid, q=q, k=acc + 1, accepted=acc, proposed=int(n_draft[j]))
        total_prop = int(n_draft[:n].sum())
        # useful = committed tokens (carry + accepted drafts); slots = the whole padded verify window the step ran
        self._acct.attribute(n + total_acc, B * chunk)
        self._acct.note_spec(total_prop, total_acc)
        device_profiler.note_quantum("spec_verify", rows=n, accepted=total_acc)
        self.decode_steps += 1
        self.decode_tokens += n + total_acc
        self.spec_proposed += total_prop
        self.spec_accepted += total_acc
        self._m_decode_tokens.inc(n + total_acc)
        self._m_spec_proposed.inc(total_prop)
        self._m_spec_accepted.inc(total_acc)
        if self.spec_proposed:
            self._m_spec_rate.set(self.spec_accepted / self.spec_proposed)
        return out

    def _spec_quantum(self, decode_ready: Dict[int, object], prompts, results, reqs, commit) -> bool:
        """The serving loops' speculative hook over a pure-decode situation:
        one draft -> verify quantum, its rows committed and taken out of
        ``decode_ready`` (rows the drafter or the scheduler skipped stay
        there). False when it did not run, so the caller runs a plain step."""
        uids = list(decode_ready)
        rows = self._run_spec_step(uids, [decode_ready[u] for u in uids],
                                   [list(prompts[u]) + results[u] for u in uids],
                                   [reqs[u].max_new_tokens - len(results[u]) for u in uids])
        if rows is None:
            return False
        for uid, toks in rows.items():
            decode_ready.pop(uid)
            commit(uid, toks)
        return True

    # ---------------------------------------------------------- serving loop
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0, on_token=None) -> List[List[int]]:
        """Continuous-batching generation over a set of prompts, greedy by
        default or sampled (temperature/top-k/top-p) from the engine's
        generator seeded with ``seed``. ``on_token(uid, token)`` streams
        tokens as they are committed (a K-step burst delivers its K tokens
        when the burst completes). The fused loop serves unless the engine
        was built with ``fused_step=False`` (or ``DS_TPU_SERVE_FUSED=0``)."""
        self._sampling = (True, float(temperature), int(top_k), float(top_p)) if do_sample else None
        self._generator.manual_seed(seed)
        self._m_requests.inc(len(prompts))
        if self._events.enabled:
            for i, p in enumerate(prompts):
                self._events.emit("enqueue", i, prompt=len(p))
        journal = get_journal()
        if journal is not None:
            journal.begin_session(
                self._journal_fingerprint(), kind="generate",
                run={"max_new_tokens": int(max_new_tokens), "eos_token_id": eos_token_id,
                     "do_sample": bool(do_sample), "temperature": float(temperature),
                     "top_k": int(top_k), "top_p": float(top_p), "seed": int(seed)})
            for i, p in enumerate(prompts):
                journal.record_request(i, list(p), arrival_s=0.0, arrival_q=self.scheduler.last_quantum_id,
                                       max_new_tokens=int(max_new_tokens))
        try:
            out = self._generate(prompts, max_new_tokens, eos_token_id, on_token)
            if journal is not None:
                # deferred mode keeps tokens on the device until the final fetch, so those requests have no
                # per-commit records: journal each one's full stream now (quantum unknown: -1)
                for i, toks in enumerate(out):
                    if not journal.has_commits(i):
                        journal.record_commit(i, -1, toks)
            return out
        finally:
            if journal is not None:
                journal.end_session(self._journal_run_summary())
            self._sampling = None
            self._update_hbm_gauges()

    # ---------------------------------------------------------- journal
    def _program_signatures(self) -> List[str]:
        """The step-function cache keys at this instant: part of the journal
        fingerprint (a replay that builds a different step set is suspect
        before a single token diverges). Every key ends in the sharding
        signature, as the JAX engine's do."""
        sigs = [f"prefill:{self._shard_sig}", f"decode:{self._shard_sig}"]
        sigs += [f"burst{k}" for k in self._bursts]
        sigs += [f"fused{k}" for k in self._fused_fns]
        sigs += [f"spec{k}" for k in self._spec_fns]
        return sorted(str(s) for s in sigs)

    def _journal_fingerprint(self) -> Dict:
        """Everything the replay harness needs to rebuild this engine: model
        config, resolved engine geometry and loop flags, the knob registry as
        resolved, and the step-function signatures, with the topology:
        ``tensor_parallel``, ``tp_allreduce_bits``, ``shard_sig`` and
        ``mesh`` ("mesh[none]" at tp 1, as the reference writes it)."""
        from ...parallel.mesh import mesh_signature

        smc = self._config.state_manager
        return {
            "model_cfg": dataclasses.asdict(self.cfg),
            "engine": {
                "dtype": self._config.dtype,
                "fused_step": self._fused_enabled,
                "spec_decode": self._spec_enabled,
                "spec_k": self._spec_k,
                "spec_drafter": self._config.spec_drafter,
                "decode_burst": self._config.decode_burst,
                "min_decode_bucket": self._config.min_decode_bucket,
                "quant_bits": self._config.quant_bits,
                "kv_quant_bits": self._kv_quant_bits,
                "kv_spill": self._kv_spill,
                "enable_prefix_cache": self.state.prefix_cache is not None,
                "tensor_parallel": self._tp,
                "tp_allreduce_bits": self._tp_bits,
                "shard_sig": self._shard_sig,
                "mesh": mesh_signature(self._mesh_topo) if self._mesh_topo is not None else "mesh[none]",
                "num_kv_blocks": self._n_kv_blocks,
                "kv_block_size": smc.kv_block_size,
                "max_context": smc.max_context,
                "max_ragged_batch_size": smc.max_ragged_batch_size,
                "max_ragged_sequence_count": smc.max_ragged_sequence_count,
            },
            "knobs": resolved_knobs(),
            "programs": self._program_signatures(),
        }

    def _journal_run_summary(self) -> Dict:
        """Run-level accounting folded into the journal's end record: the
        baseline side of a what-if comparison."""
        out: Dict = {"dispatches": get_telemetry_registry().peek("infer_dispatches_total") or 0.0,
                     "programs": self._program_signatures()}
        if self._acct.enabled:
            out["acct_totals"] = dict(self._acct.totals())
        return out

    def _generate(self, prompts, max_new_tokens, eos_token_id, on_token=None) -> List[List[int]]:
        if self._fused_enabled:
            return self._generate_fused(prompts, max_new_tokens, eos_token_id, on_token)
        return self._generate_unfused(prompts, max_new_tokens, eos_token_id, on_token)

    def _commit_closures(self, reqs, results, pieces, counts, decode_ready, eos_token_id, on_token):
        """(commit, commit_dev): record committed tokens and retire/continue the request."""
        events = self._events
        journal = get_journal()
        if journal is not None and not journal.active:
            journal = None

        def commit(uid: int, toks_out: List[int]) -> None:
            req = reqs[uid]
            # a multi-token commit (burst tail) never outlives the budget
            toks_out = list(toks_out)[:req.max_new_tokens - len(results[uid])]
            if not toks_out:
                return
            if eos_token_id is not None and eos_token_id in toks_out:
                toks_out = toks_out[:toks_out.index(eos_token_id) + 1]
            if journal is not None:
                journal.record_commit(uid, self.scheduler.last_quantum_id, toks_out)
            if on_token is not None:
                for tok in toks_out:
                    on_token(uid, tok)
            first = not results[uid]
            results[uid].extend(toks_out)
            if first:
                events.emit("first_token", uid)
            done = (len(results[uid]) >= req.max_new_tokens or
                    (eos_token_id is not None and toks_out[-1] == eos_token_id))
            if done:
                req.done = True
                events.emit("finish", uid, n_new=len(results[uid]))
                self.flush([uid])
            else:
                decode_ready[uid] = toks_out[-1]

        def commit_dev(uid: int, row) -> None:
            """Deferred commit: ``row`` is a device (k,) or 0-d tensor."""
            req = reqs[uid]
            row = torch.atleast_1d(row)
            pieces[uid].append(row)
            first = counts[uid] == 0
            counts[uid] += int(row.shape[0])
            if first:
                events.emit("first_token", uid)
            if counts[uid] >= req.max_new_tokens:
                req.done = True
                events.emit("finish", uid, n_new=counts[uid])
                self.flush([uid])
            else:
                decode_ready[uid] = row[-1]

        return commit, commit_dev

    @staticmethod
    def _collect_results(prompts, deferred, results, pieces) -> List[List[int]]:
        if not deferred:
            return [results[i] for i in range(len(prompts))]
        # one fetch for everything: equal lengths stack into a single transfer
        rows = [torch.cat(pieces[i]) if len(pieces[i]) > 1 else pieces[i][0] for i in range(len(prompts))]
        lens = {int(r.shape[0]) for r in rows}
        if len(lens) == 1:
            arr = torch.stack(rows).cpu().numpy()
            return [arr[i].tolist() for i in range(len(prompts))]
        return [r.cpu().tolist() for r in rows]

    def _generate_fused(self, prompts, max_new_tokens, eos_token_id, on_token=None) -> List[List[int]]:
        """The SplitFuse loop: the host admits, allocates blocks and commits
        streams; each scheduler quantum is one step, and pure-decode quanta
        between admission waves extend to multi-step bursts; with speculation
        on, a pure-decode situation first tries a draft -> verify quantum."""
        # speculation needs the committed token values on the host (the drafter reads the history)
        deferred = eos_token_id is None and on_token is None and not self._spec_enabled
        reqs = {i: RaggedRequest(uid=i, tokens=list(p), max_new_tokens=max_new_tokens) for i, p in enumerate(prompts)}
        pending = list(reqs.values())
        decode_ready: Dict[int, object] = {}  # uid -> next token to feed (int, or device scalar when deferred)
        results: Dict[int, List[int]] = {i: [] for i in reqs}
        pieces: Dict[int, List[object]] = {i: [] for i in reqs}  # deferred: device tensors
        counts: Dict[int, int] = {i: 0 for i in reqs}
        commit, commit_dev = self._commit_closures(reqs, results, pieces, counts, decode_ready, eos_token_id,
                                                   on_token)

        while pending or decode_ready:
            self._health.poll()
            # host-tier pre-spill: start d2h demotions while the pool is under the spill watermark, so they
            # overlap the next step (this also precedes a speculative quantum)
            self.state.spill_tick()
            if self._spec_enabled and decode_ready and not pending:
                if self._spec_quantum(decode_ready, prompts, results, reqs, commit):
                    continue
            quantum = self.scheduler.schedule_fused([r for r in pending if r.remaining_prefill],
                                                    list(decode_ready))
            if quantum.empty:
                raise RuntimeError("scheduler deadlock: no work schedulable (KV pool too small?)")
            for pf in quantum.prefills:
                reqs[pf.uid].tokens = reqs[pf.uid].tokens[len(pf.tokens):]
            steps = 1
            if quantum.decode_uids and not quantum.prefills and not pending:
                # between admission waves: everyone is decoding — extend the
                # quantum to a multi-step burst (pow2 ladder)
                done_count = counts if deferred else {u: len(results[u]) for u in quantum.decode_uids}
                rem = min(reqs[u].max_new_tokens - done_count[u] for u in quantum.decode_uids)
                steps = max(1, self._burst_steps({u: True for u in quantum.decode_uids}, rem))
            carry = [decode_ready.pop(u) for u in quantum.decode_uids]
            rows = self._run_fused(quantum, carry, steps, deferred, eos_token_id)
            for uid, row in rows.items():
                if row is None:
                    continue  # mid-prompt prefill chunk: no sampled token yet
                if deferred:
                    commit_dev(uid, row)
                else:
                    commit(uid, row.tolist())
            pending = [r for r in pending if not r.done and r.remaining_prefill]

        return self._collect_results(prompts, deferred, results, pieces)

    def _generate_unfused(self, prompts, max_new_tokens, eos_token_id, on_token=None) -> List[List[int]]:
        """The unfused loop: each scheduler step runs through ``put`` (a
        prefill step per chunk bucket, one decode step), and once nothing is
        left to admit and every sequence decodes, a multi-step burst runs
        instead (tokens past an EOS are dropped at commit). Deferred mode
        (no EOS cut, no streaming callback, no speculation) keeps the token
        carry on the device, as in the fused loop. With speculation on, a
        pure-decode situation first tries a draft -> verify quantum."""
        deferred = eos_token_id is None and on_token is None and not self._spec_enabled
        reqs = {i: RaggedRequest(uid=i, tokens=list(p), max_new_tokens=max_new_tokens) for i, p in enumerate(prompts)}
        pending = list(reqs.values())
        decode_ready: Dict[int, object] = {}  # uid -> next token to feed (int, or device scalar when deferred)
        results: Dict[int, List[int]] = {i: [] for i in reqs}
        pieces: Dict[int, List[object]] = {i: [] for i in reqs}  # deferred: device tensors
        counts: Dict[int, int] = {i: 0 for i in reqs}
        commit, commit_dev = self._commit_closures(reqs, results, pieces, counts, decode_ready, eos_token_id,
                                                   on_token)

        while pending or decode_ready:
            self._health.poll()
            self.state.spill_tick()  # host-tier pre-spill (see _generate_fused)
            if self._spec_enabled and not pending and decode_ready:
                if self._spec_quantum(decode_ready, prompts, results, reqs, commit):
                    continue
            if not pending and decode_ready:
                # a burst step decodes one token per sequence, so both scheduler caps bound the batch
                cap = min(self.scheduler.max_sequences, self.scheduler.max_batch_tokens)
                burst_uids = list(decode_ready)[:cap]
                done_count = counts if deferred else {u: len(results[u]) for u in burst_uids}
                rem = min(reqs[u].max_new_tokens - done_count[u] for u in burst_uids)
                k = self._burst_steps({u: True for u in burst_uids}, rem)
                if k >= 2:
                    carried = [decode_ready.pop(u) for u in burst_uids]
                    if deferred:
                        head = self._ids_from_carry(carried, self._decode_bucket(len(burst_uids)))
                        out = self._run_decode_burst(burst_uids, [0] * len(burst_uids), k, ids_dev=head, defer=True)
                        for uid, row in zip(burst_uids, out):
                            commit_dev(uid, row)
                    else:
                        out = self._run_decode_burst(burst_uids, carried, k)
                        for uid, row in zip(burst_uids, out):
                            commit(uid, row.tolist())
                    continue
            step = self.scheduler.schedule([r for r in pending if r.remaining_prefill], list(decode_ready))
            if step.empty:
                raise RuntimeError("scheduler deadlock: no work schedulable (KV pool too small?)")
            uids, toks = [], []
            for uid in step.decode_uids:
                uids.append(uid)
                toks.append([decode_ready.pop(uid)])
            for pf in step.prefills:
                req = reqs[pf.uid]
                uids.append(pf.uid)
                toks.append(pf.tokens)
                req.tokens = req.tokens[len(pf.tokens):]
            nxt = self.put(uids, toks, return_tokens=True, _defer=deferred)
            for uid, tok in zip(uids, nxt):
                if reqs[uid].remaining_prefill:
                    continue  # mid-prompt chunk: its logits are not a sampled token yet
                if deferred:
                    commit_dev(uid, tok)
                else:
                    commit(uid, [int(tok)])
            pending = [r for r in pending if not r.done and r.remaining_prefill]

        return self._collect_results(prompts, deferred, results, pieces)
