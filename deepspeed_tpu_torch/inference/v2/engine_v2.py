"""InferenceEngineV2 — continuous-batching ragged serving on the fused SplitFuse path.

Port of ``deepspeed_tpu/inference/v2/engine_v2.py`` (fused loop):
``generate`` -> ``_generate_fused`` -> ``RaggedBatchScheduler.
schedule_fused`` -> ``_run_fused`` -> the step of ``make_fused_step_fn``.

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

The engine runs on ``config.device`` (default ``"cuda"``, which raises
without a GPU). The unfused loop, ``put``, telemetry, journal, tensor
parallelism, speculative decoding and the host spill tier come with later
slices.
"""

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...analysis import knobs
from ...device import resolve_device
from ...models.transformer import TransformerConfig
from ...ops.paged_attention import make_kv_pool
from ..quantization import QuantizedParam, quantize_for_serving
from .model_runner import make_fused_step_fn
from .modules import build_modules
from .ragged.manager import DSStateManager, RaggedBatchConfig
from .scheduler import FusedQuantum, RaggedBatchScheduler, RaggedRequest


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class RaggedInferenceEngineConfig:
    """Parity: reference ``inference/v2/config_v2.py`` (the fused slice's fields)."""
    state_manager: RaggedBatchConfig = field(default_factory=RaggedBatchConfig)
    dtype: str = "bfloat16"
    device: str = "cuda"  # "cuda" (raises without a GPU) or "cpu" (the kernels' plain versions)
    decode_burst: Optional[int] = None  # max fused decode steps per quantum; None: DS_TPU_DECODE_BURST
    enable_prefix_cache: Optional[bool] = None  # None: DS_TPU_PREFIX_CACHE
    min_decode_bucket: Optional[int] = None  # padded decode batch floor; None: DS_TPU_MIN_DECODE_BUCKET
    # weight-only quantisation: matmul kernels stored as int8 codes, dequantised in the matmul kernel
    quant_bits: int = 0  # 0 = off; 8, or 4 (packed int4 storage, 2 codes per byte)
    quant_group_size: int = 128
    quant_min_size: int = 4096  # leave smaller weights dense
    kv_quant_bits: Optional[int] = None  # 8 = int8 K/V pages + per-slot-per-head scales; None: DS_TPU_KV_QUANT

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
        if not knobs.get_bool("DS_TPU_SERVE_FUSED"):
            raise NotImplementedError("DS_TPU_SERVE_FUSED=0 selects the unfused loop, which is not ported: "
                                      "only the fused SplitFuse loop is")
        self.model = model
        cfg: TransformerConfig = model if isinstance(model, TransformerConfig) else model.cfg
        self.cfg = cfg
        if cfg.moe_num_experts > 0:
            raise NotImplementedError("MoE models are served by a later port slice")
        self.dtype = torch.bfloat16 if config.dtype in ("bfloat16", "bf16") else torch.float32

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
                                              prefill_chunk=knobs.get_int("DS_TPU_PREFILL_CHUNK"))

        # garbage page for padded-token KV writes (allocator's first pop is 0)
        self._garbage_block = self.state._allocator.allocate(1)[0]
        assert self._garbage_block == 0

        L, bs = cfg.n_layers, smc.kv_block_size
        pool_shape = (L, n_blocks, bs, cfg.kv_heads, cfg.head_dim)
        self.k_pages = make_kv_pool(pool_shape, self.dtype, self.device, self._kv_quant_bits)
        self.v_pages = make_kv_pool(pool_shape, self.dtype, self.device, self._kv_quant_bits)
        self._max_blocks_per_seq = -(-smc.max_context // bs)

        def place(tree):
            if isinstance(tree, dict):
                return {k: place(v) for k, v in tree.items()}
            if isinstance(tree, QuantizedParam):  # quantised beforehand: codes and scales move as they are
                return dataclasses.replace(tree, q=tree.q.to(self.device), scales=tree.scales.to(self.device))
            t = torch.as_tensor(tree)
            return t.to(self.device, self.dtype) if t.is_floating_point() else t.to(self.device)

        self.params = place(params)
        if config.quant_bits:
            self.params = quantize_for_serving(self.params, num_bits=config.quant_bits,
                                               group_size=config.quant_group_size, min_size=config.quant_min_size)
        self._mods = build_modules()
        self._max_program_variants = max(1, knobs.get_int("DS_TPU_PROGRAM_CACHE"))
        self._fused_fns: Dict[tuple, object] = {}  # (bucket shape, sampling) -> step function
        self._sampling = None  # (do_sample, temperature, top_k, top_p) during generate()
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(0)

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
        every layer's K/V pool, in place. An int8 pool copies the block's scale
        plane with its codes, so the copy dequantises to the same values."""
        idx = torch.tensor([dst], dtype=torch.long, device=self.device)
        for pool in (self.k_pages, self.v_pages):
            for t in (pool if isinstance(pool, tuple) else (pool,)):
                t.index_copy_(1, idx, t[:, src:src + 1].clone())

    def _cow_ready(self, seq, start_pos: int) -> None:
        self.state.ensure_writable(seq, start_pos, self._copy_block)

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

    def _decode_bucket(self, n: int) -> int:
        return max(self._config.min_decode_bucket, _next_pow2(n))

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
        """LRU-bounded cache of step functions keyed on the padded bucket
        shape and sampling signature (``DS_TPU_PROGRAM_CACHE`` entries)."""
        key = (n_dec, n_pre, chunk) + (sampling or (False, 1.0, 0, 1.0))
        if key not in self._fused_fns:
            if len(self._fused_fns) >= self._max_program_variants:
                self._fused_fns.pop(next(iter(self._fused_fns)))
            do, t, k, p = key[3:7]
            self._fused_fns[key] = make_fused_step_fn(self._run_cfg, n_dec=n_dec, n_pre=n_pre, chunk=chunk,
                                                      do_sample=do, temperature=t, top_k=k, top_p=p,
                                                      mods=self._mods)
        else:
            self._fused_fns[key] = self._fused_fns.pop(key)  # LRU touch
        return self._fused_fns[key]

    def _run_fused(self, quantum: FusedQuantum, decode_carry: List, steps: int, defer: bool,
                   eos_token_id: Optional[int]) -> Dict[int, object]:
        """One step for a whole scheduler quantum: decode rows and chunked-
        prefill rows run as one flat ragged batch, then the batch advances
        ``steps - 1`` more decode steps (pure-decode quanta only).

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

        ids_dev, pos_dev, bt_dev, ctx_dev, slots_dev, last_dev, adv_dev, gslots_dev = self._to_device(
            ids, positions, bt, ctx, slots0, last, adv, gslots)
        if n_dec and defer:
            # device token scalars from the previous quantum stack into the
            # decode segment without a host sync; padded rows feed the garbage page
            col = [torch.as_tensor(t, dtype=torch.int32, device=self.device).reshape(()) for t in decode_carry]
            col.extend([torch.zeros((), dtype=torch.int32, device=self.device)] * (D - n_dec))
            ids_dev[:D] = torch.stack(col)

        fn = self._fused_for(D, P, S, self._sampling)
        eos = -1 if eos_token_id is None else int(eos_token_id)
        toks, self.k_pages, self.v_pages = fn(self.params, ids_dev, pos_dev, self.k_pages, self.v_pages, bt_dev,
                                              ctx_dev, slots_dev, last_dev, adv_dev, gslots_dev, eos,
                                              self._generator)
        for seq in seqs:
            seq.post_forward()

        # non-deferred mode fetches the quantum's tokens in ONE readback
        toks_host = None if defer else toks.cpu().numpy()
        out: Dict[int, object] = {}
        for j, uid in enumerate(dec_uids):
            out[uid] = toks[j] if defer else toks_host[j]
        for r, pf in enumerate(prefills):
            if pf.final:
                out[pf.uid] = toks[D + r] if defer else toks_host[D + r]
            else:
                out[pf.uid] = None
        return out

    # ---------------------------------------------------------- serving loop
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0, seed: int = 0, on_token=None) -> List[List[int]]:
        """Continuous-batching generation over a set of prompts, greedy by
        default or sampled (temperature/top-k/top-p) from the engine's
        generator seeded with ``seed``. ``on_token(uid, token)`` streams
        tokens as they are committed (a K-step burst delivers its K tokens
        when the burst completes)."""
        self._sampling = (True, float(temperature), int(top_k), float(top_p)) if do_sample else None
        self._generator.manual_seed(seed)
        try:
            return self._generate_fused(prompts, max_new_tokens, eos_token_id, on_token)
        finally:
            self._sampling = None

    def _commit_closures(self, reqs, results, pieces, counts, decode_ready, eos_token_id, on_token):
        """(commit, commit_dev): record committed tokens and retire/continue the request."""

        def commit(uid: int, toks_out: List[int]) -> None:
            req = reqs[uid]
            # a multi-token commit (burst tail) never outlives the budget
            toks_out = list(toks_out)[:req.max_new_tokens - len(results[uid])]
            if not toks_out:
                return
            if eos_token_id is not None and eos_token_id in toks_out:
                toks_out = toks_out[:toks_out.index(eos_token_id) + 1]
            if on_token is not None:
                for tok in toks_out:
                    on_token(uid, tok)
            results[uid].extend(toks_out)
            done = (len(results[uid]) >= req.max_new_tokens or
                    (eos_token_id is not None and toks_out[-1] == eos_token_id))
            if done:
                req.done = True
                self.flush([uid])
            else:
                decode_ready[uid] = toks_out[-1]

        def commit_dev(uid: int, row) -> None:
            """Deferred commit: ``row`` is a device (k,) or 0-d tensor."""
            req = reqs[uid]
            row = torch.atleast_1d(row)
            pieces[uid].append(row)
            counts[uid] += int(row.shape[0])
            if counts[uid] >= req.max_new_tokens:
                req.done = True
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
        between admission waves extend to multi-step bursts."""
        deferred = eos_token_id is None and on_token is None
        reqs = {i: RaggedRequest(uid=i, tokens=list(p), max_new_tokens=max_new_tokens) for i, p in enumerate(prompts)}
        pending = list(reqs.values())
        decode_ready: Dict[int, object] = {}  # uid -> next token to feed (int, or device scalar when deferred)
        results: Dict[int, List[int]] = {i: [] for i in reqs}
        pieces: Dict[int, List[object]] = {i: [] for i in reqs}  # deferred: device tensors
        counts: Dict[int, int] = {i: 0 for i in reqs}
        commit, commit_dev = self._commit_closures(reqs, results, pieces, counts, decode_ready, eos_token_id,
                                                   on_token)

        while pending or decode_ready:
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
