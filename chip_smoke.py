#!/usr/bin/env python3
"""Drive the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root, on a machine with one CUDA GPU
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of the serving runs, a training step, v1
                                     # and an evoformer call
    python3 chip_smoke.py --quick    # the build and one case of each kernel phase
    python3 chip_smoke.py --parent DIR  # plus DIR's norm, quantized_matmul, bf16 flash, paged, sparse and
                                        # Adam kernels beside this tree's

Phases, each fatal on failure:
1. card: the ``nvidia-smi`` name and power-limit line;
2. build: nvcc builds every CUDA kernel of the serving, training, evoformer, sparse-attention,
   quantisation and LAMB paths from csrc/;
3. kernels: each kernel's wrapper at the llama3_8b shapes of the fused serving
   path, in bf16 and fp32, against its plain PyTorch version (errors,
   tolerance, kernel/plain/library times from CUDA events, and the bound:
   the larger of bytes over 3.35 TB/s and operations over the peak rate of
   the input type, 989 TFLOP/s bf16 / 67 TFLOP/s fp32); then the kernels of
   quantised serving the same way: ``layer_norm`` at gpt2_1_3b's width
   (both norms at T 8, 768 and 2048, and at T 2048 with the weight in the
   other float type, also cold, beside ``F.rms_norm`` and ``F.layer_norm``:
   device time from a CUDA graph rotating over copies of x),
   ``quantized_matmul`` with int8 codes over gpt2_1_3b's three weight shapes
   and with packed int4 over llama3_8b's two MLP shapes at 8, 64, 512 and
   1024 tokens (at 8 and 64 also cold, in device time from a CUDA graph:
   rotating over copies of the codes, and of the library's dense weight,
   of over 100 MB, twice the L2), and
   paged decode and prefill on int8 pools at both models' heads and on bf16
   pools at gpt2_1_3b's; decode at B 64 and prefill at 2 x 512 of each pool
   and geometry also with ALiBi (``alibi_slopes(32)``) and with a window
   (4,096, 512 at gpt2_1_3b's context of 1,024; the prefill's second row
   then starts at 7,680 so that it cuts); decode at B 8 and prefill at
   2 x 16 also cold, in device time from a CUDA graph rotating over copies of
   the pools, and of SDPA's dense K/V, of over 100 MB; and prefill at the
   shape of a speculative verify step (``phase_verify``: 64 rows of 5 and of
   2 queries, each window ending a context of 130-8,192 keys) on bf16 and
   int8 pools, beside SDPA with a boolean mask; and (run after the LAMB kernel) the
   MoE grouped GEMM (``moe_grouped_gemm``, expert offsets read on the device)
   at Mixtral-8x7B's expert shapes (wi 4096 -> 14336, wo 14336 -> 4096) for
   the mixtral_8x7b_8l serve's own steps (a decode step at its bucket of 8:
   16 rows; a 2,048-token prefill quantum: 4,096 rows), a 64-token decode
   step (128 rows) and a 768-token quantum (1,536 rows) of seeded top-2
   routings, with an empty expert and with every row on one expert, each
   repeating bit for bit, beside ``torch._grouped_mm`` and a per-expert
   ``torch.matmul`` loop; then each bf16 tile body (32 and 64 rows) at the
   serve's steps of 16-4,096 rows, held to the plain version and timed in 5
   turns;
4. step parity: one prefill quantum and one mixed decode + prefill quantum
   of llama3_8b at full width and 4 layers, run with the kernels and with
   their plain versions; logits and KV pools (garbage block 0 excluded)
   agree; then the same two quanta of gpt2_1_3b at full width and 4 layers
   with int8 weights and int8 KV pools (pools compared dequantised), and of
   Mixtral-8x7B at full width and 2 layers (every block MoE: the grouped
   GEMM against its plain version);
5. serve: InferenceEngineV2 over llama3_8b at full width and depth (random
   bf16 weights from seed 0), greedy generate of 32 tokens for a dozen
   seeded prompts of 16-1500 tokens in two waves (the second wave shares a
   256-token prefix with the first, so the prefix cache is hit). The kernel
   launch counters are zeroed just before and read just after; every kernel
   must have launched. Each step replays its bucket's captured CUDA graph:
   graph replays must equal the steps and the fused quanta, and the captures,
   their host seconds and the evictions are printed; the launch counters
   count each replay as its capture's launches. The waves are then served in
   turns with each step eager (the parent's dispatch) and on graphs
   (eager, graphs, graphs, eager), every run's tokens equal to the first's;
   again on an engine built with ``DS_TPU_PROGRAM_CACHE=16`` (the waves take
   11 graphs; at the default 8 they are captured again and again); then
   through the unfused loop (``fused_step=False``: a prefill step per chunk
   bucket, a decode step, bursts), on graphs and again with eager steps,
   whose tokens must be equal; its agreement with the fused loop's tokens is
   printed (in bf16 the two loops' products have other row counts and round
   otherwise; the card tests hold the two loops to the CPU in fp32); then
   ``serve_spec`` (speculative decoding, on the first serve run's weights):
   the JAX bench's workload (32 prompts, each a seeded 16-token motif
   repeated 8 times, 128 new tokens, K 4), spec off and on with bursts off,
   spec on with an oracle drafter (spec off's tokens, while a row still
   agrees with them), spec off at burst 32, all at
   ``DS_TPU_PROGRAM_CACHE=32``, then spec on at the default cache; each a
   warm-up generate (the graphs captured; in the spec-on run the first
   verify replays held to the eager verify step on the same inputs) and a
   timed one with tokens/s, decode steps, proposed and accepted drafts,
   tokens a decode step, captures and evictions, its token agreement with
   spec off and the KV pool's free blocks before and after; then
   ``spec_fp32``: a 2-layer llama3_8b-wide engine in fp32 whose spec-on
   tokens (prompt lookup and the oracle) must equal spec off's in the fused
   and the unfused loop; then ``sla``: ``sla.run_load`` with 24 requests a
   row (a shared 256-token prefix and 16-1500 more tokens, 32 new tokens,
   greedy), every
   arrival at t = 0 and then Poisson rows at 1/4, 1/2 and 3/4 of that row's
   requests/s, each with tokens/s, TTFT and TPOT percentiles and its SLA
   misses, and ``effective_throughput_at_sla`` at the FastGen SLA (TTFT 1 s,
   TPOT 250 ms). Then ALiBi and sliding-window serving as ``serve`` does
   it (eager and graph tokens equal): a BLOOM-7b1-shaped config and a
   Mistral-7B-v0.1-shaped one (window 4,096, prompts up to 6,000 tokens),
   each at full width and 4 layers. Then MoE serving: a Mixtral-8x7B-v0.1-
   shaped config at full width and 8 layers (8 experts, top-2; 17
   ``rms_norm`` and 24 ``moe_grouped_gemm`` launches per forward), the serve
   run's waves on graphs and eager with equal tokens, and the rows each
   expert takes of real tokens (the bucket's padding apart) in every layer
   of a prefill and a decode step. Then the quantised main paths the same
   way, each with its counters zeroed before and read after: gpt2_1_3b at full width
   and depth with ``quant_bits=8`` and ``kv_quant_bits=8`` (prompts of 16-960
   tokens, max_context 1024), and llama3_8b at full width and depth with
   ``quant_bits=4`` (packed int4) on a bf16 pool; the launch counts must fit
   the models' structure (gpt2_1_3b: 49 ``layer_norm`` and 144
   ``quantized_matmul`` launches per forward; llama3_8b: 65 ``rms_norm`` and
   225 ``quantized_matmul``), and the weights' and one KV block's bytes are
   printed beside their bf16 sizes.
6. training kernels: flash attention forward, dq and dk/dv (kernels A, B, C)
   at the gpt2_1_3b shape and at GQA, Sq < Sk, window and ALiBi shapes, and
   fused AdamW (kernel D) over the ``wte`` leaf and over all 388 leaves of
   gpt2_1_3b in one ``fused_adam_multi`` call (one launch), against their
   plain versions, each with its bound and a library yardstick (SDPA
   forward and backward; ``torch.optim.AdamW(fused=True)``: Adam, with
   ``--parent`` the parent's Adam, and the library three times each in
   turns, their medians, spreads and GB/s), timed here only;
7. train parity: gpt2_1_3b at full width and 2 layers, fp32 and bf16, one
   engine step with the kernels and one with their plain versions from the
   same weights and batch: loss, per-leaf gradients, parameters after it;
8. train: ``initialize`` + ``train_batch`` on gpt2_1_3b at full width and
   depth in bf16 (micro-batch 8 x 1024, FusedAdam, WarmupLR, clip 1.0) for
   12 steps on one seeded batch; losses finite and falling; tokens/s, step
   time, MFU and peak memory over steps 3-12, with the launch counters
   zeroed before those steps and read after (A, B, C: 24 per step; D: one
   for each 512 leaves, so one). ``--profile`` adds a torch.profiler
   breakdown of one step.
9. evoformer kernels (run after phase 6): the flash kernels' additive-bias
   bodies (forward with a bias, dq writing dbias per program, the collapsed
   dq summing dbias over the programs that share a bias slice, dk/dv with a
   bias) at AlphaFold2's widths (``EVO_SHAPES``: MSA row and column
   attention, 8 heads of 32; triangle attention, 4 heads of 32; crops of
   256 x 128 and 384 x 512) in bf16 and fp32 against their plain versions,
   the collapsed dq's dq and dbias repeating bit for bit, with bounds and SDPA
   (float ``attn_mask``) as the yardstick;
10. evoformer: ``DS4Sci_EvoformerAttention`` forward and backward at those
   shapes, the counters zeroed before each call and read after (forward,
   dk/dv and the dq of each layout must launch), output and the gradients
   of q, k, v and every bias against the same call on the plain versions,
   ms per forward + backward and peak memory;
11. sparse kernels (run after phase 9): ``sparse_fwd``, ``sparse_bwd_dq`` and
   ``sparse_bwd_dkv`` (block-sparse attention over active-block lists) at
   every ``SPARSE_SHAPES`` case (fixed unidirectional layout at gpt2_1_3b's
   heads and S 8192; fixed per-head layouts at BERT-base width; BigBird at
   bigbird-roberta-base's; a causal Longformer layout at llama3_8b's GQA
   heads and D 128; a dense layout at the flash kernels' gpt2_1_3b shape) in
   bf16 and fp32 against their plain versions (at each case's check batch),
   with bounds from the layout's active pairs and SDPA with the boolean token
   mask as the yardstick, and each kernel (bf16: the forward and dq over the
   query plan, dk/dv over its plan) repeating bit for bit; the dense layout is
   also held to, and timed beside, the flash kernels;
12. sparse: ``SparseSelfAttention`` forward and backward at those cases in
   bf16, the counters zeroed before each call and read after (all three
   kernels must launch), output and gradients against the same call on the
   plain versions, ms per forward + backward and peak memory beside the
   plain path and SDPA with the token mask.

With ``--parent DIR`` (another checkout's sources, e.g. ``git archive`` of
the parent commit unpacked under ``build/``), DIR's kernels are built from
DIR and stand in for this tree's norms, ``quantized_matmul``, flash forward, dq
(per program and collapsed) and dk/dv, paged decode and prefill, the
sparse forward, dq and dk/dv and fused Adam while each of their cases is
timed again (``parent_ms``, the bias cases of dq and dk/dv included; the ALiBi and
window cases of the paged kernels are not in the parent's), the three
serving runs and the training run are repeated on them, and each
``DS4Sci_EvoformerAttention`` and ``SparseSelfAttention`` call is timed on
them too.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside this script, it exits non-zero and prints no result.
"""

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# kernel vs plain version: fp32 on the max abs error; bf16 on the per-row
# relative error (max |got - want| / max |want| over each row's last dim),
# since the outputs of long-context attention rows are ~0.03 in size and one
# bf16 rounding step is 2**-7 of a value at most
TOL = {"torch.float32": ("max_abs_err", 1e-5), "torch.bfloat16": ("max_rel_err", 1e-2)}
# llama3_8b serving geometry: heads, KV heads, head dim, KV block size,
# block-table width (max_context 8192 / 128) and model width
GEOM = dict(H=32, KVH=8, D=128, bs=128, P=64, d=4096)
# gpt2_1_3b serving geometry: MHA, head dim 64, max_context 1024 / 128
GPT2_GEOM = dict(H=32, KVH=32, D=64, bs=128, P=8, d=2048)


def model_cfg(**kw):
    """llama3_8b with fields replaced (the presets fix n_layers)."""
    import dataclasses

    from deepspeed_tpu_torch.models import llama3_8b

    return dataclasses.replace(llama3_8b(), **kw)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_rotating(fn, operands, iters: int) -> float:
    """Device time per launch of ``fn``, launch i taking ``operands[i %
    len(operands)]``: copies whose bytes together exceed the 50 MB L2 make
    every launch read its operands from device memory, as a serving step
    finds them. The launches are captured once in a CUDA graph and the graph
    is replayed, so that the host's launch cost (larger than a decode-sized
    product's device time, for the kernels' wrappers and for cuBLAS alike)
    drops out: mean of 3 replays."""
    import torch

    n = max(iters, len(operands))
    for i in range(min(3, len(operands))):
        fn(*operands[i])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a side stream, as capture wants
        fn(*operands[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*operands[i % len(operands)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (3 * n)
    del graph
    return ms


# --parent DIR: the kernels of another checkout (e.g. ``git archive`` of the parent commit, unpacked
# under build/), built from DIR's own sources, stand in for this tree's quantized_matmul, flash
# forward, dq and dk/dv, paged decode and prefill and the sparse kernels while a phase times them or runs
# a path with them ("parent" numbers, from the same run)
PARENT = {"lib": None}


class OldPagedEntry:
    """A paged decode or prefill entry point whose C interface predates the ALiBi slopes, the workspace,
    the window and the split plan, called with this tree's arguments (the slopes null and the window 0:
    the old kernels took neither; the workspace and the plan are dropped)."""

    OLD_ARGS = {"ds_paged_attention_decode": 17, "ds_paged_attention_prefill": 19}

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __call__(self, *args):
        if self.name == "ds_paged_attention_decode":
            q, kp, vp, ks, vs, bt, ctx, slopes, out, _ws, B, H, KVH, D, bs, P, window, _n, _keys, *rest = args
            head, dims = (q, kp, vp, ks, vs, bt, ctx), (B, H, KVH, D, bs, P)
        else:
            q, kp, vp, ks, vs, bt, ctx, qpos0, slopes, out, _ws, B, S, H, KVH, D, bs, P, window, _n, *rest = args
            head, dims = (q, kp, vp, ks, vs, bt, ctx, qpos0), (B, S, H, KVH, D, bs, P)
        if slopes is not None or window:
            raise NotImplementedError(f"{self.name}: the parent's kernel takes no ALiBi or window")
        return self.fn(*head, out, *dims, *rest)


class OldSparseEntry:
    """A sparse entry point whose C interface predates the plans, called with this tree's arguments: it walks
    the lists itself (the plan, the dk/dv's workspace and their counts are dropped)."""

    OLD_ARGS = {"ds_sparse_fwd": 16, "ds_sparse_bwd_dq": 18, "ds_sparse_bwd_dkv": 19}

    def __init__(self, name, fn):
        self.name, self.fn = name, fn

    def __call__(self, *args):
        if self.name == "ds_sparse_fwd":
            q, k, v, kidx, _plan, o, lse, B, S, H, D, blk, A, _n_items, _max_entries, _rows, *rest = args
            return self.fn(q, k, v, kidx, o, lse, B, S, H, D, blk, A, *rest)
        if self.name == "ds_sparse_bwd_dq":
            q, k, v, dout, lse, delta, kidx, _plan, dq, B, S, H, D, blk, A, _n_items, _max_entries, _rows, *rest = args
            return self.fn(q, k, v, dout, lse, delta, kidx, dq, B, S, H, D, blk, A, *rest)
        (q, k, v, dout, lse, delta, qidx, _plan, _ws, dk, dv, B, S, H, D, blk, Aq, _n_items, _n_reduce, _n_slots,
         _max_entries, _rows, *rest) = args
        return self.fn(q, k, v, dout, lse, delta, qidx, dk, dv, B, S, H, D, blk, Aq, *rest)


class OldAdamEntry:
    """The multi-leaf Adam entry point on a build that has only the one-leaf ``ds_fused_adam``: one launch of
    it for each leaf of the table, as that build's ``FusedAdam`` made them (the wrapper's launch count then
    counts calls, not launches)."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, ptrs, sizes, leaves, scal, *rest):
        for i in range(leaves):
            rc = self.fn(*ptrs[4 * i:4 * i + 4], sizes[i], scal, *rest)
            if rc:
                return rc
        return 0


class OldGemmEntry:
    """A grouped-GEMM entry point whose C interface predates the launch plan (tile rows chosen by the caller,
    no split of K, no workspace), called with this tree's arguments: the plan is dropped and the tile rows are
    those that build's wrapper chose (32 while an expert averages at most 16 rows, else 64; fp32 64)."""

    OLD_ARGS = 11

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, x, w, offsets, out, _ws, _counters, R, K, N, E, _rows, _split, _steps, _below, dtype, stream):
        bm = 64 if dtype == 0 or R > 16 * E else 32
        return self.fn(x, w, offsets, out, R, K, N, E, bm, dtype, stream)


class ParentKernels:
    """This tree's kernel library with the entry points in ``STAND_IN``
    taken from another build (the paged ones through ``OldPagedEntry``, the
    sparse ones through ``OldSparseEntry`` where that build has the old C
    interface, Adam's through ``OldAdamEntry`` where it has only the one-leaf
    entry point, the grouped GEMM's through ``OldGemmEntry`` where it has no
    launch plan). The collapsed dq's two entry points come from one build,
    whose plan sizes the partials."""

    STAND_IN = ("ds_rms_norm", "ds_layer_norm", "ds_quantized_matmul", "ds_flash_fwd", "ds_flash_bwd_dq",
                "ds_flash_bwd_dkv", "ds_flash_bwd_dq_collapsed", "ds_flash_dq_collapsed_parts",
                "ds_paged_attention_decode", "ds_paged_attention_prefill", "ds_sparse_fwd", "ds_sparse_bwd_dq",
                "ds_sparse_bwd_dkv", "ds_fused_adam_multi", "ds_moe_grouped_gemm")

    def __init__(self, lib, other):
        self._lib, self._other = lib, other

    def __getattr__(self, name):
        if name not in self.STAND_IN:
            return getattr(self._lib, name)
        if name == "ds_fused_adam_multi" and not hasattr(self._other, name):
            return OldAdamEntry(self._other.ds_fused_adam)
        fn = getattr(self._other, name)
        if len(fn.argtypes) == OldPagedEntry.OLD_ARGS.get(name):
            return OldPagedEntry(name, fn)
        if len(fn.argtypes) == OldSparseEntry.OLD_ARGS.get(name):
            return OldSparseEntry(name, fn)
        if name == "ds_moe_grouped_gemm" and len(fn.argtypes) == OldGemmEntry.OLD_ARGS:
            return OldGemmEntry(fn)
        return fn


def load_parent(path: str):
    """Build DIR's kernels with DIR's own ``_build.py`` (into DIR/build/) and
    return the stand-in library."""
    import importlib.util

    from deepspeed_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("parent_build",
                                                  os.path.join(path, "deepspeed_tpu_torch", "ops", "_build.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return ParentKernels(_build.lib(), mod.lib())


class parent_kernels:
    """``with parent_kernels():`` runs the port on the --parent kernels."""

    def __enter__(self):
        from deepspeed_tpu_torch.ops import _build

        self._saved, _build._lib = _build.lib(), PARENT["lib"]

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops import _build

        _build._lib = self._saved


def parent_time(fn, *args, **kw):
    """``fn(*args)`` (a timer) on the --parent kernels, or None without --parent."""
    if PARENT["lib"] is None:
        return None
    with parent_kernels():
        return fn(*args, **kw)


def errors(got, want, floor: float = 1e-30) -> dict:
    """Max abs error and max per-row relative error (rows = the last dim), each
    row's scale taken as at least ``floor``."""
    diff = (got.float() - want.float()).flatten(0, -2).abs().amax(-1)
    scale = want.float().flatten(0, -2).abs().amax(-1).clamp_min(floor)
    return dict(max_abs_err=diff.max().item(), max_rel_err=(diff / scale).max().item())


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernel phases
def paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed, garbage_rows=()):
    """Pools holding exactly the pages of ``ctx`` (row-disjoint, shuffled), block 0 spare."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = [max(1, -(-c // bs)) for c in ctx]
    n_blocks = 1 + sum(pages)
    kp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=dev).to(dtype)
    perm = (1 + torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(seed))).tolist()
    bt = torch.zeros((len(ctx), P), dtype=torch.int32)
    i = 0
    for r, n in enumerate(pages):
        if r not in garbage_rows:
            bt[r, :n] = torch.tensor(perm[i:i + n], dtype=torch.int32)
        i += n
    return kp, vp, bt.to(dev), torch.tensor(ctx, dtype=torch.int32, device=dev), g


def dense_kv(torch, kp, vp, bt, ctx):
    """Gathered dense K/V (B, KVH, L, D) for the library yardstick (SDPA with
    ``enable_gqa``), L = the longest context: dense attention pads every row
    to it, so the yardstick reads more bytes than the paged kernel."""
    B, bs, KVH, D = bt.shape[0], kp.shape[1], kp.shape[2], kp.shape[3]
    L = -(-int(ctx.max().item()) // bs) * bs
    idx = bt[:, :L // bs].long()
    k = kp[idx].reshape(B, L, KVH, D).permute(0, 2, 1, 3).contiguous()
    v = vp[idx].reshape(B, L, KVH, D).permute(0, 2, 1, 3).contiguous()
    return k, v, L


def int8_pools(kp, vp):
    """The same pages as int8 ``(codes, scales)`` pools; block 0, the garbage
    page, is left as never written (codes 0, scale 0)."""
    from deepspeed_tpu_torch.ops import paged_attention as pa

    pools = []
    for pages in (kp, vp):
        codes, scales = pa.quantize_kv(pages)
        codes[0], scales[0] = 0, 0.0
        pools.append((codes, scales))
    return pools


def kv_bytes(slots, KVH, D, item, int8):
    """Bytes of ``slots`` K and V entries: int8 codes carry one fp32 scale per slot and head."""
    return slots * KVH * 2 * ((D + 4) if int8 else D * item)


def paged_features(torch, dev, feature, geom):
    """ALiBi slopes (fp32 (H,) on the device) and window (0: none) of a kernel case: ``alibi`` takes
    ``alibi_slopes(H)`` (bloom's), ``window`` mistral's 4,096 (scaled to the geometry's context, 512 of
    gpt2_1_3b's 1,024, so that it cuts there too)."""
    from deepspeed_tpu_torch.models import alibi_slopes

    slopes = torch.from_numpy(alibi_slopes(geom["H"])).to(dev) if feature == "alibi" else None
    window = 4096 * geom["P"] * geom["bs"] // 8192 if feature == "window" else 0
    return slopes, window


def sdpa_mask(torch, slopes, window, L, qpos, cl, dtype):
    """SDPA's mask for a paged case over the dense keys [0, L): query positions ``qpos`` (B, Sq) see the keys
    before their row's ctx ``cl``, at or before themselves and inside the window; boolean (B, 1, Sq, L), or
    with ALiBi slopes float (B, H, Sq, L) in ``dtype``: -inf outside, + slope * key position inside."""
    kpos = torch.arange(L, device=qpos.device)
    allowed = (kpos[None, None, :] <= qpos[:, :, None]) & (kpos[None, None, :] < cl[:, None, None])
    if window:
        allowed = allowed & (kpos[None, None, :] > qpos[:, :, None] - window)
    allowed = allowed[:, None]
    if slopes is None:
        return allowed
    bias = slopes[None, :, None, None] * kpos.float()
    return bias.masked_fill(~allowed, float("-inf")).to(dtype)


def paged_tol(torch, dtype, slopes, last_key, v_pages) -> tuple:
    """TOL, and in fp32 with ALiBi the plain version's own rounding on top: a score of magnitude up to
    S = max slope * the last key position rounds to fp32 with an error of up to 2**-24 S, which moves that
    key's weight by as much relatively, on either side (scores reach 6,900 at llama3_8b's 8,192 keys)."""
    from deepspeed_tpu_torch.ops import paged_attention as pa

    what, tol = TOL[str(dtype)]
    if dtype != torch.float32 or slopes is None:
        return what, tol
    v = pa.dequantize_kv(v_pages) if pa.kv_pool_is_quantized(v_pages) else v_pages
    return what, tol + 2 * 2**-24 * slopes.abs().max().item() * last_key * v.abs().max().item()


def cold_ms(torch, fn, tensors, iters):
    """Device time of ``fn(*tensors)`` from a CUDA graph rotating over copies of ``tensors`` (nested tuples
    of tensors, like an int8 pool) whose bytes together pass 100 MB, twice the L2: every launch finds them
    in device memory, as a serving step finds its pools."""
    def nbytes(t):
        return sum(nbytes(x) for x in t) if isinstance(t, tuple) else t.numel() * t.element_size()

    def clone(t):
        return tuple(clone(x) for x in t) if isinstance(t, tuple) else t.clone()

    copies = [clone(tuple(tensors)) for _ in range(max(2, 100_000_000 // nbytes(tuple(tensors)) + 1))]
    ms = time_ms_rotating(fn, copies, iters)
    del copies
    return ms


def phase_decode(torch, dev, dtype, B, iters, geom=GEOM, int8=False, feature="none"):
    """Decode at ``geom``'s heads over B rows of seeded contexts (up to P bs, one padded row on the garbage
    page) against its plain version; kernel, parent, plain and SDPA times, and at B = 8 without a feature
    also cold device times of the kernel, the parent and SDPA."""
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
    base = [1, 127, 128, 129, 4096, 513, 2000, 8192]
    ctx = [min(base[i % len(base)], P * bs) for i in range(B)]
    ctx[-1] = 1  # a padded row: ctx 1 on the garbage page
    kd, vd, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=B, garbage_rows=(B - 1,))
    kp, vp = int8_pools(kd, vd) if int8 else (kd, vd)
    if int8:  # the library yardstick reads the dequantised pages in q's type
        kd, vd = pa.dequantize_kv(kp).to(dtype), pa.dequantize_kv(vp).to(dtype)
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    scale = D**-0.5
    slopes, window = paged_features(torch, dev, feature, geom)
    kw = dict(alibi_slopes=slopes, window=window or None)
    got = pa.paged_attention_decode(q, kp, vp, bt, cl, scale, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_decode_ref(q, kp, vp, bt, cl, scale, **kw)
    err = errors(got, want)
    item = q.element_size()
    live = sum(min(c, window) if window else c for c in ctx)
    nbytes = kv_bytes(live, KVH, D, item, int8) + 2 * q.numel() * item + bt.numel() * 4 + cl.numel() * 4
    flops = 4 * live * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    run = lambda: pa.paged_attention_decode(q, kp, vp, bt, cl, scale, **kw)
    k_ms = time_ms(run, iters)
    p_ms = time_ms(lambda: pa.paged_attention_decode_ref(q, kp, vp, bt, cl, scale, **kw), max(3, iters // 20))
    k, v, L = dense_kv(torch, kd, vd, bt, cl)
    mask = sdpa_mask(torch, slopes, window, L, (cl - 1)[:, None], cl, dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda kk, vv: sdpa(q[:, :, None], kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)
    l_ms = time_ms(lambda: lib(k, v), max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel() * mask.element_size()
    cold = {}
    if B == 8 and feature == "none":
        kcold = lambda kk, vv: pa.paged_attention_decode(q, kk, vv, bt, cl, scale)
        cold = dict(kernel_cold_ms=cold_ms(torch, kcold, (kp, vp), iters),
                    parent_cold_ms=parent_time(cold_ms, torch, kcold, (kp, vp), iters),
                    library_cold_ms=cold_ms(torch, lib, (k, v), iters))
    del k, v
    return dict(kernel="paged_attention_decode", pool="int8" if int8 else str(dtype), dtype=str(dtype),
                shape=f"q({B},{H},{D}) pool({kd.shape[0]},{bs},"
                f"{KVH},{D}) bt({B},{P})", features=feature, window=window, ctx=sorted(set(ctx)), **err,
                tol=paged_tol(torch, dtype, slopes, max(ctx), vp), kernel_ms=k_ms, parent_ms=None if feature != "none" else parent_time(
                    time_ms, run, iters), plain_ms=p_ms, library_ms=l_ms, library_bytes=l_bytes, **cold,
                plan=pa._decode_plan(B, KVH, P, bs, sm_count(dev)) if dtype == torch.bfloat16 else None,
                bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def phase_prefill(torch, dev, dtype, S, iters, geom=GEOM, int8=False, feature="none"):
    """Prefill of 2 x S queries at ``geom``'s heads (row 0 from position 0, row 1 continuing a context of
    1,000, or of 7,680 with a window, so that the window cuts) against its plain version; kernel, parent,
    plain and SDPA times, and at S = 16 without a feature also cold device times."""
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
    slopes, window = paged_features(torch, dev, feature, geom)
    q0 = [0, min(7680 if window else 1000, P * bs - 512)]  # row 1 continues a context: its chunk starts here
    ctx = [p + S for p in q0]
    kd, vd, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=S)
    kp, vp = int8_pools(kd, vd) if int8 else (kd, vd)
    if int8:
        kd, vd = pa.dequantize_kv(kp).to(dtype), pa.dequantize_kv(vp).to(dtype)
    q = torch.randn((2, S, H, D), generator=g, device=dev).to(dtype)
    pos = (torch.tensor(q0, dtype=torch.int32)[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(dev)
    scale = D**-0.5
    kw = dict(alibi_slopes=slopes, window=window or None)
    got = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale, **kw)
    torch.cuda.synchronize()
    want = pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale, **kw)
    err = errors(got, want)
    item = q.element_size()
    lo = (lambda p: max(0, p - window + 1)) if window else (lambda p: 0)
    visible = sum(min(c, p0 + s + 1) - lo(p0 + s) for c, p0 in zip(ctx, q0) for s in range(S))
    read = sum(c - lo(p0) for c, p0 in zip(ctx, q0))  # the keys some query of the row sees
    nbytes = kv_bytes(read, KVH, D, item, int8) + 2 * q.numel() * item + bt.numel() * 4 + 2 * 4 + pos.numel() * 4
    flops = 4 * visible * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    run = lambda: pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale, **kw)
    k_ms = time_ms(run, iters)
    p_ms = time_ms(lambda: pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale, **kw), max(3, iters // 20))
    k, v, L = dense_kv(torch, kd, vd, bt, cl)
    mask = sdpa_mask(torch, slopes, window, L, pos, cl, dtype)
    qh = q.permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda kk, vv: sdpa(qh, kk, vv, attn_mask=mask, scale=scale, enable_gqa=True)
    l_ms = time_ms(lambda: lib(k, v), max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel() * mask.element_size()
    cold = {}
    if S == 16 and feature == "none":
        kcold = lambda kk, vv: pa.paged_attention_prefill(q, kk, vv, bt, cl, pos, scale)
        cold = dict(kernel_cold_ms=cold_ms(torch, kcold, (kp, vp), iters),
                    parent_cold_ms=parent_time(cold_ms, torch, kcold, (kp, vp), iters),
                    library_cold_ms=cold_ms(torch, lib, (k, v), iters))
    del k, v
    return dict(kernel="paged_attention_prefill", pool="int8" if int8 else str(dtype), dtype=str(dtype),
                shape=f"q(2,{S},{H},{D}) kv_heads={KVH} qpos0={q0} ctx={ctx}", features=feature, window=window,
                **err, tol=paged_tol(torch, dtype, slopes, max(ctx), vp), kernel_ms=k_ms,
                parent_ms=None if feature != "none" else parent_time(
                    time_ms, run, iters), plain_ms=p_ms, library_ms=l_ms, library_bytes=l_bytes, **cold,
                plan=pa._prefill_plan(2, S, H, KVH, P, bs, sm_count(dev)) if dtype == torch.bfloat16 else None,
                bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


# A speculative verify step's prefill: B rows of chunk = K + 1 queries (K drafts of 4, and of 1), each row's
# window the last positions of a context spread evenly over this range
VERIFY_CTX = (130, 8192)


def phase_verify(torch, dev, dtype, B, chunk, iters, geom=GEOM, int8=False):
    """Prefill at the shape of a speculative verify step: B rows x ``chunk`` queries at ``geom``'s heads,
    row r's window ending its context (spread over VERIFY_CTX), against its plain version; kernel, plain
    and SDPA (boolean mask) times and the bound."""
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (geom[k] for k in ("H", "KVH", "D", "bs", "P"))
    lo, hi = VERIFY_CTX
    ctx = [min(P * bs, lo + (hi - lo) * r // max(1, B - 1)) for r in range(B)]
    q0 = [c - chunk for c in ctx]
    kd, vd, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=16 * B + chunk)
    kp, vp = int8_pools(kd, vd) if int8 else (kd, vd)
    if int8:
        kd, vd = pa.dequantize_kv(kp).to(dtype), pa.dequantize_kv(vp).to(dtype)
    q = torch.randn((B, chunk, H, D), generator=g, device=dev).to(dtype)
    pos = (torch.tensor(q0, dtype=torch.int32)[:, None] + torch.arange(chunk, dtype=torch.int32)[None]).to(dev)
    scale = D**-0.5
    got = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale)
    torch.cuda.synchronize()
    want = pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale)
    err = errors(got, want)
    item = q.element_size()
    visible = sum(p0 + s + 1 for p0 in q0 for s in range(chunk))
    nbytes = kv_bytes(sum(ctx), KVH, D, item, int8) + 2 * q.numel() * item + bt.numel() * 4 + B * 4 + pos.numel() * 4
    flops = 4 * visible * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    k_ms = time_ms(lambda: pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale), iters)
    p_ms = time_ms(lambda: pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale), max(3, iters // 20))
    k, v, L = dense_kv(torch, kd, vd, bt, cl)
    mask = sdpa_mask(torch, None, 0, L, pos, cl, dtype)
    qh = q.permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = time_ms(lambda: sdpa(qh, k, v, attn_mask=mask, scale=scale, enable_gqa=True), max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel() * mask.element_size()
    del k, v
    return dict(kernel="paged_attention_prefill", pool="int8" if int8 else str(dtype), dtype=str(dtype),
                shape=f"q({B},{chunk},{H},{D}) kv_heads={KVH} ctx={ctx[0]}..{ctx[-1]}", features="verify",
                window=0, **err, tol=TOL[str(dtype)], kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                library_bytes=l_bytes, launches_per_verify_step="one a layer (no decode launch)",
                plan=pa._prefill_plan(B, chunk, H, KVH, P, bs, sm_count(dev)) if dtype == torch.bfloat16 else None,
                bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)


def norm_wdtype(torch, dtype, mixed):
    """The weight's dtype of a norm case: x's, or with ``mixed`` the other one (bf16 x with fp32 w is how the
    parameters converted from the JAX package, fp32, meet bf16 activations)."""
    return ({torch.bfloat16: torch.float32, torch.float32: torch.bfloat16}[dtype]) if mixed else dtype


def norm_times(torch, kernel, library, x, iters) -> dict:
    """A norm's eager times (kernel, and the parent's with --parent; the library's where there is one) and
    its cold device times (kernel, parent, library): a CUDA graph rotating over copies of x, without the
    host's launch."""
    return dict(kernel_ms=time_ms(lambda: kernel(x), iters), parent_ms=parent_time(time_ms, lambda: kernel(x), iters),
                library_ms=library and time_ms(lambda: library(x), iters),
                kernel_cold_ms=cold_ms(torch, kernel, (x,), iters),
                parent_cold_ms=parent_time(cold_ms, torch, kernel, (x,), iters),
                library_cold_ms=library and cold_ms(torch, library, (x,), iters))


def phase_rms(torch, dev, dtype, T, iters, mixed=False):
    from deepspeed_tpu_torch.ops import norms

    d = GEOM["d"]
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randn((1, T, d), generator=g, device=dev).to(dtype)
    w = torch.randn((d,), generator=g, device=dev).to(norm_wdtype(torch, dtype, mixed))
    got = norms.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    err = errors(got, norms.rms_norm_ref(x, w, 1e-5))
    item = x.element_size()
    nbytes = 2 * T * d * item + d * w.element_size()
    b_ms, b_by = bound(nbytes, 4 * T * d, dtype)
    p_ms = time_ms(lambda: norms.rms_norm_ref(x, w, 1e-5), iters)
    times = norm_times(torch, lambda xx: norms.rms_norm(xx, w, 1e-5),
                       lambda xx: torch.nn.functional.rms_norm(xx, (d,), w, 1e-5), x, iters)
    return dict(kernel="rms_norm", dtype=str(dtype), shape=f"x(1,{T},{d}) w({d})", wdtype=str(w.dtype), **err,
                tol=TOL[str(dtype)], plain_ms=p_ms, library="F.rms_norm", **times, library_bytes=nbytes,
                bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def phase_layer_norm(torch, dev, dtype, T, iters, mixed=False):
    from deepspeed_tpu_torch.ops import norms

    d = GPT2_GEOM["d"]
    g = torch.Generator(device=dev).manual_seed(T)
    wdtype = norm_wdtype(torch, dtype, mixed)
    x = (torch.randn((1, T, d), generator=g, device=dev) * 2.0 + 0.5).to(dtype)
    w = torch.randn((d,), generator=g, device=dev).to(wdtype)
    b = torch.randn((d,), generator=g, device=dev).to(wdtype)
    got = norms.layer_norm(x, w, b, 1e-5)
    torch.cuda.synchronize()
    err = errors(got, norms.layer_norm_ref(x, w, b, 1e-5))
    item = x.element_size()
    nbytes = 2 * T * d * item + 2 * d * w.element_size()
    b_ms, b_by = bound(nbytes, 8 * T * d, dtype)
    p_ms = time_ms(lambda: norms.layer_norm_ref(x, w, b, 1e-5), iters)
    # F.layer_norm refuses parameters of another type than x's: no library call computes the mixed case
    library = None if mixed else lambda xx: torch.nn.functional.layer_norm(xx, (d,), w, b, 1e-5)
    times = norm_times(torch, lambda xx: norms.layer_norm(xx, w, b, 1e-5), library, x, iters)
    return dict(kernel="layer_norm", dtype=str(dtype), shape=f"x(1,{T},{d}) w({d}) b({d})", wdtype=str(wdtype),
                **err, tol=TOL[str(dtype)], plain_ms=p_ms, library=library and "F.layer_norm", **times,
                library_bytes=nbytes, bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


# (K, N) of the quantised projections: gpt2_1_3b's q/k/v/o, up and down (int8);
# llama3_8b's gate/up and down (packed int4), group size 128
QMM_INT8 = [(2048, 2048), (2048, 8192), (8192, 2048)]
QMM_INT4 = [(4096, 14336), (14336, 4096)]


def phase_qmm(torch, dev, dtype, M, K, N, bits, iters):
    """``quantized_matmul`` against its plain version (dequantise to fp32,
    multiply in fp32). Yardsticks, timed only: ``torch.matmul`` of x with the
    weight dequantised to x's type beforehand (what a dense engine pays, and
    the ``library_ms``), and dequantise + ``torch.matmul`` in one call. At M <=
    64 both are also timed cold (``*_cold_ms``, device time from a CUDA
    graph): rotating over copies of the codes and scales, and of the dense
    weight, of over 100 MB each."""
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    w = torch.randn((K, N), generator=g, device=dev) * 0.02
    q, scales = qm.quantize_weight_kgroups(w, group_size=128, bits=bits, pack=bits == 4)
    packed = q.shape[0] != K
    del w
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    got = qm.quantized_matmul(x, q, scales, packed=packed)
    torch.cuda.synchronize()
    want = qm.quantized_matmul_ref(x, q, scales, packed=packed)
    err = errors(got, want)
    # fp32: sums of K products in another order than the plain version's, held on max(1, max |plain|)
    err["max_abs_err_scaled"] = err["max_abs_err"] / max(1.0, want.float().abs().max().item())
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    del want
    item = x.element_size()
    nbytes = x.numel() * item + q.numel() + scales.numel() * 4 + M * N * item
    flops = 2 * M * K * N
    b_ms, b_by = bound(nbytes, flops, dtype)
    few = max(3, iters // 4)
    run = lambda: qm.quantized_matmul(x, q, scales, packed=packed)
    k_ms = time_ms(run, iters)
    p_ms = time_ms(lambda: qm.quantized_matmul_ref(x, q, scales, packed=packed), few)
    dense = qm._dequantize_kgroups(q, scales, packed).to(dtype)
    l_ms = time_ms(lambda: torch.matmul(x, dense), iters)
    cold = {}
    if M <= 64:
        kcold = lambda qq, ss: qm.quantized_matmul(x, qq, ss, packed=packed)
        cold["kernel_cold_ms"] = cold_ms(torch, kcold, (q, scales), iters)
        cold["parent_cold_ms"] = parent_time(cold_ms, torch, kcold, (q, scales), iters)
        cold["library_cold_ms"] = cold_ms(torch, lambda d: torch.matmul(x, d), (dense,), iters)
    del dense
    dq_ms = time_ms(lambda: torch.matmul(x, qm._dequantize_kgroups(q, scales, packed).to(dtype)), few)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = qm._qmm_plan(M, K, N, scales.shape[0], packed, sms) if dtype == torch.bfloat16 else None
    return dict(kernel="quantized_matmul", codes="packed int4" if packed else "int8", dtype=str(dtype),
                shape=f"x({M},{K}) codes({q.shape[0]},{N}) scales({scales.shape[0]},{N})", **err, tol=tol,
                kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, library="torch.matmul, weight dequantised beforehand",
                parent_ms=parent_time(time_ms, run, iters), **cold, plan=plan,
                dequant_matmul_ms=dq_ms, bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)


def run_cases(torch, cases):
    """Each case (a function of the dtype) in bf16 and fp32, held to its own
    tolerance; returns the per-case records."""
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for case in cases:
            rec = case(dtype)
            log(rec)
            what, tol = rec["tol"]
            if not rec[what] <= tol:
                raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['shape']}: {what} {rec[what]} > {tol}")
            records.append(rec)
            torch.cuda.empty_cache()
    return records


def run_kernel_phases(torch, dev, quick: bool):
    """The three kernels of unquantised serving at llama3_8b's shapes; decode (B 64) and prefill (2 x 512)
    also with ALiBi and with a window."""
    iters = 5 if quick else 50
    sizes = [(phase_decode, 64), (phase_prefill, 512), (phase_rms, 768)] if quick else [
        (phase_decode, 8), (phase_decode, 64), (phase_prefill, 16), (phase_prefill, 256), (phase_prefill, 512),
        (phase_rms, 8), (phase_rms, 768), (phase_rms, 2048)]
    cases = [lambda dt, fn=fn, n=n: fn(torch, dev, dt, n, iters) for fn, n in sizes]
    if not quick:
        cases.append(lambda dt: phase_rms(torch, dev, dt, 2048, iters, mixed=True))
        cases += [lambda dt, fn=fn, n=n, f=f: fn(torch, dev, dt, n, iters, feature=f)
                  for f in ("alibi", "window") for fn, n in ((phase_decode, 64), (phase_prefill, 512))]
        cases += [lambda dt, c=c: phase_verify(torch, dev, dt, 64, c, iters) for c in (5, 2)]
    return run_cases(torch, cases)


def run_quant_kernel_phases(torch, dev, quick: bool):
    """The kernels of quantised serving: ``layer_norm``, ``quantized_matmul`` with
    int8 and packed-int4 codes, decode and prefill on int8 pools at both models' heads."""
    iters = 5 if quick else 30
    norm = lambda T, mixed=False: lambda dt: phase_layer_norm(torch, dev, dt, T, iters, mixed)
    qmm = lambda M, K, N, bits: lambda dt: phase_qmm(torch, dev, dt, M, K, N, bits, iters)
    decode = lambda B, geom, f="none": lambda dt: phase_decode(torch, dev, dt, B, iters, geom, int8=True, feature=f)
    prefill = lambda S, geom, f="none": lambda dt: phase_prefill(torch, dev, dt, S, iters, geom, int8=True, feature=f)
    if quick:
        return run_cases(torch, [norm(768), qmm(64, 2048, 8192, 8), qmm(64, 4096, 14336, 4), decode(64, GPT2_GEOM),
                                 prefill(512, GPT2_GEOM)])
    cases = [norm(T) for T in (8, 768, 2048)] + [norm(2048, mixed=True)]
    cases += [qmm(M, K, N, bits) for bits, shapes in ((8, QMM_INT8), (4, QMM_INT4)) for K, N in shapes
              for M in (8, 64, 512, 1024)]
    for geom in (GPT2_GEOM, GEOM):
        cases += [decode(B, geom) for B in (8, 64)] + [prefill(S, geom) for S in (16, 256, 512)]
        cases += [case(n, geom, f) for f in ("alibi", "window") for case, n in ((decode, 64), (prefill, 512))]
    # the verify windows of speculative decoding on int8 pools at llama3_8b's heads
    cases += [lambda dt, c=c: phase_verify(torch, dev, dt, 64, c, iters, int8=True) for c in (5, 2)]
    # the bf16 pool at gpt2_1_3b's heads (MHA, D 64), with and without ALiBi and a window
    plain = lambda fn, n, f: lambda dt: fn(torch, dev, dt, n, iters, GPT2_GEOM, feature=f)
    cases += [plain(fn, n, f) for f in ("none", "alibi", "window") for fn, n in ((phase_decode, 64),
                                                                                  (phase_prefill, 512))]
    return run_cases(torch, cases)


# ---------------------------------------------------------------- training kernels
# gpt2_1_3b attention: 32 heads of 64, sequence 1024, micro-batch 8
FLASH_CASES = {
    "gpt2_1_3b": dict(B=8, Sq=1024, Sk=1024, H=32, KVH=32, D=64, causal=True),
    "gqa": dict(B=1, Sq=2048, Sk=2048, H=32, KVH=8, D=128, causal=True),
    "sq_lt_sk": dict(B=4, Sq=512, Sk=1024, H=32, KVH=32, D=64, causal=True),
    "window": dict(B=4, Sq=1024, Sk=1024, H=32, KVH=32, D=64, causal=True, window=256),
    "alibi": dict(B=4, Sq=1024, Sk=1024, H=32, KVH=32, D=64, causal=True, alibi=True),
}


def visible_pairs(Sq, Sk, causal, window) -> int:
    """(query, key) pairs the mask lets through, per batch row and head."""
    if not causal:
        return Sq * Sk
    rows = [(Sk - Sq) + r for r in range(Sq)]
    return sum(max(0, min(r, Sk - 1) - (max(r - window + 1, 0) if window else 0) + 1) for r in rows)


def phase_flash(torch, dev, dtype, name, iters):
    """Kernels A, B, C at one shape against their plain versions; SDPA forward
    and backward through autograd as the library yardsticks."""
    from deepspeed_tpu_torch.models import alibi_slopes
    from deepspeed_tpu_torch.ops import flash_attention as fa

    c = FLASH_CASES[name]
    B, Sq, Sk, H, KVH, D = (c[k] for k in ("B", "Sq", "Sk", "H", "KVH", "D"))
    causal, window = c["causal"], c.get("window", 0)
    g = torch.Generator(device=dev).manual_seed(Sq + H)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KVH, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KVH, D), generator=g, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    slopes = torch.from_numpy(alibi_slopes(H)).to(dev) if c.get("alibi") else None
    scale = D**-0.5
    args = (slopes, scale, causal, window)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    delta = fa.flash_delta(o_ref, do)
    bwd = (q, k, v, do, lse_ref, delta, *args)
    dq = fa.flash_bwd_dq(*bwd)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    dq_ref = fa.flash_bwd_dq_ref(*bwd)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bwd)

    def err(a, b):
        # bf16: a row's scale is at least the tensor's mean magnitude (the first
        # causal row's dq is exactly 0 in the plain version: p = 1, dp = delta).
        # fp32: the abs error over max(1, max |want|), since dk/dv sum n_rep heads
        # of 2048 rows (values ~4) in another order than the plain version
        e = errors(a, b, b.float().abs().mean().item())
        e["max_abs_err_scaled"] = e["max_abs_err"] / max(1.0, b.float().abs().max().item())
        return e

    e_fwd = err(o, o_ref)
    e_fwd["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    e_dq = err(dq, dq_ref)
    e_dk, e_dv = err(dk, dk_ref), err(dv, dv_ref)
    e_dkv = {key: max(e_dk[key], e_dv[key]) for key in e_dk}
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    del o_ref, dq_ref, dk_ref, dv_ref
    item = q.element_size()
    pairs = visible_pairs(Sq, Sk, causal, window) * B * H
    nq, nk = q.numel() * item, k.numel() * item
    stats = B * H * Sq * 4  # lse or delta
    recs = {}
    few = max(2, iters // 10)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    mask = None
    if window or slopes is not None or Sq != Sk:
        # SDPA's is_causal aligns queries to the start of the keys; give it the mask instead
        rows = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
        cols = torch.arange(Sk, device=dev)[None, :]
        allowed = (cols <= rows) & ((cols > rows - window) if window else True)
        mask = torch.zeros((Sq, Sk), device=dev).masked_fill(~allowed, float("-inf"))
        if slopes is not None:
            mask = mask[None] + slopes[:, None, None] * cols.float()
        mask = mask.to(dtype)
    lib = lambda qq, kk, vv: sdpa(qq, kk, vv, attn_mask=mask, is_causal=mask is None and causal, scale=scale,
                                  enable_gqa=KVH != H)
    leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
    out = lib(*leaves)
    doh = do.permute(0, 2, 1, 3).contiguous()
    lib_fwd = time_ms(lambda: lib(qh, kh, vh), iters)
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, leaves, doh, retain_graph=True), max(3, iters // 2))
    for kernel, e, fn, ref, n_prod, nbytes in (
            ("flash_fwd", e_fwd, lambda: fa.flash_fwd(q, k, v, *args), lambda: fa.flash_fwd_ref(q, k, v, *args), 2,
             2 * nq + 2 * nk + stats),
            ("flash_bwd_dq", e_dq, lambda: fa.flash_bwd_dq(*bwd), lambda: fa.flash_bwd_dq_ref(*bwd), 3,
             3 * nq + 2 * nk + 2 * stats),
            ("flash_bwd_dkv", e_dkv, lambda: fa.flash_bwd_dkv(*bwd), lambda: fa.flash_bwd_dkv_ref(*bwd), 4,
             2 * nq + 4 * nk + 2 * stats)):
        b_ms, b_by = bound(nbytes, 2 * n_prod * D * pairs, dtype)
        recs[kernel] = dict(kernel=kernel, case=name, dtype=str(dtype), shape=f"q({B},{Sq},{H},{D}) kv({B},{Sk},"
                            f"{KVH},{D}) causal={causal} window={window} alibi={slopes is not None}", **e,
                            tol=tol, kernel_ms=time_ms(fn, iters), plain_ms=time_ms(ref, few),
                            parent_ms=parent_time(time_ms, fn, iters),
                            library_ms=lib_fwd if kernel == "flash_fwd" else lib_bwd,
                            library="SDPA forward" if kernel == "flash_fwd" else "SDPA backward (dq, dk, dv)",
                            bound_bytes=nbytes, bound_flops=2 * n_prod * D * pairs, bound_ms=b_ms, bound_by=b_by)
    del out, leaves
    return list(recs.values())


def flatten(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, in sorted-key order (the engine's)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    return [pair for k in sorted(tree) for pair in flatten(tree[k], f"{prefix}/{k}" if prefix else k)]


def gpt2_leaf_shapes():
    """The 388 parameter shapes of gpt2_1_3b, in the engine's order."""
    from deepspeed_tpu_torch.models import gpt2_1_3b, param_shapes

    return [(path, spec[0]) for path, spec in flatten(param_shapes(gpt2_1_3b()))]


def phase_adam(torch, dev, which, iters):
    """Kernel D over the wte leaf or over every gpt2_1_3b leaf in one
    ``fused_adam_multi`` call, as ``FusedAdam`` makes it (ceil(leaves /
    TABLE_LEAVES) launches), against its plain version. Timed three times
    each in turns (each first, second and last once): this tree's kernel,
    with ``--parent`` the parent build's through the same call (a build with
    only the one-leaf entry point launches once per leaf, ``OldAdamEntry``),
    and ``torch.optim.AdamW(fused=True)`` over the same leaves as the
    yardstick. ``kernel_ms``, ``parent_ms`` and ``library_ms`` are the
    medians; ``beats`` says whether the kernel's median is below each other
    median by more than both spreads."""
    from deepspeed_tpu_torch.ops import fused_adam as fad

    shapes = gpt2_leaf_shapes()
    if which == "wte":
        shapes = [(p, s) for p, s in shapes if p == "wte"]
    g = torch.Generator(device=dev).manual_seed(7)
    leaves = []
    for _, shape in shapes:
        p = torch.randn(shape, generator=g, device=dev)
        grad = torch.randn(shape, generator=g, device=dev)
        m = torch.randn(shape, generator=g, device=dev) * 1e-3
        v = torch.rand(shape, generator=g, device=dev) * 1e-6
        leaves.append((p, grad, m, v))
    n = sum(p.numel() for p, _, _, _ in leaves)
    scal = fad.adam_scalars(1e-4, 10, 0.9, 0.999, grad_mult=0.7, device=dev)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    lists = [list(t) for t in zip(*leaves)]
    ref = [[t.clone() for t in lists[0]], lists[1], [t.clone() for t in lists[2]], [t.clone() for t in lists[3]]]
    launches = fad.fused_adam.launches
    fad.fused_adam_multi(*lists, scal, **hyper)
    launches = fad.fused_adam.launches - launches
    fad.fused_adam_multi_ref(*ref, scal, **hyper)
    torch.cuda.synchronize()
    # relative to each updated tensor's largest value
    pairs = [(a, b) for i in (0, 2, 3) for a, b in zip(lists[i], ref[i])]
    rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
    abs_err = max((a - b).abs().max().item() for a, b in pairs)
    del ref, pairs
    step = lambda: fad.fused_adam_multi(*lists, scal, **hyper)
    p_ms = time_ms(lambda: fad.fused_adam_multi_ref(*lists, scal, **hyper), max(2, iters // 5))
    for p, grad, _, _ in leaves:
        p.grad = grad
    opt = torch.optim.AdamW(lists[0], lr=1e-4, weight_decay=0.01, fused=True)

    def timed(name):
        if name == "parent":
            with parent_kernels():
                return time_ms(step, iters)
        return time_ms(step if name == "kernel" else opt.step, iters)

    names = ["kernel", "parent", "library"] if PARENT["lib"] is not None else ["kernel", "library"]
    runs = {name: [] for name in names}
    for turn in range(3):
        for name in names[turn % len(names):] + names[:turn % len(names)]:
            runs[name].append(timed(name))
    del opt
    nbytes = 28 * n
    alternating = {name: dict(ms=ts, median=sorted(ts)[1], spread=max(ts) - min(ts),
                              gb_per_s=nbytes / sorted(ts)[1] / 1e6) for name, ts in runs.items()}
    k = alternating["kernel"]
    beats = {name: r["median"] - k["median"] > max(k["spread"], r["spread"]) for name, r in alternating.items()
             if name != "kernel"}
    b_ms, b_by = bound(nbytes, 15 * n, torch.float32)
    return dict(kernel="fused_adam", case=which, dtype="torch.float32", shape=f"{len(leaves)} leaves, {n} elements",
                leaves=len(leaves), max_rel_err=rel, max_abs_err=abs_err, tol=("max_rel_err", 1e-6),
                launches_per_step=launches, kernel_ms=k["median"], gb_per_s=k["gb_per_s"],
                share_of_hbm=k["gb_per_s"] * 1e9 / HBM_BYTES_PER_S,
                parent_ms=alternating["parent"]["median"] if "parent" in alternating else None, plain_ms=p_ms,
                library_ms=alternating["library"]["median"], library="torch.optim.AdamW(fused=True)",
                alternating=alternating, beats=beats, bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def run_train_kernel_phases(torch, dev, quick: bool):
    records = []
    iters = 5 if quick else 20
    names = ["gpt2_1_3b"] if quick else list(FLASH_CASES)
    for dtype in (torch.bfloat16, torch.float32):
        for name in names:
            for rec in phase_flash(torch, dev, dtype, name, iters):
                log(rec)
                what, tol = rec["tol"]
                if not (rec[what] <= tol and rec.get("lse_max_abs_err", 0.0) <= 1e-4):
                    raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['case']}: {what} {rec[what]} > {tol}"
                                         f" or lse error {rec.get('lse_max_abs_err')} > 1e-4")
                records.append(rec)
            torch.cuda.empty_cache()
    for which in (["wte"] if quick else ["wte", "all"]):
        rec = phase_adam(torch, dev, which, iters)
        log(rec)
        if not rec["max_rel_err"] <= 1e-6:
            raise AssertionError(f"fused_adam {which}: max_rel_err {rec['max_rel_err']} > 1e-6")
        if rec["launches_per_step"] != opt_launches("FusedAdam", rec["leaves"]):
            raise AssertionError(f"fused_adam {which}: {rec['launches_per_step']} launches for {rec['shape']}")
        records.append(rec)
        torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------- evoformer (DS4Sci_EvoformerAttention)
# AlphaFold2's attention widths (Jumper et al., Nature 2021, Supplementary Information): MSA row attention
# with pair bias (Algorithm 7) and MSA column attention (Algorithm 8), 8 heads of 32; triangle attention
# around the starting node (Algorithm 13), 4 heads of 32; a crop of 256 residues and 128 MSA clusters
# (initial training, Table 4) and of 384 residues and 512 clusters (fine-tuning). q is (1, rows, S, H, D).
EVO_SHAPES = {
    # mask + pair: the summed bias keeps every (row, head): nothing collapses
    "msa_row": dict(q=(1, 128, 256, 8, 32), biases=[(1, 128, 1, 1, 256), (1, 1, 8, 256, 256)]),
    # the pair bias alone: 128 MSA rows share each head's slice (the collapsed dq, Sqb = Sq)
    "msa_row_pair": dict(q=(1, 128, 256, 8, 32), biases=[(1, 1, 8, 256, 256)]),
    # the mask alone: one bias row per column, shared by the 8 heads and every query row (Sqb = 1)
    "msa_col": dict(q=(1, 256, 128, 8, 32), biases=[(1, 256, 1, 1, 128)]),
    "tri_start": dict(q=(1, 256, 256, 4, 32), biases=[(1, 256, 1, 1, 256), (1, 1, 4, 256, 256)]),
    "msa_row_finetune": dict(q=(1, 512, 384, 8, 32), biases=[(1, 512, 1, 1, 384), (1, 1, 8, 384, 384)],
                             dtypes=("torch.bfloat16",)),
}


def evo_inputs(torch, dev, dtype, name):
    """q, k, v, dO of EVO_SHAPES[name] and its biases, from a seeded generator:
    a mask bias of 0 or -1e9 (a tenth of the keys masked, key 0 never) and a
    pair bias of N(0, 1)."""
    c = EVO_SHAPES[name]
    g = torch.Generator(device=dev).manual_seed(sum(c["q"]))
    q, k, v, do = (torch.randn(c["q"], generator=g, device=dev).to(dtype) for _ in range(4))
    biases = []
    for shape in c["biases"]:
        if shape[2:4] == (1, 1):
            mask = torch.where(torch.rand(shape, generator=g, device=dev) < 0.1, -1e9, 0.0)
            mask[..., 0] = 0.0
            biases.append(mask.to(dtype))
        else:
            biases.append(torch.randn(shape, generator=g, device=dev).to(dtype))
    return q, k, v, do, biases


def evo_err(torch, got, want):
    """As phase_flash: bf16 per-row relative error, each row's scale at least the
    tensor's mean magnitude; fp32 abs error over max(1, max |want|)."""
    e = errors(got, want, want.float().abs().mean().item())
    e["max_abs_err_scaled"] = e["max_abs_err"] / max(1.0, want.float().abs().max().item())
    return e


def sdpa_yardstick(torch, q, k, v, mask, do, scale, iters):
    """SDPA over (B, H, S, D) with the summed bias as a float ``attn_mask``,
    forward and backward (dq, dk, dv and, where the backend gives one, dmask):
    the first backend of memory-efficient, cuDNN, math that takes it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v, mask)]
                out = sdpa(*leaves[:3], attn_mask=leaves[3], scale=scale)
                grads = torch.autograd.grad(out, leaves, do, retain_graph=True, allow_unused=True)
                fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), iters)
                bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True, allow_unused=True),
                              max(3, iters // 2))
            return dict(backend=backend.name, mask_grad=grads[3] is not None, fwd_ms=fwd, bwd_ms=bwd)
        except RuntimeError as exc:
            last = str(exc).splitlines()[0][:200]
    return dict(backend=None, error=last, fwd_ms=None, bwd_ms=None)


def phase_evo_kernels(torch, dev, dtype, name, iters):
    """Each bias kernel body at one AlphaFold2 shape against its plain version:
    forward, the dq its layout selects (dbias per program, or summed over the
    sharing programs, whose result must repeat bit for bit) and dk/dv."""
    from deepspeed_tpu_torch.ops import evoformer as evo, flash_attention as fa

    q5, k5, v5, do5, biases = evo_inputs(torch, dev, dtype, name)
    lead, (Sq, H, D) = q5.shape[:-3], q5.shape[-3:]
    B = q5.numel() // (Sq * H * D)
    q, k, v, do = (t.reshape(B, Sq, H, D) for t in (q5, k5, v5, do5))
    bias, meta = fa.flat_bias(*evo.fold_biases(biases, lead), B, H, Sq, Sq)
    del biases
    scale = D**-0.5
    args = (None, scale, False, 0, bias, meta)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, do, lse_ref, fa.flash_delta(o_ref, do), *args)
    collapsed = fa.bias_is_collapsed(meta, B, H)
    if collapsed:
        dq_fn, dq_ref_fn = (lambda: fa.flash_bwd_dq_collapsed(*bwd)), (lambda: fa.flash_bwd_dq_collapsed_ref(*bwd))
        dq, dbias = dq_fn()
        dq_again, dbias_again = dq_fn()
        torch.cuda.synchronize()
        repeats = torch.equal(dbias, dbias_again) and torch.equal(dq, dq_again)
        del dq_again, dbias_again
        dq_ref, dbias_ref = dq_ref_fn()
    else:
        dbias, dbias_ref = torch.empty_like(bias), torch.empty_like(bias)
        dq_fn = lambda: fa.flash_bwd_dq(*bwd, dbias)
        dq_ref_fn = lambda: fa.flash_bwd_dq_ref(*bwd, torch.empty_like(bias))
        dq = dq_fn()
        torch.cuda.synchronize()
        repeats = None
        dq_ref = fa.flash_bwd_dq_ref(*bwd, dbias_ref)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bwd)
    e_fwd = evo_err(torch, o, o_ref)
    e_fwd["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    e_dq = evo_err(torch, dq, dq_ref)
    e_db = evo_err(torch, dbias, dbias_ref)
    e_dk, e_dv = evo_err(torch, dk, dk_ref), evo_err(torch, dv, dv_ref)
    e_dkv = {key: max(e_dk[key], e_dv[key]) for key in e_dk}
    del o_ref, dq_ref, dk_ref, dv_ref, dbias_ref
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    item = q.element_size()
    nq, nk, nb = q.numel() * item, k.numel() * item, bias.numel() * 4
    stats = B * H * Sq * 4
    pairs = B * H * Sq * Sq
    few = max(2, iters // 10)
    # the library yardstick: SDPA with the expanded bias as a float mask in q's type
    mask = fa.expand_bias(bias, meta, B, H, Sq).to(dtype)
    qh, kh, vh, doh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v, do))
    lib = sdpa_yardstick(torch, qh, kh, vh, mask, doh, scale, iters)
    del mask, qh, kh, vh, doh
    shape = (f"q{tuple(q5.shape)} biases {[tuple(s) for s in EVO_SHAPES[name]['biases']]} -> flat bias "
             f"{tuple(bias.shape)} meta {meta}")
    dq_name = "flash_bwd_dq_collapsed" if collapsed else "flash_bwd_dq (bias)"
    recs = []
    for kernel, e, fn, ref, n_prod, nbytes in (
            ("flash_fwd (bias)", e_fwd, lambda: fa.flash_fwd(q, k, v, *args), lambda: fa.flash_fwd_ref(q, k, v, *args),
             2, 2 * nq + 2 * nk + stats + nb),
            (dq_name, dict(e_dq, **{"dbias_" + key: val for key, val in e_db.items()}), dq_fn, dq_ref_fn, 3,
             3 * nq + 2 * nk + 2 * stats + 2 * nb),
            ("flash_bwd_dkv (bias)", e_dkv, lambda: fa.flash_bwd_dkv(*bwd), lambda: fa.flash_bwd_dkv_ref(*bwd), 4,
             2 * nq + 4 * nk + 2 * stats + nb)):
        flops = 2 * n_prod * D * pairs
        b_ms, b_by = bound(nbytes, flops, dtype)
        parent_ms = parent_time(time_ms, fn, iters)
        fwd = kernel.startswith("flash_fwd")
        rec = dict(kernel=kernel, case=name, dtype=str(dtype), shape=shape, **e, tol=tol, kernel_ms=time_ms(fn, iters),
                   plain_ms=time_ms(ref, few), parent_ms=parent_ms, library_ms=lib["fwd_ms" if fwd else "bwd_ms"],
                   library=f"SDPA {'forward' if fwd else 'backward'}, float attn_mask, backend {lib['backend']}, "
                   f"mask gradient {lib.get('mask_grad')}",
                   bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)
        if kernel == dq_name and collapsed:
            rec["repeats_bitwise"] = repeats  # dq and dbias of two launches
        recs.append(rec)
        torch.cuda.empty_cache()
    return recs


def run_evo_kernel_phases(torch, dev, quick: bool):
    records = []
    iters = 5 if quick else 20
    names = ["msa_row"] if quick else list(EVO_SHAPES)
    for dtype in (torch.bfloat16, torch.float32):
        for name in names:
            if str(dtype) not in EVO_SHAPES[name].get("dtypes", (str(dtype),)):
                continue
            for rec in phase_evo_kernels(torch, dev, dtype, name, iters):
                log(rec)
                what, tol = rec["tol"]
                dbias_ok = "dbias_" + what not in rec or rec["dbias_" + what] <= tol
                if not (rec[what] <= tol and dbias_ok and rec.get("lse_max_abs_err", 0.0) <= 1e-4
                        and rec.get("repeats_bitwise", True)):
                    raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['case']}: {what} {rec[what]} "
                                         f"(dbias {rec.get('dbias_' + what)}) > {tol}, lse error "
                                         f"{rec.get('lse_max_abs_err')} or dq and dbias not repeatable")
                records.append(rec)
            torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------- MoE grouped GEMM
# Mixtral-8x7B's experts (8 experts, top-2): wi (and wg) 4096 -> 14336, wo 14336 -> 4096. Rows: the
# mixtral_8x7b_8l serve's own steps, a decode step at its bucket of 8 (16 rows) and a 2,048-token prefill
# quantum (4,096 rows); a decode step of 64 tokens (128 rows) and a 768-token quantum (1,536 rows); all routed
# by seeded top-2 draws; then the 64-token step with expert 3 empty, and with every row on one expert (the
# graph warm-up's all-zero inputs)
MOE_E, MOE_D, MOE_F = 8, 4096, 14336
MOE_GEMM_CASES = {
    "decode8_wi": (8, "top2", MOE_D, MOE_F), "decode8_wo": (8, "top2", MOE_F, MOE_D),
    "prefill2048_wi": (2048, "top2", MOE_D, MOE_F), "prefill2048_wo": (2048, "top2", MOE_F, MOE_D),
    "decode_wi": (64, "top2", MOE_D, MOE_F), "decode_wo": (64, "top2", MOE_F, MOE_D),
    "prefill_wi": (768, "top2", MOE_D, MOE_F), "prefill_wo": (768, "top2", MOE_F, MOE_D),
    "decode_wi_empty_expert": (64, "empty3", MOE_D, MOE_F), "decode_wo_one_expert": (64, "one", MOE_F, MOE_D),
}
# the tile sweep's steps (top-2): the serve's buckets of 8, 136, 520 and 2,048 tokens (16, 272, 1,040 and 4,096
# rows; its first steps' routing record), and the 64- and 768-token cases above
MOE_TILE_TOKENS = (8, 64, 136, 520, 768, 2048)


def moe_routing(np, tokens, kind, seed=0):
    """Rows an expert for ``tokens`` tokens of top-2 routing: each token's two
    distinct experts drawn from a seeded generator ("top2"), with expert 3
    never drawn ("empty3"), or every row on expert 5 ("one")."""
    if kind == "one":
        return [2 * tokens if e == 5 else 0 for e in range(MOE_E)]
    rng = np.random.default_rng(seed + tokens)
    pool = [e for e in range(MOE_E) if not (kind == "empty3" and e == 3)]
    counts = [0] * MOE_E
    for _ in range(tokens):
        for e in rng.choice(pool, size=2, replace=False):
            counts[int(e)] += 1
    return counts


def moe_gemm_operands(torch, np, dev, dtype, counts, K, N):
    """Seeded x (R, K), w (E, K, N) and the int32 offsets of ``counts``."""
    R = sum(counts)
    g = torch.Generator(device=dev).manual_seed(R + K + N)
    x = torch.randn((R, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((MOE_E, K, N), generator=g, device=dev) * K**-0.5).to(dtype)
    bounds = np.concatenate([[0], np.cumsum(counts)]).tolist()
    return x, w, torch.tensor(bounds, dtype=torch.int32, device=dev), bounds


def phase_moe_gemm(torch, dev, dtype, name, iters):
    """``moe_grouped_gemm`` against its plain version (each expert's rows
    times its weight in fp32, host sizes). Yardsticks, timed only: one
    ``torch._grouped_mm`` call (bf16, where the card's torch has it: the
    ``library_ms``) and a per-expert ``torch.matmul`` loop with host sizes;
    with --parent the parent's kernel (``parent_ms``). The bound counts x,
    the routed experts' weights and the output once."""
    import numpy as np

    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    tokens, kind, K, N = MOE_GEMM_CASES[name]
    counts = moe_routing(np, tokens, kind)
    R = sum(counts)
    x, w, offsets, bounds = moe_gemm_operands(torch, np, dev, dtype, counts, K, N)
    got = mg.moe_grouped_gemm(x, w, offsets)
    torch.cuda.synchronize()
    want = mg.moe_grouped_gemm_ref(x, w, offsets)
    err = errors(got, want)
    # fp32: sums of up to 14,336 products in another order than cuBLAS's, held on max(1, max |plain|)
    err["max_abs_err_scaled"] = err["max_abs_err"] / max(1.0, want.float().abs().max().item())
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    repeat = all(torch.equal(mg.moe_grouped_gemm(x, w, offsets), got) for _ in range(2))
    del want
    item = x.element_size()
    routed = sum(1 for c in counts if c > 0)
    nbytes = (R * K + routed * K * N + R * N) * item
    flops = 2 * R * K * N
    b_ms, b_by = bound(nbytes, flops, dtype)
    few = max(3, iters // 5)
    k_ms = time_ms(lambda: mg.moe_grouped_gemm(x, w, offsets), iters)
    parent_ms = parent_time(time_ms, lambda: mg.moe_grouped_gemm(x, w, offsets), iters)
    p_ms = time_ms(lambda: mg.moe_grouped_gemm_ref(x, w, offsets), few)
    spans = [(e, bounds[e], bounds[e + 1]) for e in range(MOE_E) if bounds[e + 1] > bounds[e]]
    loop_ms = time_ms(lambda: [torch.matmul(x[a:b], w[e]) for e, a, b in spans], iters)
    l_ms = None
    if dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):  # no fp32 mode; ends of the groups as offs
        l_ms = time_ms(lambda: torch._grouped_mm(x, w, offs=offsets[1:]), iters)
    rec = dict(kernel="moe_grouped_gemm", case=name, dtype=str(dtype), shape=f"x({R},{K}) w({MOE_E},{K},{N})",
               rows_per_expert=counts, plan=mg.gemm_plan(R, K, N, MOE_E, dtype, sm_count(dev))._asdict(), **err,
               tol=tol, repeats_bit_for_bit=repeat, kernel_ms=k_ms, parent_ms=parent_ms, plain_ms=p_ms, library_ms=l_ms,
               library="torch._grouped_mm (offs = group ends)" if l_ms is not None else None,
               expert_loop_ms=loop_ms, bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms, bound_by=b_by)
    if not repeat:
        raise AssertionError(f"moe_grouped_gemm {name} {dtype}: a repeat differs")
    del x, w
    return rec


def phase_moe_plans(torch, dev, rounds: int, iters: int) -> None:
    """The plan's choices on the top-2 steps of ``MOE_TILE_TOKENS`` for wi
    and wo: each bf16 tile body (``GEMM_TILE_ROWS``) as ``gemm_plan`` would
    launch it (key "rows": its split taken only when the routing gives fewer
    tiles than SMs) and, where that plan has a split, with the split forced
    (key "rows x split"), through the wrapper, held to the plain version and
    timed in ``rounds`` turns: each choice's median and spread (max - min)
    of the turns' means, the plan's pick and the fastest."""
    import numpy as np

    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    what, tol = TOL["torch.bfloat16"]
    sms = sm_count(dev)
    for tokens in MOE_TILE_TOKENS:
        counts = moe_routing(np, tokens, "top2")
        R = sum(counts)
        for proj, (K, N) in (("wi", (MOE_D, MOE_F)), ("wo", (MOE_F, MOE_D))):
            x, w, offsets, _ = moe_gemm_operands(torch, np, dev, torch.bfloat16, counts, K, N)
            pick = mg.gemm_plan(R, K, N, MOE_E, torch.bfloat16, sms)
            plans = {}
            for rows in mg.GEMM_TILE_ROWS:
                own = plans[str(rows)] = mg.gemm_plan(R, K, N, MOE_E, torch.bfloat16, sms, rows=rows)
                if own.split > 1:
                    plans[f"{rows}x{own.split}"] = mg.gemm_plan(R, K, N, MOE_E, torch.bfloat16, sms, rows=rows,
                                                                split=own.split)
            want = mg.moe_grouped_gemm_ref(x, w, offsets)
            errs = {k: errors(mg.moe_grouped_gemm(x, w, offsets, plan=p), want)[what] for k, p in plans.items()}
            del want
            if not all(e <= tol for e in errs.values()):
                raise AssertionError(f"moe_grouped_gemm plans at R {R} {proj}: {what} {errs} > {tol}")
            turns = {k: [] for k in plans}
            for _ in range(rounds):
                for k, p in plans.items():
                    turns[k].append(time_ms(lambda: mg.moe_grouped_gemm(x, w, offsets, plan=p), iters))
            ms = {k: float(np.median(t)) for k, t in turns.items()}
            picked, fastest = str(pick.rows), min(ms, key=ms.get)
            log(dict(phase="moe plans", tokens=tokens, rows=R, proj=proj, rows_per_expert=counts, pick=picked,
                     fastest=fastest, pick_over_fastest=ms[picked] / ms[fastest], median_ms=ms,
                     spread_ms={k: max(t) - min(t) for k, t in turns.items()}, **{what: errs}))
            del x, w
            torch.cuda.empty_cache()


def run_moe_kernel_phases(torch, dev, quick: bool):
    """The grouped GEMM of MoE serving at Mixtral-8x7B's expert shapes, bf16 and fp32, then its plan sweep."""
    iters = 5 if quick else 30
    names = ["decode8_wi"] if quick else list(MOE_GEMM_CASES)
    records = run_cases(torch, [lambda dt, n=n: phase_moe_gemm(torch, dev, dt, n, iters) for n in names])
    phase_moe_plans(torch, dev, 1 if quick else 5, 5 if quick else 10)
    return records


# ---------------------------------------------------------------- step parity
def quantum_inputs(np, rows, n_dec, chunk, bs, P):
    """Flat fused-step operands for rows of (tokens, start, blocks); decode rows
    first (one token; blocks [] marks a padded row on the garbage page)."""
    n_pre = len(rows) - n_dec
    T = n_dec + n_pre * chunk
    ids, pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    slots = (np.arange(T) % bs).astype(np.int32)  # padding writes the garbage page (block 0)
    bt = np.zeros((len(rows), P), np.int32)
    ctx, last = np.ones(len(rows), np.int32), np.zeros(len(rows), np.int32)
    for r, (toks, start, blocks) in enumerate(rows):
        base = r if r < n_dec else n_dec + (r - n_dec) * chunk
        last[r] = base
        if not blocks:
            continue
        p = start + np.arange(len(toks))
        ids[base:base + len(toks)] = toks
        pos[base:base + len(toks)] = p
        slots[base:base + len(toks)] = np.asarray(blocks)[p // bs] * bs + p % bs
        bt[r, :len(blocks)] = blocks
        ctx[r] = start + len(toks)
        last[r] = base + len(toks) - 1
    return ids, pos, bt, ctx, slots, last


# step-parity tolerances, at about twice the errors measured on an H100 at these
# seeded inputs, which repeat exactly from run to run.
# llama3_8b, dense bf16/fp32 weights and pools: fp32 1.3e-5 on logits and pools;
# bf16 6.3e-2 on logits of size ~5, 4.7e-2 on the pools.
# gpt2_1_3b, int8 weights and int8 pools. The pools are compared dequantised, in
# units of one code step (the largest scale, 0.041); `codes` is the share of pool
# codes that differ. A K/V value that differs in its last bits between the two
# bundles can round to the neighbouring code, and later layers inherit the
# difference. Measured, fp32: logits 1.7e-3 of size ~4.4, pools 1.0007 steps,
# 0.80 % of the codes; bf16 (one bf16 rounding step of a K/V value of size 4 is
# 0.75 of a code step): logits 4.7e-2, pools 1.81 steps, 29.7 % of the codes.
# mixtral_8x7b (every block MoE): a token whose two best gates nearly tie can take another expert in the
# plain run than in the kernel run, and its later layers' K/V then differ at O(1) (measured on an H100, bf16,
# free routing: pools 3.57 with logits 0.064). So the plain run takes the kernel run's routing, call by call,
# and the flips its own gate would have made are printed; the tolerances are then those of the dense model.
STEP_TOL = {
    ("llama3_8b", "torch.float32"): dict(logits=1e-4, pools=1e-4),
    ("llama3_8b", "torch.bfloat16"): dict(logits=0.125, pools=0.1),
    ("gpt2_1_3b", "torch.float32"): dict(logits=3.5e-3, pools_steps=2.0, codes=0.016),
    ("gpt2_1_3b", "torch.bfloat16"): dict(logits=0.1, pools_steps=3.6, codes=0.6),
    ("mixtral_8x7b", "torch.float32"): dict(logits=1e-4, pools=1e-4),
    ("mixtral_8x7b", "torch.bfloat16"): dict(logits=0.125, pools=0.1),
}


def phase_step_parity(torch, dev, dtype, model="llama3_8b", n_layers=4):
    """The kernel bundle against ``build_modules(plain=True)`` over two quanta:
    llama3_8b dense, gpt2_1_3b with int8 weights and int8 KV pools, or
    Mixtral-8x7B (every block MoE: the grouped GEMM against its plain version)."""
    import numpy as np

    from deepspeed_tpu_torch.inference.quantization import quantize_for_serving
    from deepspeed_tpu_torch.inference.v2.model_runner import fused_forward
    from deepspeed_tpu_torch.inference.v2.modules import build_modules
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops import paged_attention as pa

    quant = model == "gpt2_1_3b"
    geom = GPT2_GEOM if quant else GEOM
    cfg = {"llama3_8b": model_cfg, "gpt2_1_3b": gpt2_cfg, "mixtral_8x7b": mixtral_cfg}[model](n_layers=n_layers,
                                                                                           dtype=dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=dtype)
    if quant:
        params = quantize_for_serving(params, num_bits=8)
    bs, P = geom["bs"], geom["P"]
    rng = np.random.default_rng(0)
    tok = lambda n: rng.integers(0, cfg.vocab_size, n).tolist()
    a, b, c, d = tok(512), tok(300), tok(200), tok(500)
    blocks, n_blocks = {}, 1  # block 0 is the garbage page
    for name, n in (("a", 513), ("b", 301), ("c", 200), ("d", 500)):  # final KV lengths
        blocks[name] = list(range(n_blocks, n_blocks + -(-n // bs)))
        n_blocks += len(blocks[name])
    pad = ([0], 0, [])
    quanta = [
        (0, 512, [(a, 0, blocks["a"]), (b, 0, blocks["b"]), (d[:400], 0, blocks["d"])]),
        # mixed: 2 decode rows padded to the bucket of 8, a fresh chunk, and d's
        # second chunk continuing its context at position 400
        (8, 256, [([a[0]], 512, blocks["a"]), ([b[0]], 300, blocks["b"])] + [pad] * 6
         + [(c, 0, blocks["c"]), (d[400:], 400, blocks["d"])]),
    ]
    shape = (cfg.n_layers, n_blocks, bs, cfg.kv_heads, cfg.head_dim)
    kvq = 8 if quant else 0
    pools = {v: (pa.make_kv_pool(shape, dtype, dev, kvq), pa.make_kv_pool(shape, dtype, dev, kvq))
             for v in ("kernel", "plain")}
    mods = {"kernel": build_modules(), "plain": build_modules(plain=True)}
    tol = STEP_TOL[(model, str(dtype))]
    moe = cfg.moe_num_experts > 0
    live = lambda pool: tuple(t[:, 1:] for t in pool) if quant else pool[:, 1:].float()  # without the garbage page
    out = []
    for n_dec, chunk, rows in quanta:
        args = [torch.from_numpy(x).to(dev) for x in quantum_inputs(np, rows, n_dec, chunk, bs, P)]
        ids, pos, bt, ctx, slots, last = args
        logits, routes = {}, {}
        for v in ("kernel", "plain"):
            kp, vp = pools[v]
            # MoE: the plain run takes the kernel run's routing (see STEP_TOL), and counts its own flips
            with route_log(pin=routes["kernel"].routes if v == "plain" else None) if moe else \
                    contextlib.nullcontext() as routes[v]:
                logits[v], _, _ = fused_forward(cfg, params, ids, pos, kp, vp, bt, ctx, slots, last, n_dec=n_dec,
                                                chunk=chunk, mods=mods[v])
        torch.cuda.synchronize()
        real = [r for r, (_, _, blk) in enumerate(rows) if blk]
        l_err = (logits["kernel"][real] - logits["plain"][real]).abs().max().item()
        agree = (logits["kernel"][real].argmax(-1) == logits["plain"][real].argmax(-1)).float().mean().item()
        rec = dict(phase="step_parity", model=model, weights="int8" if quant else str(dtype),
                   kv_pool="int8" if quant else str(dtype), dtype=str(dtype), n_layers=n_layers, n_dec=n_dec,
                   chunk=chunk, rows=len(rows), logits_max_abs_err=l_err,
                   logits_max_abs=logits["plain"][real].abs().max().item(), argmax_agree=agree, tol=tol)
        if moe:  # real tokens' routings over the MoE layers, and those the plain run's own gate would change
            real_tok = torch.zeros(ids.shape[0], dtype=torch.bool)
            for r, (toks, _, blk) in enumerate(rows):
                base = r if r < n_dec else n_dec + (r - n_dec) * chunk
                real_tok[base:base + len(toks)] = bool(blk)
            flipped = routes["plain"].flipped
            rec.update(routing="pinned to the kernel run's", routed_tokens=int(real_tok.sum()) * len(flipped),
                       routing_flips=sum(int((f & real_tok).sum()) for f in flipped))
        if quant:
            got, want = ([live(pools[v][i]) for i in (0, 1)] for v in ("kernel", "plain"))
            rec["pools_max_abs_err"] = max((pa.dequantize_kv(a) - pa.dequantize_kv(b)).abs().max().item()
                                           for a, b in zip(got, want))
            rec["pools_step"] = max(b[1].max().item() for b in want)  # the largest scale: one code step
            rec["codes_differ_share"] = max((a[0] != b[0]).float().mean().item() for a, b in zip(got, want))
            pools_ok = (rec["pools_max_abs_err"] <= tol["pools_steps"] * rec["pools_step"]
                        and rec["codes_differ_share"] <= tol["codes"])
        else:
            rec["pools_max_abs_err"] = max((live(pools["kernel"][i]) - live(pools["plain"][i])).abs().max().item()
                                           for i in (0, 1))
            pools_ok = rec["pools_max_abs_err"] <= tol["pools"]
        log(rec)
        if not (l_err <= tol["logits"] and pools_ok and torch.isfinite(logits["kernel"]).all()):
            raise AssertionError(f"step parity failed: {rec}")
        out.append(rec)
    del params, pools
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- serving run
def serving_prompts(np, vocab, longest=1500):
    """Twelve seeded prompts in two waves; three share a 256-token prefix.
    ``longest`` scales the lengths to a model's context (960 for gpt2_1_3b)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 256).tolist()
    lens = [16, 1500, 300, 64, 700, 1100, 40, 900, 128, 1300, 512, 200]
    if longest != 1500:
        lens = [n if n <= 300 else n * longest // 1500 for n in lens]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    for i in (2, 7, 10):  # share a 256-token prefix (two full 128-token blocks)
        prompts[i] = shared + prompts[i][256:]
    return prompts[:6], prompts[6:]


def profiled(torch, fn, cats) -> dict:
    """Run ``fn`` once under torch.profiler and return its wall time and the
    device time of its kernels by category (``cats``: category -> substrings
    of kernel names; the rest is "other"), with the 15 longest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat, top = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = (getattr(e, "self_device_time_total", 0) or getattr(e, "device_time_total", 0)) / 1e3
        if ms <= 0:
            continue
        cat = next((c for c, keys in cats.items() if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        top.append((ms, e.count, e.key[:100]))
    busy = sum(by_cat.values())
    top.sort(reverse=True)
    return dict(wall_ms_profiled=wall_ms, device_busy_ms=busy if top else "not measured",
                busy_share=busy / wall_ms if top else "not measured", by_category_ms=by_cat,
                top=[dict(ms=t, calls=c, name=n) for t, c, n in top[:15]])


MATMUL = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def profile_serve(torch, engine, waves, model, dispatch="graphs") -> None:
    """Device-time breakdown of the serving waves under torch.profiler: a
    separate pass after the timed one, with the prefix cache reset first so
    that it repeats the same admissions. Profiling slows the host, so only
    the shares are meant to be read, not the pass's wall time. ``dispatch``
    names the engine's step mode (``_eager_steps``) during the pass."""
    engine.state.reset_prefix_cache()

    def run():
        for wave in waves:
            engine.generate(wave, max_new_tokens=32)

    # paged_decode_kernel (bf16) and decode_kernel (fp32); a combine of split partials counts as decode
    cats = {"paged_attention_decode": ("decode_kernel", "paged_combine_kernel"),
            "paged_attention_prefill": ("prefill_kernel",),
            # layer_norm by this tree's and a --parent tree's kernel names: a bare "layer_norm" also matches
            # PyTorch's vectorized_layer_norm_kernel
            "rms_norm": ("rms_norm",),
            "layer_norm": ("layer_norm_rows", "layer_norm_general", "layer_norm_vec", "layer_norm_plain"),
            "quantized_matmul": ("qmm_",), "moe_grouped_gemm": ("gg_wgmma_kernel", "gg_bf16_kernel", "gg_fp32_kernel"),
            "matmul": MATMUL, "copy": ("Memcpy", "Memset")}
    log(dict(phase="profile", model=model, dispatch=dispatch, **profiled(torch, run, cats)))


# The serving runs: the longest prompt, max_context, the engine's quantisation fields, and the kernel
# launches per forward that the model's structure fixes
SERVE_RUNS = {
    # the main path; its waves are served again with each step eager (the parent's dispatch) and on graphs
    "llama3_8b": dict(longest=1500, max_context=8192, quant={}, per_forward={"rms_norm": 65},
                      compare_eager=(True, False, False, True)),
    # the same with DS_TPU_PROGRAM_CACHE=16, above the 11 graphs the waves take (8, the default, re-captures):
    # after the first run every step is a replay
    "llama3_8b_cache16": dict(longest=1500, max_context=8192, quant={}, per_forward={"rms_norm": 65},
                              compare_eager=(True, False, False, True), program_cache=16),
    # the same waves through the unfused loop: a prefill step per chunk bucket, a decode step, bursts; served
    # again with eager steps
    "llama3_8b_unfused": dict(longest=1500, max_context=8192, quant=dict(fused_step=False),
                              per_forward={"rms_norm": 65}, compare_eager=(True,)),
    # 24 layers x (2 norms; q, k, v, o, up, down) + the final norm; the tied head stays a dense product
    "gpt2_1_3b_w8_kv8": dict(longest=960, max_context=1024, quant=dict(quant_bits=8, kv_quant_bits=8),
                             per_forward={"layer_norm": 49, "quantized_matmul": 144}),
    # 32 layers x (2 norms; q, k, v, o, gate, up, down) + the final norm and the untied head
    "llama3_8b_w4": dict(longest=1500, max_context=8192, quant=dict(quant_bits=4),
                         per_forward={"rms_norm": 65, "quantized_matmul": 225}),
    # ALiBi serving: BLOOM-7b1's widths cut to 4 layers; 4 x 2 norms + the embedding norm + the final norm;
    # its 2,048 positions bound max_context
    "bloom_7b1_alibi_4l": dict(cfg=lambda: bloom_cfg(n_layers=4), longest=1500, max_context=2048, quant={},
                               per_forward={"layer_norm": 10}, compare_eager=(True, False)),
    # sliding-window serving: Mistral-7B-v0.1's widths cut to 4 layers, window 4,096; prompts up to 6,000
    # tokens, so that the window masks
    "mistral_7b_swa_4l": dict(cfg=lambda: mistral_cfg(n_layers=4), longest=6000, max_context=8192, quant={},
                              per_forward={"rms_norm": 9}, compare_eager=(True, False)),
    # MoE serving: Mixtral-8x7B-v0.1's widths cut to 8 layers (the 32 hold 46.7 B parameters, 93 GB in bf16,
    # more than one card); 8 x 2 norms + the final norm, 8 x 3 grouped products (wi, wg, wo)
    "mixtral_8x7b_8l": dict(cfg=lambda: mixtral_cfg(n_layers=8), longest=1500, max_context=8192, quant={},
                            per_forward={"rms_norm": 17, "moe_grouped_gemm": 24}, compare_eager=(True, False)),
}


def bloom_cfg(**kw):
    """BLOOM-7b1 (bigscience/bloom-7b1 config.json): 30 layers, d 4096, 32 heads, vocab 250,880, ALiBi,
    LayerNorm with an embedding norm, tanh GELU, tied embeddings, 2,048 positions; fields replaced by ``kw``."""
    from deepspeed_tpu_torch.models import TransformerConfig

    fields = dict(vocab_size=250880, n_layers=30, n_heads=32, d_model=4096, max_seq_len=2048, norm="layernorm",
                  activation="gelu", pos_emb="alibi", embedding_norm=True, tie_embeddings=True)
    return TransformerConfig(**{**fields, **kw})


def mistral_cfg(**kw):
    """Mistral-7B-v0.1 (mistralai/Mistral-7B-v0.1 config.json): 32 layers, d 4096, 32/8 heads, d_ff 14,336,
    vocab 32,000, rope theta 1e4, sliding window 4,096, 32,768 positions; fields replaced by ``kw``."""
    from deepspeed_tpu_torch.models import TransformerConfig

    fields = dict(vocab_size=32000, n_layers=32, n_heads=32, n_kv_heads=8, d_model=4096, d_ff=14336,
                  max_seq_len=32768, norm="rmsnorm", activation="swiglu", pos_emb="rope", rope_theta=10000.0,
                  sliding_window=4096, tie_embeddings=False)
    return TransformerConfig(**{**fields, **kw})


def mixtral_cfg(**kw):
    """Mixtral-8x7B-v0.1 (mistralai/Mixtral-8x7B-v0.1 config.json): 32 layers, d 4096, 32/8 heads, d_ff 14,336,
    8 experts, top-2, every block MoE, vocab 32,000, RMSNorm eps 1e-5, rope theta 1e6, 32,768 positions, no
    window, untied head, router aux loss 0.02; fields replaced by ``kw``."""
    from deepspeed_tpu_torch.models import TransformerConfig

    fields = dict(vocab_size=32000, n_layers=32, n_heads=32, n_kv_heads=8, d_model=4096, d_ff=14336,
                  max_seq_len=32768, norm="rmsnorm", norm_eps=1e-5, activation="swiglu", pos_emb="rope",
                  rope_theta=1e6, tie_embeddings=False, moe_num_experts=8, moe_top_k=2, moe_layer_freq=1,
                  moe_aux_loss_coef=0.02)
    return TransformerConfig(**{**fields, **kw})


class route_log:
    """Wraps ``modules.moe_route`` over the enclosed eager steps (it syncs):
    records each MoE call's routing (weights, experts, order, offsets) in
    ``routes``, and in ``live`` which of its tokens are real: those whose KV
    slot lies outside the engine's garbage block 0 (``model_runner._run_stack``
    wrapped too, for the step's slot mapping; ``block_size`` the pool's). With
    ``pin`` (another log's routes) each call returns the pinned routing of the
    same call instead of its own, and ``flipped`` holds per call the tokens
    whose own top-k set differs from the pinned one."""

    def __init__(self, pin=None, block_size=1):
        from deepspeed_tpu_torch.inference.v2 import model_runner, modules

        self.modules, self.runner, self.pin, self.block_size = modules, model_runner, pin, block_size
        self.routes, self.live, self.flipped, self._live = [], [], [], None

    def rows(self, live_only=True):
        """Rows each expert took, per call: of the real tokens only, or
        (``live_only=False``) of every token of the bucket, padding included."""
        if not live_only:
            return [r[3].diff().tolist() for r in self.routes]
        return [r[1][m].reshape(-1).bincount(minlength=r[3].numel() - 1).tolist()
                for r, m in zip(self.routes, self.live)]

    def __enter__(self):
        inner, stack = self._inner, self._stack = self.modules.moe_route, self.runner._run_stack

        def stack_spy(cfg, params, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping, *a, **kw):
            self._live = slot_mapping.reshape(-1) >= self.block_size
            return stack(cfg, params, x, k_pages, v_pages, block_tables, ctx_lens, slot_mapping, *a, **kw)

        def spy(cfg, p, tokens):
            out = inner(cfg, p, tokens)
            self.routes.append(tuple(t.clone() for t in out))
            self.live.append(self._live.clone())
            if self.pin is None:
                return out
            pinned = self.pin[len(self.routes) - 1]
            self.flipped.append((out[1].sort(-1).values != pinned[1].sort(-1).values).any(-1).cpu())
            return pinned

        self.modules.moe_route, self.runner._run_stack = spy, stack_spy
        return self

    def __exit__(self, *exc):
        self.modules.moe_route, self.runner._run_stack = self._inner, self._stack
        return False


def tree_bytes(tree) -> int:
    """Bytes the parameter tree holds on the device (quantised leaves: codes + scales)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if hasattr(tree, "nbytes_quantized"):
        return tree.nbytes_quantized
    return tree.numel() * tree.element_size()


def graph_counts(engine) -> dict:
    """The engine's step counters (``dispatches``: graph replays or eager
    step calls; ``fused_quanta``) and its graph cache's."""
    g = engine.graphs
    return dict(dispatches=engine.dispatches, quanta=engine.fused_quanta, graph_replays=g.replays,
                captures=g.captures, capture_s=g.capture_s, evictions=g.evictions)


def counts_since(engine, before: dict) -> dict:
    return {k: v - before[k] for k, v in graph_counts(engine).items()}


def dispatch_ab(torch, engine, waves, want, turns) -> dict:
    """The serving waves again, with each step replayed from its graph and with
    each step run eagerly (``_eager_steps``: the parent's dispatch), in
    ``turns`` (True: eager), the prefix cache reset before each: the tokens/s
    of each and the graphs' captures; every run's tokens must equal
    ``want``, the first run's."""
    runs = []
    for eager in turns:
        engine.state.reset_prefix_cache()
        engine._eager_steps = eager
        before = graph_counts(engine)
        t0 = time.perf_counter()
        out = [t for wave in waves for t in engine.generate(wave, max_new_tokens=32)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if out != want:
            raise AssertionError(f"serve: the {'eager' if eager else 'graph'} steps' tokens differ from the first run's")
        runs.append(dict(dispatch="eager" if eager else "graphs", wall_s=wall,
                         tokens_per_s=sum(len(o) for o in out) / wall, **counts_since(engine, before)))
    engine._eager_steps = False
    return dict(runs=runs, tokens_equal=True)


def agreement(out, other) -> dict:
    """How far two runs' tokens agree: equal tokens, equal requests, and each
    request's first differing position (None where all agree)."""
    first = [next((i for i, (a, b) in enumerate(zip(o, w)) if a != b), None) for o, w in zip(out, other)]
    return dict(equal_tokens=sum(a == b for o, w in zip(out, other) for a, b in zip(o, w)),
                tokens=sum(len(w) for w in other), equal_requests=first.count(None), first_difference=first)


def phase_serve(torch, dev, counters, run="llama3_8b", profile=False, want=None, beside=None, keep_params=False):
    """One serving run through ``InferenceEngineV2.generate``: the counters in
    ``counters`` are zeroed just before the two waves and read just after.
    Each step replays its bucket's CUDA graph: the graph replays must equal
    the steps (and the fused quanta), and the captures and their seconds are
    printed. ``want``: tokens the run must give; ``beside``: tokens it is
    compared with and the agreement printed (the unfused loop's bf16 products
    have other row counts than the fused loop's, so they round otherwise).
    ``keep_params``: the record keeps the engine's weights (``params``) for
    the next phase, which then needs no set-up of its own."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops.paged_attention import kv_pool_is_quantized

    spec = SERVE_RUNS[run]
    cfg = spec["cfg"]() if "cfg" in spec else gpt2_cfg() if run.startswith("gpt2") else model_cfg()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    bf16_weight_bytes = tree_bytes(params)
    t0 = time.perf_counter()
    with program_cache(spec.get("program_cache")):
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(max_context=spec["max_context"], kv_block_size=128, memory_gb=8.0),
            dtype="bfloat16", device=str(dev), **spec["quant"]))
    fused = engine._fused_enabled
    del params  # a quantised engine holds codes and scales only: let the bf16 kernels go
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    engine_s = time.perf_counter() - t0
    hits = []
    admit = engine.state.admit_sequence

    def admit_spy(uid, tokens):
        seq = admit(uid, tokens)
        hits.append(seq.seen_tokens)
        return seq

    engine.state.admit_sequence = admit_spy
    wave1, wave2 = serving_prompts(np, cfg.vocab_size, spec["longest"])
    engine.generate([wave1[0][:32]], max_new_tokens=4)  # warm-up: cuBLAS handles, allocator (not counted)
    torch.cuda.synchronize()
    hits.clear()
    torch.cuda.reset_peak_memory_stats()
    before = graph_counts(engine)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(wave1, max_new_tokens=32) + engine.generate(wave2, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    steps = counts_since(engine, before)
    n_out = sum(len(o) for o in out)
    slot_heads = 2 * cfg.n_layers * 128 * cfg.kv_heads  # K and V entries of one block, all layers
    int8_pool = kv_pool_is_quantized(engine.k_pages)
    rec = dict(phase="serve", run=run, model=run.split("_w")[0], layers=cfg.n_layers, d_model=cfg.d_model,
               dtype="bfloat16", quant_bits=spec["quant"].get("quant_bits", 0),
               kv_quant_bits=8 if int8_pool else 0, prompts=len(out),
               prompt_tokens=sum(len(p) for p in wave1 + wave2), new_tokens=n_out,
               wall_s=wall, tokens_per_s=n_out / wall, weights_init_s=init_s, engine_init_s=engine_s,
               kv_blocks=engine._n_kv_blocks, weight_bytes=tree_bytes(engine.params),
               weight_bytes_bf16=bf16_weight_bytes,
               kv_block_bytes=slot_heads * ((cfg.head_dim + 4) if int8_pool else cfg.head_dim * 2),
               kv_block_bytes_bf16=slot_heads * cfg.head_dim * 2,
               prefix_hit_tokens=sum(hits), max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, forwards=launches[next(iter(spec["per_forward"]))] / next(iter(
                   spec["per_forward"].values())), loop="fused" if fused else "unfused", **steps,
               graphs_live=len(engine.graphs), program_cache=engine._max_program_variants)
    log(rec)
    if steps["graph_replays"] != steps["dispatches"] or (fused and steps["quanta"] != steps["dispatches"]):
        raise AssertionError(f"serve {run}: {steps['graph_replays']} graph replays, {steps['dispatches']} steps, "
                             f"{steps['quanta']} fused quanta: each step must be one replay"
                             + (" and each quantum one step" if fused else ""))
    if want is not None and out != want:
        raise AssertionError(f"serve {run}: tokens differ from the wanted run's: {agreement(out, want)}")
    if beside is not None:
        log(dict(phase="serve agreement", run=run, beside="llama3_8b (fused loop)", **agreement(out, beside)))
    if not all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o) for o in out):
        raise AssertionError(f"serve {run}: a request did not get 32 in-vocab tokens")
    if sum(hits) == 0:
        raise AssertionError(f"serve {run}: the prefix cache was never hit")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"serve {run}: kernels never launched on the main path: {missing}")
    # the model's structure fixes the launches of each forward: every such counter gives the same number
    # of forwards, and each forward launches the decode kernel, the prefill kernel or both in each layer
    n_fwd = rec["forwards"]
    paged = launches["paged_attention_decode"] + launches["paged_attention_prefill"]
    if (n_fwd != int(n_fwd) or any(launches[name] != n * n_fwd for name, n in spec["per_forward"].items())
            or not cfg.n_layers * n_fwd <= paged <= 2 * cfg.n_layers * n_fwd):
        raise AssertionError(f"serve {run}: launches {launches} do not fit {spec['per_forward']} per forward "
                             f"and {cfg.n_layers} layers")
    if spec.get("compare_eager"):
        rec = dict(rec, dispatch_ab=dispatch_ab(torch, engine, (wave1, wave2), out, spec["compare_eager"]))
        log(dict(phase="serve dispatch", run=run, **rec["dispatch_ab"]))
    if cfg.moe_num_experts > 0:
        # the rows each expert takes in every layer of the first step (a prefill quantum of wave 1) and of the
        # last (a decode step), from an eager pass of wave 1 with 4 new tokens after the timed runs: of the real
        # tokens (padding rows of the bucket apart), beside each step's rows in the bucket and of real tokens,
        # and the tokens the pass generated
        engine.state.reset_prefix_cache()
        engine._eager_steps = True
        with route_log(block_size=engine.state.block_size) as spy:
            out4 = engine.generate(wave1, max_new_tokens=4)
        engine._eager_steps = False
        L, rows = cfg.n_layers, spy.rows()
        rec["expert_rows"] = dict(first_step=rows[:L], last_step=rows[-L:],
                                  bucket_rows=[sum(r) for r in spy.rows(live_only=False)[::L]],
                                  live_rows=[sum(r) for r in rows[::L]],
                                  new_tokens=out4)
        log(dict(phase="serve routing", run=run, steps=len(rows) // L, **rec["expert_rows"]))
    if profile:
        profile_serve(torch, engine, (wave1, wave2), run)
        if spec.get("compare_eager") and fused:
            engine._eager_steps = True
            profile_serve(torch, engine, (wave1, wave2), run, dispatch="eager")
    rec["params"] = engine.params if keep_params else None
    del engine
    gc.collect()  # the engine's closures form cycles: free its pools and weights before the next phase
    torch.cuda.empty_cache()
    rec["tokens"] = out
    return rec


# The SLA load: 24 requests a row, each a shared 256-token system prompt and a tail of 16-1,500 tokens,
# 32 new tokens, greedy; a row with every arrival at t = 0, then Poisson rows at fractions of its requests/s
SLA_SPEC = dict(n_requests=24, prompt_len_range=(16, 1500), max_new_tokens=32, shared_prefix_len=256, seed=0)
SLA_FRACTIONS = (0.25, 0.5, 0.75)


def phase_sla(torch, dev, counters):
    """``sla.run_load`` on llama3_8b at full size (bf16, the serve run's engine
    configuration, random weights from seed 0): the saturation row, then the
    rows of ``SLA_FRACTIONS``, the prefix cache reset before each row; each
    row's tokens/s, TTFT and TPOT percentiles and SLA misses, and
    ``effective_throughput_at_sla`` at the FastGen SLA (TTFT 1 s, TPOT
    250 ms). Every request must get its 32 in-vocab tokens and every kernel
    in ``counters`` must launch in each row."""
    import dataclasses

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2 import sla
    from deepspeed_tpu_torch.models import init_params

    cfg = model_cfg()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(max_context=8192, kv_block_size=128, memory_gb=8.0), dtype="bfloat16",
        device=str(dev)))
    del params
    base = sla.LoadSpec(vocab_size=cfg.vocab_size, **SLA_SPEC)
    engine.generate([sla.load_prompts(base)[1][0][:32]], max_new_tokens=4)  # warm-up, as in serve
    torch.cuda.synchronize()
    rows = []

    def row(rate: float) -> dict:
        engine.state.reset_prefix_cache()
        before = graph_counts(engine)
        for fn in counters:
            fn.launches = 0
        stats = sla.run_load(engine, dataclasses.replace(base, arrival_rate=rate))
        torch.cuda.synchronize()
        rec = dict(phase="sla", model="llama3_8b", arrival_rate=rate, **sla.summarize(stats),
                   launches={fn.__name__: fn.launches for fn in counters}, **counts_since(engine, before))
        log(rec)
        if not all(s.n_new == base.max_new_tokens and all(0 <= t < cfg.vocab_size for t in s.tokens)
                   for s in stats):
            raise AssertionError(f"sla at {rate} requests/s: a request did not get {base.max_new_tokens} "
                                 "in-vocab tokens")
        if any(n <= 0 for n in rec["launches"].values()) or rec["graph_replays"] != rec["dispatches"]:
            raise AssertionError(f"sla at {rate} requests/s: launches {rec['launches']}, {rec['graph_replays']} "
                                 f"replays for {rec['dispatches']} steps")
        rows.append(rec)
        return rec

    saturated = row(float("inf"))["requests_per_sec"]
    for frac in SLA_FRACTIONS:
        row(frac * saturated)
    out = dict(phase="sla", effective_throughput_at_sla=sla.effective_throughput_at_sla(rows), ttft_sla_s=1.0,
               tpot_sla_s=0.25, max_miss=0.01, rates=[r["arrival_rate"] for r in rows])
    log(out)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- speculative decoding
# serve_spec at the JAX bench's chip sizes (bench.py, run_serve_spec): 32 prompts, each a seeded 16-token motif
# repeated 8 times, 128 new tokens, K = 4, bursts off; the KV pool as the bench sizes it
SPEC_SERVE = dict(n_req=32, motif=16, reps=8, new=128, spec_k=4, kv_block=128)
SPEC_PROGRAM_CACHE = 32  # holds every graph key of a serve_spec run (the default, 8, is run beside)


class program_cache:
    """``DS_TPU_PROGRAM_CACHE`` set to ``n`` (None: left as it is) while an engine is built: the engine reads
    the knob once."""

    def __init__(self, n):
        self.n, self.old = n, os.environ.get("DS_TPU_PROGRAM_CACHE")

    def __enter__(self):
        if self.n is not None:
            os.environ["DS_TPU_PROGRAM_CACHE"] = str(self.n)

    def __exit__(self, *exc):
        if self.n is not None:
            if self.old is None:
                del os.environ["DS_TPU_PROGRAM_CACHE"]
            else:
                os.environ["DS_TPU_PROGRAM_CACHE"] = self.old


def spec_prompts(np, vocab, n_req, motif, reps):
    """The bench's prompts: ``n_req`` seeded motifs of ``motif`` tokens, each repeated ``reps`` times."""
    rng = np.random.RandomState(0)
    return [rng.randint(1, vocab, size=motif).tolist() * reps for _ in range(n_req)]


class OracleDrafter:
    """Proposes the tokens a reference run gave after the generated part of the history, so that the
    full-accept path of the verify runs whatever the weights (a test drafter only). A row whose tokens have
    left the reference's (bf16 rounds spec on and off otherwise) gets no proposal: plain decode."""

    def __init__(self, prompts, outs):
        self._want = {tuple(p): o for p, o in zip(prompts, outs)}
        self._plen = len(prompts[0])

    def propose(self, history, k):
        want = self._want.get(tuple(history[:self._plen]), [])
        done = len(history) - self._plen
        if list(history[self._plen:]) != want[:done]:
            return []
        return list(want[done:done + k])


def spec_engine(dev, cfg, params, dtype, cache, **kw):
    """An engine at serve_spec's KV sizes: max_context = the prompt, the new tokens, K and one block; a pool
    of one max_context a request and 8 blocks more (as the bench sizes it)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig

    s = SPEC_SERVE
    max_ctx = min(cfg.max_seq_len, s["motif"] * s["reps"] + s["new"] + s["spec_k"] + s["kv_block"])
    smc = RaggedBatchConfig(max_context=max_ctx, kv_block_size=s["kv_block"],
                            num_kv_blocks=s["n_req"] * -(-max_ctx // s["kv_block"]) + 8)
    with program_cache(cache):
        return InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=smc, dtype=dtype, device=str(dev), spec_k=s["spec_k"], **kw))


def verify_graph_checks(torch, engine, limit=6):
    """Hold the engine's verify graphs to the eager verify step: after each of the first ``limit`` greedy
    verify replays, the same step runs eagerly on the same inputs (it writes the same KV to the same slots)
    and its committed ids and accepted counts are compared with the replay's. Returns the list the checks
    go into; ``del engine._dispatch`` ends them."""
    checks = []
    inner = engine._dispatch

    def spy(key, step, arrays, sampled=False, head=None):
        out = inner(key, step, arrays, sampled, head)
        if key[0] == "spec" and not sampled and len(checks) < limit:
            eager = step(*engine._to_device(*arrays), None)
            checks.append(dict(key=list(key[:3]), committed_equal=bool(torch.equal(out[:, :-1], eager[:, :-1])),
                               counts_equal=bool(torch.equal(out[:, -1], eager[:, -1]))))
        return out

    engine._dispatch = spy
    return checks


def spec_counts(engine) -> dict:
    return dict(decode_steps=engine.decode_steps, decode_tokens=engine.decode_tokens, proposed=engine.spec_proposed,
                accepted=engine.spec_accepted, rollback_tokens=engine.state.spec_rollback_tokens,
                **graph_counts(engine))


def spec_run(torch, engine, prompts, label, counters, vocab, check_graph=False) -> dict:
    """One serve_spec run: a warm-up generate that captures every graph key the run takes (with
    ``check_graph`` also holding the verify graphs to the eager step), then the timed generate, the prefix
    cache reset before each; the counters zeroed just before the timed run and read just after. Gates:
    every request gets its new tokens, in vocab; the KV pool's free blocks come back; each step is one
    graph replay."""
    new = SPEC_SERVE["new"]
    engine.state.reset_prefix_cache()
    before = spec_counts(engine)
    checks = verify_graph_checks(torch, engine) if check_graph else None
    engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    if checks is not None:
        del engine._dispatch
    warm = {k: v - before[k] for k, v in spec_counts(engine).items()}
    engine.state.reset_prefix_cache()
    free0 = engine.state.free_blocks
    before = spec_counts(engine)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    c = {k: v - before[k] for k, v in spec_counts(engine).items()}
    engine.state.reset_prefix_cache()
    n_req = len(prompts)
    rec = dict(phase="serve_spec", run=label, spec=engine._spec_enabled, burst=engine._config.decode_burst,
               drafter=type(engine._drafter).__name__ if engine._spec_enabled else None,
               program_cache=engine._max_program_variants, wall_s=wall, tokens_per_s=n_req * new / wall,
               steps=c["dispatches"], decode_steps=c["decode_steps"], decode_tokens=c["decode_tokens"],
               tokens_per_decode_step=c["decode_tokens"] / max(1, c["decode_steps"]),
               tokens_per_decode_step_per_row=c["decode_tokens"] / max(1, c["decode_steps"]) / n_req,
               proposed=c["proposed"], accepted=c["accepted"],
               acceptance=c["accepted"] / c["proposed"] if c["proposed"] else None,
               rollback_tokens=c["rollback_tokens"], captures=c["captures"], capture_s=c["capture_s"],
               evictions=c["evictions"], graph_replays=c["graph_replays"], warmup_captures=warm["captures"],
               warmup_capture_s=warm["capture_s"], warmup_evictions=warm["evictions"], graphs_live=len(engine.graphs),
               launches=launches, free_blocks_before=free0, free_blocks_after=engine.state.free_blocks,
               verify_graph_checks=checks)
    log(rec)
    if not all(len(o) == new and all(0 <= t < vocab for t in o) for o in out):
        raise AssertionError(f"serve_spec {label}: a request did not get {new} in-vocab tokens")
    if rec["free_blocks_after"] != free0:
        raise AssertionError(f"serve_spec {label}: {free0} free KV blocks before, {rec['free_blocks_after']} after")
    if c["graph_replays"] != c["dispatches"]:
        raise AssertionError(f"serve_spec {label}: {c['graph_replays']} graph replays for {c['dispatches']} steps")
    if launches["paged_attention_prefill"] <= 0 or launches["rms_norm"] <= 0:
        raise AssertionError(f"serve_spec {label}: kernels of the path never launched: {launches}")
    if checks is not None and not (checks and all(x["committed_equal"] and x["counts_equal"] for x in checks)):
        raise AssertionError(f"serve_spec {label}: the verify graph's replay differs from the eager step: {checks}")
    rec["tokens"] = out
    return rec


def phase_serve_spec(torch, dev, counters, params):
    """Speculative decoding on llama3_8b at full width and depth (bf16, ``params``: the serve phase's
    weights), the JAX bench's serve_spec workload, in turns: spec off, spec on (prompt lookup, its first
    verify steps held to the eager step), spec on with the oracle drafter (the reference: spec off's tokens),
    and spec off at the default burst of 32, all at DS_TPU_PROGRAM_CACHE=32; then spec on at the default
    cache. Each run reports tokens/s, decode steps, proposed and accepted drafts, tokens a decode step,
    captures and evictions, and its bf16 token agreement with spec off; the oracle must have accepted."""
    import numpy as np

    cfg = model_cfg()
    s = SPEC_SERVE
    prompts = spec_prompts(np, cfg.vocab_size, s["n_req"], s["motif"], s["reps"])
    runs = {}

    def run(label, cache=SPEC_PROGRAM_CACHE, drafter=None, check_graph=False, **kw):
        engine = spec_engine(dev, cfg, params, "bfloat16", cache, **kw)
        if drafter is not None:
            engine._drafter = drafter
        rec = spec_run(torch, engine, prompts, label, counters, cfg.vocab_size, check_graph)
        if "off" in runs:
            rec["agreement_with_spec_off"] = agreement(rec["tokens"], runs["off"]["tokens"])
            log(dict(phase="serve_spec agreement", run=label, beside="off", **rec["agreement_with_spec_off"]))
        runs[label] = rec
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    run("off", spec_decode=False, decode_burst=0)
    run("on", spec_decode=True, decode_burst=0, check_graph=True)
    run("oracle", spec_decode=True, decode_burst=0, drafter=OracleDrafter(prompts, runs["off"]["tokens"]))
    run("off_burst32", spec_decode=False, decode_burst=32)
    run("on_default_cache", cache=None, spec_decode=True, decode_burst=0)
    if runs["oracle"]["accepted"] <= 0:
        raise AssertionError(f"serve_spec: the oracle drafter's proposals were never accepted: {runs['oracle']}")
    summary = {label: {k: r[k] for k in ("tokens_per_s", "decode_steps", "tokens_per_decode_step", "proposed",
                                         "accepted", "captures", "evictions", "warmup_captures", "warmup_evictions")}
               for label, r in runs.items()}
    log(dict(phase="serve_spec summary", model="llama3_8b", **summary))
    return runs


def phase_spec_fp32(torch, dev, counters, n_layers=2, n_req=8, new=32):
    """A ``n_layers``-layer engine at llama3_8b's widths in fp32 on the card: greedy tokens with speculative
    decoding on equal those with it off, in the fused and the unfused loop (serve_spec's prompts, cut to
    ``n_req`` and ``new`` tokens), with prompt lookup and with the oracle drafter (spec off's tokens, so
    that whole windows are accepted)."""
    import numpy as np

    from deepspeed_tpu_torch.models import init_params

    cfg = model_cfg(n_layers=n_layers)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.float32)
    s = SPEC_SERVE
    prompts = spec_prompts(np, cfg.vocab_size, n_req, s["motif"], s["reps"])
    out = []
    for fused in (True, False):
        toks, counts = {}, {}
        for run in ("off", "on", "oracle"):
            engine = spec_engine(dev, cfg, params, "float32", SPEC_PROGRAM_CACHE, spec_decode=run != "off",
                                 fused_step=fused)
            if run == "oracle":
                engine._drafter = OracleDrafter(prompts, toks["off"])
            for fn in counters:
                fn.launches = 0
            toks[run] = engine.generate(prompts, max_new_tokens=new)
            torch.cuda.synchronize()
            counts[run] = dict(proposed=engine.spec_proposed, accepted=engine.spec_accepted,
                               decode_steps=engine.decode_steps, launches={fn.__name__: fn.launches for fn in counters})
            del engine
            gc.collect()
        rec = dict(phase="spec_fp32", model="llama3_8b", layers=n_layers, loop="fused" if fused else "unfused",
                   tokens_equal={run: toks[run] == toks["off"] for run in ("on", "oracle")}, **counts,
                   agreement_on=agreement(toks["on"], toks["off"]))
        log(rec)
        if not all(rec["tokens_equal"].values()) or counts["oracle"]["accepted"] <= 0:
            raise AssertionError(f"spec_fp32 ({rec['loop']} loop): spec-on tokens differ from spec-off, or the "
                                 f"oracle's drafts were never accepted: {rec}")
        out.append(rec)
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- training run
MICRO, SEQ, TRAIN_STEPS, TIMED_FROM = 8, 1024, 12, 2  # steps 3-12 are timed
# LAMB scales each leaf's step by ||p|| / ||u||, so its elements move by about lr * rms(p), not lr: it
# takes a larger lr (BERT's LAMB runs used 1e-3 to 1e-2)
TRAIN_LR = {"Lamb": 2e-3}


def gpt2_cfg(**kw):
    """gpt2_1_3b with fields replaced (the presets fix n_layers)."""
    import dataclasses

    from deepspeed_tpu_torch.models import gpt2_1_3b

    return dataclasses.replace(gpt2_1_3b(), **kw)


def train_config(torch, optimizer: str, dtype) -> dict:
    lr = TRAIN_LR.get(optimizer, 1e-4)
    return {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": lr,
                                                         "warmup_num_steps": 5}},
            "gradient_clipping": 1.0, "bf16": {"enabled": dtype == torch.bfloat16}}


def train_batch_data(np, vocab: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (MICRO, SEQ)).astype(np.int32)}


class PlainKernels:
    """Bind the plain versions of the flash kernels in place of their wrappers
    on the card, for a parity run (the autograd function calls them by name)."""

    NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dq_collapsed", "flash_bwd_dkv")
    PLAIN = "_ref"  # the plain version of wrapper ``n`` is ``n + PLAIN`` in the same module

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops import flash_attention as fa

        return fa

    def __enter__(self):
        fa = self.module()
        self.fa, self.saved = fa, {n: getattr(fa, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(fa, n, getattr(fa, n + self.PLAIN))

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.fa, n, fn)


class PlainLambKernels(PlainKernels):
    """The plain version of the LAMB direction kernel bound in place of its wrapper."""

    NAMES = ("lamb_direction",)

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops import fused_lamb as tfl

        return tfl


# the plain form of each optimizer of a parity run: (config name, contexts that bind plain versions)
PLAIN_OPTIMIZER = {"FusedAdam": ("AdamW", (PlainKernels,)), "Lamb": ("Lamb", (PlainKernels, PlainLambKernels))}


def phase_train_parity(torch, dev, dtype, counters, n_layers=2, optimizer="FusedAdam"):
    """One engine step of gpt2_1_3b at full width with the kernels (flash
    attention, and FusedAdam or the LAMB direction) and one with their plain
    versions (the flash plain versions under the same autograd function, and
    plain AdamW or LAMB with the direction's plain version), from the same
    weights and batch."""
    import contextlib

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = gpt2_cfg(n_layers=n_layers, dtype=dtype)
    model = CausalLM(cfg)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    batch = train_batch_data(np, cfg.vocab_size)
    ids = torch.from_numpy(batch["input_ids"]).to(dev)
    plain_name, plain_contexts = PLAIN_OPTIMIZER[optimizer]
    res = {}
    for variant, opt_name, contexts in (("kernel", optimizer, ()), ("plain", plain_name, plain_contexts)):
        for fn in counters:
            fn.launches = 0
        with contextlib.ExitStack() as stack:
            for ctx in contexts:
                stack.enter_context(ctx())
            # the loss and the gradients of the compute-dtype weights, as the engine takes them
            leaves = [(path, t.detach().clone().requires_grad_(True)) for path, t in flatten(params)]
            tree = {}
            for path, t in leaves:
                node = tree
                *parents, name = path.split("/")
                for part in parents:
                    node = node.setdefault(part, {})
                node[name] = t.to(dtype)
            loss = model.loss_fn(tree, {"input_ids": ids})
            loss.backward()
            grads = [t.grad for _, t in leaves]
            engine, _, _, _ = dst.initialize(model=model, model_parameters=params,
                                             config=train_config(torch, opt_name, dtype), device=dev)
            step_loss = engine.train_batch(iter([batch]))
            after = [t.detach() for _, t in flatten(engine.module_state_dict())]
            torch.cuda.synchronize()
        res[variant] = dict(loss=loss.item(), step_loss=step_loss.item(), grads=grads, after=after,
                            launches={fn.__name__: fn.launches for fn in counters})
        del engine, leaves, tree
    k, p = res["kernel"], res["plain"]
    lr = TRAIN_LR.get(optimizer, 1e-4)  # the first step runs at the optimizer's lr (consume-then-step clock)
    before = [t for _, t in flatten(params)]
    moved = [(a - b).abs() for a, b in zip(k["after"], p["after"])]
    # each leaf's farthest step in the plain run; k_proj's bias is left out of the share: its true gradient is
    # zero, so LAMB's step there is the engines' own fp32 noise over eps (u = g / (|g| + 1e-8)), and its
    # travel is that noise
    travel = [(a - b).abs().max() for a, b in zip(p["after"], before)]
    kept = [not path.endswith("k_proj/bias") for path, _ in flatten(params)]
    n = sum(m.numel() for m in moved)
    rec = dict(phase="train_parity", model="gpt2_1_3b", optimizer=optimizer, layers=n_layers, dtype=str(dtype),
               loss=p["loss"], loss_abs_err=abs(k["loss"] - p["loss"]),
               step_loss_abs_err=abs(k["step_loss"] - p["step_loss"]),
               # k_proj's bias has a zero true gradient (softmax ignores a per-row
               # constant): its fp32 noise is held on the abs error instead
               grad_max_rel_err=max(((a - b).abs().max() / b.abs().max()).item()
                                    for (path, _), a, b in zip(flatten(params), k["grads"], p["grads"])
                                    if not path.endswith("k_proj/bias")),
               k_bias_grad_max_abs=max(max(a.abs().max().item(), b.abs().max().item())
                                       for (path, _), a, b in zip(flatten(params), k["grads"], p["grads"])
                                       if path.endswith("k_proj/bias")),
               param_max_diff_over_lr=max(m.max().item() for m in moved) / lr,
               param_share_off_by_lr_over_10=sum((m > lr / 10).sum().item() for m in moved) / n,
               param_share_off_by_travel_over_10=sum((m > t / 10).sum().item()
                                                     for m, t, keep in zip(moved, travel, kept) if keep) / n,
               kernel_launches=k["launches"], plain_launches=p["launches"],
               moved_from_init=max((a - b).abs().max().item() for a, b in zip(k["after"], before)) / lr)
    # about twice the errors measured on an H100 at these seeded inputs (fp32:
    # loss equal, gradients 4.2e-6, one parameter element in 2e8 off by more
    # than lr/10; bf16: loss 2.6e-5, gradients 1.7e-2, 0.20 % of the elements:
    # Adam's first step is lr * sign(g), so a gradient that flips sign moves
    # its element by 2 lr). LAMB's first direction is Adam's first step over lr, scaled per leaf by
    # ||p|| / ||u||: its elements move by a leaf's own step, so the share is taken against each leaf's
    # farthest step, with the same bounds
    share = "param_share_off_by_lr_over_10" if optimizer == "FusedAdam" else "param_share_off_by_travel_over_10"
    tol = {"torch.float32": {"loss_abs_err": 1e-5, "grad_max_rel_err": 1e-5, share: 1e-8},
           "torch.bfloat16": {"loss_abs_err": 5e-5, "grad_max_rel_err": 0.035, share: 0.005}}[str(dtype)]
    rec["tol"] = tol
    log(rec)
    del res, params
    torch.cuda.empty_cache()
    kernel_launched = all(n > 0 for name, n in k["launches"].items()
                          if name.startswith(("flash", "fused" if optimizer == "FusedAdam" else "lamb")))
    plain_clean = all(n == 0 for n in p["launches"].values())
    if not (all(rec[key] <= t for key, t in tol.items()) and kernel_launched and plain_clean
            and np.isfinite(rec["loss"])):
        raise AssertionError(f"train parity failed: {rec}")
    return rec


def profile_train(torch, engine, data, optimizer="FusedAdam") -> None:
    """Device-time breakdown of one training step under torch.profiler."""
    cats = {"flash_fwd": ("flash_fwd",), "flash_bwd_dq": ("flash_dq_kernel", "flash_dq_bf16_kernel"),
            "flash_bwd_dkv": ("flash_dkv_kernel", "flash_dkv_bf16_kernel"), "fused_adam": ("adam_kernel",),
            "lamb_direction": ("lamb_dir_kernel",), "matmul": MATMUL, "copy": ("Memcpy", "Memset")}
    log(dict(phase="profile_train", optimizer=optimizer, **profiled(torch, lambda: engine.train_batch(data), cats)))


# the optimizer's kernel and its launches per step over n leaves in one group: FusedAdam one for each
# TABLE_LEAVES leaves, the LAMB direction one per leaf
OPT_COUNTER = {"FusedAdam": "fused_adam", "Lamb": "lamb_direction"}


def opt_launches(optimizer: str, n: int) -> int:
    from deepspeed_tpu_torch.ops.fused_adam import TABLE_LEAVES

    return -(-n // TABLE_LEAVES) if optimizer == "FusedAdam" else n


def phase_train(torch, dev, counters, profile=False, optimizer="FusedAdam"):
    """gpt2_1_3b at full width and depth in bf16 through ``initialize`` and
    ``train_batch``: 12 steps on one seeded batch with ``optimizer``."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = gpt2_cfg(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params,
                                     config=train_config(torch, optimizer, torch.bfloat16), device=dev)
    del params
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for p in engine.parameters())
    data = itertools.repeat(train_batch_data(np, cfg.vocab_size))
    losses = [engine.train_batch(data) for _ in range(TIMED_FROM)]  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    losses += [engine.train_batch(data) for _ in range(TRAIN_STEPS - TIMED_FROM)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    losses = [float(x) for x in losses]
    steps = TRAIN_STEPS - TIMED_FROM
    tokens = MICRO * SEQ
    pairs = visible_pairs(SEQ, SEQ, True, 0)
    # model FLOPs per step: 6 N T for the weights (the tied head included in N),
    # plus attention's two products, forward and backward (3x), over the causal pairs
    flops = 6 * n_params * tokens + 12 * cfg.n_layers * MICRO * cfg.n_heads * cfg.head_dim * pairs
    step_s = wall / steps
    rec = dict(phase="train", model="gpt2_1_3b", optimizer=optimizer, layers=cfg.n_layers, d_model=cfg.d_model,
               params=n_params,
               leaves=len(engine.parameters()), dtype="bfloat16", micro_batch=MICRO, seq=SEQ, steps=TRAIN_STEPS,
               timed_steps=f"{TIMED_FROM + 1}-{TRAIN_STEPS}", losses=losses, step_ms=step_s * 1e3,
               tokens_per_s=tokens / step_s, model_flops_per_step=flops, mfu=flops / step_s / PEAK_FLOPS[
                   "torch.bfloat16"], max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
               weights_init_s=init_s, grad_norm=engine.get_global_grad_norm(), skipped_steps=engine.skipped_steps,
               launches=launches, launches_per_step={k: v / steps for k, v in launches.items()})
    log(rec)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses not finite or not falling: {losses}")
    want = {"flash_fwd": cfg.n_layers, "flash_bwd_dq": cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
            OPT_COUNTER[optimizer]: opt_launches(optimizer, rec["leaves"])}
    bad = {name: launches[name] / steps for name in want if launches[name] != want[name] * steps}
    if bad:
        raise AssertionError(f"train: launches per step {bad}, expected {want}")
    if profile:
        profile_train(torch, engine, data, optimizer)
    return rec


# kernel path vs plain path, forward and backward end to end. bf16: per-row relative error with each
# row's scale at least the tensor's mean magnitude, at about twice the worst measured on an H100 (dq
# 3.9e-2 at msa_row_pair; every other output and gradient at most 2.3e-2): each path's own bf16 o
# enters delta = rowsum(o * dO), so the two backward passes start from deltas one bf16 rounding apart,
# on top of the kernels' own 1e-2. fp32 (measured at most 8e-7): abs error over max(1, max |want|),
# as the kernel checks.
EVO_PATH_TOL = {"torch.bfloat16": ("max_rel_err", 0.08), "torch.float32": ("max_abs_err_scaled", 1e-5)}


# an evoformer call's kernels: the flash bodies, and the rest (the bias fold's sum and cast, autograd's
# reductions of dbias to the biases' shapes, delta)
EVO_CATS = {"flash_fwd": ("flash_fwd",), "flash_bwd_dq": ("flash_dq_bf16_kernel", "flash_dq_kernel"),
            "flash_bwd_dq_collapsed": ("flash_dq_collapsed", "dbias_reduce_kernel"),
            "flash_bwd_dkv": ("flash_dkv",), "reduce (dbias sums, delta)": ("reduce_kernel",),
            "elementwise (bias fold, casts)": ("elementwise_kernel",), "copy": ("Memcpy", "Memset", "copy")}


def evo_rest(torch, q, do, biases, iters) -> dict:
    """CUDA-event times of what an evoformer call does besides its flash
    kernels: the bias fold (``fold_biases`` summing the biases, ``flat_bias``'s
    fp32 copy), its backward (autograd's reduction of dbias to each bias's
    shape) and delta = rowsum(o * do)."""
    from deepspeed_tpu_torch.ops import evoformer as evo, flash_attention as fa

    lead, (Sq, H, D) = q.shape[:-3], q.shape[-3:]
    B = q.numel() // (Sq * H * D)
    leaves = [b.detach().requires_grad_(True) for b in biases]
    fold = lambda: fa.flat_bias(*evo.fold_biases(leaves, lead), B, H, Sq, Sq)[0]
    folded = fold()
    dbias = torch.ones_like(folded)
    o, dof = q.reshape(B, Sq, H, D), do.reshape(B, Sq, H, D)  # q stands in for o: the same shape and type
    return dict(bias_fold_ms=time_ms(fold, iters),
                dbias_reduce_ms=time_ms(lambda: torch.autograd.grad(folded, leaves, dbias, retain_graph=True), iters),
                delta_ms=time_ms(lambda: fa.flash_delta(o, dof), iters))


def phase_evoformer(torch, dev, counters, profile=False):
    """``DS4Sci_EvoformerAttention(q, k, v, biases)`` forward and backward
    through autograd (gradients of q, k, v and every bias) at the AlphaFold2
    shapes, bf16 and fp32 (the fine-tuning crop bf16): the counters are zeroed
    just before each call and read just after; each route must launch the
    forward, dk/dv and the dq its layout selects. The same call with the plain
    versions bound in place gives the output and gradients to compare with;
    ms per forward + backward and peak memory for both, and on the --parent
    kernels; the times of the work around the kernels (``evo_rest``).
    ``profile``: a torch.profiler breakdown of ten bf16 calls at ``msa_row``
    and at the crop."""
    from deepspeed_tpu_torch.ops import evoformer as evo, flash_attention as fa

    def step(q, k, v, do, biases):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, *biases)]
        out = evo.DS4Sci_EvoformerAttention(*leaves[:3], leaves[3:])
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    recs, total = [], {fn.__name__: 0 for fn in counters}
    for dtype in (torch.bfloat16, torch.float32):
        for name, c in EVO_SHAPES.items():
            if str(dtype) not in c.get("dtypes", (str(dtype),)):
                continue
            q, k, v, do, biases = evo_inputs(torch, dev, dtype, name)
            for fn in counters:
                fn.launches = 0
            got = step(q, k, v, do, biases)
            torch.cuda.synchronize()
            launches = {fn.__name__: fn.launches for fn in counters}
            with PlainKernels():
                want = step(q, k, v, do, biases)
                torch.cuda.synchronize()
                plain_launches = sum(fn.launches for fn in counters) - sum(launches.values())
                torch.cuda.reset_peak_memory_stats()
                step(q, k, v, do, biases)
                plain_peak = torch.cuda.max_memory_allocated() / 2**30
                plain_ms = time_ms(lambda: step(q, k, v, do, biases), 3, warmup=1)
            labels = ["out", "dq", "dk", "dv"] + [f"dbias{i}{tuple(b.shape)}" for i, b in enumerate(biases)]
            errs = {lab: evo_err(torch, a, b) for lab, a, b in zip(labels, got, want)}
            finite = all(torch.isfinite(t).all().item() for t in got)
            del got, want
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step(q, k, v, do, biases)
            peak = torch.cuda.max_memory_allocated() / 2**30
            kernel_ms = time_ms(lambda: step(q, k, v, do, biases), 10)
            parent_peak = None
            if PARENT["lib"] is not None:
                with parent_kernels():
                    torch.cuda.reset_peak_memory_stats()
                    step(q, k, v, do, biases)
                    parent_peak = torch.cuda.max_memory_allocated() / 2**30
            parent_ms = parent_time(time_ms, lambda: step(q, k, v, do, biases), 10)
            if parent_ms is not None:  # this tree, parent, parent, this tree: each side its faster mean of 10,
                # so that the host's drift over the run (small calls are host-bound) falls on both sides alike
                parent_ms = min(parent_ms, parent_time(time_ms, lambda: step(q, k, v, do, biases), 10))
                kernel_ms = min(kernel_ms, time_ms(lambda: step(q, k, v, do, biases), 10))
            if profile and dtype == torch.bfloat16 and name in ("msa_row", "msa_row_finetune"):
                log(dict(phase="profile_evoformer", case=name, calls=10,
                         **profiled(torch, lambda: [step(q, k, v, do, biases) for _ in range(10)], EVO_CATS)))
            what, tol = EVO_PATH_TOL[str(dtype)]
            B, (Sq, H, _) = q.numel() // q.shape[-3:].numel(), q.shape[-3:]
            meta = fa.flat_bias(*evo.fold_biases(biases, q.shape[:-3]), B, H, Sq, Sq)[1]
            collapsed = fa.bias_is_collapsed(meta, B, H)
            need = ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq_collapsed" if collapsed else "flash_bwd_dq"]
            rec = dict(phase="evoformer", case=name, dtype=str(dtype), q=tuple(q.shape),
                       biases=[tuple(b.shape) for b in biases], dq_route=need[2], launches=launches,
                       plain_launches=plain_launches, errors={lab: e[what] for lab, e in errs.items()},
                       max_abs_err={lab: e["max_abs_err"] for lab, e in errs.items()}, tol=(what, tol),
                       ms_per_fwd_bwd=kernel_ms, plain_ms_per_fwd_bwd=plain_ms, peak_memory_gb=peak,
                       plain_peak_memory_gb=plain_peak, parent_ms_per_fwd_bwd=parent_ms,
                       parent_peak_memory_gb=parent_peak, rest=evo_rest(torch, q, do, biases, 10), finite=finite)
            log(rec)
            for key in total:
                total[key] += launches[key]
            if not (finite and all(e[what] <= tol for e in errs.values()) and all(launches[n] > 0 for n in need)
                    and plain_launches == 0):
                raise AssertionError(f"evoformer {name} {dtype}: {rec}")
            recs.append(rec)
            del q, k, v, do, biases
            torch.cuda.empty_cache()
    return dict(phase="evoformer", launches=total, records=recs)


# ---------------------------------------------------------------- block-sparse attention (SparseSelfAttention)
# Attention widths of models the repository supports at the lengths sparse attention is used for, each
# with a layout from a public source. q is (B, S, H, D); KV heads `kvh` are expanded to H before the
# kernels, as the path does.
SPARSE_SHAPES = {
    # gpt2_1_3b's heads at a long context with the upstream FixedSparsityConfig defaults (Sparse Transformer)
    "fixed_uni_gpt2_1_3b": dict(config="FixedSparsityConfig", fields=dict(
        num_heads=32, block=16, num_local_blocks=4, num_global_blocks=1, attention="unidirectional"),
        q=(2, 8192, 32, 64), kvh=32, causal=True),
    # BERT-base / gpt2_125m width; the `fixed` example of DeepSpeed's sparse-attention tutorial
    "fixed_bi_bert": dict(config="FixedSparsityConfig", fields=dict(
        num_heads=12, block=16, different_layout_per_head=True, num_local_blocks=4, num_global_blocks=1,
        num_different_global_patterns=4), q=(8, 4096, 12, 64), kvh=12, causal=False),
    # google/bigbird-roberta-base: 12 heads of 64, block 64, 3 random blocks, 4096 positions
    "bigbird_base": dict(config="BigBirdSparsityConfig", fields=dict(
        num_heads=12, block=64, num_random_blocks=3, num_sliding_window_blocks=3, num_global_blocks=1),
        q=(8, 4096, 12, 64), kvh=12, causal=False),
    # llama3_8b's heads (32 query / 8 KV, D 128): GQA expansion, D 128, block 64
    "longformer_gqa_llama3_8b": dict(config="BSLongformerSparsityConfig", fields=dict(
        num_heads=32, block=64, num_sliding_window_blocks=3, global_block_indices=[0], attention="unidirectional"),
        q=(1, 8192, 32, 128), kvh=8, causal=True),
    # the port's flash kernels' gpt2_1_3b training shape (FLASH_CASES): a dense layout, held to flash
    "dense_gpt2_1_3b": dict(config="DenseSparsityConfig", fields=dict(num_heads=32, block=64),
                            q=(8, 1024, 32, 64), kvh=32, causal=True),
}


def sparse_config(name):
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    c = SPARSE_SHAPES[name]
    return getattr(sa, c["config"])(**c["fields"])


def sparse_inputs(torch, dev, dtype, name):
    """q, k, v, dO of SPARSE_SHAPES[name] from a seeded generator (k, v with
    the case's KV heads), and the case's block lists on the card."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    c = SPARSE_SHAPES[name]
    B, S, H, D = c["q"]
    g = torch.Generator(device=dev).manual_seed(S + H + D)
    q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn((B, S, c["kvh"], D), generator=g, device=dev).to(dtype) for _ in range(2))
    kidx, qidx = ss._device_lists(sparse_config(name), S, H, c["causal"], dev)
    return q, k, v, do, kidx, qidx


def sparse_pairs(np, name) -> tuple:
    """(active (query, key) pairs per batch row over all heads, active blocks per
    batch row, layout density): counted from the causal-trimmed layout, the
    diagonal blocks of a causal run at blk (blk + 1) / 2 pairs each."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    c = SPARSE_SHAPES[name]
    _, S, H, _ = c["q"]
    cfg = sparse_config(name)
    blk = cfg.block
    layout = np.broadcast_to(cfg.make_layout(S), (H, S // blk, S // blk))
    kidx, _ = ss._active_lists(layout, c["causal"])
    blocks = int((kidx >= 0).sum())
    pairs = blocks * blk * blk
    full = H * S * S
    if c["causal"]:
        diag = H * (S // blk)  # the causal-trimmed layouts all keep their diagonal blocks
        pairs -= diag * blk * (blk - 1) // 2
        full = H * S * (S + 1) // 2
    return pairs, blocks, pairs / full


def sdpa_bool_yardstick(torch, q, k, v, mask, do, scale, iters):
    """SDPA over (B, H, S, D) with the boolean token mask, forward and backward
    (dq, dk, dv), on the cuDNN and the memory-efficient backends: the faster of
    the two that take it (forward + backward), else the math backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    runs, last = [], None
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        if backend == SDPBackend.MATH and runs:
            break
        try:
            with sdpa_kernel(backend):
                leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = sdpa(*leaves, attn_mask=mask, scale=scale)
                fwd = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), iters)
                bwd = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), max(3, iters // 2))
            runs.append(dict(backend=backend.name, fwd_ms=fwd, bwd_ms=bwd))
        except (RuntimeError, torch.cuda.OutOfMemoryError) as exc:
            last = str(exc).splitlines()[0][:200]
        out = leaves = None
        torch.cuda.empty_cache()
    if not runs:
        return dict(backend=None, error=last, fwd_ms=None, bwd_ms=None)
    best = min(runs, key=lambda r: r["fwd_ms"] + r["bwd_ms"])
    return dict(best, tried={r["backend"]: (r["fwd_ms"], r["bwd_ms"]) for r in runs})


def phase_sparse_kernels(torch, dev, dtype, name, iters):
    """sparse_fwd, sparse_bwd_dq and sparse_bwd_dkv at one SPARSE_SHAPES case
    against their plain versions, with bounds, SDPA with the boolean token
    mask as the library yardstick (bf16) and, at the dense layout, the flash
    kernels on the same inputs."""
    import numpy as np

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    c = SPARSE_SHAPES[name]
    B, S, H, D = c["q"]
    blk, causal = sparse_config(name).block, c["causal"]
    q, k, v, do, kidx, qidx = sparse_inputs(torch, dev, dtype, name)
    k, v = ss._expand_kv(k, H // c["kvh"]), ss._expand_kv(v, H // c["kvh"])
    # the bf16 kernels' walks, as the path's: the forward's and dq's over kidx, the dk/dv's over qidx
    qplan = ss._device_query_plan(sparse_config(name), S, H, causal, dev)
    plan = ss._device_dkv_plan(sparse_config(name), S, H, causal, dev)
    scale = D**-0.5
    args = (blk, scale, causal)
    fwd_fn = lambda: ss.sparse_fwd(q, k, v, kidx, *args, plan=qplan)
    o, lse = fwd_fn()
    delta = ss.flash_delta(o, do)
    bwd = (q, k, v, do, lse, delta)
    dq_fn = lambda: ss.sparse_bwd_dq(*bwd, kidx, *args, plan=qplan)
    dkv_fn = lambda: ss.sparse_bwd_dkv(*bwd, qidx, *args, plan=plan)
    dq = dq_fn()
    dk, dv = dkv_fn()
    # each kernel launched twice more on the same inputs: bit-equal results (no atomics, fixed-order sums)
    again = fwd_fn() + (dq_fn(),) + dkv_fn()
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip((o, lse, dq, dk, dv), again)]
    repeats = {"sparse_fwd": same[0] and same[1], "sparse_bwd_dq": same[2], "sparse_bwd_dkv": same[3] and same[4]}
    del again
    o_ref, lse_ref = ss.sparse_fwd_ref(q, k, v, kidx, *args)
    dq_ref = ss.sparse_bwd_dq_ref(*bwd, kidx, *args)
    dk_ref, dv_ref = ss.sparse_bwd_dkv_ref(*bwd, qidx, *args)

    def err(a, b):
        # as phase_flash: bf16 per row with each row's scale at least the tensor's mean magnitude;
        # fp32 abs error over max(1, max |want|)
        e = errors(a, b, b.float().abs().mean().item())
        e["max_abs_err_scaled"] = e["max_abs_err"] / max(1.0, b.float().abs().max().item())
        return e

    e_fwd = err(o, o_ref)
    e_fwd["lse_max_abs_err"] = (lse - lse_ref).abs().max().item()
    e_dq = err(dq, dq_ref)
    e_dk, e_dv = err(dk, dk_ref), err(dv, dv_ref)
    e_dkv = {key: max(e_dk[key], e_dv[key]) for key in e_dk}
    del o_ref, lse_ref, dq_ref, dk_ref, dv_ref
    flash = {}
    if c["config"] == "DenseSparsityConfig":  # the same work as the flash kernels: hold the two to each other
        o_f, lse_f = fa.flash_fwd(q, k, v, None, scale, causal, 0)
        dq_f = fa.flash_bwd_dq(*bwd, None, scale, causal, 0)
        dk_f, dv_f = fa.flash_bwd_dkv(*bwd, None, scale, causal, 0)
        e = {"sparse_fwd": err(o, o_f), "sparse_bwd_dq": err(dq, dq_f)}
        e["sparse_fwd"]["lse_max_abs_err"] = (lse - lse_f).abs().max().item()
        e_k, e_v = err(dk, dk_f), err(dv, dv_f)
        e["sparse_bwd_dkv"] = {key: max(e_k[key], e_v[key]) for key in e_k}
        fargs = (None, scale, causal, 0)
        flash = {"sparse_fwd": (e["sparse_fwd"], time_ms(lambda: fa.flash_fwd(q, k, v, *fargs), iters)),
                 "sparse_bwd_dq": (e["sparse_bwd_dq"], time_ms(lambda: fa.flash_bwd_dq(*bwd, *fargs), iters)),
                 "sparse_bwd_dkv": (e["sparse_bwd_dkv"], time_ms(lambda: fa.flash_bwd_dkv(*bwd, *fargs), iters))}
        del o_f, lse_f, dq_f, dk_f, dv_f
    del o, dq, dk, dv
    torch.cuda.empty_cache()
    tol = ("max_abs_err_scaled", 1e-5) if dtype == torch.float32 else TOL[str(dtype)]
    pairs, blocks, density = sparse_pairs(np, name)
    pairs *= B
    item = q.element_size()
    nt = q.numel() * item  # one (B, S, H, D) tensor
    stats = B * H * S * 4  # lse or delta
    few = max(2, iters // 10)
    # the library yardstick: SDPA with the (H, S, S) boolean token mask of the layout, in bf16, the type of
    # the kernels line (the plain versions, which take a second a call at the largest cases, too)
    lib = dict(backend=None, fwd_ms=None, bwd_ms=None)
    if dtype == torch.bfloat16:
        mask = torch.from_numpy(np.ascontiguousarray(ss.layout_to_token_mask(
            np.broadcast_to(sparse_config(name).make_layout(S), (H, S // blk, S // blk)), blk, causal))).to(dev)
        qh, kh, vh, doh = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
        lib = sdpa_bool_yardstick(torch, qh, kh, vh, mask[None], doh, scale, iters)
        del mask, qh, kh, vh, doh
        torch.cuda.empty_cache()
    shape = f"q({B},{S},{H},{D}) kv heads {c['kvh']} block {blk} causal={causal}"
    recs = []
    for kernel, e, fn, ref, idx, walk, n_prod, nbytes in (
            ("sparse_fwd", e_fwd, fwd_fn, lambda: ss.sparse_fwd_ref(q, k, v, kidx, *args), kidx, qplan, 2,
             4 * nt + stats),
            ("sparse_bwd_dq", e_dq, dq_fn, lambda: ss.sparse_bwd_dq_ref(*bwd, kidx, *args), kidx, qplan, 3,
             5 * nt + 2 * stats),
            ("sparse_bwd_dkv", e_dkv, dkv_fn, lambda: ss.sparse_bwd_dkv_ref(*bwd, qidx, *args), qidx, plan, 4,
             6 * nt + 2 * stats)):
        nbytes += idx.numel() * 4
        flops = 2 * n_prod * D * pairs
        b_ms, b_by = bound(nbytes, flops, dtype)
        fwd = kernel == "sparse_fwd"
        plain_ms = time_ms(ref, few, warmup=1) if dtype == torch.bfloat16 else None
        rec = dict(kernel=kernel, case=name, dtype=str(dtype), shape=shape, **e, tol=tol,
                   kernel_ms=time_ms(fn, iters), plain_ms=plain_ms,
                   library_ms=lib["fwd_ms"] if fwd else lib["bwd_ms"],
                   library=f"SDPA {'forward' if fwd else 'backward (dq, dk, dv together)'}, boolean token mask, "
                           f"backend {lib['backend']}" if lib["backend"] else None, library_tried=lib.get("tried"),
                   active_pairs=pairs,
                   active_blocks=blocks * B,
                   density=density, list_width=idx.shape[2], bound_bytes=nbytes, bound_flops=flops, bound_ms=b_ms,
                   bound_by=b_by)
        # the redesigned bf16 kernels: the parent's time, two launches bit-equal, and the walk's plan
        rec.update(parent_ms=parent_time(time_ms, fn, iters), repeats_bitwise=repeats[kernel],
                   plan=dict(items=walk.n_items, split_groups=walk.n_reduce, pieces=walk.n_slots,
                             longest_walk=walk.max_entries) if dtype == torch.bfloat16 else None)
        if kernel in flash:
            fe, f_ms = flash[kernel]
            rec.update(flash_ms=f_ms, vs_flash_max_rel_err=fe["max_rel_err"],
                       vs_flash_max_abs_err_scaled=fe["max_abs_err_scaled"],
                       vs_flash_lse_max_abs_err=fe.get("lse_max_abs_err", 0.0))
        recs.append(rec)
    torch.cuda.empty_cache()
    return recs


def run_sparse_kernel_phases(torch, dev, quick: bool):
    records = []
    iters = 5 if quick else 10
    names = ["fixed_uni_gpt2_1_3b"] if quick else list(SPARSE_SHAPES)
    for dtype in (torch.bfloat16, torch.float32):
        for name in names:
            for rec in phase_sparse_kernels(torch, dev, dtype, name, iters):
                log(rec)
                what, tol = rec["tol"]
                ok = rec[what] <= tol and rec.get("lse_max_abs_err", 0.0) <= 1e-4 and rec["repeats_bitwise"]
                if "flash_ms" in rec:  # the dense layout against the flash kernels, at the same tolerance
                    flash_what = "vs_flash_max_abs_err_scaled" if what == "max_abs_err_scaled" else "vs_flash_" + what
                    ok = ok and rec[flash_what] <= tol and rec["vs_flash_lse_max_abs_err"] <= 1e-4
                if not ok:
                    raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['case']}: {what} {rec[what]} > "
                                         f"{tol}, lse error {rec.get('lse_max_abs_err')}, not repeatable "
                                         f"or the flash kernels disagree: {rec}")
                records.append(rec)
            torch.cuda.empty_cache()
    return records


class PlainSparseKernels(PlainKernels):
    """The plain versions of the sparse kernels bound in place of their wrappers
    (without the plans, the kernels' walks, which they do not need)."""

    NAMES = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

        return ss

    def __enter__(self):
        super().__enter__()
        ss = self.fa
        for n in self.NAMES:
            setattr(ss, n, lambda *args, plan=None, ref=getattr(ss, n + self.PLAIN): ref(*args))


# kernel path vs plain path, forward and backward end to end. bf16: per-row relative error with each
# row's scale at least the tensor's mean magnitude (as the evoformer path: each path's own bf16 o enters
# delta = rowsum(o * dO), so the backward passes start one bf16 rounding apart); fp32: abs error over
# max(1, max |want|), as the kernel checks.
SPARSE_PATH_TOL = {"torch.bfloat16": ("max_rel_err", 0.08), "torch.float32": ("max_abs_err_scaled", 1e-5)}


def phase_sparse(torch, dev, counters):
    """``SparseSelfAttention(cfg, causal)(q, k, v)`` forward and backward
    through autograd (gradients of q, k and v) at each SPARSE_SHAPES case in
    bf16: the counters are zeroed just before each call and read just after,
    and each of the three kernels must launch. The same call with the plain
    versions bound in place gives the output and gradients to compare with.
    ms per forward + backward and peak memory beside the plain path and SDPA
    with the token mask."""
    import numpy as np

    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    recs, total = [], {fn.__name__: 0 for fn in counters}
    dtype = torch.bfloat16
    for name, c in SPARSE_SHAPES.items():
        q, k, v, do, _, _ = sparse_inputs(torch, dev, dtype, name)
        attn = sa.SparseSelfAttention(sparse_config(name), causal=c["causal"])

        def step(q, k, v, do, fn=attn):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            out.backward(do)
            return [out.detach()] + [t.grad for t in leaves]

        for fn in counters:
            fn.launches = 0
        got = step(q, k, v, do)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        finite = all(torch.isfinite(t).all().item() for t in got)
        before = sum(fn.launches for fn in counters)
        with PlainSparseKernels():
            want = step(q, k, v, do)
            torch.cuda.synchronize()
            plain_launches = sum(fn.launches for fn in counters) - before
            torch.cuda.reset_peak_memory_stats()
            step(q, k, v, do)
            plain_peak = torch.cuda.max_memory_allocated() / 2**30
            plain_ms = time_ms(lambda: step(q, k, v, do), 2, warmup=0)
        errs = {lab: evo_err(torch, a, b) for lab, a, b in zip(["out", "dq", "dk", "dv"], got, want)}
        del got, want
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step(q, k, v, do)
        peak = torch.cuda.max_memory_allocated() / 2**30
        kernel_ms = time_ms(lambda: step(q, k, v, do), 5, warmup=1)
        parent_ms = parent_time(time_ms, lambda: step(q, k, v, do), 5, warmup=1)
        # SDPA with the token mask, forward + backward through autograd, on the expanded K/V
        B, S, H, D = c["q"]
        blk = sparse_config(name).block
        mask = torch.from_numpy(np.ascontiguousarray(ss.layout_to_token_mask(
            np.broadcast_to(sparse_config(name).make_layout(S), (H, S // blk, S // blk)), blk, c["causal"]))).to(dev)
        sdpa = lambda qq, kk, vv: torch.nn.functional.scaled_dot_product_attention(
            qq.transpose(1, 2), ss._expand_kv(kk, H // c["kvh"]).transpose(1, 2),
            ss._expand_kv(vv, H // c["kvh"]).transpose(1, 2), attn_mask=mask[None]).transpose(1, 2)
        try:
            torch.cuda.reset_peak_memory_stats()
            step(q, k, v, do, sdpa)
            sdpa_peak = torch.cuda.max_memory_allocated() / 2**30
            sdpa_ms = time_ms(lambda: step(q, k, v, do, sdpa), 3, warmup=1)
        except torch.cuda.OutOfMemoryError as exc:
            sdpa_peak, sdpa_ms = None, f"out of memory: {str(exc).splitlines()[0][:120]}"
        del mask
        what, tol = SPARSE_PATH_TOL[str(dtype)]
        rec = dict(phase="sparse", case=name, dtype=str(dtype), q=tuple(q.shape), kv_heads=c["kvh"],
                   config=c["config"], block=blk, causal=c["causal"], launches=launches,
                   plain_launches=plain_launches, errors={lab: e[what] for lab, e in errs.items()},
                   max_abs_err={lab: e["max_abs_err"] for lab, e in errs.items()}, tol=(what, tol),
                   ms_per_fwd_bwd=kernel_ms, parent_ms_per_fwd_bwd=parent_ms, peak_memory_gb=peak,
                   plain_ms_per_fwd_bwd=plain_ms,
                   plain_peak_memory_gb=plain_peak, sdpa_ms_per_fwd_bwd=sdpa_ms, sdpa_peak_memory_gb=sdpa_peak,
                   sdpa_backend="default dispatch", finite=finite)
        log(rec)
        for key in total:
            total[key] += launches[key]
        if not (finite and all(e[what] <= tol for e in errs.values()) and all(n > 0 for n in launches.values())
                and plain_launches == 0):
            raise AssertionError(f"sparse {name} {dtype}: {rec}")
        recs.append(rec)
        del q, k, v, do
        torch.cuda.empty_cache()
    return dict(phase="sparse", launches=total, records=recs)


# ---------------------------------------------------------------- group-wise quantisation (the v1 engine's flat layout)
QUANT_GROUP = 64  # the v1 engine's group size (the config's default)
# odd sizes: (rows, group): a size of 3 g, a last CUDA block cut short, scalar loads (g 3), teams shorter
# than a warp (g 16) and a team that loops over its group (g 4096)
QUANT_ODD = [(3, 64), (1003, 64), (224, 3), (15, 16), (2, 4096)]


def llama_flat_leaves():
    """The 226 leaves of llama3_8b that ``quantize_model_params`` quantises
    (>= 2-D and >= 1024 elements), as (path, shape)."""
    from deepspeed_tpu_torch.models import param_shapes

    return [(path, spec[0]) for path, spec in flatten(param_shapes(model_cfg()))
            if len(spec[0]) >= 2 and math.prod(spec[0]) >= 1024]


def each(fn, calls) -> None:
    """``fn(*args)`` for each args in ``calls``, each result dropped at once (one output alive at a time)."""
    for args in calls:
        fn(*args)


def quant_bytes(n: int, rows: int, item: int) -> int:
    """Bytes of one quantise (read ``item``-byte values, write codes and scales) or dequantise (the reverse)."""
    return n * item + n + rows * 4


def codes_differ(torch, got, want) -> int:
    """Elements of two (codes, scales) pairs that differ in any bit."""
    return int((got[0] != want[0]).sum()) + int((got[1].view(torch.int32) != want[1].view(torch.int32)).sum())


def phase_quant_odd(torch, dev, cases):
    """Quantise and dequantise at odd sizes against the plain versions, bit for bit."""
    from deepspeed_tpu_torch.ops import quantization as tq

    g = torch.Generator(device=dev).manual_seed(12)
    bad = []
    for rows, group in cases:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((rows, group), generator=g, device=dev).to(dtype)
            x[0] = 0.0  # an all-zero group
            for bits in (8, 4):
                got = tq.quantize_groupwise(x, group, bits)
                want = tq.quantize_groupwise_xla(x, group, bits)
                bad += [f"quantize {rows}x{group} {dtype} int{bits}"] if codes_differ(torch, got, want) else []
                for out in (torch.bfloat16, torch.float32):
                    if not torch.equal(tq.dequantize_groupwise(*got, out_dtype=out),
                                       tq.dequantize_groupwise_xla(*got, out_dtype=out)):
                        bad.append(f"dequantize {rows}x{group} int{bits} -> {out}")
    torch.cuda.synchronize()
    log(dict(phase="quant odd sizes", cases=[f"{r}x{g}" for r, g in cases], bit_equal=not bad))
    if bad:
        raise AssertionError(f"quant kernels differ from their plain versions at odd sizes: {bad}")


def phase_quant_kernels(torch, dev, quick: bool):
    """``quantize_groupwise`` and ``dequantize_groupwise`` over llama3_8b's 226
    flat-quantised leaves (random bf16 weights, group 64) at int8 and int4:
    codes, scales and the dequantised bf16 and fp32 weights bit-equal to the
    plain versions, leaf by leaf; then times at ``wte`` and over all leaves."""
    from deepspeed_tpu_torch.ops import quantization as tq

    phase_quant_odd(torch, dev, QUANT_ODD[1:2] if quick else QUANT_ODD)
    leaves = llama_flat_leaves()
    if not quick and (len(leaves) != 226 or sum(math.prod(s) for _, s in leaves) != 8_029_995_008):
        raise AssertionError(f"llama3_8b has {len(leaves)} flat-quantised leaves, not 226")
    if quick:
        leaves = [(p, s) for p, s in leaves if p == "wte"]
    gen = torch.Generator(device=dev).manual_seed(11)
    weights = [(torch.randn(shape, generator=gen, device=dev) * 0.02).to(torch.bfloat16) for _, shape in leaves]
    wte = weights[[p for p, _ in leaves].index("wte")]
    iters = 3 if quick else 5
    records = []
    for bits in (8,) if quick else (8, 4):
        codes, bad = [], 0
        for w in weights:  # leaf by leaf: the plain versions' fp32 temporaries stay small
            got = tq.quantize_groupwise(w, QUANT_GROUP, bits)
            bad += codes_differ(torch, got, tq.quantize_groupwise_xla(w, QUANT_GROUP, bits))
            for out in (torch.bfloat16, torch.float32):
                bad += int((tq.dequantize_groupwise(*got, w.shape, out) !=
                            tq.dequantize_groupwise_xla(*got, w.shape, out)).sum())
            codes.append(got)
        torch.cuda.synchronize()
        if bad:
            raise AssertionError(f"quant kernels int{bits}: {bad} codes, scales or dequantised values differ")
        wte_codes = codes[[p for p, _ in leaves].index("wte")]
        for case, ws, cs in (("wte", [wte], [wte_codes]), ("all", weights, codes)):
            n = sum(w.numel() for w in ws)
            rows = n // QUANT_GROUP
            shape = f"{len(ws)} leaves, {n} elements, g {QUANT_GROUP}"
            quant = lambda: each(tq.quantize_groupwise, [(w, QUANT_GROUP, bits) for w in ws])
            quant_plain = lambda: each(tq.quantize_groupwise_xla, [(w, QUANT_GROUP, bits) for w in ws])
            b_ms, b_by = bound(quant_bytes(n, rows, 2), 4 * n, torch.float32)  # |x|, max, divide, round
            records.append(dict(kernel="quantize_groupwise", case=f"{case}-int{bits}", dtype="torch.bfloat16",
                                shape=shape, bit_equal=True, max_abs_err=0.0, max_rel_err=0.0,
                                kernel_ms=time_ms(quant, iters, 1), plain_ms=time_ms(quant_plain, 1, 1),
                                library_ms=None, library="none: no single PyTorch call quantises group-wise",
                                bound_bytes=quant_bytes(n, rows, 2), bound_ms=b_ms, bound_by=b_by))
            for out in (torch.bfloat16, torch.float32) if case == "wte" else (torch.bfloat16,):
                item = 2 if out == torch.bfloat16 else 4
                deq = lambda: each(tq.dequantize_groupwise, [(q, s, None, out) for q, s in cs])
                deq_plain = lambda: each(tq.dequantize_groupwise_xla, [(q, s, None, out) for q, s in cs])
                # one PyTorch call of the same function: the fp32 product (and its bf16 cast)
                lib = lambda: each(lambda q, s: torch.mul(q, s[:, None]).to(out), cs)
                b_ms, b_by = bound(quant_bytes(n, rows, item), n, torch.float32)
                records.append(dict(kernel="dequantize_groupwise", case=f"{case}-int{bits}", dtype=str(out),
                                    shape=shape, bit_equal=True, max_abs_err=0.0, max_rel_err=0.0,
                                    kernel_ms=time_ms(deq, iters, 1), plain_ms=time_ms(deq_plain, 1, 1),
                                    library_ms=time_ms(lib, iters, 1),
                                    library="torch.mul(q, scales[:, None])" + (".to(bf16)" if item == 2 else ""),
                                    bound_bytes=quant_bytes(n, rows, item), bound_ms=b_ms, bound_by=b_by))
        del codes, wte_codes
        torch.cuda.empty_cache()
    for rec in records:
        log(rec)
    del weights, wte
    torch.cuda.empty_cache()
    return records


def phase_lamb(torch, dev, which, iters):
    """The LAMB direction over the wte leaf or over every gpt2_1_3b leaf (one
    launch per leaf) against its plain version. No PyTorch call computes the
    direction; ``torch.optim.AdamW(fused=True)`` over the same leaves moves the
    same bytes and is printed beside it, not as a library time."""
    from deepspeed_tpu_torch.ops import fused_adam as fad, fused_lamb as tfl

    shapes = gpt2_leaf_shapes()
    if which == "wte":
        shapes = [(p, s) for p, s in shapes if p == "wte"]
    g = torch.Generator(device=dev).manual_seed(8)
    leaves = []
    for _, shape in shapes:
        p = torch.randn(shape, generator=g, device=dev)
        grad = torch.randn(shape, generator=g, device=dev)
        m = torch.randn(shape, generator=g, device=dev) * 1e-3
        v = torch.rand(shape, generator=g, device=dev) * 1e-6
        leaves.append((p, grad, m, v))
    n = sum(p.numel() for p, _, _, _ in leaves)
    u = torch.empty(max(p.numel() for p, _, _, _ in leaves), device=dev)
    scal = fad.adam_scalars(1e-3, 10, 0.9, 0.999, grad_mult=0.7, device=dev)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    rel = abs_err = 0.0
    for p, grad, m, v in leaves:  # leaf by leaf: kernel and plain version from the same m and v
        rm, rv = m.clone(), v.clone()
        got = tfl.lamb_direction(p, grad, m, v, scal, u_out=u[:p.numel()].view_as(p), **hyper)
        want = tfl.lamb_direction_ref(p, grad, rm, rv, scal, **hyper)
        for a, b in ((got, want), (m, rm), (v, rv)):
            diff = (a - b).abs().max()
            rel, abs_err = max(rel, (diff / b.abs().max()).item()), max(abs_err, diff.item())
    del rm, rv, got, want
    step = lambda: each(lambda p, grad, m, v: tfl.lamb_direction(p, grad, m, v, scal, u_out=u[:p.numel()].view_as(p),
                                                                 **hyper), leaves)
    plain = lambda: each(lambda p, grad, m, v: tfl.lamb_direction_ref(p, grad, m, v, scal, **hyper), leaves)
    k_ms = time_ms(step, iters)
    p_ms = time_ms(plain, max(2, iters // 5))
    params = [p for p, _, _, _ in leaves]
    for p, grad, _, _ in leaves:
        p.grad = grad
    opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.01, fused=True)
    adamw_ms = time_ms(opt.step, iters)
    del opt
    nbytes = 28 * n  # read p, g, m, v; write u, m, v
    b_ms, b_by = bound(nbytes, 15 * n, torch.float32)
    return dict(kernel="lamb_direction", case=which, dtype="torch.float32", shape=f"{len(leaves)} leaves, {n} elements",
                max_rel_err=rel, max_abs_err=abs_err, tol=("max_rel_err", 1e-5), launches_per_step=len(leaves),
                kernel_ms=k_ms, plain_ms=p_ms, library_ms=None, library="none: no PyTorch call computes it",
                adamw_fused_ms_same_bytes_not_same_function=adamw_ms, bound_bytes=nbytes, bound_ms=b_ms,
                bound_by=b_by)


def run_lamb_kernel_phases(torch, dev, quick: bool):
    records = []
    for which in (["wte"] if quick else ["wte", "all"]):
        rec = phase_lamb(torch, dev, which, 5 if quick else 20)
        log(rec)
        # nvcc contracts the moment updates to FMAs: fp32 within 1e-5 of each tensor's largest value
        if not rec["max_rel_err"] <= 1e-5:
            raise AssertionError(f"lamb_direction {which}: max_rel_err {rec['max_rel_err']} > 1e-5")
        records.append(rec)
        torch.cuda.empty_cache()
    return records


class PlainQuantKernels(PlainKernels):
    """The plain versions of the group-wise quantisation kernels bound in place of their wrappers."""

    NAMES = ("quantize_groupwise", "dequantize_groupwise")
    PLAIN = "_xla"

    @staticmethod
    def module():
        from deepspeed_tpu_torch.ops import quantization as tq

        return tq


# v1 serving: a batch of 4 seeded prompts at each length, greedy, V1_NEW new tokens
V1_PROMPT_LENS, V1_BATCH, V1_NEW, V1_MAX_OUT = (16, 512), 4, 32, 1024
V1_RUNS = {"v1": 0, "v1_w8": 8, "v1_w4": 4}  # run -> quant bits (0: off)


def profile_v1(torch, engine, prompts, run) -> None:
    """Device-time breakdown of one pass of the v1 generate calls under
    torch.profiler (after the timed pass; only the shares are meant to be
    read, since profiling slows the host)."""

    def gen():
        for p in prompts:
            engine.generate(p, max_new_tokens=V1_NEW)

    cats = {"dequantize_groupwise": ("dequant_kernel",), "matmul": MATMUL, "softmax": ("softmax",),
            "copy": ("Memcpy", "Memset", "copy_", "Copy")}
    log(dict(phase="profile_v1", run=run, **profiled(torch, gen, cats)))


def phase_v1(torch, dev, counters, profile=False):
    """``init_inference`` + ``generate`` on llama3_8b at full width and depth
    (random bf16 weights from seed 0), quantisation off and on (flat int8
    and int4, group 64). For each quantised run the counters are zeroed just
    before ``init_inference`` (which quantises: one ``quantize_groupwise`` per
    leaf) and read after the generate calls (one ``dequantize_groupwise`` per
    leaf per forward); the same run with the plain versions must give the
    same tokens."""
    import contextlib

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = model_cfg(dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_leaves = len(llama_flat_leaves())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (V1_BATCH, S)) for S in V1_PROMPT_LENS]
    model = CausalLM(cfg)
    forwards = V1_NEW * len(prompts)  # a prefill and V1_NEW - 1 decode steps per generate
    base = {"dtype": "bfloat16", "max_out_tokens": V1_MAX_OUT, "device": str(dev)}
    warm = dst.init_inference(model, base, params=params)
    warm.generate(prompts[0][:, :8], max_new_tokens=2)  # warm-up: cuBLAS handles, allocator (not counted)
    del warm
    runs, tokens = {}, {}
    for run, bits in V1_RUNS.items():
        for variant in ("kernel", "plain") if bits else ("kernel",):
            config = dict(base)
            if bits:
                config["quant"] = {"enabled": True, "bits": bits, "group_size": QUANT_GROUP}
            with PlainQuantKernels() if variant == "plain" else contextlib.nullcontext():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for fn in counters:
                    fn.launches = 0
                t0 = time.perf_counter()
                engine = dst.init_inference(model, config, params=params)
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
                setup_launches = {fn.__name__: fn.launches for fn in counters}
                t0 = time.perf_counter()
                outs = [engine.generate(p, max_new_tokens=V1_NEW) for p in prompts]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches = {fn.__name__: fn.launches for fn in counters}
                weight_bytes = tree_bytes(engine.params)
                if profile and variant == "kernel" and bits in (0, 8):
                    profile_v1(torch, engine, prompts, run)
                del engine
                gc.collect()
            new = [o[:, -V1_NEW:].cpu() for o in outs]
            tokens[(run, variant)] = new
            rec = dict(phase="v1", run=run, variant=variant, model="llama3_8b", layers=cfg.n_layers,
                       d_model=cfg.d_model, dtype="bfloat16", quant_bits=bits, group_size=QUANT_GROUP if bits else 0,
                       prompts=[list(p.shape) for p in prompts], new_tokens=V1_BATCH * V1_NEW * len(prompts),
                       wall_s=wall, tokens_per_s=V1_BATCH * V1_NEW * len(prompts) / wall, setup_s=setup_s,
                       weights_init_s=init_s, weight_bytes=weight_bytes, weight_bytes_bf16=tree_bytes(params),
                       max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
                       setup_launches=setup_launches, launches=launches, forwards=forwards)
            if bits and variant == "kernel":
                rec["agree_with_unquantised"] = float(np.mean([(a == b).float().mean().item() for a, b in zip(
                    new, tokens[("v1", "kernel")])]))
                runs[run] = rec
            if run == "v1":
                runs[run] = rec
            if bits and variant == "plain":
                rec["tokens_equal_kernel_run"] = all(torch.equal(a, b) for a, b in zip(new, tokens[(run, "kernel")]))
            log(rec)
            torch.cuda.empty_cache()
            if not all(o.shape == (V1_BATCH, p.shape[1] + V1_NEW) and 0 <= int(o.min()) and int(o.max()) < cfg.vocab_size
                       for o, p in zip(outs, prompts)):
                raise AssertionError(f"v1 {run} {variant}: a prompt did not get {V1_NEW} in-vocab tokens")
            if variant == "plain" and not (rec["tokens_equal_kernel_run"] and not any(launches.values())):
                raise AssertionError(f"v1 {run}: the plain versions' tokens differ from the kernels' (or a kernel "
                                     f"launched): {rec}")
            want = {"quantize_groupwise": n_leaves, "dequantize_groupwise": n_leaves * forwards} if bits else {}
            if variant == "kernel" and (setup_launches.get("quantize_groupwise", 0) != want.get("quantize_groupwise", 0)
                                        or any(launches[k] != v for k, v in want.items())):
                raise AssertionError(f"v1 {run}: launches {launches} (set-up {setup_launches}), expected {want}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return runs


CSRC, TPU_OPS = "deepspeed_tpu_torch/csrc/", "deepspeed_tpu/ops/"
# The kernels line: name, the run whose launches are read, the wrapper counted, the dtype and the
# fields (matched by their start) of the record that represents the kernel, its source, the TPU kernel.
KERNEL_ROWS = [
    ("paged_attention_decode", "llama3_8b", "paged_attention_decode", "bfloat16",
     dict(kernel="paged_attention_decode", pool="torch", shape="q(64,32,128)", features="none"), "paged_decode.cu",
     "pallas/paged_attention.py:386"),
    ("paged_attention_prefill", "llama3_8b", "paged_attention_prefill", "bfloat16",
     dict(kernel="paged_attention_prefill", pool="torch", shape="q(2,512,32,128)", features="none"),
     "paged_prefill.cu", "pallas/paged_attention.py:531"),
    ("rms_norm", "llama3_8b", "rms_norm", "bfloat16", dict(kernel="rms_norm", shape="x(1,768,4096)"), "rms_norm.cu",
     "pallas/norms.py:45"),
    ("layer_norm", "gpt2_1_3b_w8_kv8", "layer_norm", "bfloat16", dict(kernel="layer_norm", shape="x(1,768,2048)"),
     "layer_norm.cu", "pallas/norms.py:91"),
    ("quantized_matmul (int8 codes)", "gpt2_1_3b_w8_kv8", "quantized_matmul", "bfloat16",
     dict(kernel="quantized_matmul", shape="x(64,2048) codes(2048,8192)"), "quantized_matmul.cu",
     "pallas/quantized_matmul.py:140"),
    ("quantized_matmul (packed int4 codes)", "llama3_8b_w4", "quantized_matmul", "bfloat16",
     dict(kernel="quantized_matmul", shape="x(64,4096) codes(2048,14336)"), "quantized_matmul.cu",
     "pallas/quantized_matmul.py:140"),
    ("paged_attention_decode (int8 pool)", "gpt2_1_3b_w8_kv8", "paged_attention_decode", "bfloat16",
     dict(kernel="paged_attention_decode", pool="int8", shape="q(64,32,64)", features="none"), "paged_decode.cu",
     "pallas/paged_attention.py:386"),
    ("paged_attention_prefill (int8 pool)", "gpt2_1_3b_w8_kv8", "paged_attention_prefill", "bfloat16",
     dict(kernel="paged_attention_prefill", pool="int8", shape="q(2,512,32,64)", features="none"),
     "paged_prefill.cu", "pallas/paged_attention.py:531"),
    ("flash_fwd", "train", "flash_fwd", "bfloat16", dict(kernel="flash_fwd", case="gpt2_1_3b"), "flash_fwd.cu",
     "pallas/flash_attention.py:185"),
    ("flash_bwd_dq", "train", "flash_bwd_dq", "bfloat16", dict(kernel="flash_bwd_dq", case="gpt2_1_3b"),
     "flash_bwd.cu", "pallas/flash_attention.py:417"),
    ("flash_bwd_dkv", "train", "flash_bwd_dkv", "bfloat16", dict(kernel="flash_bwd_dkv", case="gpt2_1_3b"),
     "flash_bwd.cu", "pallas/flash_attention.py:518"),
    ("fused_adam", "train", "fused_adam", "float32", dict(kernel="fused_adam", case="all"), "fused_adam.cu",
     "pallas/fused_adam.py:51"),
    ("flash_fwd (bias)", "evoformer", "flash_fwd", "bfloat16", dict(kernel="flash_fwd (bias)", case="msa_row"),
     "flash_fwd.cu", "pallas/flash_attention.py:185"),
    ("flash_bwd_dq (bias)", "evoformer", "flash_bwd_dq", "bfloat16", dict(kernel="flash_bwd_dq (bias)",
                                                                          case="msa_row"),
     "flash_bwd.cu", "pallas/flash_attention.py:417"),
    ("flash_bwd_dq_collapsed", "evoformer", "flash_bwd_dq_collapsed", "bfloat16",
     dict(kernel="flash_bwd_dq_collapsed", case="msa_row_pair"), "flash_bwd.cu",
     "pallas/flash_attention.py:456"),
    ("flash_bwd_dkv (bias)", "evoformer", "flash_bwd_dkv", "bfloat16", dict(kernel="flash_bwd_dkv (bias)",
                                                                            case="msa_row"),
     "flash_bwd.cu", "pallas/flash_attention.py:485"),
    ("sparse_fwd", "sparse", "sparse_fwd", "bfloat16", dict(kernel="sparse_fwd", case="fixed_uni_gpt2_1_3b"),
     "sparse_fwd.cu", "sparse_attention/sparse_self_attention.py:193"),
    ("sparse_bwd_dq", "sparse", "sparse_bwd_dq", "bfloat16", dict(kernel="sparse_bwd_dq", case="fixed_uni_gpt2_1_3b"),
     "sparse_dq.cu", "sparse_attention/sparse_self_attention.py:222"),
    ("sparse_bwd_dkv", "sparse", "sparse_bwd_dkv", "bfloat16",
     dict(kernel="sparse_bwd_dkv", case="fixed_uni_gpt2_1_3b"), "sparse_dkv.cu",
     "sparse_attention/sparse_self_attention.py:239"),
    ("lamb_direction", "train_lamb", "lamb_direction", "float32", dict(kernel="lamb_direction", case="all"),
     "fused_lamb.cu", "pallas/fused_lamb.py:45"),
    ("quantize_groupwise", "v1_w8", "quantize_groupwise", "bfloat16",
     dict(kernel="quantize_groupwise", case="all-int8"), "quantization.cu", "pallas/quantization.py:49"),
    ("dequantize_groupwise", "v1_w8", "dequantize_groupwise", "bfloat16",
     dict(kernel="dequantize_groupwise", case="all-int8"), "quantization.cu", "pallas/quantization.py:64"),
    # no pallas_call: the reference's MoE serving module runs lax.ragged_dot (plain XLA) at this line
    ("moe_grouped_gemm", "mixtral_8x7b_8l", "moe_grouped_gemm", "bfloat16",
     dict(kernel="moe_grouped_gemm", case="decode8_wi"), "moe_grouped_gemm.cu",
     "deepspeed_tpu/inference/v2/modules.py:195"),
]


def kernel_row(records, runs, name, run, counter, dtype, want, source, replaces) -> dict:
    r = next(x for x in records if x["dtype"] == f"torch.{dtype}"
             and all(str(x.get(k, "")).startswith(v) for k, v in want.items()))
    replaces = replaces if replaces.startswith("deepspeed_tpu/") else TPU_OPS + replaces
    return {"name": name, "route": "cuda", "source": CSRC + source, "replaces": replaces,
            "launches": runs[run]["launches"][counter], "max_abs_err": r["max_abs_err"],
            "max_rel_err": r["max_rel_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "dtype": dtype, "launches_read_from": run,
            **({"parent_ms": r["parent_ms"]} if r.get("parent_ms") is not None else {})}


def main(argv) -> int:
    quick = "--quick" in argv  # build + one case per kernel, then stop
    profile = "--profile" in argv  # add torch.profiler passes over the serving waves and a training step
    # --parent DIR: also time DIR's quantized_matmul and flash forward, dq and dk/dv, and run the quantised
    # serving runs and the training run once more on them (DIR: another checkout's sources, e.g. under build/)
    parent_dir = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False); nothing was run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        print(f"chip_smoke: the deepspeed_tpu_torch package is not beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    from deepspeed_tpu_torch.ops import _build, flash_attention as fa, fused_adam as fad, fused_lamb as tfl, norms
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg
    from deepspeed_tpu_torch.ops import paged_attention as pa, quantization as tq, quantized_matmul as qm
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 comparisons in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    log(dict(phase="card", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
             torch=torch.__version__, cuda=torch.version.cuda))

    t0 = time.perf_counter()
    _build.lib()
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", _build.build_log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", _build.build_log)]
    log(dict(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds,
             ptxas=dict(entries=len(regs), max_registers=max(regs, default=0), spill_store_bytes=sum(spills))))
    if parent_dir is not None:
        t0 = time.perf_counter()
        PARENT["lib"] = load_parent(os.path.abspath(parent_dir))
        log(dict(phase="parent build", dir=parent_dir, seconds=time.perf_counter() - t0))

    records = run_kernel_phases(torch, dev, quick)
    quant_records = run_quant_kernel_phases(torch, dev, quick)
    records += run_train_kernel_phases(torch, dev, quick)
    records += run_evo_kernel_phases(torch, dev, quick)
    t0 = time.perf_counter()
    records += run_sparse_kernel_phases(torch, dev, quick)
    log(dict(phase="sparse kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += phase_quant_kernels(torch, dev, quick)
    log(dict(phase="quant kernels", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_lamb_kernel_phases(torch, dev, quick)
    log(dict(phase="lamb kernel", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    records += run_moe_kernel_phases(torch, dev, quick)
    log(dict(phase="moe kernel", seconds=time.perf_counter() - t0))
    if quick:
        log(dict(phase="quick", seconds=time.perf_counter() - t_start))
        return 0
    for model in ("llama3_8b", "gpt2_1_3b"):
        for dtype in (torch.float32, torch.bfloat16):
            phase_step_parity(torch, dev, dtype, model)
    for dtype in (torch.float32, torch.bfloat16):
        phase_step_parity(torch, dev, dtype, "mixtral_8x7b", n_layers=2)
    paged = [pa.paged_attention_decode, pa.paged_attention_prefill]
    counters = paged + [norms.rms_norm]
    serve = phase_serve(torch, dev, counters, "llama3_8b", profile, keep_params=True)
    t0 = time.perf_counter()
    phase_serve_spec(torch, dev, counters, serve.pop("params"))
    phase_spec_fp32(torch, dev, counters)
    log(dict(phase="serve_spec", seconds=time.perf_counter() - t0))
    phase_serve(torch, dev, counters, "llama3_8b_cache16", profile, want=serve["tokens"])
    t0 = time.perf_counter()
    phase_serve(torch, dev, counters, "llama3_8b_unfused", profile, beside=serve["tokens"])
    log(dict(phase="serve_unfused", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_sla(torch, dev, counters)
    log(dict(phase="sla", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    phase_serve(torch, dev, paged + [norms.layer_norm], "bloom_7b1_alibi_4l")
    phase_serve(torch, dev, counters, "mistral_7b_swa_4l")
    log(dict(phase="serve alibi and window", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    serve_moe = phase_serve(torch, dev, counters + [mg.moe_grouped_gemm], "mixtral_8x7b_8l", profile)
    log(dict(phase="serve moe", seconds=time.perf_counter() - t0))
    serve_w8 = phase_serve(torch, dev, paged + [norms.layer_norm, qm.quantized_matmul], "gpt2_1_3b_w8_kv8", profile)
    serve_w4 = phase_serve(torch, dev, paged + [norms.rms_norm, qm.quantized_matmul], "llama3_8b_w4", profile)
    train_counters = [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fad.fused_adam]
    for dtype in (torch.float32, torch.bfloat16):
        phase_train_parity(torch, dev, dtype, train_counters)
    train = phase_train(torch, dev, counters + train_counters, profile)
    if PARENT["lib"] is not None:  # the same paths on the parent's kernels, for comparison only
        log(dict(phase="parent kernels", begin=True))
        with parent_kernels():
            phase_serve(torch, dev, counters, "llama3_8b", profile)
            phase_serve(torch, dev, paged + [norms.layer_norm, qm.quantized_matmul], "gpt2_1_3b_w8_kv8", profile)
            phase_serve(torch, dev, paged + [norms.rms_norm, qm.quantized_matmul], "llama3_8b_w4", profile)
            phase_serve(torch, dev, counters + [mg.moe_grouped_gemm], "mixtral_8x7b_8l", profile)
            phase_train(torch, dev, counters + train_counters, profile)
        log(dict(phase="parent kernels", begin=False))
    evoformer = phase_evoformer(torch, dev, [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dq_collapsed,
                                             fa.flash_bwd_dkv], profile)
    t0 = time.perf_counter()
    sparse = phase_sparse(torch, dev, [ss.sparse_fwd, ss.sparse_bwd_dq, ss.sparse_bwd_dkv])
    log(dict(phase="sparse", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    v1 = phase_v1(torch, dev, [tq.quantize_groupwise, tq.dequantize_groupwise], profile)
    log(dict(phase="v1", seconds=time.perf_counter() - t0))
    t0 = time.perf_counter()
    lamb_counters = [fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, tfl.lamb_direction]
    for dtype in (torch.float32, torch.bfloat16):
        phase_train_parity(torch, dev, dtype, lamb_counters, optimizer="Lamb")
    train_lamb = phase_train(torch, dev, lamb_counters, profile, optimizer="Lamb")
    log(dict(phase="train lamb", seconds=time.perf_counter() - t0))

    runs = {"llama3_8b": serve, "gpt2_1_3b_w8_kv8": serve_w8, "llama3_8b_w4": serve_w4,
            "mixtral_8x7b_8l": serve_moe, "train": train,
            "evoformer": evoformer, "sparse": sparse, "train_lamb": train_lamb, **v1}
    kernels = [kernel_row(records + quant_records, runs, *row) for row in KERNEL_ROWS]
    log(dict(phase="done", seconds=time.perf_counter() - t_start, card=card))
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
