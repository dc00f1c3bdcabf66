#!/usr/bin/env python3
"""Drive the PyTorch port (deepspeed_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py            # from the repository root, on a machine with one CUDA GPU
    python3 chip_smoke.py --profile  # plus a torch.profiler breakdown of the serving run

Phases, each fatal on failure:
1. card: the ``nvidia-smi`` name and power-limit line;
2. build: nvcc builds every CUDA kernel of the serving path from csrc/;
3. kernels: each kernel's wrapper at the llama3_8b shapes of the fused serving
   path, in bf16 and fp32, against its plain PyTorch version (errors,
   tolerance, kernel/plain/library times from CUDA events, and the bound:
   the larger of bytes over 3.35 TB/s and operations over the peak rate of
   the input type, 989 TFLOP/s bf16 / 67 TFLOP/s fp32);
4. step parity: one prefill quantum and one mixed decode + prefill quantum
   of llama3_8b at full width and 4 layers, run with the kernels and with
   their plain versions; logits and KV pools (garbage block 0 excluded) agree;
5. serve: InferenceEngineV2 over llama3_8b at full width and depth (random
   bf16 weights from seed 0), greedy generate of 32 tokens for a dozen
   seeded prompts of 16-1500 tokens in two waves (the second wave shares a
   256-token prefix with the first, so the prefix cache is hit). The kernel
   launch counters are zeroed just before and read just after; every kernel
   must have launched.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the package
beside this script, it exits non-zero and prints no result.
"""

import json
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


def errors(got, want) -> dict:
    """Max abs error and max per-row relative error (rows = the last dim)."""
    diff = (got.float() - want.float()).flatten(0, -2).abs().amax(-1)
    scale = want.float().flatten(0, -2).abs().amax(-1).clamp_min(1e-30)
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


def phase_decode(torch, dev, dtype, B, iters):
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (GEOM[k] for k in ("H", "KVH", "D", "bs", "P"))
    base = [1, 127, 128, 129, 4096, 513, 2000, 8192]
    ctx = [base[i % len(base)] for i in range(B)]
    ctx[-1] = 1  # a padded row: ctx 1 on the garbage page
    kp, vp, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=B, garbage_rows=(B - 1,))
    q = torch.randn((B, H, D), generator=g, device=dev).to(dtype)
    scale = D**-0.5
    got = pa.paged_attention_decode(q, kp, vp, bt, cl, scale)
    torch.cuda.synchronize()
    want = pa.paged_attention_decode_ref(q, kp, vp, bt, cl, scale)
    err = errors(got, want)
    item = kp.element_size()
    live = sum(ctx)
    nbytes = live * KVH * D * 2 * item + 2 * q.numel() * item + bt.numel() * 4 + cl.numel() * 4
    flops = 4 * live * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    k_ms = time_ms(lambda: pa.paged_attention_decode(q, kp, vp, bt, cl, scale), iters)
    p_ms = time_ms(lambda: pa.paged_attention_decode_ref(q, kp, vp, bt, cl, scale), max(3, iters // 20))
    k, v, L = dense_kv(torch, kp, vp, bt, cl)
    mask = (torch.arange(L, device=dev)[None, :] < cl[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = time_ms(lambda: sdpa(q[:, :, None], k, v, attn_mask=mask, scale=scale, enable_gqa=True),
                   max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel()
    del k, v
    return dict(kernel="paged_attention_decode", dtype=str(dtype), shape=f"q({B},{H},{D}) pool({kp.shape[0]},{bs},"
                f"{KVH},{D}) bt({B},{P})", ctx=sorted(set(ctx)), **err, tol=TOL[str(dtype)], kernel_ms=k_ms,
                plain_ms=p_ms, library_ms=l_ms, library_bytes=l_bytes, bound_bytes=nbytes, bound_ms=b_ms,
                bound_by=b_by)


def phase_prefill(torch, dev, dtype, S, iters):
    from deepspeed_tpu_torch.ops import paged_attention as pa

    H, KVH, D, bs, P = (GEOM[k] for k in ("H", "KVH", "D", "bs", "P"))
    q0 = [0, 1000]  # row 1 continues a context: its chunk starts at position 1000
    ctx = [p + S for p in q0]
    kp, vp, bt, cl, g = paged_case(torch, dev, dtype, ctx, H, KVH, D, bs, P, seed=S)
    q = torch.randn((2, S, H, D), generator=g, device=dev).to(dtype)
    pos = (torch.tensor(q0, dtype=torch.int32)[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(dev)
    scale = D**-0.5
    got = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale)
    torch.cuda.synchronize()
    want = pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale)
    err = errors(got, want)
    item = kp.element_size()
    visible = sum(min(c, p0 + s + 1) for c, p0 in zip(ctx, q0) for s in range(S))
    nbytes = sum(ctx) * KVH * D * 2 * item + 2 * q.numel() * item + bt.numel() * 4 + 2 * 4 + pos.numel() * 4
    flops = 4 * visible * H * D
    b_ms, b_by = bound(nbytes, flops, dtype)
    k_ms = time_ms(lambda: pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, scale), iters)
    p_ms = time_ms(lambda: pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, scale), max(3, iters // 20))
    k, v, L = dense_kv(torch, kp, vp, bt, cl)
    kpos = torch.arange(L, device=dev)
    mask = ((kpos[None, None, :] < cl[:, None, None]) & (kpos[None, None, :] <= pos[:, :, None]))[:, None]
    qh = q.permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    l_ms = time_ms(lambda: sdpa(qh, k, v, attn_mask=mask, scale=scale, enable_gqa=True), max(3, iters // 4))
    l_bytes = 2 * k.numel() * item + 2 * q.numel() * item + mask.numel()
    del k, v
    return dict(kernel="paged_attention_prefill", dtype=str(dtype), shape=f"q(2,{S},{H},{D}) qpos0={q0} ctx={ctx}",
                **err, tol=TOL[str(dtype)], kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, library_bytes=l_bytes,
                bound_bytes=nbytes, bound_ms=b_ms, bound_by=b_by)


def phase_rms(torch, dev, dtype, T, iters):
    from deepspeed_tpu_torch.ops import norms

    d = GEOM["d"]
    g = torch.Generator(device=dev).manual_seed(T)
    x = torch.randn((1, T, d), generator=g, device=dev).to(dtype)
    w = torch.randn((d,), generator=g, device=dev).to(dtype)
    got = norms.rms_norm(x, w, 1e-5)
    torch.cuda.synchronize()
    err = errors(got, norms.rms_norm_ref(x, w, 1e-5))
    item = x.element_size()
    nbytes = 2 * T * d * item + d * w.element_size()
    b_ms, b_by = bound(nbytes, 4 * T * d, dtype)
    k_ms = time_ms(lambda: norms.rms_norm(x, w, 1e-5), iters)
    p_ms = time_ms(lambda: norms.rms_norm_ref(x, w, 1e-5), iters)
    lib = getattr(torch.nn.functional, "rms_norm", None)
    l_ms = time_ms(lambda: lib(x, (d,), w, 1e-5), iters) if lib is not None else None
    return dict(kernel="rms_norm", dtype=str(dtype), shape=f"x(1,{T},{d}) w({d})", **err, tol=TOL[str(dtype)],
                kernel_ms=k_ms, plain_ms=p_ms, library_ms=l_ms, library_bytes=nbytes, bound_bytes=nbytes,
                bound_ms=b_ms, bound_by=b_by)


def run_kernel_phases(torch, dev, quick: bool):
    """Every case in bf16 and fp32; returns the per-case records."""
    cases = [(phase_decode, 8), (phase_decode, 64), (phase_prefill, 16), (phase_prefill, 256),
             (phase_prefill, 512), (phase_rms, 8), (phase_rms, 768), (phase_rms, 2048)]
    if quick:
        cases = [(phase_decode, 64), (phase_prefill, 512), (phase_rms, 768)]
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for fn, size in cases:
            rec = fn(torch, dev, dtype, size, iters=5 if quick else 50)
            log(rec)
            what, tol = rec["tol"]
            if not rec[what] <= tol:
                raise AssertionError(f"{rec['kernel']} {rec['dtype']} {rec['shape']}: {what} {rec[what]} > {tol}")
            records.append(rec)
            torch.cuda.empty_cache()
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


def phase_step_parity(torch, dev, dtype, n_layers=4):
    import numpy as np

    from deepspeed_tpu_torch.inference.v2.model_runner import fused_forward
    from deepspeed_tpu_torch.inference.v2.modules import build_modules
    from deepspeed_tpu_torch.models import init_params

    cfg = model_cfg(n_layers=n_layers, dtype=dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=dtype)
    bs, P = GEOM["bs"], GEOM["P"]
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
    pools = {v: (torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev))
             for v in ("kernel", "plain")}
    mods = {"kernel": build_modules(), "plain": build_modules(plain=True)}
    # about twice the errors measured on an H100 at these seeded inputs (fp32:
    # 1.3e-5 on logits and pools; bf16: 6.3e-2 on logits of size ~5, 4.7e-2
    # on the pools), which repeat exactly from run to run
    tol = {"torch.float32": dict(logits=1e-4, pools=1e-4),
           "torch.bfloat16": dict(logits=0.125, pools=0.1)}[str(dtype)]
    out = []
    for n_dec, chunk, rows in quanta:
        args = [torch.from_numpy(x).to(dev) for x in quantum_inputs(np, rows, n_dec, chunk, bs, P)]
        ids, pos, bt, ctx, slots, last = args
        logits = {}
        for v in ("kernel", "plain"):
            kp, vp = pools[v]
            logits[v], _, _ = fused_forward(cfg, params, ids, pos, kp, vp, bt, ctx, slots, last, n_dec=n_dec,
                                            chunk=chunk, mods=mods[v])
        torch.cuda.synchronize()
        real = [r for r, (_, _, blk) in enumerate(rows) if blk]
        l_err = (logits["kernel"][real] - logits["plain"][real]).abs().max().item()
        agree = (logits["kernel"][real].argmax(-1) == logits["plain"][real].argmax(-1)).float().mean().item()
        p_err = max((pools["kernel"][i][:, 1:].float() - pools["plain"][i][:, 1:].float()).abs().max().item()
                    for i in (0, 1))
        rec = dict(phase="step_parity", dtype=str(dtype), n_layers=n_layers, n_dec=n_dec, chunk=chunk,
                   rows=len(rows), logits_max_abs_err=l_err, logits_max_abs=logits["plain"][real].abs().max().item(),
                   argmax_agree=agree, pools_max_abs_err=p_err, tol=tol)
        log(rec)
        if not (l_err <= tol["logits"] and p_err <= tol["pools"] and torch.isfinite(logits["kernel"]).all()):
            raise AssertionError(f"step parity failed: {rec}")
        out.append(rec)
    del params, pools
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- serving run
def serving_prompts(np, vocab):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 256).tolist()
    lens = [16, 1500, 300, 64, 700, 1100, 40, 900, 128, 1300, 512, 200]
    prompts = [rng.integers(0, vocab, n).tolist() for n in lens]
    for i in (2, 7, 10):  # share a 256-token prefix (two full 128-token blocks)
        prompts[i] = shared + prompts[i][256:]
    return prompts[:6], prompts[6:]


def profile_serve(torch, engine, waves) -> None:
    """Device-time breakdown of the serving waves under torch.profiler: a
    separate pass after the timed one, with the prefix cache reset first so
    that it repeats the same admissions. Profiling slows the host, so only
    the shares are meant to be read, not the pass's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.state.reset_prefix_cache()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for wave in waves:
            engine.generate(wave, max_new_tokens=32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cats = {"paged_attention_decode": ("decode_kernel",), "paged_attention_prefill": ("prefill_kernel",),
            "rms_norm": ("rms_norm",), "matmul": ("gemm", "cutlass", "xmma", "nvjet", "cublas"),
            "copy": ("Memcpy", "Memset")}
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
    log(dict(phase="profile", wall_ms_profiled=wall_ms, device_busy_ms=busy if top else "not measured",
             busy_share=busy / wall_ms if top else "not measured", by_category_ms=by_cat,
             top=[dict(ms=t, calls=c, name=n) for t, c, n in top[:15]]))


def phase_serve(torch, dev, counters, profile=False):
    import numpy as np

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import init_params

    cfg = model_cfg()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(max_context=8192, kv_block_size=128, memory_gb=8.0), dtype="bfloat16",
        device=str(dev)))
    hits = []
    admit = engine.state.admit_sequence

    def admit_spy(uid, tokens):
        seq = admit(uid, tokens)
        hits.append(seq.seen_tokens)
        return seq

    engine.state.admit_sequence = admit_spy
    wave1, wave2 = serving_prompts(np, cfg.vocab_size)
    engine.generate([wave1[0][:32]], max_new_tokens=4)  # warm-up: cuBLAS handles, allocator (not counted)
    torch.cuda.synchronize()
    hits.clear()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(wave1, max_new_tokens=32) + engine.generate(wave2, max_new_tokens=32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    n_out = sum(len(o) for o in out)
    rec = dict(phase="serve", model="llama3_8b", layers=cfg.n_layers, d_model=cfg.d_model, dtype="bfloat16",
               prompts=len(out), prompt_tokens=sum(len(p) for p in wave1 + wave2), new_tokens=n_out,
               wall_s=wall, tokens_per_s=n_out / wall, weights_init_s=init_s, kv_blocks=engine._n_kv_blocks,
               prefix_hit_tokens=sum(hits), max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches)
    log(rec)
    if not all(len(o) == 32 and all(0 <= t < cfg.vocab_size for t in o) for o in out):
        raise AssertionError("serve: a request did not get 32 in-vocab tokens")
    if sum(hits) == 0:
        raise AssertionError("serve: the prefix cache was never hit")
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched on the main path: {missing}")
    if profile:
        profile_serve(torch, engine, (wave1, wave2))
    return rec


def main(argv) -> int:
    quick = "--quick" in argv  # build + one case per kernel, then stop
    profile = "--profile" in argv  # add a torch.profiler pass over the serving waves
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
    from deepspeed_tpu_torch.ops import _build, norms, paged_attention as pa

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

    records = run_kernel_phases(torch, dev, quick)
    if quick:
        log(dict(phase="quick", seconds=time.perf_counter() - t_start))
        return 0
    for dtype in (torch.float32, torch.bfloat16):
        phase_step_parity(torch, dev, dtype)
    counters = [pa.paged_attention_decode, pa.paged_attention_prefill, norms.rms_norm]
    serve = phase_serve(torch, dev, counters, profile)

    rep = {"paged_attention_decode": ("q(64,32,128)", "deepspeed_tpu_torch/csrc/paged_attention.cu",
                                      "deepspeed_tpu/ops/pallas/paged_attention.py:386"),
           "paged_attention_prefill": ("q(2,512,32,128)", "deepspeed_tpu_torch/csrc/paged_attention.cu",
                                       "deepspeed_tpu/ops/pallas/paged_attention.py:531"),
           "rms_norm": ("x(1,768,4096)", "deepspeed_tpu_torch/csrc/rms_norm.cu",
                        "deepspeed_tpu/ops/pallas/norms.py:45")}
    kernels = []
    for name, (shape, source, replaces) in rep.items():
        r = next(x for x in records if x["kernel"] == name and x["dtype"] == "torch.bfloat16"
                 and x["shape"].startswith(shape))
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": serve["launches"][name], "max_abs_err": r["max_abs_err"],
                        "max_rel_err": r["max_rel_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"], "dtype": "bfloat16"})
    log(dict(phase="done", seconds=time.perf_counter() - t_start, card=card))
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
