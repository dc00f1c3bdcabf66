"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 1e-5 on the max abs error in float32 (same fp32 math, other
summation order); 1e-2 on the per-row relative error in bfloat16, that is
max |got - want| / max |want| over each row's last dim (both sides compute
in fp32 from the same bf16 inputs and round the output to bf16, where one
rounding step is at most 2**-7 = 7.8e-3 of a value); the flash gradients
floor each row's scale at the tensor's mean magnitude. fused Adam: 1e-6 of
the largest value of each updated tensor; fp32 flash outputs and the fp32
quantised matmul on max abs error over max(1, max |want|) (sums of thousands
of products in another order than the plain version's). The group-wise
quantise and dequantise kernels: bit for bit (IEEE division, one rounding);
the LAMB direction: 1e-5 of the largest value of each tensor (nvcc contracts
the moment updates to FMAs).
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import norms, paged_attention as pa

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _err(got, want, floor=1e-30):
    """fp32: max abs error; bf16: max per-row relative error (rows = last dim),
    each row's scale taken as at least ``floor``."""
    diff = (got.float() - want.float()).flatten(0, -2).abs().amax(-1)
    if got.dtype == torch.float32:
        return diff.max().item()
    return (diff / want.float().flatten(0, -2).abs().amax(-1).clamp_min(floor)).max().item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wdtype", [((3, 4096), None), ((1, 7, 4096), torch.float32), ((5, 128), None),
                                          ((2, 100), None)])
def test_rms_norm_kernel(cuda, dtype, shape, wdtype):
    g = _gen(cuda)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda).to(wdtype or dtype)
    n0 = norms.rms_norm.launches
    got = norms.rms_norm(x, w)
    torch.cuda.synchronize()
    assert norms.rms_norm.launches == n0 + 1
    err = _err(got, norms.rms_norm_ref(x, w))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,wdtype", [((3, 2048), None), ((1, 7, 2048), torch.float32), ((5, 128), None),
                                          ((2, 100), None), ((2, 4096), torch.bfloat16)])
def test_layer_norm_kernel(cuda, dtype, shape, wdtype):
    g = _gen(cuda)
    x = (torch.randn(shape, generator=g, device=cuda) * 2.0 + 3.0).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda).to(wdtype or dtype)
    b = torch.randn(shape[-1], generator=g, device=cuda).to(wdtype or dtype)
    n0 = norms.layer_norm.launches
    got = norms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert norms.layer_norm.launches == n0 + 1
    err = _err(got, norms.layer_norm_ref(x, w, b))
    assert err <= TOL[dtype], err


def test_norm_gradients_on_the_card(cuda):
    """The autograd functions' plain backward runs on CUDA tensors behind the forward kernels."""
    g = _gen(cuda)
    x = torch.randn((4, 6, 256), generator=g, device=cuda)
    w, b, do = (torch.randn(s, generator=g, device=cuda) for s in ((256,), (256,), (4, 6, 256)))
    for fn, ref, params in ((norms.layer_norm, norms.layer_norm_ref, (w, b)),
                            (norms.rms_norm, norms.rms_norm_ref, (w,))):
        grads = []
        for f in (fn, ref):
            leaves = [t.clone().requires_grad_(True) for t in (x, *params)]
            (f(*leaves) * do).sum().backward()
            grads.append([t.grad for t in leaves])
        for got, want in zip(*grads):
            assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


# (M, K, N, group_size, bits/pack): aligned shapes (the 16-byte-load path) and odd ones (element-wise staging)
QMM_CASES = [(1, 2048, 2048, 128, 8), (64, 2048, 8192, 128, 8), (200, 8192, 2048, 128, 8), (5, 64, 128, 128, 8),
             (8, 4096, 1024, 128, 4), (70, 14336, 4096, 128, 4), (3, 64, 64, 64, 4), (9, 192, 48, 128, 4),
             (4, 75, 20, 128, 4), (130, 100, 37, 128, 8), (2, 16 * 70, 48, 16, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,group,bits", QMM_CASES)
def test_quantized_matmul_kernel(cuda, dtype, M, K, N, group, bits):
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    g = _gen(cuda, M + K)
    w = torch.randn((K, N), generator=g, device=cuda) * 0.05
    w[: K // 2, 0] = 0.0  # an all-zero group
    q, scales = qm.quantize_weight_kgroups(w, group_size=group, bits=bits, pack=bits == 4)
    packed = q.shape[0] != K
    x = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    n0 = qm.quantized_matmul.launches
    got = qm.quantized_matmul(x, q, scales, packed=packed)
    torch.cuda.synchronize()
    assert qm.quantized_matmul.launches == n0 + 1
    want = qm.quantized_matmul_ref(x, q, scales, packed=packed)
    err = _err(got, want)
    if dtype == torch.float32:
        err /= max(1.0, want.abs().max().item())
    assert err <= TOL[dtype], err


def _qmm_run(dev, dtype, M, K, N, group, bits, seed=0):
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    g = _gen(dev, seed + M + K)
    w = torch.randn((K, N), generator=g, device=dev) * 0.05
    q, scales = qm.quantize_weight_kgroups(w, group_size=group, bits=bits, pack=bits == 4)
    packed = q.shape[0] != K
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    got = qm.quantized_matmul(x, q, scales, packed=packed)
    torch.cuda.synchronize()
    return got, qm.quantized_matmul_ref(x, q, scales, packed=packed), (x, q, scales, packed)


@pytest.mark.parametrize("M", [1, 8, 64, 65, 128, 512, 1024])
@pytest.mark.parametrize("K,N,bits", [(8192, 2048, 8), (14336, 4096, 4)])
def test_quantized_matmul_kernel_across_the_plans(cuda, M, K, N, bits):
    """bf16 at the serving shapes across every tile and split the plan picks."""
    got, want, _ = _qmm_run(cuda, torch.bfloat16, M, K, N, 128, bits)
    err = _err(got, want)
    assert err <= TOL[torch.bfloat16], err


@pytest.mark.parametrize("M", [8, 200])
@pytest.mark.parametrize("group", [32, 64, 128, 256])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_matmul_kernel_group_sizes(cuda, M, group, bits):
    got, want, _ = _qmm_run(cuda, torch.bfloat16, M, 4096, 1024, group, bits)
    err = _err(got, want)
    assert err <= TOL[torch.bfloat16], err


def test_quantized_matmul_single_group_slices_repeat_bit_for_bit(cuda):
    """A plan of one-group K slices (M 1), and a split launch that repeats bit
    for bit: the partials are summed in slice order, not by atomics."""
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert qm._qmm_plan(1, 2048, 2048, 16, False, sms)[2] == 1
    got, want, _ = _qmm_run(cuda, torch.bfloat16, 1, 2048, 2048, 128, 8)
    assert _err(got, want) <= TOL[torch.bfloat16]
    for M, K, N, bits in ((8, 8192, 2048, 8), (64, 14336, 4096, 4)):
        got, want, (x, q, scales, packed) = _qmm_run(cuda, torch.bfloat16, M, K, N, 128, bits)
        assert qm._qmm_plan(M, K, N, scales.shape[0], packed, sms)[1] > 1
        for _ in range(3):
            assert torch.equal(qm.quantized_matmul(x, q, scales, packed=packed), got)
        assert _err(got, want) <= TOL[torch.bfloat16]


def test_quantized_matmul_raises_on_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    w = torch.randn((64, 32), device=cuda)
    q, scales = qm.quantize_weight_kgroups(w, group_size=64)
    x = torch.randn((2, 64), device=cuda)
    with pytest.raises(ValueError):
        qm.quantized_matmul(x[:, :32], q, scales)
    with pytest.raises(ValueError):
        qm.quantized_matmul(x, q.float(), scales)
    with pytest.raises(ValueError):
        qm.quantized_matmul(x, q.cpu(), scales)
    with pytest.raises(NotImplementedError):
        qm.quantized_matmul(x.half(), q, scales)


def _paged(dev, dtype, ctx, H=32, KVH=8, D=128, bs=128, P=64, seed=0):
    g = _gen(dev, seed)
    pages = [max(1, -(-c // bs)) for c in ctx]
    n_blocks = 1 + sum(pages)
    kp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((n_blocks, bs, KVH, D), generator=g, device=dev).to(dtype)
    perm = (1 + torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(seed))).tolist()
    bt = torch.zeros((len(ctx), P), dtype=torch.int32)
    i = 0
    for r, n in enumerate(pages):
        bt[r, :n] = torch.tensor(perm[i:i + n], dtype=torch.int32)
        i += n
    return kp, vp, bt.to(dev), torch.tensor(ctx, dtype=torch.int32, device=dev), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(32, 8), (8, 8)])
def test_decode_kernel(cuda, dtype, heads):
    ctx = [1, 127, 128, 129, 4096, 0, 1]
    kp, vp, bt, cl, g = _paged(cuda, dtype, ctx, H=heads[0], KVH=heads[1])
    bt[-1] = 0  # a padded row reading the garbage page
    q = torch.randn((len(ctx), heads[0], 128), generator=g, device=cuda).to(dtype)
    got = pa.paged_attention_decode(q, kp, vp, bt, cl)
    torch.cuda.synchronize()
    want = pa.paged_attention_decode_ref(q, kp, vp, bt, cl)
    assert torch.all(got[5] == 0)  # ctx 0 writes zeros
    err = _err(got, want)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 100, 512])
def test_prefill_kernel(cuda, dtype, S):
    q0 = torch.tensor([0, 1000], dtype=torch.int32)
    ctx = (q0 + S).tolist()
    kp, vp, bt, cl, g = _paged(cuda, dtype, ctx)
    q = torch.randn((2, S, 32, 128), generator=g, device=cuda).to(dtype)
    pos = (q0[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(cuda)
    got = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos)
    torch.cuda.synchronize()
    err = _err(got, pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos))
    assert err <= TOL[dtype], err


def _int8_pools(kp, vp):
    """The same pages as int8 (codes, scales) pools; the first block stays never written (scale 0)."""
    pools = []
    for p in (kp, vp):
        codes, scales = pa.quantize_kv(p)
        codes[0], scales[0] = 0, 0.0
        pools.append((codes, scales))
    return pools


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(32, 8, 128), (32, 32, 64), (8, 8, 128), (12, 3, 64)])
def test_decode_kernel_int8_pool(cuda, dtype, heads):
    H, KVH, D = heads
    ctx = [1, 127, 128, 129, 1000, 0, 1]
    kp, vp, bt, cl, g = _paged(cuda, dtype, ctx, H=H, KVH=KVH, D=D)
    bt[-1] = 0  # a padded row reading the never-written garbage page
    k8, v8 = _int8_pools(kp, vp)
    q = torch.randn((len(ctx), H, D), generator=g, device=cuda).to(dtype)
    n0 = pa.paged_attention_decode.launches
    got = pa.paged_attention_decode(q, k8, v8, bt, cl)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == n0 + 1
    want = pa.paged_attention_decode_ref(q, k8, v8, bt, cl)
    assert torch.all(got[5] == 0) and torch.all(got[6] == 0) and torch.isfinite(got).all()
    err = _err(got, want)
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [(32, 8, 128), (32, 32, 64)])
@pytest.mark.parametrize("S", [16, 100, 512])
def test_prefill_kernel_int8_pool(cuda, dtype, heads, S):
    H, KVH, D = heads
    q0 = torch.tensor([0, 700], dtype=torch.int32)
    ctx = (q0 + S).tolist()
    kp, vp, bt, cl, g = _paged(cuda, dtype, ctx, H=H, KVH=KVH, D=D)
    k8, v8 = _int8_pools(kp, vp)
    q = torch.randn((2, S, H, D), generator=g, device=cuda).to(dtype)
    pos = (q0[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(cuda)
    got = pa.paged_attention_prefill(q, k8, v8, bt, cl, pos)
    torch.cuda.synchronize()
    err = _err(got, pa.paged_attention_prefill_ref(q, k8, v8, bt, cl, pos))
    assert err <= TOL[dtype], err


def test_int8_pool_wrappers_raise_on_a_bad_pool(cuda):
    kp, vp, bt, cl, g = _paged(cuda, torch.bfloat16, [5])
    k8, v8 = _int8_pools(kp, vp)
    q = torch.randn((1, 32, 128), generator=g, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError):  # one pool quantised, the other not
        pa.paged_attention_decode(q, k8, vp, bt, cl)
    with pytest.raises(ValueError):  # scale plane of the wrong shape
        pa.paged_attention_decode(q, (k8[0], k8[1][..., :4].contiguous()), v8, bt, cl)
    with pytest.raises(ValueError):  # scales must be fp32
        pa.paged_attention_decode(q, (k8[0], k8[1].to(torch.bfloat16)), v8, bt, cl)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    kp, vp, bt, cl, g = _paged(cuda, torch.bfloat16, [5])
    q = torch.randn((1, 32, 128), generator=g, device=cuda).to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        pa.paged_attention_decode(q, kp, vp, bt, cl, window=4)
    with pytest.raises(NotImplementedError):  # the mixed routing has no gather fallback either
        pa.paged_attention_mixed(q, kp, vp, bt, cl, cl - 1, n_dec=1, chunk=0, alibi_slopes=[0.5] * 32)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q.float(), kp, vp, bt, cl)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, kp, vp, bt.long(), cl)


def test_engine_on_the_card_matches_the_cpu(cuda):
    """The fused serving path with the kernels (fp32, head dim 64) gives the
    CPU engine's greedy tokens (plain versions), and every kernel launched."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, max_seq_len=512,
                            norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [[3, 17, 42], list(range(40)), [100, 2] * 30, [9] * 11]

    def serve(device):
        smc = RaggedBatchConfig(kv_block_size=16, max_context=512, num_kv_blocks=64)
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(state_manager=smc, dtype="float32",
                                                                           device=device, decode_burst=8))
        engine.scheduler.prefill_chunk = 32  # mixed quanta: chunked prefill rows beside decode rows
        return engine.generate(prompts, max_new_tokens=12)

    counters = (norms.rms_norm, pa.paged_attention_decode, pa.paged_attention_prefill)
    before = [fn.launches for fn in counters]
    assert serve("cuda") == serve("cpu")
    assert all(fn.launches > n for fn, n in zip(counters, before))


@pytest.mark.parametrize("quant_bits,kv_quant_bits", [(8, 8), (4, 0)])
def test_quantised_engine_on_the_card_matches_the_cpu(cuda, quant_bits, kv_quant_bits):
    """A LayerNorm model served with quantised weights (and int8 KV pages) in
    fp32, head dim 64: the card's greedy tokens (kernels) equal the CPU
    engine's (plain versions), and every kernel of the path launched."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, init_params
    from deepspeed_tpu_torch.ops import quantized_matmul as qm

    cfg = TransformerConfig(vocab_size=512, n_layers=2, n_heads=4, d_model=256, max_seq_len=512)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [[3, 17, 42], list(range(40)), [100, 2] * 30, [9] * 11]

    def serve(device):
        smc = RaggedBatchConfig(kv_block_size=16, max_context=512, num_kv_blocks=64)
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=smc, dtype="float32", device=device, decode_burst=8, quant_bits=quant_bits,
            quant_min_size=256, kv_quant_bits=kv_quant_bits))
        engine.scheduler.prefill_chunk = 32  # mixed quanta: chunked prefill rows beside decode rows
        return engine.generate(prompts, max_new_tokens=12)

    counters = (norms.layer_norm, qm.quantized_matmul, pa.paged_attention_decode, pa.paged_attention_prefill)
    before = [fn.launches for fn in counters]
    assert serve("cuda") == serve("cpu")
    assert all(fn.launches > n for fn, n in zip(counters, before))


# ---------------------------------------------------------------- training kernels (flash A/B/C, fused Adam D)
def _flash_inputs(dev, dtype, B, Sq, Sk, H, KVH, D, seed=0):
    g = _gen(dev, seed)
    q = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KVH, D), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KVH, D), generator=g, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, D), generator=g, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=2, Sq=256, Sk=256, H=4, KVH=4, D=64, causal=True),
    dict(B=1, Sq=200, Sk=200, H=8, KVH=2, D=128, causal=True),      # GQA, ragged tail
    dict(B=2, Sq=96, Sk=160, H=4, KVH=1, D=32, causal=True),        # Sq < Sk, MQA
    dict(B=1, Sq=130, Sk=130, H=4, KVH=2, D=64, causal=False),
    dict(B=1, Sq=256, Sk=256, H=4, KVH=4, D=64, causal=True, window=48),
    dict(B=1, Sq=128, Sk=128, H=4, KVH=4, D=64, causal=True, alibi=True),
    dict(B=1, Sq=160, Sk=96, H=4, KVH=2, D=64, causal=True),         # Sq > Sk: leading rows see no key
    dict(B=1, Sq=64, Sk=200, H=8, KVH=2, D=32, causal=False, alibi=True),
])
def test_flash_kernels(cuda, dtype, case):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    case = dict(case)
    causal, window, alibi = case.pop("causal"), case.pop("window", 0), case.pop("alibi", False)
    q, k, v, do = _flash_inputs(cuda, dtype, **case)
    slopes = torch.tensor([0.5 ** (i + 1) for i in range(case["H"])], device=cuda) if alibi else None
    scale = case["D"] ** -0.5
    counts = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, slopes, scale, causal, window)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, slopes, scale, causal, window)
    delta = fa.flash_delta(o_ref, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, slopes, scale, causal, window)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, slopes, scale, causal, window)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == tuple(c + 1 for c in counts)
    dq_ref = fa.flash_bwd_dq_ref(q, k, v, do, lse_ref, delta, slopes, scale, causal, window)
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(q, k, v, do, lse_ref, delta, slopes, scale, causal, window)
    # a row's scale is at least the tensor's mean magnitude: the first causal
    # row's dq is exactly 0 in the plain version (p = 1, dp = delta)
    # fp32: relative to max(1, max |want|), since dk/dv sum the group's heads in another order
    errs = {name: _err(got, want, want.float().abs().mean().item())
            / (max(1.0, want.float().abs().max().item()) if dtype == torch.float32 else 1.0)
            for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref))}
    errs["lse"] = (lse - lse_ref).abs().max().item()
    assert errs["lse"] <= 1e-4 and all(errs[n] <= TOL[dtype] for n in ("o", "dq", "dk", "dv")), errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    dict(B=2, Sq=300, Sk=300, H=4, KVH=2, D=64, causal=True),        # Sq, Sk not multiples of 128
    dict(B=1, Sq=300, Sk=130, H=4, KVH=4, D=32, causal=True),        # Sq > Sk: leading rows see no key
    dict(B=1, Sq=77, Sk=333, H=4, KVH=1, D=128, causal=True),        # Sq < Sk, one KV head
    dict(B=1, Sq=200, Sk=260, H=2, KVH=2, D=32, causal=False),
    dict(B=1, Sq=400, Sk=400, H=2, KVH=2, D=128, causal=True, window=100),  # a window across tiles
    dict(B=1, Sq=256, Sk=256, H=4, KVH=2, D=64, causal=True, window=64, alibi=True),
])
def test_flash_fwd_kernel(cuda, dtype, case):
    """The forward alone at ragged, empty-row, window and head-dim cases: o and lse against the plain version."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    case = dict(case)
    causal, window, alibi = case.pop("causal"), case.pop("window", 0), case.pop("alibi", False)
    q, k, v, _ = _flash_inputs(cuda, dtype, **case)
    slopes = torch.tensor([0.5 ** (i + 1) for i in range(case["H"])], device=cuda) if alibi else None
    args = (slopes, case["D"] ** -0.5, causal, window)
    o, lse = fa.flash_fwd(q, k, v, *args)
    torch.cuda.synchronize()
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
    err = _err(o, o_ref, o_ref.float().abs().mean().item())
    if dtype == torch.float32:
        err /= max(1.0, o_ref.float().abs().max().item())
    assert err <= TOL[dtype] and (lse - lse_ref).abs().max().item() <= 1e-4, (err, (lse - lse_ref).abs().max())
    blind = case["Sq"] - case["Sk"]  # rows that see no key (Sq > Sk, causal): zeros and lse = -1e30
    if causal and blind > 0:
        assert torch.all(o[:, :blind] == 0) and torch.all(lse[..., :blind] == fa.NEG_INF)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sqb", ["1", "Sq"])
@pytest.mark.parametrize("Hb", ["1", "H"])
def test_flash_fwd_kernel_bias_layouts(cuda, dtype, Sqb, Hb):
    """Each bias layout the forward reads (Sqb 1 or Sq, Hb 1 or H) at ragged Sq, Sk and an odd Sk."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    for B, Sq, Sk, H, D, causal in ((2, 150, 150, 4, 32, False), (1, 129, 257, 2, 64, True), (2, 70, 77, 2, 128, False)):
        shape = (1, H if Hb == "H" else 1, Sq if Sqb == "Sq" else 1, Sk)
        q, k, v, _, bias, meta = _bias_inputs(cuda, dtype, B, Sq, Sk, H, D, shape, 1)
        args = (None, D ** -0.5, causal, 0, bias, meta)
        o, lse = fa.flash_fwd(q, k, v, *args)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args)
        err = _err(o, o_ref, o_ref.float().abs().mean().item())
        if dtype == torch.float32:
            err /= max(1.0, o_ref.float().abs().max().item())
        assert err <= TOL[dtype] and (lse - lse_ref).abs().max().item() <= 1e-4, (B, Sq, Sk, D, err)


def test_flash_attention_autograd_on_the_card(cuda):
    """Gradients through the autograd function equal those through the plain path."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.attention import attention_xla

    q, k, v, do = _flash_inputs(cuda, torch.float32, 2, 128, 128, 8, 2, 64)
    grads = []
    for fn in (fa.flash_attention, attention_xla):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True)
        out.backward(do)
        grads.append([out] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        assert (got - want).abs().max().item() <= 1e-4
    # an additive bias takes the kernels too, and its gradient comes back in its own shape
    bias = torch.randn((1, 8, 128, 128), generator=_gen(cuda, 1), device=cuda)
    n0 = fa.flash_bwd_dq_collapsed.launches
    grads = []
    for fn in (fa.flash_attention, attention_xla):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
        out = fn(*leaves[:3], causal=True, bias=leaves[3])
        out.backward(do)
        grads.append([out] + [t.grad for t in leaves])
    assert fa.flash_bwd_dq_collapsed.launches == n0 + 1
    for got, want in zip(*grads):
        assert got.shape == want.shape and (got - want).abs().max().item() <= 1e-4


# ---------------------------------------------------------------- flash with an additive bias (evoformer)
# (B, Sq, Sk, H, D, 4-D bias shape, repeat, causal): the four ways programs share a
# bias slice (Bb = Hb = 1; Hb = 1; Bb = 1; neither), each with Sqb = Sq and Sqb = 1,
# a bias that nothing collapses, odd Sq and Sk, D 32 / 64 / 128
BIAS_CASES = [
    (4, 64, 64, 2, 32, (1, 1, 64, 64), 1, False),
    (4, 64, 64, 2, 32, (1, 1, 1, 64), 1, False),
    (6, 48, 48, 2, 64, (2, 1, 48, 48), 3, False),
    (6, 48, 48, 2, 64, (2, 1, 1, 48), 3, False),
    (3, 70, 70, 4, 32, (1, 4, 70, 70), 1, False),
    (3, 70, 70, 4, 32, (1, 4, 1, 70), 1, False),
    (4, 40, 77, 2, 64, (2, 2, 40, 77), 2, False),
    (4, 40, 77, 2, 64, (2, 2, 1, 77), 2, False),
    (2, 96, 96, 2, 128, (2, 2, 96, 96), 1, False),
    (2, 50, 77, 2, 32, (2, 2, 50, 77), 1, True),
    (4, 64, 64, 2, 128, (1, 2, 64, 64), 1, True),
    (4, 33, 33, 2, 32, (4, 1, 1, 33), 1, True),
]


def _bias_inputs(dev, dtype, B, Sq, Sk, H, D, shape, repeat, seed=0):
    q, k, v, do = _flash_inputs(dev, dtype, B, Sq, Sk, H, H, D, seed)
    g = _gen(dev, seed + 1)
    bias = torch.randn(shape, generator=g, device=dev) * 0.5
    bias = bias.masked_fill(torch.rand(shape, generator=g, device=dev) < 0.15, -1e9)  # a mask bias: finite
    bias[..., 0] = 0.0  # every row keeps a key
    Bb, Hb, Sqb, _ = shape
    return q, k, v, do, bias.reshape(Bb * Hb, Sqb, Sk).contiguous(), (Bb, Hb, Sqb, repeat if Bb > 1 else 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BIAS_CASES, ids=[f"{c[5]}x{c[6]}{'-causal' if c[7] else ''}-D{c[4]}"
                                                  for c in BIAS_CASES])
def test_flash_bias_kernels(cuda, dtype, case):
    """Forward, dq (per program or collapsed, with dbias) and dk/dv with a bias
    against their plain versions; a collapsed dbias repeats bit for bit."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, Sq, Sk, H, D, shape, repeat, causal = case
    q, k, v, do, bias, meta = _bias_inputs(cuda, dtype, B, Sq, Sk, H, D, shape, repeat)
    args = (None, D**-0.5, causal, 0)
    o, lse = fa.flash_fwd(q, k, v, *args, bias, meta)
    o_ref, lse_ref = fa.flash_fwd_ref(q, k, v, *args, bias, meta)
    bwd = (q, k, v, do, lse_ref, fa.flash_delta(o_ref, do), *args, bias, meta)
    collapsed = fa.bias_is_collapsed(meta, B, H)
    n0 = fa.flash_bwd_dq_collapsed.launches
    if collapsed:
        dq, dbias = fa.flash_bwd_dq_collapsed(*bwd)
        dq2, dbias2 = fa.flash_bwd_dq_collapsed(*bwd)
        dq_ref, dbias_ref = fa.flash_bwd_dq_collapsed_ref(*bwd)
        assert fa.flash_bwd_dq_collapsed.launches == n0 + 2
        assert torch.equal(dbias, dbias2) and torch.equal(dq, dq2)
    else:
        dbias, dbias_ref = torch.empty_like(bias), torch.empty_like(bias)
        dq = fa.flash_bwd_dq(*bwd, dbias)
        dq_ref = fa.flash_bwd_dq_ref(*bwd, dbias_ref)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    torch.cuda.synchronize()
    dk_ref, dv_ref = fa.flash_bwd_dkv_ref(*bwd)
    assert dbias.shape == bias.shape
    # as test_flash_kernels: a row's scale at least the tensor's mean magnitude;
    # fp32 over max(1, max |want|), since dbias sums up to B*H programs' rows
    errs = {name: _err(got, want, want.float().abs().mean().item())
            / (max(1.0, want.float().abs().max().item()) if dtype == torch.float32 else 1.0)
            for name, got, want in (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref),
                                    ("dbias", dbias, dbias_ref))}
    errs["lse"] = (lse - lse_ref).abs().max().item()
    assert errs["lse"] <= 1e-4 and all(errs[n] <= TOL[dtype] for n in ("o", "dq", "dk", "dv", "dbias")), errs


def test_evoformer_on_the_card_matches_the_cpu(cuda):
    """DS4Sci_EvoformerAttention on CUDA tensors (the kernels) gives the CPU
    route's output and the gradients of q, k, v and both biases, for the MSA
    row shape (mask + pair: nothing collapsed), the pair bias alone (a
    collapsed batch) and the mask alone (one row per slice)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.evoformer import DS4Sci_EvoformerAttention

    g = torch.Generator().manual_seed(0)
    B, N, L, H, D = 1, 6, 40, 4, 32
    q, k, v, do = (torch.randn((B, N, L, H, D), generator=g) for _ in range(4))
    mask = torch.where(torch.rand((B, N, 1, 1, L), generator=g) < 0.2, -1e9, 0.0)
    mask[..., 0] = 0.0
    pair = torch.randn((B, 1, H, L, L), generator=g)
    for biases in ([mask, pair], [pair], [mask]):
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [t.to(dev).detach().requires_grad_(True) for t in (q, k, v, *biases)]
            out = DS4Sci_EvoformerAttention(*leaves[:3], leaves[3:])
            out.backward(do.to(dev))
            grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
        for got, want in zip(*grads):
            assert got.shape == want.shape and (got - want).abs().max().item() <= 1e-4 * max(
                1.0, want.abs().max().item())
    assert fa.flash_bwd_dq_collapsed.launches > 0 and fa.flash_bwd_dq.launches > 0


@pytest.mark.parametrize("n", [1000, 4096 * 3 + 1])
@pytest.mark.parametrize("finite", [True, False])
def test_fused_adam_kernel(cuda, n, finite):
    from deepspeed_tpu_torch.ops import fused_adam as fad

    g = _gen(cuda)
    state = [torch.randn(n, generator=g, device=cuda) for _ in range(3)]
    state[2] = state[2].abs()
    grad = torch.randn(n, generator=g, device=cuda)
    scal = fad.adam_scalars(1e-3, 3, 0.9, 0.999, grad_mult=0.5, finite=finite, device=cuda)
    ref = [t.clone() for t in state]
    n0 = fad.fused_adam.launches
    fad.fused_adam(*state[:1], grad, *state[1:], scal, weight_decay=0.01)
    fad.fused_adam_ref(ref[0], grad, ref[1], ref[2], scal, weight_decay=0.01)
    torch.cuda.synchronize()
    assert fad.fused_adam.launches == n0 + 1
    for got, want in zip(state, ref):  # relative to the tensor's largest value
        assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6


def test_training_on_the_card_matches_the_cpu(cuda):
    """Three engine steps of a small gpt2 (head dim 64) in fp32 on the card
    (flash kernels, FusedAdam) give the CPU engine's losses (plain versions),
    and every training kernel launched."""
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, init_params
    from deepspeed_tpu_torch.ops import flash_attention as fa, fused_adam as fad

    cfg = TransformerConfig(vocab_size=512, n_layers=2, n_heads=4, d_model=256, max_seq_len=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"input_ids": np.random.default_rng(0).integers(0, 512, (2, 128)).astype(np.int32)}
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3}}}

    def run(device):
        engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=config, device=device)
        return [float(engine.train_batch(itertools.repeat(batch))) for _ in range(3)]

    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv, fad.fused_adam)
    before = [fn.launches for fn in counters]
    got, want = run("cuda"), run("cpu")
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-4, (got, want)
    assert all(fn.launches > n for fn, n in zip(counters, before))


# ---------------------------------------------------------------- block-sparse attention (SparseSelfAttention)
def _sparse_configs():
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    return {
        "fixed_uni_b16": lambda H: sa.FixedSparsityConfig(num_heads=H, block=16, attention="unidirectional"),
        "fixed_bi_heads_b16": lambda H: sa.FixedSparsityConfig(num_heads=H, block=16, different_layout_per_head=True,
                                                               num_different_global_patterns=4),
        "bigbird_b64": lambda H: sa.BigBirdSparsityConfig(num_heads=H, block=64, num_random_blocks=3),
        "longformer_uni_b32": lambda H: sa.BSLongformerSparsityConfig(num_heads=H, block=32,
                                                                      attention="unidirectional"),
        "variable_b128": lambda H: sa.VariableSparsityConfig(num_heads=H, block=128, num_random_blocks=1,
                                                             local_window_blocks=[1, 2], global_block_indices=[1]),
    }


# (config, B, S, H, D, causal): small shapes over every block size and head dim (S 272
# and 224 end in a partial CUDA block of the forward and dq), and the full gpt2_1_3b
# shape of the main case at batch 1
SPARSE_CASES = [
    ("fixed_uni_b16", 2, 512, 4, 64, True),
    ("fixed_uni_b16", 2, 272, 4, 64, True),
    ("longformer_uni_b32", 1, 224, 2, 32, True),
    ("fixed_bi_heads_b16", 1, 256, 4, 32, False),
    ("bigbird_b64", 1, 1024, 2, 32, False),
    ("longformer_uni_b32", 2, 512, 4, 128, True),
    ("variable_b128", 1, 1024, 2, 64, False),
    ("fixed_uni_b16", 1, 8192, 32, 64, True),
]


def _sparse_errs(dtype, pairs):
    """As test_flash_kernels: a row's scale at least the tensor's mean magnitude;
    fp32 over max(1, max |want|)."""
    return {name: _err(got, want, want.float().abs().mean().item())
            / (max(1.0, want.float().abs().max().item()) if dtype == torch.float32 else 1.0)
            for name, got, want in pairs}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPARSE_CASES, ids=[f"{c[0]}-S{c[2]}-D{c[4]}" for c in SPARSE_CASES])
def test_sparse_kernels(cuda, dtype, case):
    """sparse_fwd, sparse_bwd_dq and sparse_bwd_dkv against their plain versions."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    name, B, S, H, D, causal = case
    cfg = _sparse_configs()[name](H)
    q, k, v, do = _flash_inputs(cuda, dtype, B, S, S, H, H, D)
    kidx, qidx = ss._device_lists(cfg, S, H, causal, cuda)
    args = (cfg.block, D**-0.5, causal)
    counts = (ss.sparse_fwd.launches, ss.sparse_bwd_dq.launches, ss.sparse_bwd_dkv.launches)
    o, lse = ss.sparse_fwd(q, k, v, kidx, *args)
    o_ref, lse_ref = ss.sparse_fwd_ref(q, k, v, kidx, *args)
    delta = ss.flash_delta(o_ref, do)
    bwd = (q, k, v, do, lse_ref, delta)
    dq = ss.sparse_bwd_dq(*bwd, kidx, *args)
    dk, dv = ss.sparse_bwd_dkv(*bwd, qidx, *args)
    torch.cuda.synchronize()
    assert (ss.sparse_fwd.launches, ss.sparse_bwd_dq.launches, ss.sparse_bwd_dkv.launches) == tuple(
        c + 1 for c in counts)
    dq_ref = ss.sparse_bwd_dq_ref(*bwd, kidx, *args)
    dk_ref, dv_ref = ss.sparse_bwd_dkv_ref(*bwd, qidx, *args)
    errs = _sparse_errs(dtype, (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)))
    errs["lse"] = (lse - lse_ref).abs().max().item()
    assert errs["lse"] <= 1e-4 and all(errs[n] <= TOL[dtype] for n in ("o", "dq", "dk", "dv")), errs


def test_sparse_dense_layout_matches_the_flash_kernels(cuda):
    """A dense layout (block 64) through the sparse kernels gives the flash
    kernels' o, lse, dq, dk and dv (bf16 per row within 1e-2)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa, sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    B, S, H, D = 2, 1024, 8, 64
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, B, S, S, H, H, D)
    kidx, qidx = ss._device_lists(sa.DenseSparsityConfig(num_heads=H, block=64), S, H, True, cuda)
    o, lse = ss.sparse_fwd(q, k, v, kidx, 64, D**-0.5, True)
    o_f, lse_f = fa.flash_fwd(q, k, v, None, D**-0.5, True, 0)
    bwd = (q, k, v, do, lse_f, fa.flash_delta(o_f, do))
    dq = ss.sparse_bwd_dq(*bwd, kidx, 64, D**-0.5, True)
    dk, dv = ss.sparse_bwd_dkv(*bwd, qidx, 64, D**-0.5, True)
    dq_f = fa.flash_bwd_dq(*bwd, None, D**-0.5, True, 0)
    dk_f, dv_f = fa.flash_bwd_dkv(*bwd, None, D**-0.5, True, 0)
    torch.cuda.synchronize()
    errs = _sparse_errs(torch.bfloat16, (("o", o, o_f), ("dq", dq, dq_f), ("dk", dk, dk_f), ("dv", dv, dv_f)))
    errs["lse"] = (lse - lse_f).abs().max().item()
    assert errs["lse"] <= 1e-4 and all(errs[n] <= 1e-2 for n in ("o", "dq", "dk", "dv")), errs


def test_sparse_attention_on_the_card_matches_the_cpu(cuda):
    """SparseSelfAttention on CUDA tensors (the kernels) gives the CPU route's
    output and gradients (fp32, GQA 4 / 2 heads, causal), and a layout with an
    empty query row gives o = 0 there on both."""
    import numpy as np

    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    class HoleConfig(sa.SparsityConfig):
        def make_layout(self, seq_len):
            lay = sa.FixedSparsityConfig(num_heads=self.num_heads, block=self.block).make_layout(seq_len)
            lay[:, 2, :] = False  # query block 2 attends nothing
            return lay

    g = torch.Generator().manual_seed(0)
    q, do = torch.randn((2, 256, 4, 64), generator=g), torch.randn((2, 256, 4, 64), generator=g)
    k, v = torch.randn((2, 256, 2, 64), generator=g), torch.randn((2, 256, 2, 64), generator=g)
    n0 = [fn.launches for fn in (ss.sparse_fwd, ss.sparse_bwd_dq, ss.sparse_bwd_dkv)]
    for cfg, causal in ((sa.BigBirdSparsityConfig(num_heads=4, block=32), True), (HoleConfig(num_heads=4), False)):
        grads = []
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v)]
            out = sa.SparseSelfAttention(cfg, causal=causal)(*leaves)
            out.backward(do.to(dev))
            grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
        for got, want in zip(*grads):
            assert got.shape == want.shape and (got - want).abs().max().item() <= 1e-5 * max(
                1.0, want.abs().max().item())
        if isinstance(cfg, HoleConfig):
            assert np.all(grads[0][0][:, 32:48].numpy() == 0.0)
    assert all(fn.launches >= n + 2 for fn, n in zip((ss.sparse_fwd, ss.sparse_bwd_dq, ss.sparse_bwd_dkv), n0))


def test_sparse_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    def call(block, D, dtype):
        q = torch.randn((1, 256, 2, D), device=cuda).to(dtype)
        return sa.sparse_attention(q, q, q, sa.FixedSparsityConfig(num_heads=2, block=block))

    for block, D, dtype in ((8, 64, torch.bfloat16), (16, 80, torch.bfloat16), (16, 64, torch.float16)):
        with pytest.raises(NotImplementedError):
            call(block, D, dtype)


# ---------------------------------------------------------------- group-wise quantisation and the LAMB direction
def _quant_input(dev, rows, group, dtype, seed=0):
    """Random rows with one all-zero group and one group at exact half-way ties."""
    g = _gen(dev, seed)
    x = torch.randn((rows, group), generator=g, device=dev) * torch.rand((rows, 1), generator=g, device=dev) * 3
    x[min(1, rows - 1)] = 0.0
    if rows > 2:
        x[2] = torch.arange(group, device=dev) % 15 - 7 + 0.5
        x[2, 0] = 127.0
    return x.to(dtype)


# rows 3 (a size of 3 g) and 1003 (the last CUDA block partial at every team size)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("rows", [3, 1003])
def test_quantize_groupwise_kernel_is_bit_equal(cuda, dtype, bits, group, rows):
    from deepspeed_tpu_torch.ops import quantization as tq

    x = _quant_input(cuda, rows, group, dtype)
    n0 = tq.quantize_groupwise.launches
    q, s = tq.quantize_groupwise(x, group_size=group, bits=bits)
    wq, ws = tq.quantize_groupwise_xla(x, group_size=group, bits=bits)
    torch.cuda.synchronize()
    assert tq.quantize_groupwise.launches == n0 + 1
    assert torch.equal(q, wq) and torch.equal(s.view(torch.int32), ws.view(torch.int32))
    assert s[min(1, rows - 1)].item() == 1.0


@pytest.mark.parametrize("shape,group", [((7, 96), 3), ((5, 48), 16), ((2, 4096), 4096)])
def test_quantize_groupwise_kernel_odd_groups(cuda, shape, group):
    """Groups that take the scalar loads (3), sub-warp teams (16) and a team
    that loops (4096), over a 2-D weight."""
    from deepspeed_tpu_torch.ops import quantization as tq

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, generator=_gen(cuda), device=cuda).to(dtype)
        q, s = tq.quantize_groupwise(x, group_size=group)
        wq, ws = tq.quantize_groupwise_xla(x, group_size=group)
        torch.cuda.synchronize()
        assert torch.equal(q, wq) and torch.equal(s, ws)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [3, 64])
def test_dequantize_groupwise_kernel_is_bit_equal(cuda, out_dtype, group):
    from deepspeed_tpu_torch.ops import quantization as tq

    x = _quant_input(cuda, 1003, group * 2, torch.float32)
    q, s = tq.quantize_groupwise_xla(x, group_size=group, bits=8)
    n0 = tq.dequantize_groupwise.launches
    got = tq.dequantize_groupwise(q, s, out_shape=(1003, 2 * group), out_dtype=out_dtype)
    want = tq.dequantize_groupwise_xla(q, s, out_shape=(1003, 2 * group), out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tq.dequantize_groupwise.launches == n0 + 1
    assert got.dtype == out_dtype and torch.equal(got, want)


def test_quantisation_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import quantization as tq

    q, s = tq.quantize_groupwise(torch.randn(4, 64, device=cuda), group_size=64)
    with pytest.raises(NotImplementedError):
        tq.dequantize_groupwise(q, s, out_dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        tq.quantize_groupwise(torch.randn(4, 64, device=cuda).half(), group_size=64)
    with pytest.raises(NotImplementedError):
        tq.quantize_groupwise(torch.randn(4, 64, device=cuda), group_size=64, bits=6)
    with pytest.raises(ValueError):
        tq.quantize_groupwise(torch.randn(4, 60, device=cuda), group_size=64)


@pytest.mark.parametrize("n", [1000, 4096 * 3 + 1, 65536 + 7])
@pytest.mark.parametrize("finite", [True, False])
def test_lamb_direction_kernel(cuda, n, finite):
    from deepspeed_tpu_torch.ops import fused_adam as fad, fused_lamb as tfl

    g = _gen(cuda)
    p, grad, m = (torch.randn(n, generator=g, device=cuda) for _ in range(3))
    v = torch.rand(n, generator=g, device=cuda)
    scal = fad.adam_scalars(1e-3, 3, 0.9, 0.999, grad_mult=0.5, finite=finite, device=cuda)
    m0, v0 = m.clone(), v.clone()
    rm, rv = m.clone(), v.clone()
    n0 = tfl.lamb_direction.launches
    u = tfl.lamb_direction(p, grad, m, v, scal, weight_decay=0.01)
    want = tfl.lamb_direction_ref(p, grad, rm, rv, scal, weight_decay=0.01)
    torch.cuda.synchronize()
    assert tfl.lamb_direction.launches == n0 + 1
    for got, ref in ((u, want), (m, rm), (v, rv)):  # relative to the tensor's largest value
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-5
    if not finite:
        assert torch.equal(m, m0) and torch.equal(v, v0)


def test_v1_engine_on_the_card_matches_the_cpu(cuda):
    """Greedy tokens of a quantised llama-shaped model in fp32 on the card
    (quantise and dequantise kernels) equal the CPU engine's (plain versions)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, init_params, llama_tiny
    from deepspeed_tpu_torch.ops import quantization as tq

    cfg = llama_tiny(dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [[5, 17, 3, 99, 4, 23, 7, 1], [7, 2, 8, 11, 40, 41, 42, 3]]
    out = {}
    for device in ("cuda", "cpu"):
        n0 = tq.dequantize_groupwise.launches
        engine = dst.init_inference(CausalLM(cfg), {"dtype": "float32", "max_out_tokens": 64, "device": device,
                                                    "quant": {"enabled": True, "bits": 8}}, params=params)
        out[device] = engine.generate(prompts, max_new_tokens=12).cpu()
        if device == "cuda":
            assert tq.dequantize_groupwise.launches > n0
    assert torch.equal(out["cuda"], out["cpu"])


def test_lamb_training_on_the_card_matches_the_cpu(cuda):
    import itertools

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, init_params
    from deepspeed_tpu_torch.ops import fused_lamb as tfl

    cfg = TransformerConfig(vocab_size=512, n_layers=2, n_heads=4, d_model=256, max_seq_len=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {"input_ids": np.random.default_rng(0).integers(0, 512, (2, 128)).astype(np.int32)}
    config = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "Lamb", "params": {"lr": 1e-3}}}

    def run(device):
        engine, _, _, _ = dst.initialize(model=CausalLM(cfg), model_parameters=params, config=config, device=device)
        return [float(engine.train_batch(itertools.repeat(batch))) for _ in range(3)]

    n0 = tfl.lamb_direction.launches
    got, want = run("cuda"), run("cpu")
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-4, (got, want)
    assert tfl.lamb_direction.launches > n0
