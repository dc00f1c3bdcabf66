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
the moment updates to FMAs). Paged attention in fp32 with ALiBi adds the
plain version's own rounding of scores in the thousands (``_paged_tol``).
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


# The norms' row body (csrc/norm_rows.cuh) has a bucket per power of two of 16-byte vectors a row, up to d
# 8192: d 64 and 128 (the qk-norm's head_dim) on sub-warp teams, 768 and 2048 on a warp, 4096 and 8192 on
# several warps. 1000 falls between buckets; 8200 is past the largest and 100 is not whole vectors in bf16
# (both take the general kernel). Rows: one, partial blocks, a tail and more rows than a wave of teams.
NORM_WIDTHS = [64, 128, 768, 1000, 2048, 4096, 8192, 8200, 100]
NORM_ROWS = [1, 7, 8, 133, 2049]
# (x, w): each alone, and the mixed pairs (bf16 x with the fp32 parameters converted from the JAX package)
NORM_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16)]


def _norm_inputs(dev, dtype, wdtype, rows, d, mean=0.0, offset=False):
    """x (rows, d) (as (1, 7, d) at 7 rows, so that leading dims flatten), w, b; with ``offset`` x starts one
    element past a 16-byte boundary, so that it must take the general kernel."""
    g = _gen(dev, rows * 10_000 + d)
    x = torch.randn((rows * d + offset,), generator=g, device=dev) * 2.0 + mean
    x = x.to(dtype)[int(offset):].view((1, 7, d) if rows == 7 else (rows, d))
    w = torch.randn(d, generator=g, device=dev).to(wdtype)
    b = torch.randn(d, generator=g, device=dev).to(wdtype)
    return x, w, b


@pytest.mark.parametrize("dtype,wdtype", NORM_DTYPES)
@pytest.mark.parametrize("rows", NORM_ROWS)
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_rms_norm_kernel(cuda, dtype, wdtype, rows, d):
    x, w, _ = _norm_inputs(cuda, dtype, wdtype, rows, d)
    n0 = norms.rms_norm.launches
    got = norms.rms_norm(x, w)
    torch.cuda.synchronize()
    assert norms.rms_norm.launches == n0 + 1
    err = _err(got, norms.rms_norm_ref(x, w))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype,wdtype", NORM_DTYPES)
@pytest.mark.parametrize("rows", NORM_ROWS)
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_layer_norm_kernel(cuda, dtype, wdtype, rows, d):
    x, w, b = _norm_inputs(cuda, dtype, wdtype, rows, d, mean=3.0)
    n0 = norms.layer_norm.launches
    got = norms.layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert norms.layer_norm.launches == n0 + 1
    err = _err(got, norms.layer_norm_ref(x, w, b))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype,wdtype", NORM_DTYPES)
@pytest.mark.parametrize("d", [128, 2048, 4096])
def test_norm_kernels_on_unaligned_input(cuda, dtype, wdtype, d):
    """x one element past a 16-byte boundary takes the general kernel, once, and is still right."""
    x, w, b = _norm_inputs(cuda, dtype, wdtype, 133, d, mean=3.0, offset=True)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    for fn, ref, params in ((norms.rms_norm, norms.rms_norm_ref, (w,)),
                            (norms.layer_norm, norms.layer_norm_ref, (w, b))):
        n0 = fn.launches
        got = fn(x, *params)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        err = _err(got, ref(x, *params))
        assert err <= TOL[dtype], (fn.__name__, err)


@pytest.mark.parametrize("dtype,wdtype", NORM_DTYPES)
@pytest.mark.parametrize("d", [64, 2048, 4096, 100])
def test_layer_norm_kernel_large_mean(cuda, dtype, wdtype, d):
    """Rows of mean 50: the two-pass variance keeps the precision that E[x^2] - mean^2 would lose. Held on
    the per-row relative error in both types: in fp32 each side's rounding of a mean of 50 (2**-24 * 50 =
    3e-6, in another summation order on each side) moves y by up to ~1.2e-5 absolute against values of ~8."""
    x, w, b = _norm_inputs(cuda, dtype, wdtype, 133, d, mean=50.0)
    got, want = norms.layer_norm(x, w, b), norms.layer_norm_ref(x, w, b)
    diff = (got.float() - want.float()).flatten(0, -2).abs().amax(-1)
    err = (diff / want.float().flatten(0, -2).abs().amax(-1)).max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype,wdtype", NORM_DTYPES)
@pytest.mark.parametrize("d", [64, 128, 2048, 4096, 8192, 100])
def test_norm_kernels_repeat_bit_for_bit(cuda, dtype, wdtype, d):
    x, w, b = _norm_inputs(cuda, dtype, wdtype, 2049, d, mean=1.0)
    for fn, params in ((norms.rms_norm, (w,)), (norms.layer_norm, (w, b))):
        first, second = fn(x, *params), fn(x, *params)
        assert torch.equal(first, second), fn.__name__


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
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q.float(), kp, vp, bt, cl)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, kp, vp, bt.long(), cl)
    with pytest.raises(ValueError):  # one slope per query head
        pa.paged_attention_decode(q, kp, vp, bt, cl, alibi_slopes=[0.5] * 8)
    with pytest.raises(ValueError):
        pa.paged_attention_decode(q, kp, vp, bt, cl, window=-4)
    with pytest.raises(NotImplementedError):  # more than 8 query heads a KV head
        pa.paged_attention_decode(torch.randn((1, 32, 128), device=cuda).to(torch.bfloat16), kp[:, :, :2].contiguous(),
                                  vp[:, :, :2].contiguous(), bt, cl)


# ALiBi, the sliding window, both or neither, in every body (bf16 and fp32 q; bf16 or int8 pools). Decode
# contexts on split and page edges (511, 512, 513: the bf16 plan cuts these rows' 64 x 128 slots into splits of
# 256 keys), 1 and 0, a padded row on the garbage page and one long row among short ones.
DEC_CTX = [511, 512, 513, 1, 0, 1, 6000, 37]
FEATURES = [None, "alibi", "window", "both"]


def _feature_args(feature, H):
    from deepspeed_tpu_torch.models import alibi_slopes

    slopes = alibi_slopes(H) if feature in ("alibi", "both") else None
    window = 300 if feature in ("window", "both") else None
    return slopes, window


def _paged_tol(dtype, slopes, last_key, v_pages):
    """TOL, and in fp32 with ALiBi the plain version's own rounding on top: a score of magnitude up to
    S = max slope * the last key position rounds to fp32 with an error of up to 2**-24 S, which moves
    that key's weight by as much relatively, on either side (7.6e-5 seen at S 4,243 against 1e-5)."""
    if dtype != torch.float32 or slopes is None:
        return TOL[dtype]
    v = pa.dequantize_kv(v_pages) if pa.kv_pool_is_quantized(v_pages) else v_pages
    return TOL[dtype] + 2 * 2**-24 * float(max(abs(x) for x in slopes)) * last_key * v.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,D", [(1, 64), (1, 128), (4, 64), (4, 128), (8, 64), (8, 128)])
@pytest.mark.parametrize("feature", FEATURES)
def test_decode_kernel_features(cuda, dtype, int8, G, D, feature):
    KVH = 4
    H = G * KVH
    kp, vp, bt, cl, g = _paged(cuda, dtype, DEC_CTX, H=H, KVH=KVH, D=D, seed=G + D)
    bt[5] = 0  # a padded row reading the garbage page
    if int8:
        kp, vp = _int8_pools(kp, vp)
    q = torch.randn((len(DEC_CTX), H, D), generator=g, device=cuda).to(dtype)
    slopes, window = _feature_args(feature, H)
    n0 = pa.paged_attention_decode.launches
    got = pa.paged_attention_decode(q, kp, vp, bt, cl, alibi_slopes=slopes, window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == n0 + 1
    want = pa.paged_attention_decode_ref(q, kp, vp, bt, cl, alibi_slopes=slopes, window=window)
    assert torch.all(got[4] == 0) and torch.isfinite(got).all()  # ctx 0 writes zeros
    err = _err(got, want)
    assert err <= _paged_tol(dtype, slopes, max(DEC_CTX), vp), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("bs,P", [(16, 40), (32, 9), (256, 3)])
@pytest.mark.parametrize("feature", [None, "both"])
def test_decode_kernel_block_sizes(cuda, dtype, int8, bs, P, feature):
    ctx = [100, 33, 0, P * bs, 257 % (P * bs)]
    kp, vp, bt, cl, g = _paged(cuda, dtype, ctx, H=16, KVH=4, D=128, bs=bs, P=P, seed=bs)
    if int8:
        kp, vp = _int8_pools(kp, vp)
    q = torch.randn((len(ctx), 16, 128), generator=g, device=cuda).to(dtype)
    slopes, window = _feature_args(feature, 16)
    got = pa.paged_attention_decode(q, kp, vp, bt, cl, alibi_slopes=slopes, window=window)
    torch.cuda.synchronize()
    err = _err(got, pa.paged_attention_decode_ref(q, kp, vp, bt, cl, alibi_slopes=slopes, window=window))
    assert err <= _paged_tol(dtype, slopes, max(ctx), vp), err


# Prefill rows: a chunk from position 0; one continuing a context of 1,000 (its causal end inside a tile, and
# cut by a window of 300); one whose 20 keys lie before its queries (under the window its queries see no key
# and write zeros).
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (8, 128), (4, 64)])
@pytest.mark.parametrize("S", [16, 77])
@pytest.mark.parametrize("feature", FEATURES)
def test_prefill_kernel_features(cuda, dtype, int8, G, D, S, feature):
    KVH = 2
    H = G * KVH
    q0 = torch.tensor([0, 1000, 700], dtype=torch.int32)
    ctx = [S, 1000 + S, 20]
    kp, vp, bt, cl, g = _paged(cuda, dtype, ctx, H=H, KVH=KVH, D=D, seed=S + G)
    if int8:
        kp, vp = _int8_pools(kp, vp)
    q = torch.randn((3, S, H, D), generator=g, device=cuda).to(dtype)
    pos = (q0[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(cuda)
    slopes, window = _feature_args(feature, H)
    n0 = pa.paged_attention_prefill.launches
    got = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, alibi_slopes=slopes, window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention_prefill.launches == n0 + 1
    want = pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos, alibi_slopes=slopes, window=window)
    assert torch.isfinite(got).all()
    if window is not None:
        assert torch.all(got[2] == 0)
    err = _err(got, want)
    assert err <= _paged_tol(dtype, slopes, max(ctx), vp), err


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("feature", [None, "both"])
def test_paged_kernels_repeat_bit_for_bit(cuda, int8, feature):
    """Two launches of the bf16 decode (8 rows: its plan splits every row) and prefill (2 x 16, split; 2 x 300,
    whole) give bit-equal results: the splits merge in a fixed order, without atomics."""
    dec_ctx = [4096, 1, 127, 513, 2000, 8192, 0, 300]
    kp, vp, bt, cl, g = _paged(cuda, torch.bfloat16, dec_ctx, seed=3)
    if int8:
        kp, vp = _int8_pools(kp, vp)
    q = torch.randn((8, 32, 128), generator=g, device=cuda).to(torch.bfloat16)
    slopes, window = _feature_args(feature, 32)
    kw = dict(alibi_slopes=slopes, window=window)
    first = pa.paged_attention_decode(q, kp, vp, bt, cl, **kw)
    assert torch.equal(first, pa.paged_attention_decode(q, kp, vp, bt, cl, **kw))
    for S in (16, 300):
        q0 = torch.tensor([0, 1000], dtype=torch.int32)
        kp, vp, bt, cl, g = _paged(cuda, torch.bfloat16, (q0 + S).tolist(), seed=S)
        if int8:
            kp, vp = _int8_pools(kp, vp)
        q = torch.randn((2, S, 32, 128), generator=g, device=cuda).to(torch.bfloat16)
        pos = (q0[:, None] + torch.arange(S, dtype=torch.int32)[None]).to(cuda)
        first = pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, **kw)
        assert torch.equal(first, pa.paged_attention_prefill(q, kp, vp, bt, cl, pos, **kw))
        assert torch.isfinite(first).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,chunk", [(64, 5), (64, 2), (8, 5), (3, 3)])
def test_prefill_kernel_at_verify_windows(cuda, dtype, int8, B, chunk):
    """A speculative verify step's prefill: B rows of ``chunk`` queries at llama3_8b's heads, each window the
    last positions of a context between 130 and 8,192 (at B 8 the bf16 plan splits the keys), and
    ``paged_attention_mixed`` with no decode rows launches the prefill kernel alone."""
    ctx = [130 + (8192 - 130) * r // max(1, B - 1) for r in range(B)]
    kp, vp, bt, cl, g = _paged(cuda, dtype, ctx, seed=B + chunk)
    if int8:
        kp, vp = _int8_pools(kp, vp)
    q = torch.randn((B, chunk, 32, 128), generator=g, device=cuda).to(dtype)
    pos = (torch.tensor(ctx, dtype=torch.int32)[:, None] - chunk + torch.arange(chunk, dtype=torch.int32)[None])
    pos = pos.to(cuda)
    n_dec, n_pre = pa.paged_attention_decode.launches, pa.paged_attention_prefill.launches
    got = pa.paged_attention_mixed(q.reshape(B * chunk, 32, 128), kp, vp, bt, cl, pos.reshape(-1), n_dec=0,
                                   chunk=chunk).reshape(B, chunk, 32, 128)
    torch.cuda.synchronize()
    assert pa.paged_attention_decode.launches == n_dec and pa.paged_attention_prefill.launches == n_pre + 1
    err = _err(got, pa.paged_attention_prefill_ref(q, kp, vp, bt, cl, pos))
    assert err <= TOL[dtype], err
    if dtype == torch.bfloat16:
        assert torch.equal(got.reshape(B, chunk, 32, 128), pa.paged_attention_prefill(q, kp, vp, bt, cl, pos))


def test_engine_on_the_card_matches_the_cpu(cuda):
    """The fused serving path with the kernels (fp32, head dim 64) gives the
    CPU engine's greedy tokens (plain versions), and every kernel launched;
    so does the unfused loop on the card."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, max_seq_len=512,
                            norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [[3, 17, 42], list(range(40)), [100, 2] * 30, [9] * 11]

    def serve(device, fused=True):
        smc = RaggedBatchConfig(kv_block_size=16, max_context=512, num_kv_blocks=64)
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=smc, dtype="float32", device=device, decode_burst=8, fused_step=fused))
        engine.scheduler.prefill_chunk = 32  # mixed quanta: chunked prefill rows beside decode rows
        return engine.generate(prompts, max_new_tokens=12)

    counters = (norms.rms_norm, pa.paged_attention_decode, pa.paged_attention_prefill)
    before = [fn.launches for fn in counters]
    cpu = serve("cpu")
    assert serve("cuda") == cpu
    assert all(fn.launches > n for fn, n in zip(counters, before))
    # the unfused loop (prefill, decode and burst steps) gives the same tokens on the card in fp32
    before = [fn.launches for fn in counters]
    assert serve("cuda", fused=False) == cpu
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


def _graph_engines(fused, **kw):
    """Two bf16 engines on the card from one set of weights: one replays a
    captured CUDA graph per step, the other (``_eager_steps``) runs each step
    eagerly, as a CPU engine does."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, max_seq_len=512,
                            norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = []
    for eager in (False, True):
        smc = RaggedBatchConfig(kv_block_size=16, max_context=512, num_kv_blocks=64)
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=smc, dtype="bfloat16", device="cuda", decode_burst=8, fused_step=fused, **kw))
        engine.scheduler.prefill_chunk = 32  # mixed quanta: chunked prefill rows beside decode rows
        engine._eager_steps = eager
        out.append(engine)
    return out


GRAPH_PROMPTS = [[3, 17, 42], list(range(40)), [100, 2] * 30, [9] * 11, list(range(7, 90))]


def _serve_both(engines, counters, **gen):
    """The same two waves on each engine; per engine the tokens and each
    counter's launches."""
    runs = []
    for engine in engines:
        before = [fn.launches for fn in counters]
        toks = [engine.generate(GRAPH_PROMPTS, max_new_tokens=12, **gen),
                engine.generate([p + [5] * 9 for p in GRAPH_PROMPTS[1:4]], max_new_tokens=9, **gen)]
        torch.cuda.synchronize()
        runs.append((toks, [fn.launches - b for fn, b in zip(counters, before)]))
    return runs


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sample", [None, dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9, seed=7)])
def test_graph_steps_equal_eager_steps(cuda, fused, sample):
    """Each step replayed from its captured graph (the fused step; or the
    unfused loop's prefill, decode and burst steps) gives the eager step's
    tokens, greedy and sampled from one seed, and leaves the KV pools equal
    bit for bit (block 0, the garbage page the warm-up writes, excluded); the
    kernels' counters move as they do eagerly, by one graph replay a step."""
    counters = (norms.rms_norm, pa.paged_attention_decode, pa.paged_attention_prefill)
    graphs, eager = _graph_engines(fused)
    (g_toks, g_launches), (e_toks, e_launches) = _serve_both((graphs, eager), counters, **(sample or {}))
    assert g_toks == e_toks
    for g, e in ((graphs.k_pages, eager.k_pages), (graphs.v_pages, eager.v_pages)):
        assert torch.equal(g[:, 1:], e[:, 1:])
    assert g_launches == e_launches and all(n > 0 for n in g_launches)
    assert graphs.graphs.replays == graphs.dispatches == eager.dispatches > 0
    assert graphs.graphs.captures > 0 and len(eager.graphs) == 0
    if fused:
        assert graphs.fused_quanta == graphs.dispatches


def test_graph_cache_evicts_and_recaptures(cuda, monkeypatch):
    """``DS_TPU_PROGRAM_CACHE`` bounds the graphs: more buckets than that
    evict the least recently used graph and capture it again when it comes
    back, with the same tokens and launch counts as the eager engine."""
    monkeypatch.setenv("DS_TPU_PROGRAM_CACHE", "2")
    counters = (norms.rms_norm, pa.paged_attention_decode, pa.paged_attention_prefill)
    graphs, eager = _graph_engines(True)
    (g_toks, g_launches), (e_toks, e_launches) = _serve_both((graphs, eager), counters)
    assert g_toks == e_toks and g_launches == e_launches
    assert len(graphs.graphs) == 2 and graphs.graphs.evictions == graphs.graphs.captures - 2 > 0
    assert graphs.graphs.capture_s > 0.0


SPEC_PROMPTS = [[5, 9, 13] * 3, [7] * 6, [100, 2, 55, 44, 33, 22, 11], [3, 17, 42, 3, 17, 42], list(range(40))]


@pytest.mark.parametrize("fused", [True, False])
def test_spec_decode_on_the_card_matches_spec_off(cuda, fused):
    """Speculative decoding on the card in fp32 (kernels, verify steps on graphs): greedy tokens equal the
    card's with speculation off and the CPU engine's with it on, in the fused and the unfused loop; drafts
    were proposed and accepted, and the verify steps launched the prefill kernel."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import TransformerConfig, init_params

    cfg = TransformerConfig(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, max_seq_len=512,
                            norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def serve(device, spec):
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(kv_block_size=16, max_context=512, num_kv_blocks=64), dtype="float32",
            device=device, decode_burst=8, fused_step=fused, spec_decode=spec))
        return engine.generate(SPEC_PROMPTS, max_new_tokens=32), engine

    before = pa.paged_attention_prefill.launches
    on, engine = serve("cuda", True)
    assert pa.paged_attention_prefill.launches > before
    assert engine.spec_proposed > 0 and engine.graphs.replays == engine.dispatches
    assert on == serve("cuda", False)[0] == serve("cpu", True)[0]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("sample", [None, dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9, seed=7)])
def test_verify_graphs_equal_eager_verify_steps(cuda, fused, sample):
    """With speculation on, each verify step replayed from its graph gives the eager step's committed tokens
    and accepted counts, greedy and sampled (the graph advances the engine's generator as the eager step
    does), and leaves the KV pools equal bit for bit (the garbage page excluded)."""
    counters = (norms.rms_norm, pa.paged_attention_decode, pa.paged_attention_prefill)
    graphs, eager = _graph_engines(fused, spec_decode=True)
    (g_toks, g_launches), (e_toks, e_launches) = _serve_both((graphs, eager), counters, **(sample or {}))
    assert g_toks == e_toks
    for g, e in ((graphs.k_pages, eager.k_pages), (graphs.v_pages, eager.v_pages)):
        assert torch.equal(g[:, 1:], e[:, 1:])
    assert g_launches == e_launches
    assert (graphs.spec_proposed, graphs.spec_accepted) == (eager.spec_proposed, eager.spec_accepted)
    assert graphs.spec_proposed > 0 and graphs.graphs.replays == graphs.dispatches == eager.dispatches
    assert any(key[0] == "spec" for key in graphs.graphs._steps)


def test_sampled_topk1_verify_replays_deterministically(cuda):
    """A sampled verify at ``top_k=1`` replayed from its graphs: two runs from one seed give the same tokens,
    and those of the same run with eager steps. (In bf16, logits tie often enough that a draw among the tied
    tokens need not pick greedy's first one, so greedy is not the yardstick here.)"""
    graphs, eager = _graph_engines(True, spec_decode=True)

    def run(engine):  # each run from an empty prefix cache, so that each admits the prompts alike
        engine.state.reset_prefix_cache()
        return engine.generate(GRAPH_PROMPTS, max_new_tokens=24, do_sample=True, top_k=1, seed=5)

    first = run(graphs)
    assert graphs.spec_proposed > 0
    assert run(graphs) == first == run(eager)
    assert any(key[0] == "spec" and key[3] for key in graphs.graphs._steps)  # a sampled verify graph


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
    # the bf16 backward's tile edges (dq: 128 query rows a block, 64 keys a stage, 32 or 64 a sub-tile; dk/dv:
    # 64 keys a block, 64 queries a stage, 32 or 16 a sub-tile): one below and one above
    dict(B=1, Sq=127, Sk=127, H=4, KVH=4, D=64, causal=True),
    dict(B=1, Sq=129, Sk=129, H=4, KVH=1, D=64, causal=True),       # n_rep 4
    dict(B=1, Sq=65, Sk=63, H=8, KVH=1, D=128, causal=True),        # n_rep 8, Sq > Sk
    dict(B=2, Sq=191, Sk=193, H=4, KVH=4, D=32, causal=False),
    dict(B=1, Sq=320, Sk=320, H=4, KVH=1, D=64, causal=True, window=100),   # the window's edge crosses tiles
    dict(B=1, Sq=300, Sk=200, H=8, KVH=1, D=128, causal=True, window=70),   # Sq > Sk with a window
    dict(B=1, Sq=257, Sk=257, H=4, KVH=4, D=128, causal=True, alibi=True),
    dict(B=2, Sq=129, Sk=255, H=8, KVH=8, D=32, causal=True, window=33, alibi=True),
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


@pytest.mark.parametrize("case", [
    dict(B=2, Sq=1024, Sk=1024, H=8, KVH=8, D=64, causal=True),
    dict(B=1, Sq=515, Sk=515, H=8, KVH=2, D=128, causal=True, window=200, alibi=True),
    dict(B=1, Sq=300, Sk=200, H=8, KVH=1, D=32, causal=False),
])
def test_flash_backward_repeats_bit_for_bit(cuda, case):
    """Two launches of the bf16 dq and dk/dv give bit-equal results: no atomics, a fixed order over the group."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    case = dict(case)
    causal, window, alibi = case.pop("causal"), case.pop("window", 0), case.pop("alibi", False)
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, **case)
    slopes = torch.tensor([0.5 ** (i + 1) for i in range(case["H"])], device=cuda) if alibi else None
    args = (slopes, case["D"] ** -0.5, causal, window)
    o, lse = fa.flash_fwd_ref(q, k, v, *args)
    bwd = (q, k, v, do, lse, fa.flash_delta(o, do), *args)
    first = (fa.flash_bwd_dq(*bwd), *fa.flash_bwd_dkv(*bwd))
    second = (fa.flash_bwd_dq(*bwd), *fa.flash_bwd_dkv(*bwd))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.isfinite(t).all() for t in first)


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
# (B, Sq, Sk, H, D, 4-D bias shape, repeat, causal[, extras]): the four ways programs share a
# bias slice (Bb = Hb = 1; Hb = 1; Bb = 1; neither), each with Sqb = Sq and Sqb = 1,
# a bias that nothing collapses, odd Sq and Sk, D 32 / 64 / 128. extras: ALiBi slopes and a
# window beside the bias; a query row whose keys all carry -1e9; an evoformer bias, a
# (B, 1, 1, Sk) mask plus an (H, Sq, Sk) pair bias; fewer KV heads (dk/dv sums a KV head's
# query heads, each with its own bias slice). The last two: MSA column attention's mask (one
# row per batch row, shared by its heads and every query row), and 64 programs sharing each
# of two slices, which the collapsed dq splits into chunks whose partials a reduce sums
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
    (2, 130, 130, 4, 64, (2, 4, 130, 130), 1, True, dict(alibi=True, window=40)),
    (2, 70, 70, 2, 32, (2, 2, 70, 70), 1, False, dict(masked_row=37)),
    (2, 61, 61, 4, 32, (2, 4, 61, 61), 1, False),
    (16, 256, 256, 8, 32, (16, 8, 256, 256), 1, False, dict(mask_pair=True)),
    (2, 96, 96, 4, 32, (2, 4, 96, 96), 1, False, dict(kvh=2)),
    (32, 128, 128, 8, 32, (32, 1, 1, 128), 1, False),
    (64, 100, 100, 2, 64, (1, 2, 100, 100), 1, False),
]


def _bias_id(c):
    extras = "".join(f"-{key}" for key in (c[8] if len(c) > 8 else {}))
    return f"{c[5]}x{c[6]}{'-causal' if c[7] else ''}-D{c[4]}{extras}"


def _bias_inputs(dev, dtype, B, Sq, Sk, H, D, shape, repeat, seed=0, masked_row=None, mask_pair=False, kvh=None):
    q, k, v, do = _flash_inputs(dev, dtype, B, Sq, Sk, H, kvh or H, D, seed)
    g = _gen(dev, seed + 1)
    if mask_pair:  # evoformer's summed bias: a mask of 0 or -1e9 per (batch, key) plus an N(0, 1) pair bias
        mask = torch.where(torch.rand((shape[0], 1, 1, Sk), generator=g, device=dev) < 0.1, -1e9, 0.0)
        bias = torch.randn((1, *shape[1:]), generator=g, device=dev) + mask
    else:
        bias = torch.randn(shape, generator=g, device=dev) * 0.5
        bias = bias.masked_fill(torch.rand(shape, generator=g, device=dev) < 0.15, -1e9)  # a mask bias: finite
    bias[..., 0] = 0.0  # every row keeps a key
    if masked_row is not None:
        bias[..., masked_row, :] = -1e9  # every key of this row: a score of -1e9, not a masked pair
    Bb, Hb, Sqb, _ = shape
    return q, k, v, do, bias.reshape(Bb * Hb, Sqb, Sk).contiguous(), (Bb, Hb, Sqb, repeat if Bb > 1 else 1)


def _bias_case(dev, dtype, case):
    """The inputs of a BIAS_CASES case: q, k, v, do, the flat bias, its meta and the kernels' arguments."""
    B, Sq, Sk, H, D, shape, repeat, causal, *extras = case
    extras = dict(extras[0]) if extras else {}
    alibi, window = extras.pop("alibi", False), extras.pop("window", 0)
    q, k, v, do, bias, meta = _bias_inputs(dev, dtype, B, Sq, Sk, H, D, shape, repeat, **extras)
    slopes = torch.tensor([0.5 ** (i + 1) for i in range(H)], device=dev) if alibi else None
    return q, k, v, do, bias, meta, (slopes, D**-0.5, causal, window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BIAS_CASES, ids=[_bias_id(c) for c in BIAS_CASES])
def test_flash_bias_kernels(cuda, dtype, case):
    """Forward, dq (per program or collapsed, with dbias) and dk/dv with a bias
    against their plain versions; a collapsed dbias repeats bit for bit."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H = case[0], case[3]
    q, k, v, do, bias, meta, args = _bias_case(cuda, dtype, case)
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
    tol = {n: TOL[dtype] for n in ("o", "dq", "dk", "dv", "dbias")}
    if dtype == torch.bfloat16 and len(case) > 8 and "masked_row" in case[8]:
        # the row at -1e9 has p = 1 on every key (the plain version's lse), so its ds is about Sk times
        # any other row's and sets each key's dk and its own dq: a rounding of that bf16 ds that falls
        # the other way (its fp32 dlogits differ by the products' summation order, dbias shows how
        # little) and the output's rounding add, two rounding steps of 2**-7 each
        tol["dq"] = tol["dk"] = 2 * 2**-7
    assert errs["lse"] <= 1e-4 and all(errs[n] <= tol[n] for n in tol), errs


# every extras case, one row shared by every query row (dk/dv's one-row stage), D 128 uncollapsed, and
# collapsed at D 32, 64 and 128 (Sqb = Sq and Sqb = 1), the MSA column mask and the chunked one
REPEAT_CASES = [c for c in BIAS_CASES if len(c) > 8] + [BIAS_CASES[i] for i in (1, 8, 0, 2, 3, 10, 17, 18)]


@pytest.mark.parametrize("case", REPEAT_CASES, ids=[_bias_id(c) for c in REPEAT_CASES])
def test_flash_bias_backward_repeats_bit_for_bit(cuda, case):
    """Two launches of the bf16 dq writing dbias (or the collapsed dq) and of dk/dv with a bias give
    bit-equal dq, dbias, dk and dv: no atomics, a fixed order everywhere."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H = case[0], case[3]
    q, k, v, do, bias, meta, args = _bias_case(cuda, torch.bfloat16, case)
    o, lse = fa.flash_fwd_ref(q, k, v, *args, bias, meta)
    bwd = (q, k, v, do, lse, fa.flash_delta(o, do), *args, bias, meta)

    def once():
        if fa.bias_is_collapsed(meta, B, H):
            dq, dbias = fa.flash_bwd_dq_collapsed(*bwd)
        else:
            dbias = torch.empty_like(bias)
            dq = fa.flash_bwd_dq(*bwd, dbias)
        return (dq, dbias, *fa.flash_bwd_dkv(*bwd))

    first, second = once(), once()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.isfinite(t).all() for t in first)


def test_bf16_bias_that_nothing_collapses_takes_dq_and_dkv(cuda):
    """Through the autograd function, a bf16 bias that nothing collapses launches flash_bwd_dq (writing
    dbias) and flash_bwd_dkv, and not the collapsed dq. The output and the gradients match the same
    function on the CPU (the plain versions) within chip_smoke.py's evoformer path tolerance (0.08 on the
    per-row relative error: the forward's bf16 o and delta differ too)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do, bias, _ = _bias_inputs(cuda, torch.bfloat16, 4, 96, 96, 4, 32, (4, 4, 96, 96), 1)
    counters = (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dq_collapsed)
    grads = []
    for dev in ("cuda", "cpu"):
        counts = [fn.launches for fn in counters]
        leaves = [t.detach().to(dev).requires_grad_(True) for t in (q, k, v, bias.reshape(4, 4, 96, 96))]
        out = fa.flash_attention(*leaves[:3], causal=False, bias=leaves[3])
        out.backward(do.to(dev))
        torch.cuda.synchronize()
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in leaves])
        launched = [fn.launches - n for fn, n in zip(counters, counts)]
        assert launched == ([1, 1, 0] if dev == "cuda" else [0, 0, 0])
    for got, want in zip(*grads):
        assert got.shape == want.shape and _err(got, want, want.float().abs().mean().item()) <= 0.08


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


# fused_adam_multi's ragged leaves: sizes 1, 3, 4 and 5 (a vector's tail alone and after a vector), 4097 and
# 65,537 (past a tile of 4,096 elements, and many tiles), an empty leaf, and tensors that start one element into
# their storage (not 16-byte aligned: the scalar path)
ADAM_LEAVES = [(1, 0), (3, 0), (4, 0), (5, 0), (4097, 0), (0, 0), (65537, 0), (4097, 1), (6, 1)]


def _adam_leaves(dev, leaves, seed=0):
    """[p, g, m, v] per (size, offset): views ``offset`` elements into their storage, v positive."""
    g = _gen(dev, seed)
    out = []
    for size, offset in leaves:
        leaf = [torch.randn(size + offset, generator=g, device=dev)[offset:] for _ in range(4)]
        leaf[3].abs_()
        out.append(leaf)
    return out


def _adam_multi(leaves, scal, fn=None):
    from deepspeed_tpu_torch.ops import fused_adam as fad

    (fn or fad.fused_adam_multi)(*[[leaf[i] for leaf in leaves] for i in range(4)], scal, weight_decay=0.01)


@pytest.mark.parametrize("finite", [True, False])
def test_fused_adam_multi_kernel(cuda, finite):
    """One launch over ragged, empty and unaligned leaves against the plain
    version, within 1e-6 of each updated tensor's largest value; with the
    finite flag at 0 every leaf stays as it was, bit for bit."""
    from deepspeed_tpu_torch.ops import fused_adam as fad

    leaves = _adam_leaves(cuda, ADAM_LEAVES)
    assert leaves[-1][0].data_ptr() % 16 and leaves[-2][1].data_ptr() % 16
    scal = fad.adam_scalars(1e-3, 3, 0.9, 0.999, grad_mult=0.5, finite=finite, device=cuda)
    before = [[t.clone() for t in leaf] for leaf in leaves]
    ref = [[t.clone() for t in leaf] for leaf in leaves]
    n0 = fad.fused_adam.launches
    _adam_multi(leaves, scal)
    _adam_multi(ref, scal, fad.fused_adam_multi_ref)
    torch.cuda.synchronize()
    assert fad.fused_adam.launches == n0 + 1
    for got, want, was in zip(leaves, ref, before):
        for i in (0, 2, 3):  # p, m, v
            if not finite:
                assert torch.equal(got[i], was[i])
            elif want[i].numel():
                assert ((got[i] - want[i]).abs().max() / want[i].abs().max()).item() <= 1e-6


def test_fused_adam_multi_overflows_the_table(cuda):
    """More leaves than one launch's table takes: ceil(n / TABLE_LEAVES) launches, each leaf as the plain version."""
    from deepspeed_tpu_torch.ops import fused_adam as fad

    n = 2 * fad.TABLE_LEAVES + 5
    leaves = _adam_leaves(cuda, [(1 + (7 * i) % 61 + (4096 if i % 97 == 0 else 0), int(i % 3 == 1)) for i in range(n)])
    scal = fad.adam_scalars(1e-3, 2, 0.9, 0.999, grad_mult=0.5, device=cuda)
    ref = [[t.clone() for t in leaf] for leaf in leaves]
    n0 = fad.fused_adam.launches
    _adam_multi(leaves, scal)
    _adam_multi(ref, scal, fad.fused_adam_multi_ref)
    torch.cuda.synchronize()
    assert fad.fused_adam.launches == n0 + 3
    for got, want in zip(leaves, ref):
        for i in (0, 2, 3):
            assert ((got[i] - want[i]).abs().max() / want[i].abs().max()).item() <= 1e-6


def test_fused_adam_multi_repeats_bit_for_bit(cuda):
    from deepspeed_tpu_torch.ops import fused_adam as fad

    scal = fad.adam_scalars(1e-3, 5, 0.9, 0.999, grad_mult=0.7, device=cuda)
    runs = []
    for _ in range(2):
        leaves = _adam_leaves(cuda, ADAM_LEAVES, seed=1)
        _adam_multi(leaves, scal)
        runs.append(leaves)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for la, lb in zip(*runs) for a, b in zip(la, lb))


def test_fused_adam_multi_in_a_cuda_graph_equals_the_eager_call(cuda):
    """The launch captured in a CUDA graph (its table is a kernel parameter,
    copied at capture) and replayed equals the eager call bit for bit."""
    from deepspeed_tpu_torch.ops import fused_adam as fad

    scal = fad.adam_scalars(1e-3, 5, 0.9, 0.999, grad_mult=0.7, device=cuda)
    eager = _adam_leaves(cuda, ADAM_LEAVES, seed=2)
    replayed = _adam_leaves(cuda, ADAM_LEAVES, seed=2)
    _adam_multi(eager, scal)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _adam_multi(replayed, scal)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for la, lb in zip(eager, replayed) for a, b in zip(la, lb))


def test_fused_adam_multi_raises_on_what_the_kernel_does_not_take(cuda):
    from deepspeed_tpu_torch.ops import fused_adam as fad

    scal = fad.adam_scalars(1e-3, 1, 0.9, 0.999, device=cuda)
    p, g, m, v = _adam_leaves(cuda, [(64, 0)])[0]
    bad = {"dtype": [p, g.bfloat16(), m, v], "contiguity": [p, torch.randn(8, 8, device=cuda).t(), m, v],
           "size": [p, g[:63], m, v], "device": [p, g, m.cpu(), v]}
    for leaf in bad.values():
        with pytest.raises(ValueError, match="fused_adam: leaf 1"):
            fad.fused_adam_multi([p, leaf[0]], [g, leaf[1]], [m, leaf[2]], [v, leaf[3]], scal)
    with pytest.raises(ValueError, match="scalars"):
        fad.fused_adam_multi([p], [g], [m], [v], scal.cpu())


def test_training_on_the_card_matches_the_cpu(cuda):
    """Three engine steps of a small gpt2 (head dim 64) in fp32 on the card
    (flash kernels, FusedAdam) give the CPU engine's losses (plain versions),
    every training kernel launched, and FusedAdam once a step."""
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
    assert fad.fused_adam.launches == before[3] + 3  # one launch a step over every leaf


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
    ("fixed_uni_b16", 1, 8192, 4, 64, True),
    ("fixed_bi_heads_b16", 1, 8192, 4, 64, False),
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
    qplan = ss._device_query_plan(cfg, S, H, causal, cuda)
    o, lse = ss.sparse_fwd(q, k, v, kidx, *args, plan=qplan)
    o_ref, lse_ref = ss.sparse_fwd_ref(q, k, v, kidx, *args)
    delta = ss.flash_delta(o_ref, do)
    bwd = (q, k, v, do, lse_ref, delta)
    dq = ss.sparse_bwd_dq(*bwd, kidx, *args, plan=qplan)
    dk, dv = ss.sparse_bwd_dkv(*bwd, qidx, *args, plan=ss._device_dkv_plan(cfg, S, H, causal, cuda))
    torch.cuda.synchronize()
    assert (ss.sparse_fwd.launches, ss.sparse_bwd_dq.launches, ss.sparse_bwd_dkv.launches) == tuple(
        c + 1 for c in counts)
    dq_ref = ss.sparse_bwd_dq_ref(*bwd, kidx, *args)
    dk_ref, dv_ref = ss.sparse_bwd_dkv_ref(*bwd, qidx, *args)
    errs = _sparse_errs(dtype, (("o", o, o_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)))
    errs["lse"] = (lse - lse_ref).abs().max().item()
    assert errs["lse"] <= 1e-4 and all(errs[n] <= TOL[dtype] for n in ("o", "dq", "dk", "dv")), errs


# grouped key blocks and split walks of the bf16 dk/dv: Fixed layouts at block 16 and S 8192 (walks of
# more than 256 entries split), and a block of 128 (half a key block a CUDA block)
DKV_REPEAT_CASES = [c for c in SPARSE_CASES if c[2] >= 8192] + [SPARSE_CASES[6]]


@pytest.mark.parametrize("case", DKV_REPEAT_CASES, ids=[f"{c[0]}-S{c[2]}-D{c[4]}" for c in DKV_REPEAT_CASES])
def test_sparse_dkv_repeats_bit_for_bit(cuda, case):
    """Two launches of the bf16 dk/dv (grouped key blocks, split walks summed in a fixed order) give
    bit-equal dk and dv; the plan splits at least one walk at these cases."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    name, B, S, H, D, causal = case
    cfg = _sparse_configs()[name](H)
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, B, S, S, H, H, D)
    kidx, qidx = ss._device_lists(cfg, S, H, causal, cuda)
    plan = ss._device_dkv_plan(cfg, S, H, causal, cuda)
    o, lse = ss.sparse_fwd_ref(q, k, v, kidx, cfg.block, D**-0.5, causal)
    bwd = (q, k, v, do, lse, ss.flash_delta(o, do), qidx, cfg.block, D**-0.5, causal)
    first, second = ss.sparse_bwd_dkv(*bwd, plan=plan), ss.sparse_bwd_dkv(*bwd, plan=plan)
    torch.cuda.synchronize()
    assert plan.n_slots > 0 or cfg.block == 128
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.isfinite(t).all() for t in first)


@pytest.mark.parametrize("case", SPARSE_CASES, ids=[f"{c[0]}-S{c[2]}-D{c[4]}" for c in SPARSE_CASES])
def test_sparse_fwd_and_dq_repeat_bit_for_bit(cuda, case):
    """Two launches of the bf16 forward and dq (no atomics, no split walks) give bit-equal o, lse and dq."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    name, B, S, H, D, causal = case
    cfg = _sparse_configs()[name](H)
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, B, S, S, H, H, D)
    kidx, _ = ss._device_lists(cfg, S, H, causal, cuda)
    plan = ss._device_query_plan(cfg, S, H, causal, cuda)
    args = (kidx, cfg.block, D**-0.5, causal)
    first, second = ss.sparse_fwd(q, k, v, *args, plan=plan), ss.sparse_fwd(q, k, v, *args, plan=plan)
    bwd = (q, k, v, do, first[1], ss.flash_delta(first[0], do))
    dq, dq_again = ss.sparse_bwd_dq(*bwd, *args, plan=plan), ss.sparse_bwd_dq(*bwd, *args, plan=plan)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first + (dq,), second + (dq_again,)))
    assert all(torch.isfinite(t).all() for t in (first[0], dq))


def test_sparse_bf16_fwd_and_dq_refuse_a_missing_or_foreign_plan(cuda):
    """bf16 forward and dq on the card walk the configuration's query plan: without one, with another
    length's, or with the dk/dv's plan, they raise before anything is launched."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    B, S, H, D = 1, 512, 4, 64
    cfg = _sparse_configs()["fixed_uni_b16"](H)
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, B, S, S, H, H, D)
    kidx, _ = ss._device_lists(cfg, S, H, True, cuda)
    o, lse = ss.sparse_fwd_ref(q, k, v, kidx, cfg.block, D**-0.5, True)
    bwd = (q, k, v, do, lse, ss.flash_delta(o, do), kidx, cfg.block, D**-0.5, True)
    launches = (ss.sparse_fwd.launches, ss.sparse_bwd_dq.launches)
    for call in (lambda **kw: ss.sparse_fwd(q, k, v, kidx, cfg.block, D**-0.5, True, **kw),
                 lambda **kw: ss.sparse_bwd_dq(*bwd, **kw)):
        with pytest.raises(ValueError, match="walks a plan"):
            call()
        for plan in (ss._device_query_plan(cfg, 2 * S, H, True, cuda), ss._device_dkv_plan(cfg, S, H, True, cuda)):
            with pytest.raises(ValueError, match="the plan is for"):
                call(plan=plan)
    assert (ss.sparse_fwd.launches, ss.sparse_bwd_dq.launches) == launches


def test_sparse_bf16_dkv_refuses_a_missing_or_foreign_plan(cuda):
    """bf16 dk/dv on the card walks the configuration's plan: without one, or with another length's, it
    raises before anything is launched."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    B, S, H, D = 1, 512, 4, 64
    cfg = _sparse_configs()["fixed_uni_b16"](H)
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, B, S, S, H, H, D)
    kidx, qidx = ss._device_lists(cfg, S, H, True, cuda)
    o, lse = ss.sparse_fwd_ref(q, k, v, kidx, cfg.block, D**-0.5, True)
    bwd = (q, k, v, do, lse, ss.flash_delta(o, do), qidx, cfg.block, D**-0.5, True)
    launches = ss.sparse_bwd_dkv.launches
    with pytest.raises(ValueError, match="walks a plan"):
        ss.sparse_bwd_dkv(*bwd)
    with pytest.raises(ValueError, match="the plan is for"):
        ss.sparse_bwd_dkv(*bwd, plan=ss._device_dkv_plan(cfg, 2 * S, H, True, cuda))
    assert ss.sparse_bwd_dkv.launches == launches


def test_sparse_dense_layout_matches_the_flash_kernels(cuda):
    """A dense layout (block 64) through the sparse kernels gives the flash
    kernels' o, lse, dq, dk and dv (bf16 per row within 1e-2)."""
    from deepspeed_tpu_torch.ops import flash_attention as fa, sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss

    B, S, H, D = 2, 1024, 8, 64
    q, k, v, do = _flash_inputs(cuda, torch.bfloat16, B, S, S, H, H, D)
    dense = sa.DenseSparsityConfig(num_heads=H, block=64)
    kidx, qidx = ss._device_lists(dense, S, H, True, cuda)
    qplan = ss._device_query_plan(dense, S, H, True, cuda)
    o, lse = ss.sparse_fwd(q, k, v, kidx, 64, D**-0.5, True, plan=qplan)
    o_f, lse_f = fa.flash_fwd(q, k, v, None, D**-0.5, True, 0)
    bwd = (q, k, v, do, lse_f, fa.flash_delta(o_f, do))
    dq = ss.sparse_bwd_dq(*bwd, kidx, 64, D**-0.5, True, plan=qplan)
    dk, dv = ss.sparse_bwd_dkv(*bwd, qidx, 64, D**-0.5, True, plan=ss._device_dkv_plan(dense, S, H, True, cuda))
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


# ---------------------------------------------------------------- MoE: the grouped GEMM and MoE serving
# (name -> rows a group, K, N): R not a multiple of any tile, empty experts, every row on one expert, the
# mixtral_8x7b_8l serve's decode step at its bucket of 8 (16 rows) and its 2,048-token quantum (4,096 rows), a
# decode step's routing at Mixtral's widths (64 tokens x top-2 over 8 experts) for wi and wo, a prefill
# quantum's (768 tokens x top-2), K past the ring's depth, K not a multiple of the TMA box's 64 and N not of the
# 128-column tile (its last tile's second 64-column box wholly outside w), every row of a decode step on one
# expert for wo (the plan splits K), and shapes the bf16 body does not take (fp32 only)
GEMM_CASES = {
    "k_and_n_tails": ([5, 12, 0, 40], 200, 136),
    "mixtral_one_expert_wo": ([0, 0, 0, 0, 0, 128, 0, 0], 14336, 4096),
    "ragged": ([3, 0, 21, 5], 64, 96),
    "one_expert": ([0, 0, 77, 0], 128, 256),
    "last_expert": ([0, 0, 0, 40], 40, 24),
    "mixtral_serve_decode_wi": ([2, 3, 1, 2, 0, 4, 2, 2], 4096, 14336),
    "mixtral_serve_decode_wo": ([2, 3, 1, 2, 0, 4, 2, 2], 14336, 4096),
    "mixtral_serve_prefill_wo": ([520, 480, 505, 530, 498, 512, 540, 511], 14336, 4096),
    "mixtral_decode_wi": ([14, 19, 15, 17, 16, 13, 18, 16], 4096, 14336),
    "mixtral_decode_wo": ([14, 19, 15, 17, 16, 13, 18, 16], 14336, 4096),
    "mixtral_prefill_wi": ([201, 176, 188, 215, 190, 170, 205, 191], 4096, 14336),
    "mixtral_skewed_wo": ([0, 1, 120, 2, 0, 5, 0, 0], 14336, 4096),
}
GEMM_ODD = {"odd_k_n": ([7, 0, 30], 37, 53), "tiny": ([1], 8, 8)}


def _gemm_case(dev, dtype, sizes, K, N, seed=0):
    g = _gen(dev, seed + K + N)
    R, E = sum(sizes), len(sizes)
    x = torch.randn((R, K), generator=g, device=dev).to(dtype)
    w = (torch.randn((E, K, N), generator=g, device=dev) * K**-0.5).to(dtype)
    offsets = torch.tensor([0] + sizes, dtype=torch.int64).cumsum(0).to(torch.int32).to(dev)
    return x, w, offsets


def _gemm_err(got, want):
    """bf16: the per-row relative error; fp32: the max abs error over max(1, max |want|) (sums of up to
    14,336 products in another order than cuBLAS's)."""
    err = _err(got, want)
    return err / max(1.0, want.abs().max().item()) if got.dtype == torch.float32 else err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(GEMM_CASES) + list(GEMM_ODD))
def test_moe_grouped_gemm_kernel(cuda, dtype, case):
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    sizes, K, N = {**GEMM_CASES, **GEMM_ODD}[case]
    x, w, offsets = _gemm_case(cuda, dtype, sizes, K, N)
    if dtype == torch.bfloat16 and case in GEMM_ODD and (K % 8 or N % 8):
        with pytest.raises(NotImplementedError):
            mg.moe_grouped_gemm(x, w, offsets)
        return
    n0 = mg.moe_grouped_gemm.launches
    got = mg.moe_grouped_gemm(x, w, offsets)
    torch.cuda.synchronize()
    assert mg.moe_grouped_gemm.launches == n0 + 1 and got.dtype == dtype and got.shape == (sum(sizes), N)
    err = _gemm_err(got, mg.moe_grouped_gemm_ref(x, w, offsets))
    assert err <= TOL[dtype], err
    for _ in range(2):  # no atomics: a repeat is bit for bit
        assert torch.equal(mg.moe_grouped_gemm(x, w, offsets), got)


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_moe_grouped_gemm_every_plan(cuda, case):
    """Each bf16 tile body as the plan launches it (its split taken when the
    routing gives few tiles), and unsplit and with K cut into 2 and 3 slices
    and the plan's own split forced, through the entry point whatever
    ``gemm_plan`` picks, equals the plain version; a split repeats bit for
    bit and leaves the tile counters zero."""
    from deepspeed_tpu_torch.device import sm_count
    from deepspeed_tpu_torch.ops import _utils, moe_grouped_gemm as mg

    sizes, K, N = GEMM_CASES[case]
    x, w, offsets = _gemm_case(cuda, torch.bfloat16, sizes, K, N)
    R, E = x.shape[0], len(sizes)
    want = mg.moe_grouped_gemm_ref(x, w, offsets)
    for rows in mg.GEMM_TILE_ROWS:
        own = mg.gemm_plan(R, K, N, E, torch.bfloat16, sm_count(x.device), rows=rows)
        forced = [mg.gemm_plan(R, K, N, E, torch.bfloat16, sm_count(x.device), rows=rows, split=split)
                  for split in sorted({1, 2, 3, own.split})]
        for plan in [own] + forced:
            out = mg.moe_grouped_gemm(x, w, offsets, plan=plan)
            torch.cuda.synchronize()
            assert _gemm_err(out, want) <= TOL[torch.bfloat16], (rows, plan.split)
            if plan.split > 1:
                assert torch.equal(mg.moe_grouped_gemm(x, w, offsets, plan=plan), out), (rows, plan.split)
                assert not _utils.tile_counters(x.device, 1).any(), (rows, plan.split)


def test_moe_grouped_gemm_tiles_from_host_shapes_only(cuda):
    """Every routing of the same R, K, N, E runs the same launch: the offsets
    change on the device between calls inside one CUDA graph, and each replay
    equals the plain version on that routing. At N 4,096 the launch carries
    a split of K (every row on one expert gives 4 x 32 tiles), which the
    kernel takes for the two one-expert routings only (the others give 256
    tiles or more)."""
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    x, w, offsets = _gemm_case(cuda, torch.bfloat16, [16] * 8, 512, 4096)
    routings = [[16] * 8, [128, 0, 0, 0, 0, 0, 0, 0], [0] * 7 + [128], [1, 2, 3, 4, 5, 6, 7, 100], [0, 64, 0, 64] * 2]
    static = offsets.clone()
    mg.moe_grouped_gemm(x, w, static)  # warm-up: the build, the shared-memory attribute
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mg.moe_grouped_gemm(x, w, static)
    for sizes in routings:
        static.copy_(torch.tensor([0] + sizes).cumsum(0).to(torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert _err(out, mg.moe_grouped_gemm_ref(x, w, static)) <= TOL[torch.bfloat16], sizes


def test_moe_grouped_gemm_raises_on_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    x, w, offsets = _gemm_case(cuda, torch.bfloat16, [4, 4], 64, 64)
    with pytest.raises(ValueError):
        mg.moe_grouped_gemm(x, w.float(), offsets)
    with pytest.raises(ValueError):
        mg.moe_grouped_gemm(x, w, offsets.long())
    with pytest.raises(ValueError):
        mg.moe_grouped_gemm(x, w, offsets[:-1])
    with pytest.raises(ValueError):
        mg.moe_grouped_gemm(x, w.cpu(), offsets)
    with pytest.raises(ValueError):
        mg.moe_grouped_gemm(x[:, ::2], w[:, ::2], offsets)
    with pytest.raises(NotImplementedError):
        mg.moe_grouped_gemm(x.half(), w.half(), offsets)


def _moe_cfg(**kw):
    from deepspeed_tpu_torch.models import TransformerConfig

    fields = dict(vocab_size=512, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, d_ff=384, max_seq_len=512,
                  norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False, moe_num_experts=8,
                  moe_top_k=2, moe_layer_freq=1)
    return TransformerConfig(**{**fields, **kw})


def test_moe_serving_module_never_syncs(cuda):
    """The MoE serving module on CUDA tensors makes no host sync (the sync
    debug mode raises on one): routing, offsets, the three grouped products
    and the combine all stay on the device, in bf16 and fp32; the result
    equals the plain bundle's within the kernels' tolerance."""
    from deepspeed_tpu_torch.inference.v2.modules import moe_tpu
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    for dtype in (torch.float32, torch.bfloat16):
        cfg = _moe_cfg(dtype=dtype)
        p = init_params(cfg, _gen(cuda), device=cuda, dtype=dtype)["layer_0"]["moe"]
        x = torch.randn((4, 37, 256), generator=_gen(cuda), device=cuda).to(dtype)
        moe_tpu(cfg, p, x)  # the build and the kernels' attributes, before the check
        torch.cuda.synchronize()
        n0 = mg.moe_grouped_gemm.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = moe_tpu(cfg, p, x)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert mg.moe_grouped_gemm.launches == n0 + 3
        want = moe_tpu(cfg, p, x, gemm=mg.moe_grouped_gemm_ref)
        err = _gemm_err(got.reshape(-1, 256), want.reshape(-1, 256))
        assert err <= (1e-5 if dtype == torch.float32 else 2e-2), err


def test_moe_engine_on_the_card_matches_the_cpu(cuda):
    """An MoE model served on the card in fp32 (the grouped GEMM, paged and
    norm kernels, each step a graph replay) gives the CPU engine's greedy
    tokens, in the fused and the unfused loop, and the grouped GEMM launched."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    cfg = _moe_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [[3, 17, 42], list(range(40)), [100, 2] * 30, [9] * 11]

    def serve(device, fused=True):
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(kv_block_size=16, max_context=512, num_kv_blocks=64), dtype="float32",
            device=device, decode_burst=8, fused_step=fused))
        engine.scheduler.prefill_chunk = 32
        return engine.generate(prompts, max_new_tokens=12), engine

    cpu = serve("cpu")[0]
    for fused in (True, False):
        n0 = mg.moe_grouped_gemm.launches
        got, engine = serve("cuda", fused)
        assert got == cpu
        assert mg.moe_grouped_gemm.launches > n0 and engine.graphs.replays == engine.dispatches > 0


@pytest.mark.parametrize("fused", [True, False])
def test_moe_graph_steps_equal_eager_steps(cuda, fused):
    """bf16 MoE serving with each step replayed from its captured graph gives
    the eager steps' tokens and KV pools bit for bit (the garbage page
    excluded), and the kernels' counters move alike; the capture needs no
    sync, so no step runs eagerly on the graph engine."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import init_params
    from deepspeed_tpu_torch.ops import moe_grouped_gemm as mg

    cfg = _moe_cfg(moe_layer_freq=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    engines = []
    for eager in (False, True):
        engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(kv_block_size=16, max_context=512, num_kv_blocks=64), dtype="bfloat16",
            device="cuda", decode_burst=8, fused_step=fused))
        engine.scheduler.prefill_chunk = 32
        engine._eager_steps = eager
        engines.append(engine)
    counters = (norms.rms_norm, mg.moe_grouped_gemm, pa.paged_attention_decode, pa.paged_attention_prefill)
    (g_toks, g_launches), (e_toks, e_launches) = _serve_both(engines, counters)
    graphs, eager = engines
    assert g_toks == e_toks
    for g, e in ((graphs.k_pages, eager.k_pages), (graphs.v_pages, eager.v_pages)):
        assert torch.equal(g[:, 1:], e[:, 1:])
    assert g_launches == e_launches and all(n > 0 for n in g_launches)
    assert graphs.graphs.replays == graphs.dispatches == eager.dispatches > 0 and graphs.graphs.captures > 0
