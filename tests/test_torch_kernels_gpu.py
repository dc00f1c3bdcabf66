"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker ``gpu``) and skips without one.
The file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

Tolerances: 1e-5 on the max abs error in float32 (same fp32 math, other
summation order); 1e-2 on the per-row relative error in bfloat16, that is
max |got - want| / max |want| over each row's last dim (both sides compute
in fp32 from the same bf16 inputs and round the output to bf16, where one
rounding step is at most 2**-7 = 7.8e-3 of a value).
"""

import pytest
import torch

from deepspeed_tpu_torch.ops import norms, paged_attention as pa

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _err(got, want):
    """fp32: max abs error; bf16: max per-row relative error (rows = last dim)."""
    diff = (got.float() - want.float()).flatten(0, -2).abs().amax(-1)
    if got.dtype == torch.float32:
        return diff.max().item()
    return (diff / want.float().flatten(0, -2).abs().amax(-1).clamp_min(1e-30)).max().item()


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
