"""Port parity: serving Hugging Face checkpoints, and the paged plain versions
at the head dims and groups those families bring.

- v1: ``init_inference(<checkpoint directory>)`` and
  ``init_inference(model=<live transformers model>)`` (fp32, on the CPU)
  for opt, gpt_neox, phi, bloom and gemma: greedy tokens equal the JAX
  ``init_inference``'s on the same directory and the Hugging Face
  ``generate``'s (``test_new_arch_decode_matches_oracle``), logits within
  1e-5 of JAX's relative to max |logit|; the live model's logits equal the
  directory's bit for bit.
- v2: ``InferenceEngineV2(model, params)`` on the loaded tree, as the JAX
  tests build it (``test_hf_interop_archs.py:138``, ``:260``): a prefill
  ``put`` and one decode ``put`` within the JAX test's 3e-4 of the Hugging
  Face logits and 1e-5 of the JAX engine's, and ``generate``'s greedy tokens
  on a ragged trace equal to the JAX engine's. The Mixtral and Qwen3 / OLMo
  cases of the JAX tests are served the same way.
- BERT through the v1 engine's ``forward`` (the encoder: no cache).
- The paged decode and prefill plain versions at D 80, 96 and 256 and
  groups of 16 and 71 query heads on one KV head, against the JAX paged
  functions (Pallas in interpret mode) on the same pools, within 1e-5.
"""

import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)

transformers = pytest.importorskip("transformers")

import jax.numpy as jnp  # noqa: E402

import deepspeed_tpu  # noqa: E402
import torch_hf_models as hm  # noqa: E402
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine  # noqa: E402
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig  # noqa: E402
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig  # noqa: E402
from deepspeed_tpu.models.transformer import alibi_slopes  # noqa: E402
from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load  # noqa: E402
from deepspeed_tpu.ops.pallas import paged_attention as jpa  # noqa: E402
from deepspeed_tpu_torch import init_inference  # noqa: E402
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedBatchConfig,  # noqa: E402
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.module_inject import load_hf_checkpoint  # noqa: E402
from deepspeed_tpu_torch.ops import paged_attention as tpa  # noqa: E402

JAX_TOL = 1e-5
HF_TOL = dict(rtol=3e-4, atol=3e-4)
SERVE_ARCHS = ["opt", "gpt_neox", "phi", "bloom", "gemma"]
TRACE = [[3, 17, 42, 9, 88, 101, 7], [5, 5, 5], [120, 1, 64, 33, 2, 90, 11, 12, 13, 14, 15], [77]]


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def _smc(**kw):
    return dict(kv_block_size=8, max_context=64, num_kv_blocks=32, **kw)


def _engines(d):
    jm, jp = jax_load(d)
    je = JaxEngine(jm, jp, JaxEngineConfig(state_manager=JaxBatchConfig(**_smc()), dtype="float32"))
    pm, pp = load_hf_checkpoint(d, device="cpu")
    te = InferenceEngineV2(pm, pp, RaggedInferenceEngineConfig(state_manager=RaggedBatchConfig(**_smc()),
                                                               dtype="float32", device="cpu"))
    return je, te


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_v1_serves_a_checkpoint_and_a_live_model(tmp_path, arch):
    tm = hm.build(arch, seed=10)
    d = hm.save(tm, tmp_path)
    ids = hm.IDS
    jeng = deepspeed_tpu.init_inference(d, config={"dtype": "fp32"})
    teng = init_inference(d, config={"dtype": "fp32", "device": "cpu"})
    live = init_inference(tm, config={"dtype": "fp32", "device": "cpu"})
    got = teng.forward(ids).numpy()
    assert _rel(got, np.asarray(jeng.forward(ids))) <= JAX_TOL
    assert np.array_equal(live.forward(ids).numpy(), got)
    want = np.asarray(jeng.generate(ids, max_new_tokens=4))
    with torch.no_grad():
        hf = tm.generate(torch.from_numpy(ids.astype(np.int64)), max_new_tokens=4, do_sample=False).numpy()
    for eng in (teng, live):
        out = eng.generate(ids, max_new_tokens=4).numpy()
        assert np.array_equal(out, want) and np.array_equal(out, hf)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_v2_serves_a_loaded_tree(tmp_path, arch):
    tm = hm.build(arch, seed=20)
    je, te = _engines(hm.save(tm, tmp_path))
    ids = TRACE[0]
    logits = np.asarray(te.put([0], [ids])[0])
    assert _rel(logits, np.asarray(je.put([0], [ids])[0])) <= JAX_TOL
    np.testing.assert_allclose(logits, hm.hf_logits(tm, [ids])[0, -1], **HF_TOL)
    tok = int(np.argmax(logits))
    logits2 = np.asarray(te.put([0], [[tok]])[0])  # one decode step
    assert _rel(logits2, np.asarray(je.put([0], [[tok]])[0])) <= JAX_TOL
    np.testing.assert_allclose(logits2, hm.hf_logits(tm, [ids + [tok]])[0, -1], **HF_TOL)
    te.flush([0])
    je.flush([0])
    assert te.generate(TRACE, max_new_tokens=6) == je.generate(TRACE, max_new_tokens=6)


@pytest.mark.parametrize("arch,seed", [("mixtral", 11), ("qwen3", 100), ("olmo", 90)])
def test_v2_serves_moe_qk_norm_and_parameter_free_norms(tmp_path, arch, seed):
    """test_mixtral_moe_interop, test_qwen3_logits_match and test_olmo_logits_match's v2 halves."""
    tm = hm.build(arch, seed=seed)
    je, te = _engines(hm.save(tm, tmp_path))
    ids = [3, 17, 42, 9, 88]
    logits = np.asarray(te.put([0], [ids])[0])
    assert _rel(logits, np.asarray(je.put([0], [ids])[0])) <= JAX_TOL
    np.testing.assert_allclose(logits, hm.hf_logits(tm, [ids])[0, -1], **HF_TOL)
    te.flush([0])
    je.flush([0])
    assert te.generate(TRACE, max_new_tokens=5) == je.generate(TRACE, max_new_tokens=5)


@pytest.mark.parametrize("arch", ["bert", "distilbert"])
def test_v1_forward_of_an_encoder(tmp_path, arch):
    tm = hm.build(arch, seed=13)
    d = hm.save(tm, tmp_path)
    got = init_inference(d, config={"dtype": "fp32", "device": "cpu"}).forward(hm.IDS).numpy()
    assert _rel(got, np.asarray(deepspeed_tpu.init_inference(d, config={"dtype": "fp32"}).forward(hm.IDS))) <= JAX_TOL
    np.testing.assert_allclose(got, hm.hf_logits(tm, hm.IDS), **HF_TOL)


def test_init_inference_maps_dtype_strings_as_jax(tmp_path):
    """bf16 unless the config says otherwise; fp16 and half load in float16; the rest fp32."""
    d = hm.save(hm.build("gpt2"), tmp_path)
    for dtype, want in ((None, torch.bfloat16), ("bf16", torch.bfloat16), ("fp16", torch.float16),
                        ("fp32", torch.float32), ("float32", torch.float32)):
        config = {"device": "cpu", **({"dtype": dtype} if dtype else {})}
        eng = init_inference(d, config=config)
        assert eng.module.cfg.dtype == want and eng.params["wte"].dtype == eng.dtype


# ---------------------------------------------------------------- paged plain versions at the new shapes
PAGED_SHAPES = {"d80": (4, 2, 80), "d96": (4, 2, 96), "d256": (2, 1, 256), "g16": (16, 1, 16), "g71": (71, 1, 16)}


def _paged_case(H, KVH, D, ctx, seed, S=1, bs=8, P=6):
    rng = np.random.default_rng(seed)
    B = len(ctx)
    n_blocks = B * P + 1
    kp = rng.standard_normal((n_blocks, bs, KVH, D)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, KVH, D)).astype(np.float32)
    bt = (1 + rng.permutation(n_blocks - 1)[:B * P]).reshape(B, P).astype(np.int32)
    q = rng.standard_normal((B, S, H, D) if S > 1 else (B, H, D)).astype(np.float32)
    return q, kp, vp, bt, np.asarray(ctx, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape", list(PAGED_SHAPES))
@pytest.mark.parametrize("feature", [None, "both"])
def test_paged_plain_versions_at_new_head_dims_and_groups(shape, feature):
    H, KVH, D = PAGED_SHAPES[shape]
    sl = alibi_slopes(H) if feature else None
    win = 9 if feature else None
    q, kp, vp, bt, ctx = _paged_case(H, KVH, D, [1, 8, 9, 23, 48, 0], seed=H + D)
    want = np.asarray(jpa.paged_attention_decode(*map(jnp.asarray, (q, kp, vp, bt, ctx)), interpret=True,
                                                 alibi_slopes=sl, window=win))
    got = tpa.paged_attention_decode(*_t(q, kp, vp, bt, ctx), alibi_slopes=sl, window=win).numpy()
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
    S = 7
    q0 = np.array([0, 20, 40], np.int32)
    q, kp, vp, bt, ctx = _paged_case(H, KVH, D, (q0 + S).tolist(), seed=H + D + 1, S=S)
    pos = q0[:, None] + np.arange(S, dtype=np.int32)[None]
    want = np.asarray(jpa.paged_attention_prefill(*map(jnp.asarray, (q, kp, vp, bt, ctx, pos)), interpret=True,
                                                  alibi_slopes=sl, window=win))
    got = tpa.paged_attention_prefill(*_t(q, kp, vp, bt, ctx, pos), alibi_slopes=sl, window=win).numpy()
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
