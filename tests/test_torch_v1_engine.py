"""Port parity: the v1 ``InferenceEngine`` (``init_inference``) against the JAX engine.

The JAX package initialises ``gpt2_tiny`` (LayerNorm, learned positions, tied
head) and ``llama_tiny`` (RMSNorm, rope, GQA, untied head); the port takes
the same weights through ``params_from_numpy``. Both engines run on the CPU
in fp32 (the port's kernels through their plain versions). Held to the
reference, with the scenarios of ``tests/unit/test_inference.py``:
- greedy tokens equal, with quantisation off and on at int8 and int4 (each
  side quantises its own tree; the codes are equal bit for bit);
- ``forward`` logits within 1e-5 of the reference's, relative to the largest;
- the KV-cache generate equals the no-cache oracle;
- a batch with an EOS: the same tokens, finished rows keep emitting EOS;
  ``fused=False`` stops once every row is done, as the reference's loop;
- seeded sampling repeats itself; top-p keeps the smallest prefix reaching
  p; top-p 0 is greedy; the sliding window masks as a banded softmax;
- ``init_kv_caches`` has the reference's shapes; tp_size 2, a checkpoint
  path, a Hugging Face model and a prompt past ``max_out_tokens`` raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference import generation as jgen
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.models import llama_tiny as jax_llama_tiny
from deepspeed_tpu_torch.inference.generation import sample_logits
from deepspeed_tpu_torch.inference.quantization import QuantizedParam
from deepspeed_tpu_torch.models import CausalLM, gpt2_tiny, llama_tiny, params_from_numpy
from deepspeed_tpu_torch.ops.attention import attention_xla

PRESETS = {"gpt2_tiny": (jax_gpt2_tiny, gpt2_tiny), "llama_tiny": (jax_llama_tiny, llama_tiny)}
PROMPTS = np.array([[5, 17, 3, 99, 4, 23, 7, 1], [7, 2, 8, 11, 40, 41, 42, 3]], np.int32)
_BUILT = {}


def _models(name):
    if name not in _BUILT:
        jax_preset, preset = PRESETS[name]
        jmodel = JaxCausalLM(jax_preset(dtype=jnp.float32))
        jparams = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), {"input_ids": PROMPTS}))
        cfg = preset(dtype=torch.float32)
        _BUILT[name] = jmodel, jparams, CausalLM(cfg), params_from_numpy(jparams, "cpu", cfg=cfg)
    return _BUILT[name]


def _config(bits=0, max_out=64):
    c = {"dtype": "float32", "max_out_tokens": max_out}
    if bits:
        c["quant"] = {"enabled": True, "bits": bits, "group_size": 64}
    return c


def _engines(name, bits=0):
    jmodel, jparams, model, params = _models(name)
    jeng = deepspeed_tpu.init_inference(jmodel, _config(bits), params=jparams)
    teng = deepspeed_tpu_torch.init_inference(model, {**_config(bits), "device": "cpu"}, params=params)
    return jeng, teng


@pytest.mark.parametrize("name", ["gpt2_tiny", "llama_tiny"])
@pytest.mark.parametrize("bits", [0, 8, 4])
def test_greedy_tokens_and_logits_equal_the_jax_engine(name, bits):
    jeng, teng = _engines(name, bits)
    if bits:
        assert teng.quant_stats["quantized"] > 0
        leaves = [x for layer in teng.params.values() if isinstance(layer, dict) for x in layer.values()]
        assert isinstance(teng.params["wte"], QuantizedParam) and teng.params["wte"].layout == "flat" and leaves
    want = np.asarray(jeng.generate(PROMPTS, max_new_tokens=10))
    got = teng.generate(PROMPTS, max_new_tokens=10)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    jl = np.asarray(jeng.forward(PROMPTS))
    tl = teng.forward(PROMPTS).numpy()
    assert np.abs(tl - jl).max() <= 1e-5 * np.abs(jl).max()


@pytest.mark.parametrize("name", ["gpt2_tiny", "llama_tiny"])
def test_generate_matches_the_no_cache_oracle(name):
    _, _, model, params = _models(name)
    teng = deepspeed_tpu_torch.init_inference(model, {**_config(), "device": "cpu"}, params=params)
    got = teng.generate(PROMPTS[:1], max_new_tokens=8)
    ids = torch.from_numpy(PROMPTS[:1]).long()
    with torch.no_grad():
        for _ in range(8):
            nxt = torch.argmax(model.apply(params, ids)[:, -1, :], dim=-1)[:, None]
            ids = torch.cat([ids, nxt], dim=1)
    np.testing.assert_array_equal(got.numpy(), ids.numpy())


def test_batch_with_eos_equals_the_jax_loops():
    jeng, teng = _engines("llama_tiny")
    free = np.asarray(jeng.generate(PROMPTS, max_new_tokens=6))
    eos = int(free[0, PROMPTS.shape[1] + 1])  # row 0 emits it at its second new token
    want = np.asarray(jeng.generate(PROMPTS, max_new_tokens=6, eos_token_id=eos))
    got = teng.generate(PROMPTS, max_new_tokens=6, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, PROMPTS.shape[1] + 1:] == eos).all()  # a finished row keeps emitting eos
    # the unfused loop: both rows the same prompt, so both finish and the loop stops early
    both = np.repeat(PROMPTS[:1], 2, axis=0)
    prefill, decode = jgen.build_step_fns(jeng.module)
    want = np.asarray(jgen.generate_tokens(jeng.module, jeng.params, prefill, decode, both, max_new_tokens=6,
                                           cache_len=64, cache_dtype=jnp.float32, eos_token_id=eos, fused=False))
    got = teng.generate(both, max_new_tokens=6, eos_token_id=eos, fused=False).numpy()
    assert got.shape == want.shape == (2, PROMPTS.shape[1] + 2)
    np.testing.assert_array_equal(got, want)


def test_sampling_is_seeded():
    _, teng = _engines("llama_tiny")
    kw = dict(max_new_tokens=5, do_sample=True, temperature=1.5)
    a = teng.generate(PROMPTS[:1, :3], seed=3, **kw)
    b = teng.generate(PROMPTS[:1, :3], seed=3, **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ((a >= 0) & (a < 1024)).all()
    draws = {tuple(teng.generate(PROMPTS[:1, :3], seed=s, **kw)[0, 3:].tolist()) for s in range(6)}
    assert len(draws) > 1  # the seed reaches the draws


def test_top_p_keeps_the_smallest_prefix_reaching_p():
    logits = torch.log(torch.tensor([[0.6, 0.3, 0.08, 0.02]]))
    seen = {int(sample_logits(logits, torch.Generator().manual_seed(i), True, 1.0, 0, top_p=0.7)[0])
            for i in range(64)}
    assert seen <= {0, 1} and 0 in seen
    seen_all = {int(sample_logits(logits, torch.Generator().manual_seed(i), True, 1.0, 0, top_p=1.0)[0])
                for i in range(256)}
    assert 2 in seen_all or 3 in seen_all


def test_top_p_zero_is_greedy():
    logits = torch.log(torch.tensor([[0.1, 0.2, 0.6, 0.1]]))
    for i in range(8):
        assert int(sample_logits(logits, torch.Generator().manual_seed(i), True, 1.0, 0, top_p=0.0)[0]) == 2


def test_windowed_attention_oracle():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 8, 2, 4).astype(np.float32) for _ in range(3))
    out = attention_xla(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=True, window=3)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / 2.0
    qi, ki = np.mgrid[0:8, 0:8]
    s = np.where(((ki <= qi) & (ki > qi - 3))[None, None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    np.testing.assert_allclose(out.numpy(), np.einsum("bhqk,bkhd->bqhd", p, v), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["gpt2_tiny", "llama_tiny"])
def test_init_kv_caches_has_the_reference_shapes(name):
    jmodel, _, model, _ = _models(name)
    want = jmodel.init_kv_caches(3, 32)
    got = model.init_kv_caches(3, 32, device="cpu")
    assert len(got) == len(want)
    for (ck, cv, n), (jk, jv, jn) in zip(got, want):
        assert ck.shape == cv.shape == tuple(jk.shape) == tuple(jv.shape) and n == int(jn) == 0
        assert ck.dtype == torch.float32 and not ck.any()
    assert model.init_kv_caches(1, 8, dtype=torch.bfloat16, device="cpu")[0][0].dtype == torch.bfloat16


class _HFLike:
    class config:  # noqa: N801
        @staticmethod
        def to_dict():
            return {}

    def state_dict(self):
        return {}


@pytest.mark.parametrize("model,config,error", [
    ("llama", {"tensor_parallel": {"tp_size": 2}}, NotImplementedError),
    ("llama", {"tp": {"tp_size": 2}}, NotImplementedError),
    ("/no/such/checkpoint", {}, NotImplementedError),
    (_HFLike(), {}, NotImplementedError),
])
def test_unported_options_raise(model, config, error):
    _, _, tmodel, params = _models("llama_tiny")
    with pytest.raises(error):
        deepspeed_tpu_torch.init_inference(tmodel if model == "llama" else model,
                                           {**_config(), "device": "cpu", **config}, params=params)


def test_a_prompt_past_max_out_tokens_raises():
    _, _, model, params = _models("llama_tiny")
    teng = deepspeed_tpu_torch.init_inference(model, {**_config(max_out=12), "device": "cpu"}, params=params)
    with pytest.raises(ValueError, match="exceeds max_out_tokens"):
        teng.generate(PROMPTS, max_new_tokens=5)
    assert teng.generate(PROMPTS, max_new_tokens=4).shape == (2, 12)


def test_config_fields_and_aliases():
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig

    c = DeepSpeedInferenceConfig.from_dict({"max_tokens": 77, "min_tokens": 2, "kernel_inject": True,
                                            "quant": True, "dtype": "fp16"})
    assert (c.max_out_tokens, c.min_out_tokens, c.replace_with_kernel_inject, c.quant.enabled) == (77, 2, True, True)
    assert c.torch_dtype() == torch.float16 and c.tensor_parallel.tp_size == 1 and c.device == "cuda"
    with pytest.raises(ValueError):
        DeepSpeedInferenceConfig.from_dict({"max_out_tokens": 0})


def test_the_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    _, _, model, params = _models("llama_tiny")
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.init_inference(model, _config(), params=params)
