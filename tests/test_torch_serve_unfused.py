"""Port parity: ``put`` and the unfused serving loop against the JAX engine.

The JAX package initialises the tiny GQA llama of
``tests/unit/test_serve_fused.py``; the port takes the same weights through
``params_from_numpy`` and serves on the CPU in fp32 (every kernel wrapper runs
its plain version). Both engines are built with ``fused_step=False``. Held to
the reference:
- ``put``: logits at atol = rtol = 1e-5 over a prefill step (two chunk
  buckets), a decode step and a mixed step, and ``return_tokens`` ids equal;
- the unfused loop: greedy tokens equal JAX's and the port's own fused loop's,
  with the prefix cache on and off, an EOS cut, chunked prefill, bursts and
  the streaming callback; ``top_k=1`` sampling equal to greedy;
- the KV pool drains after ``generate``; a duplicate uid in ``put`` raises.
"""

import jax
import numpy as np
import pytest

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
from deepspeed_tpu_torch.models import TransformerConfig, params_from_numpy

PUT_TOL = 1e-5
TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=256, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
PROMPTS = [[3, 17, 42], [7, 7, 7, 7, 7], [100, 2], [55, 44, 33, 22, 11, 1, 0], [9] * 11, [1, 2, 3, 4]]
SHARED = list(range(20, 36))  # two full blocks of 8: a prefix the radix cache can reuse


@pytest.fixture(scope="module")
def tiny():
    model = CausalLM(JaxConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def engines(burst=8, prefix_cache=None, chunk=None, fused=False):
        smc = dict(kv_block_size=8, max_context=256, num_kv_blocks=128)
        je = JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(**smc), dtype="float32",
                                                      fused_step=fused, decode_burst=burst,
                                                      enable_prefix_cache=prefix_cache))
        te = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(**smc), dtype="float32", device="cpu", decode_burst=burst,
            enable_prefix_cache=prefix_cache, fused_step=fused))
        if chunk is not None:
            je.scheduler.prefill_chunk = te.scheduler.prefill_chunk = chunk
        return je, te

    return engines


def test_put_logits_and_tokens_match(tiny):
    je, te = tiny()
    steps = [
        ([0, 1, 2], [PROMPTS[0], PROMPTS[4] + PROMPTS[3], PROMPTS[1]]),  # chunk buckets 16 and 32
        ([0, 1, 2], [[5], [6], [7]]),  # one decode step
        ([1, 3, 0], [[8], PROMPTS[5], [9]]),  # decode rows beside a new prefill
    ]
    for uids, toks in steps:
        np.testing.assert_allclose(te.put(uids, toks), je.put(uids, toks), rtol=PUT_TOL, atol=PUT_TOL)
    uids, toks = [0, 1, 2, 3], [[11], [12], [13], [14]]
    assert te.put(uids, toks, return_tokens=True).tolist() == np.asarray(je.put(uids, toks, return_tokens=True)).tolist()
    te.flush([0, 1, 2, 3])
    assert te.state.free_blocks + te.state.prefix_cache.cached_blocks == te.state.total_blocks - 1


def test_put_refuses_a_duplicate_uid(tiny):
    _, te = tiny()
    with pytest.raises(ValueError, match="duplicate uid"):
        te.put([4, 4], [[1, 2, 3], [4, 5]])
    with pytest.raises(ValueError, match="align"):
        te.put([4], [[1], [2]])


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_unfused_greedy_tokens_match(tiny, prefix_cache):
    je, te = tiny(prefix_cache=prefix_cache)
    _, tf = tiny(prefix_cache=prefix_cache, fused=True)
    out = te.generate(PROMPTS, max_new_tokens=9)
    assert out == je.generate(PROMPTS, max_new_tokens=9) == tf.generate(PROMPTS, max_new_tokens=9)
    # a second wave: with the cache on, admitted on cached blocks (copy-on-write)
    wave = [p * 4 for p in PROMPTS[:3]] + [SHARED, SHARED + [3]]
    assert te.generate(wave, max_new_tokens=5) == je.generate(wave, max_new_tokens=5)
    if prefix_cache:
        assert te.state.prefix_cache.cached_blocks > 0
    free = te.state.free_blocks + (te.state.prefix_cache.cached_blocks if prefix_cache else 0)
    assert free == te.state.total_blocks - 1  # every block back, but the garbage page


def test_unfused_eos_cut_matches(tiny):
    je, te = tiny()
    greedy = te.generate(PROMPTS, max_new_tokens=9)
    eos = greedy[0][3]
    free0 = te.state.free_blocks
    out = te.generate(PROMPTS, max_new_tokens=9, eos_token_id=eos)
    assert out == je.generate(PROMPTS, max_new_tokens=9, eos_token_id=eos)
    assert any(eos in o and len(o) < 9 for o in out)
    assert te.state.free_blocks == free0


def test_unfused_chunked_prefill_matches(tiny):
    je, te = tiny(chunk=4)
    _, tf = tiny(chunk=4, fused=True)
    out = te.generate(PROMPTS, max_new_tokens=5)
    assert out == je.generate(PROMPTS, max_new_tokens=5) == tf.generate(PROMPTS, max_new_tokens=5)


@pytest.mark.parametrize("burst", [0, 16])
def test_unfused_bursts_match(tiny, burst):
    je, te = tiny(burst=burst)
    n0 = te.dispatches
    out = te.generate(PROMPTS[:3], max_new_tokens=17)
    assert out == je.generate(PROMPTS[:3], max_new_tokens=17)
    # 17 tokens: one prefill step, then 16 decode steps, or one burst of 16
    assert te.dispatches - n0 == (2 if burst else 17)


def test_unfused_streaming_and_sampling(tiny):
    je, te = tiny()
    streams = {}
    out = te.generate(PROMPTS[:3], max_new_tokens=7, on_token=lambda u, t: streams.setdefault(u, []).append(t))
    assert [streams[i] for i in range(3)] == out == je.generate(PROMPTS[:3], max_new_tokens=7)
    assert out == te.generate(PROMPTS[:3], max_new_tokens=7)  # deferred mode, same tokens
    # top_k=1 draws the argmax whatever the generator gives
    assert te.generate(PROMPTS, max_new_tokens=6, do_sample=True, top_k=1, seed=3) == \
        je.generate(PROMPTS, max_new_tokens=6)
