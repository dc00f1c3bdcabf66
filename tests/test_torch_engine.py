"""Port parity: the fused SplitFuse serving path against the JAX engine.

The JAX package initialises a tiny GQA llama (the config of
``tests/unit/test_serve_fused.py``); the port takes the same weights through
``params_from_numpy`` and serves on the CPU in fp32, where every kernel
wrapper runs its plain version. Held to the reference:
- ``fused_forward``: per-row logits at 1e-4 and the KV pools (block 0, the
  garbage page, excluded) at 1e-4, over a prefill quantum and a mixed one;
- the scheduler: the same quantum compositions for one arrival trace;
- the engine: greedy tokens equal, with the prefix cache on and off, with an
  EOS cut, with streaming, with chunked mixed quanta, and ``top_k=1``
  sampling equal to greedy; ``DS_TPU_SERVE_FUSED=0`` serves the same tokens
  through the unfused loop (``tests/test_torch_serve_unfused.py`` holds that
  loop to the JAX engine);
- ALiBi and sliding-window serving: greedy tokens of a tiny bloom-shaped
  config (ALiBi, LayerNorm, an embedding norm) and of a tiny config with a
  window of 4 on layer 1 equal the JAX engine's, in both loops, with
  speculative decoding off and on;
- MoE serving: a tiny Mixtral-shaped config (4 experts, top-2, every block
  or every second block MoE): ``fused_forward`` logits and pools at 1e-4,
  a fused step's tokens (``make_fused_step_fn``) equal and its pools at
  1e-4, and greedy tokens equal the JAX engine's in both loops, with
  speculative decoding off and on, and with int8 weights.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.model_runner import fused_forward as jax_fused_forward
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2.model_runner import fused_forward
from deepspeed_tpu_torch.models import TransformerConfig, params_from_numpy

LOGIT_TOL = 1e-4
TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=256, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
PROMPTS = [[3, 17, 42], [7, 7, 7, 7, 7], [100, 2], [55, 44, 33, 22, 11, 1, 0], [9] * 11, [1, 2, 3, 4]]


@pytest.fixture(scope="module")
def tiny():
    model = CausalLM(JaxConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def engines(burst=8, blocks=128, prefix_cache=None, chunk=None):
        smc = dict(kv_block_size=8, max_context=256, num_kv_blocks=blocks)
        je = JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(**smc), dtype="float32",
                                                      fused_step=True, decode_burst=burst,
                                                      enable_prefix_cache=prefix_cache))
        te = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(**smc), dtype="float32", device="cpu", decode_burst=burst,
            enable_prefix_cache=prefix_cache))
        if chunk is not None:
            je.scheduler.prefill_chunk = te.scheduler.prefill_chunk = chunk
        return je, te

    return model, params, cfg, tparams, engines


def _quantum_inputs(rows, n_dec, chunk, bs=8, P=4):
    """Flat fused-step operands for rows of (tokens, start, blocks) — decode
    rows first (one token each), then prefill rows padded to ``chunk``."""
    n_pre = len(rows) - n_dec
    T = n_dec + n_pre * chunk
    ids = np.zeros(T, np.int32)
    pos = np.zeros(T, np.int32)
    slots = (np.arange(T) % bs).astype(np.int32)  # padding writes the garbage page (block 0)
    bt = np.zeros((len(rows), P), np.int32)
    ctx = np.ones(len(rows), np.int32)
    last = np.zeros(len(rows), np.int32)
    for r, (toks, start, blocks) in enumerate(rows):
        base = r if r < n_dec else n_dec + (r - n_dec) * chunk
        p = start + np.arange(len(toks))
        ids[base:base + len(toks)] = toks
        pos[base:base + len(toks)] = p
        slots[base:base + len(toks)] = np.asarray(blocks)[p // bs] * bs + p % bs
        bt[r, :len(blocks)] = blocks
        ctx[r] = start + len(toks)
        last[r] = base + len(toks) - 1
    return ids, pos, bt, ctx, slots, last


def test_fused_forward_logits_and_pools_match(tiny):
    _, params, cfg, tparams, _ = tiny
    rng = np.random.default_rng(0)
    L, n_blocks, bs, KVH, D = cfg.n_layers, 16, 8, cfg.kv_heads, cfg.head_dim
    a, b, c = (rng.integers(0, 128, n).tolist() for n in (5, 7, 12))
    blocks = {"a": [1, 2], "b": [3, 4], "c": [5, 6]}
    quanta = [
        # prefill-only quantum: three first chunks (c continues in the next quantum)
        (0, 8, [(a, 0, blocks["a"]), (b, 0, blocks["b"]), (c[:8], 0, blocks["c"])]),
        # mixed quantum: two decode rows + c's second chunk continuing its context
        (2, 4, [([11], 5, blocks["a"]), ([12], 7, blocks["b"]), (c[8:], 8, blocks["c"])]),
    ]
    jcfg = JaxConfig(**TINY)
    jk = jv = jnp.zeros((L, n_blocks, bs, KVH, D), jnp.float32)
    tk = torch.zeros((L, n_blocks, bs, KVH, D))
    tv = torch.zeros((L, n_blocks, bs, KVH, D))
    for n_dec, chunk, rows in quanta:
        ids, pos, bt, ctx, slots, last = _quantum_inputs(rows, n_dec, chunk)
        jl, jk, jv = jax_fused_forward(jcfg, params, *(jnp.asarray(x) for x in (ids, pos)), jk, jv,
                                       *(jnp.asarray(x) for x in (bt, ctx, slots, last)), n_dec=n_dec, chunk=chunk,
                                       interpret=True)
        tl, tk, tv = fused_forward(cfg, tparams, *(torch.from_numpy(x) for x in (ids, pos)), tk, tv,
                                   *(torch.from_numpy(x) for x in (bt, ctx, slots, last)), n_dec=n_dec, chunk=chunk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:], rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:], rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _record_quanta(engine):
    log = []
    inner = engine.scheduler.schedule_fused

    def spy(pending, decode_uids):
        q = inner(pending, decode_uids)
        log.append((tuple(q.decode_uids), tuple((p.uid, p.start_pos, len(p.tokens), p.final) for p in q.prefills)))
        return q

    engine.scheduler.schedule_fused = spy
    return log


SHARED = list(range(20, 36))  # two full blocks of 8: a prefix the radix cache can reuse
TRACE_1 = [SHARED + [1, 2, 3], [5] * 13, SHARED + [4]]
TRACE_2 = [SHARED + [7, 8], SHARED[:8] + [9] * 6, [40, 41]]


def test_scheduler_compositions_match(tiny):
    *_, engines = tiny
    je, te = engines(burst=4, chunk=4)
    jlog, tlog = _record_quanta(je), _record_quanta(te)
    for trace in (TRACE_1, TRACE_2):  # the second trace is admitted against cached prefixes
        assert te.generate(trace, max_new_tokens=6) == je.generate(trace, max_new_tokens=6)
    assert tlog == jlog
    assert any(start > 0 and final for _, pre in tlog[len(tlog) // 2:] for _, start, _, final in pre)


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_greedy_tokens_match(tiny, prefix_cache):
    *_, engines = tiny
    je, te = engines(prefix_cache=prefix_cache)
    assert te.generate(PROMPTS, max_new_tokens=9) == je.generate(PROMPTS, max_new_tokens=9)
    # a second wave over the same engines: prompts extend the first wave's,
    # so with the cache on they are admitted on cached blocks (copy-on-write)
    wave = [p * 4 for p in PROMPTS[:3]] + [SHARED, SHARED + [3]]
    assert te.generate(wave, max_new_tokens=5) == je.generate(wave, max_new_tokens=5)
    assert te.generate(wave, max_new_tokens=5) == je.generate(wave, max_new_tokens=5)
    if prefix_cache:
        assert te.state.prefix_cache.cached_blocks > 0
    free = te.state.free_blocks + (te.state.prefix_cache.cached_blocks if prefix_cache else 0)
    assert free == te.state.total_blocks - 1  # every block back, but the garbage page


def test_eos_cut_matches(tiny):
    *_, engines = tiny
    je, te = engines()
    greedy = te.generate(PROMPTS, max_new_tokens=9)
    eos = greedy[0][3]
    free0 = te.state.free_blocks
    out_t = te.generate(PROMPTS, max_new_tokens=9, eos_token_id=eos)
    assert out_t == je.generate(PROMPTS, max_new_tokens=9, eos_token_id=eos)
    assert any(eos in o and len(o) < 9 for o in out_t)
    assert te.state.free_blocks == free0


def test_chunked_prefill_mixed_quanta_match(tiny):
    *_, engines = tiny
    je, te = engines(chunk=4)
    assert te.generate(PROMPTS, max_new_tokens=5) == je.generate(PROMPTS, max_new_tokens=5)


def test_topk1_sampling_equals_greedy(tiny):
    *_, engines = tiny
    je, te = engines()
    greedy = je.generate(PROMPTS, max_new_tokens=6)
    assert te.generate(PROMPTS, max_new_tokens=6, do_sample=True, top_k=1, seed=3) == greedy


def test_streaming_callback(tiny):
    *_, engines = tiny
    _, te = engines()
    streams = {}
    out = te.generate(PROMPTS[:3], max_new_tokens=7, on_token=lambda u, t: streams.setdefault(u, []).append(t))
    assert [streams[i] for i in range(3)] == out
    assert out == te.generate(PROMPTS[:3], max_new_tokens=7)  # deferred mode, same tokens


def test_bucketing_matches(tiny):
    *_, engines = tiny
    je, te = engines()
    for args in [(3, 0, 0), (9, 0, 0), (0, 3, 5), (2, 1, 1), (2, 2, 40)]:
        assert te._fused_bucket(*args) == je._fused_bucket(*args)


def test_default_device_raises_without_gpu(tiny, monkeypatch):
    _, _, cfg, tparams, engines = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngineV2(cfg, tparams)
    _, fused = engines()
    monkeypatch.setenv("DS_TPU_SERVE_FUSED", "0")  # the unfused loop serves on the CPU
    unfused = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(kv_block_size=8, max_context=256, num_kv_blocks=128), dtype="float32",
        device="cpu", decode_burst=8))
    assert not unfused._fused_enabled and fused._fused_enabled
    assert unfused.generate(PROMPTS, max_new_tokens=6) == fused.generate(PROMPTS, max_new_tokens=6)


def test_package_imports_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import importlib.abc, sys
        for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "deepspeed_tpu")]:
            del sys.modules[name]

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "deepspeed_tpu"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import deepspeed_tpu_torch
        import deepspeed_tpu_torch.inference.generation, deepspeed_tpu_torch.inference.v2
        import deepspeed_tpu_torch.inference.v2.graphs, deepspeed_tpu_torch.inference.v2.sla
        import deepspeed_tpu_torch.models, deepspeed_tpu_torch.ops.norms, deepspeed_tpu_torch.ops.paged_attention
        import deepspeed_tpu_torch.telemetry, deepspeed_tpu_torch.analysis.kv_sanitizer
        import deepspeed_tpu_torch.inference.v2.ragged.host_tier, deepspeed_tpu_torch.inference.v2.replay
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "deepspeed_tpu")]
        assert not bad, bad
        print("clean")
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "clean" in res.stdout, res.stderr


ALIBI = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=32, max_seq_len=256, norm="layernorm", activation="gelu",
             pos_emb="alibi", embedding_norm=True)
WINDOW = dict(vocab_size=64, n_layers=2, n_heads=2, d_model=16, max_seq_len=64, norm="layernorm", activation="gelu",
              pos_emb="learned", sliding_window=4, window_layers=(1,))
# repetitive prompts, so that prompt lookup drafts; lengths past the window of 4
FEATURE_PROMPTS = [[5, 9, 13] * 3, [7] * 6, [30, 2, 55, 44, 33, 22, 11, 1, 0, 8], [3, 17, 42, 3, 17, 42]]


@pytest.fixture(scope="module")
def feature_models():
    """name -> (port cfg, port params, the JAX engine's greedy tokens) for the ALiBi and window configs."""
    out = {}
    for name, fields, seed in (("alibi", ALIBI, 0), ("window", WINDOW, 3)):
        jcfg = JaxConfig(**fields)
        model = CausalLM(jcfg)
        params = model.init(jax.random.PRNGKey(seed), {"input_ids": np.zeros((1, 8), np.int32)})
        smc = JaxBatchConfig(kv_block_size=8, max_context=64, num_kv_blocks=64)
        want = JaxEngine(model, params, JaxEngineConfig(state_manager=smc, dtype="float32", fused_step=True,
                                                        decode_burst=8)).generate(FEATURE_PROMPTS, max_new_tokens=20)
        cfg = TransformerConfig(**fields)
        out[name] = (cfg, params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg), want)
    return out


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["alibi", "window"])
def test_alibi_and_window_serving_match(feature_models, name, fused, spec):
    cfg, tparams, want = feature_models[name]
    te = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(kv_block_size=8, max_context=64, num_kv_blocks=64), dtype="float32",
        device="cpu", decode_burst=8, fused_step=fused, spec_decode=spec))
    assert te._run_cfg.pos_emb == cfg.pos_emb and te._run_cfg.sliding_window == cfg.sliding_window
    assert te.generate(FEATURE_PROMPTS, max_new_tokens=20) == want
    if spec:
        assert te.spec_accepted > 0


# A tiny Mixtral-shaped MoE config (the JAX package's ``_moe_model`` in tests/unit/test_inference_v2.py):
# 4 experts, top-2, every second block MoE (freq 2) or every block (freq 1)
MOE = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=128, norm="rmsnorm",
           activation="swiglu", pos_emb="rope", tie_embeddings=False, moe_num_experts=4, moe_top_k=2)
MOE_QUANT = dict(quant_bits=8, quant_min_size=256)


@pytest.fixture(scope="module")
def moe_models():
    """freq -> (JAX config, JAX params, port cfg, port params, {quant: the JAX engine's greedy tokens})."""
    out = {}
    for freq in (2, 1):
        fields = dict(MOE, moe_layer_freq=freq)
        jcfg = JaxConfig(**fields)
        model = CausalLM(jcfg)
        params = model.init(jax.random.PRNGKey(3), {"input_ids": np.zeros((1, 8), np.int32)})
        want = {}
        for quant in (False, True):
            smc = JaxBatchConfig(kv_block_size=8, max_context=64, num_kv_blocks=64)
            je = JaxEngine(model, params, JaxEngineConfig(state_manager=smc, dtype="float32", fused_step=True,
                                                          decode_burst=8, **(MOE_QUANT if quant else {})))
            want[quant] = je.generate(FEATURE_PROMPTS, max_new_tokens=20)
        cfg = TransformerConfig(**fields)
        out[freq] = (jcfg, params, cfg, params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg), want)
    return out


@pytest.mark.parametrize("freq", [2, 1])
def test_moe_fused_forward_logits_and_pools_match(moe_models, freq):
    """The fused step's forward on an MoE config: per-row logits and the KV
    pools against JAX ``fused_forward`` over a prefill quantum and a mixed
    one (1e-4, as the dense config)."""
    jcfg, params, cfg, tparams, _ = moe_models[freq]
    rng = np.random.default_rng(freq)
    L, n_blocks, bs, KVH, D = cfg.n_layers, 16, 8, cfg.kv_heads, cfg.head_dim
    a, b, c = (rng.integers(0, 128, n).tolist() for n in (5, 7, 12))
    blocks = {"a": [1, 2], "b": [3, 4], "c": [5, 6]}
    quanta = [(0, 8, [(a, 0, blocks["a"]), (b, 0, blocks["b"]), (c[:8], 0, blocks["c"])]),
              (2, 4, [([11], 5, blocks["a"]), ([12], 7, blocks["b"]), (c[8:], 8, blocks["c"])])]
    jk = jv = jnp.zeros((L, n_blocks, bs, KVH, D), jnp.float32)
    tk, tv = torch.zeros((L, n_blocks, bs, KVH, D)), torch.zeros((L, n_blocks, bs, KVH, D))
    for n_dec, chunk, rows in quanta:
        ids, pos, bt, ctx, slots, last = _quantum_inputs(rows, n_dec, chunk)
        jl, jk, jv = jax_fused_forward(jcfg, params, *(jnp.asarray(x) for x in (ids, pos)), jk, jv,
                                       *(jnp.asarray(x) for x in (bt, ctx, slots, last)), n_dec=n_dec, chunk=chunk,
                                       interpret=True)
        tl, tk, tv = fused_forward(cfg, tparams, *(torch.from_numpy(x) for x in (ids, pos)), tk, tv,
                                   *(torch.from_numpy(x) for x in (bt, ctx, slots, last)), n_dec=n_dec, chunk=chunk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:], rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:], rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("freq", [2, 1])
def test_moe_fused_step_matches(moe_models, freq):
    """One fused step on an MoE config (``make_fused_step_fn``: the mixed
    quantum, greedy tokens on the device, then 3 follow-on decode steps of
    the burst) after a prefill quantum: tokens equal the JAX step's, pools
    within 1e-4."""
    from deepspeed_tpu.inference.v2.model_runner import make_fused_step_fn as jax_make_fused_step_fn
    from deepspeed_tpu_torch.inference.v2.model_runner import make_fused_step_fn

    jcfg, params, cfg, tparams, _ = moe_models[freq]
    rng = np.random.default_rng(10 + freq)
    L, n_blocks, bs, KVH, D = cfg.n_layers, 16, 8, cfg.kv_heads, cfg.head_dim
    a, b, c = (rng.integers(0, 128, n).tolist() for n in (5, 7, 12))
    blocks = {"a": [1, 2], "b": [3, 4], "c": [5, 6]}
    ids, pos, bt, ctx, slots, last = _quantum_inputs(
        [(a, 0, blocks["a"]), (b, 0, blocks["b"]), (c[:8], 0, blocks["c"])], 0, 8)
    jl, jk, jv = jax_fused_forward(jcfg, params, *(jnp.asarray(x) for x in (ids, pos)),
                                   jnp.zeros((L, n_blocks, bs, KVH, D), jnp.float32),
                                   jnp.zeros((L, n_blocks, bs, KVH, D), jnp.float32),
                                   *(jnp.asarray(x) for x in (bt, ctx, slots, last)), n_dec=0, chunk=8, interpret=True)
    tk, tv = torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv))  # the same pools on both sides
    rows = [([11], 5, blocks["a"]), ([12], 7, blocks["b"]), (c[8:], 8, blocks["c"])]
    ids, pos, bt, ctx, slots, last = _quantum_inputs(rows, 2, 4)
    # the burst's follow-on slots: each row's next 3 positions (ctx + off) in its own blocks
    adv = np.array([[blk[(p + off) // bs] * bs + (p + off) % bs for (_, _, blk), p in zip(rows, ctx)]
                    for off in range(3)], np.int32)
    garbage = np.zeros(3, np.int32)
    jfn = jax_make_fused_step_fn(jcfg, True, n_dec=2, n_pre=1, chunk=4)
    jt, jk, jv = jfn(params, *(jnp.asarray(x) for x in (ids, pos)), jk, jv,
                     *(jnp.asarray(x) for x in (bt, ctx, slots, last, adv, garbage)), -1, jax.random.PRNGKey(0))
    tfn = make_fused_step_fn(cfg, n_dec=2, n_pre=1, chunk=4)
    tt, tk, tv = tfn(tparams, *(torch.from_numpy(x) for x in (ids, pos)), tk, tv,
                     *(torch.from_numpy(x) for x in (bt, ctx, slots, last, adv, garbage)), -1, None)
    assert tt.shape == (3, 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:], rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("fused,spec,quant", [(True, False, False), (True, True, False), (False, False, False),
                                               (False, True, False), (True, False, True), (False, False, True)])
@pytest.mark.parametrize("freq", [2, 1])
def test_moe_serving_matches(moe_models, freq, fused, spec, quant):
    """Greedy tokens of the MoE config equal the JAX engine's (fused loop, spec
    off) in both loops, with speculative decoding off and on, and with int8
    weights (the JAX engine quantised alike; gates and experts stay dense in
    both)."""
    *_, cfg, tparams, want = moe_models[freq]
    te = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(kv_block_size=8, max_context=64, num_kv_blocks=64), dtype="float32",
        device="cpu", decode_burst=8, fused_step=fused, spec_decode=spec, **(MOE_QUANT if quant else {})))
    moe_layer = te.params[f"layer_{cfg.n_layers - 1}"]["moe"]
    assert all(isinstance(t, torch.Tensor) for t in (moe_layer["gate"]["kernel"], *moe_layer["experts"].values()))
    assert isinstance(te.params["layer_0"]["attn"]["q_proj"]["kernel"], torch.Tensor) != quant
    assert te.generate(FEATURE_PROMPTS, max_new_tokens=20) == want[quant]
    if spec:
        assert te.spec_proposed > 0
