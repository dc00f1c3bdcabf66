"""Port parity: quantised serving (weight-only int8 / packed int4, int8 KV pages) against the JAX engine.

The JAX package initialises ``gpt2_tiny`` (LayerNorm, learned positions, tied
head) and ``llama_tiny`` (RMSNorm, rope, GQA, untied head); the port takes the
same weights through ``params_from_numpy`` and each side quantises them with
its own ``quantize_for_serving``. Everything runs on the CPU in fp32, where the
port's kernel wrappers take their plain versions and the JAX engine runs its
Pallas kernels in interpret mode. Held to the reference:
- the quantised tree: the same leaves, layouts, codes and scales, bit for bit;
- ``fused_forward``: per-row logits and the KV pools (block 0, the garbage
  page, excluded) at 1e-4 (int8 pool codes may differ by one step where the
  two frameworks' fp32 K/V differ in the last bit, so the pools are compared
  dequantised, at one quantisation step);
- the engine: greedy tokens equal for W8, W4, KV8 and W8+KV8, with the prefix
  cache on and off, a copy-on-write of an int8 block among the admissions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.quantization import QuantizedParam as JaxQuantizedParam
from deepspeed_tpu.inference.quantization import dequantize_param as jax_dequantize_param
from deepspeed_tpu.inference.quantization import quantize_for_serving as jax_quantize_for_serving
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.model_runner import fused_forward as jax_fused_forward
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.models import llama_tiny as jax_llama_tiny
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.inference.quantization import (QuantizedParam, dequantize_param, dequantize_tree,
                                                        quantize_for_serving)
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.model_runner import fused_forward
from deepspeed_tpu_torch.models import gpt2_tiny, llama_tiny, params_from_numpy, quantized_from_numpy
from deepspeed_tpu_torch.ops import paged_attention as tpa

LOGIT_TOL = 1e-4
MIN_SIZE = 256  # the tiny models' kernels have 4096 to 16384 elements; the default leaves smaller ones dense
PRESETS = {"gpt2_tiny": (jax_gpt2_tiny, gpt2_tiny), "llama_tiny": (jax_llama_tiny, llama_tiny)}
SHARED = list(range(20, 36))  # two full blocks of 8: a prefix the radix cache can reuse
WAVE_1 = [SHARED + [1, 2, 3], [5] * 13, [3, 17, 42]]
WAVE_2 = [SHARED + [7, 8], SHARED, SHARED + [3]]  # admitted on cached blocks: SHARED alone needs a copy-on-write


_BUILT = {}


def _tiny(name):
    if name not in _BUILT:
        _BUILT[name] = _build(name)
    return _BUILT[name]


def _build(name):
    jax_preset, preset = PRESETS[name]
    jcfg = jax_preset(dtype=jnp.float32)
    model = CausalLM(jcfg)
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = preset(dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def engines(prefix_cache=None, **quant):
        smc = dict(kv_block_size=8, max_context=256, num_kv_blocks=96)
        je = JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(**smc), dtype="float32",
                                                      fused_step=True, decode_burst=4,
                                                      enable_prefix_cache=prefix_cache, **quant))
        te = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(**smc), dtype="float32", device="cpu", decode_burst=4,
            enable_prefix_cache=prefix_cache, **quant))
        return je, te

    return name, model, params, jcfg, cfg, tparams, engines


def _quantized_leaves(tree, cls, prefix=""):
    if isinstance(tree, cls):
        return {prefix: tree}
    if not isinstance(tree, dict) and not hasattr(tree, "items"):
        return {}
    out = {}
    for k, v in tree.items():
        out.update(_quantized_leaves(v, cls, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("model", list(PRESETS))
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_for_serving_equals_jax(model, bits):
    name, _, params, _, _, tparams, _ = _tiny(model)
    jq = _quantized_leaves(jax_quantize_for_serving(params, num_bits=bits, group_size=128, min_size=MIN_SIZE),
                           JaxQuantizedParam)
    tq_tree = quantize_for_serving(tparams, num_bits=bits, group_size=128, min_size=MIN_SIZE)
    tq = _quantized_leaves(tq_tree, QuantizedParam)
    assert set(tq) == {p[len("params/"):] if p.startswith("params/") else p for p in jq} and tq
    # attention and MLP kernels (and llama's untied head) are quantised; embeddings, norms and biases are not
    assert all(p.endswith("/kernel") for p in tq) and ("lm_head/kernel" in tq) == (name == "llama_tiny")
    for path, want in jq.items():
        got = tq[path[len("params/"):] if path.startswith("params/") else path]
        assert (got.layout, got.num_bits, tuple(got.shape)) == (want.layout, want.num_bits, tuple(want.shape))
        assert got.layout == ("kgroups_p4" if bits == 4 else "kgroups")
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
        assert got.nbytes_quantized == want.nbytes_quantized
        # a reference leaf carried across as it is dequantises to the same weight
        carried = quantized_from_numpy(np.asarray(want.q), np.asarray(want.scales), want.shape, torch.float32,
                                       want.num_bits, want.layout, device="cpu")
        np.testing.assert_array_equal(dequantize_param(carried).numpy(), np.asarray(jax_dequantize_param(want)))
    dense = dequantize_tree(tq_tree)
    assert not _quantized_leaves(dense, QuantizedParam)
    assert dense["layer_0"]["attn"]["o_proj"]["kernel"].shape == tparams["layer_0"]["attn"]["o_proj"]["kernel"].shape


def test_int4_odd_group_stays_unpacked():
    tree = {"layer_0": {"mlp": {"up_proj": {"kernel": torch.ones((15, 512))}}}}
    qp = quantize_for_serving(tree, num_bits=4, group_size=128, min_size=1024)["layer_0"]["mlp"]["up_proj"]["kernel"]
    assert qp.layout == "kgroups" and tuple(qp.q.shape) == (15, 512)
    small = quantize_for_serving(tree, num_bits=8, min_size=1 << 20)  # under min_size: left dense
    assert isinstance(small["layer_0"]["mlp"]["up_proj"]["kernel"], torch.Tensor)


def _quantum_inputs(rows, n_dec, chunk, bs=8, P=4):
    """Flat fused-step operands for rows of (tokens, start, blocks): decode rows first."""
    n_pre = len(rows) - n_dec
    T = n_dec + n_pre * chunk
    ids, pos = np.zeros(T, np.int32), np.zeros(T, np.int32)
    slots = (np.arange(T) % bs).astype(np.int32)  # padding writes the garbage page (block 0)
    bt = np.zeros((len(rows), P), np.int32)
    ctx, last = np.ones(len(rows), np.int32), np.zeros(len(rows), np.int32)
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


@pytest.mark.parametrize("model,bits,kvq", [("gpt2_tiny", 8, 8), ("llama_tiny", 4, 0), ("llama_tiny", 0, 8)])
def test_fused_forward_logits_and_pools_match(model, bits, kvq):
    _, _, params, jcfg, cfg, tparams, _ = _tiny(model)
    jparams, tp = params, tparams
    if bits:
        jparams = jax_quantize_for_serving(params, num_bits=bits, group_size=128, min_size=MIN_SIZE)
        tp = quantize_for_serving(tparams, num_bits=bits, group_size=128, min_size=MIN_SIZE)
    rng = np.random.default_rng(0)
    shape = (cfg.n_layers, 16, 8, cfg.kv_heads, cfg.head_dim)
    a, b, c = (rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 7, 12))
    blocks = {"a": [1, 2], "b": [3, 4], "c": [5, 6]}
    quanta = [
        (0, 8, [(a, 0, blocks["a"]), (b, 0, blocks["b"]), (c[:8], 0, blocks["c"])]),
        (2, 4, [([11], 5, blocks["a"]), ([12], 7, blocks["b"]), (c[8:], 8, blocks["c"])]),
    ]
    jk, jv = jpa.make_kv_pool(shape, jnp.float32, kvq), jpa.make_kv_pool(shape, jnp.float32, kvq)
    tk, tv = tpa.make_kv_pool(shape, torch.float32, "cpu", kvq), tpa.make_kv_pool(shape, torch.float32, "cpu", kvq)
    for n_dec, chunk, rows in quanta:
        ids, pos, bt, ctx, slots, last = _quantum_inputs(rows, n_dec, chunk)
        jl, jk, jv = jax_fused_forward(jcfg, jparams, *(jnp.asarray(x) for x in (ids, pos)), jk, jv,
                                       *(jnp.asarray(x) for x in (bt, ctx, slots, last)), n_dec=n_dec, chunk=chunk,
                                       interpret=True)
        tl, tk, tv = fused_forward(cfg, tp, *(torch.from_numpy(x) for x in (ids, pos)), tk, tv,
                                   *(torch.from_numpy(x) for x in (bt, ctx, slots, last)), n_dec=n_dec, chunk=chunk)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for tpool, jpool in ((tk, jk), (tv, jv)):
            if kvq:
                # scales at 1e-6 relative; a code may sit one step apart where the fp32 K/V differ in the last bit
                np.testing.assert_allclose(tpool[1][:, 1:].numpy(), np.asarray(jpool[1])[:, 1:], rtol=1e-5, atol=1e-7)
                assert np.abs(tpool[0][:, 1:].numpy().astype(np.int32)
                              - np.asarray(jpool[0])[:, 1:].astype(np.int32)).max() <= 1
                got, want = tpa.dequantize_kv(tpool).numpy(), np.asarray(jpa.dequantize_kv(jpool))
                step = np.asarray(jpool[1])[:, 1:].max()
                np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=step * 1.001)
            else:
                np.testing.assert_allclose(tpool[:, 1:].numpy(), np.asarray(jpool)[:, 1:], rtol=LOGIT_TOL,
                                           atol=LOGIT_TOL)


QUANT = {"w8": dict(quant_bits=8, quant_min_size=MIN_SIZE), "w4": dict(quant_bits=4, quant_min_size=MIN_SIZE),
         "kv8": dict(kv_quant_bits=8), "w8_kv8": dict(quant_bits=8, quant_min_size=MIN_SIZE, kv_quant_bits=8)}


@pytest.mark.parametrize("model,quant,prefix_cache", [
    ("gpt2_tiny", "w8_kv8", True), ("gpt2_tiny", "w8_kv8", False), ("gpt2_tiny", "w4", True),
    ("llama_tiny", "w8", True), ("llama_tiny", "kv8", True), ("llama_tiny", "w4", False)])
def test_greedy_tokens_match(model, quant, prefix_cache):
    *_, engines = _tiny(model)
    je, te = engines(prefix_cache=prefix_cache, **QUANT[quant])
    if "kv_quant_bits" in QUANT[quant]:
        assert tpa.kv_pool_is_quantized(te.k_pages) and te.k_pages[1].shape == te.k_pages[0].shape[:-1]
    if "quant_bits" in QUANT[quant]:
        assert isinstance(te.params["layer_0"]["attn"]["q_proj"]["kernel"], QuantizedParam)
    copies = []
    copy_block = te._copy_block
    te._copy_block = lambda src, dst: (copies.append((src, dst)), copy_block(src, dst))[1]
    for wave in (WAVE_1, WAVE_2):
        assert te.generate(wave, max_new_tokens=5) == je.generate(wave, max_new_tokens=5)
    if prefix_cache:
        assert copies  # a cached block was copied before a write, scale planes and all
        assert te.state.prefix_cache.cached_blocks > 0


def test_copy_block_copies_codes_and_scale_planes():
    *_, cfg, tparams, _ = _tiny("llama_tiny")
    te = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(kv_block_size=8, max_context=64, num_kv_blocks=8), dtype="float32",
        device="cpu", kv_quant_bits=8))
    g = torch.Generator().manual_seed(0)
    for codes, scales in (te.k_pages, te.v_pages):
        codes[:, 3] = torch.randint(-127, 128, codes[:, 3].shape, generator=g, dtype=torch.int8)
        scales[:, 3] = torch.rand(scales[:, 3].shape, generator=g)
    te._copy_block(3, 5)
    for codes, scales in (te.k_pages, te.v_pages):
        assert torch.equal(codes[:, 5], codes[:, 3]) and torch.equal(scales[:, 5], scales[:, 3])
        assert codes[:, 4].eq(0).all() and scales[:, 4].eq(0).all()


def test_kv_quant_off_is_the_unquantised_engine_and_int8_logits_stay_close():
    *_, cfg, tparams, _ = _tiny("gpt2_tiny")
    smc = RaggedBatchConfig(kv_block_size=8, max_context=256, num_kv_blocks=64)
    mk = lambda **kw: InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
        state_manager=dataclasses.replace(smc), dtype="float32", device="cpu", **kw))
    dense, off = mk(), mk(kv_quant_bits=0, quant_bits=0)
    assert not tpa.kv_pool_is_quantized(off.k_pages)
    assert off.generate(WAVE_1, max_new_tokens=6) == dense.generate(WAVE_1, max_new_tokens=6)
    # int8 weight-only serving: prefill logits within quantisation error of the dense engine's
    w8 = mk(quant_bits=8, quant_min_size=MIN_SIZE)
    prompt = [3, 17, 42, 9, 88, 5, 23]
    ids, pos, bt, ctx, slots, last = (torch.from_numpy(x) for x in _quantum_inputs([(prompt, 0, [1])], 0, 8))
    logits = [fused_forward(e._run_cfg, e.params, ids, pos, e.k_pages, e.v_pages, bt, ctx, slots, last, n_dec=0,
                            chunk=8)[0] for e in (w8, dense)]
    rel = (logits[0] - logits[1]).abs().max() / logits[1].abs().max()
    assert 0.0 < rel < 0.06, rel


def test_kv_quant_bits_validation_knob_and_block_sizing(monkeypatch):
    _, model, params, _, cfg, tparams, _ = _tiny("llama_tiny")
    mk = lambda **kw: InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(kv_block_size=8, max_context=64, memory_gb=0.002), dtype="float32",
        device="cpu", **kw))
    with pytest.raises(ValueError, match="kv_quant_bits"):
        mk(kv_quant_bits=4)
    assert mk()._kv_quant_bits == 0
    monkeypatch.setenv("DS_TPU_KV_QUANT", "8")  # read when the field is None
    eng = mk()
    assert eng._kv_quant_bits == 8 and tpa.kv_pool_is_quantized(eng.k_pages)
    assert mk(kv_quant_bits=0)._kv_quant_bits == 0  # the field wins over the knob
    # block sizing: head_dim + 4 bytes per slot-head, as the reference sizes its int8 pool
    je = JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(
        kv_block_size=8, max_context=64, memory_gb=0.002), dtype="float32", kv_quant_bits=8))
    assert eng._n_kv_blocks == je._n_kv_blocks
    assert eng._n_kv_blocks > mk(kv_quant_bits=0)._n_kv_blocks
