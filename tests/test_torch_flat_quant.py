"""Port parity: flat-layout weight quantisation of whole parameter trees.

The JAX package initialises ``gpt2_tiny`` and ``llama_tiny``; the port takes
the same weights through ``params_from_numpy``, and each side runs its own
``quantize_model_params``. Held to the reference bit for bit, on the CPU
(the port's kernels through their plain versions): the same leaves are
quantised, their codes and scales are equal, and so is the stats dict; config
groups match by substring of the "/"-joined path, ``min_size`` leaves small
leaves dense, and ``QuantizationContext.quantize`` is the default config.
A JAX flat ``QuantizedParam`` carried across with ``quantized_from_numpy``
dequantises to the reference's values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.quantization import QuantizationContext as JaxContext
from deepspeed_tpu.inference.quantization import QuantizedParam as JaxQP
from deepspeed_tpu.inference.quantization import dequantize_param as jax_dequantize_param
from deepspeed_tpu.inference.quantization import quantize_model_params as jax_quantize_model_params
from deepspeed_tpu.inference.quantization.quantization import quantize_param as jax_quantize_param
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.models import llama_tiny as jax_llama_tiny
from deepspeed_tpu_torch.inference.quantization import (QuantizationContext, QuantizedParam, dequantize_param,
                                                        dequantize_tree, quantize_model_params, quantize_param)
from deepspeed_tpu_torch.models import gpt2_tiny, llama_tiny, params_from_numpy, quantized_from_numpy

PRESETS = {"gpt2_tiny": (jax_gpt2_tiny, gpt2_tiny), "llama_tiny": (jax_llama_tiny, llama_tiny)}
_BUILT = {}


def _trees(name):
    if name not in _BUILT:
        jax_preset, preset = PRESETS[name]
        params = CausalLM(jax_preset(dtype=jnp.float32)).init(jax.random.PRNGKey(0),
                                                               {"input_ids": np.zeros((1, 8), np.int32)})
        params = jax.tree.map(np.asarray, params)
        _BUILT[name] = params, params_from_numpy(params, "cpu", cfg=preset(dtype=torch.float32))
    return _BUILT[name]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert isinstance(g, QuantizedParam) == isinstance(w, JaxQP), path
        if isinstance(w, JaxQP):
            assert (g.layout, g.num_bits, g.shape) == (w.layout, w.num_bits, tuple(w.shape)) == ("flat", w.num_bits,
                                                                                                w.shape), path
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), err_msg=path)
            np.testing.assert_array_equal(g.scales.numpy().view(np.uint32), np.asarray(w.scales).view(np.uint32),
                                          err_msg=path)
            assert g.nbytes_quantized == w.nbytes_quantized
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=path)


@pytest.mark.parametrize("name", ["gpt2_tiny", "llama_tiny"])
@pytest.mark.parametrize("bits,group", [(8, 64), (4, 64), (8, 32)])
def test_quantize_model_params_equals_the_reference(name, bits, group):
    jparams, tparams = _trees(name)
    config = {"weight_quantization": {"post_init_quant": {"*": {"num_bits": bits, "group_size": group}}}}
    jtree, jstats = jax_quantize_model_params(jparams, config)
    ttree, tstats = quantize_model_params(tparams, config)
    assert tstats == jstats and tstats["quantized"] > 0 and tstats["skipped"] > 0
    _assert_same_tree(ttree, jtree)
    # dequantised weights equal the reference's
    want = _flat(jax.tree.map(np.asarray, jax.tree_util.tree_map(
        lambda x: jax_dequantize_param(x) if isinstance(x, JaxQP) else x, jtree,
        is_leaf=lambda x: isinstance(x, JaxQP))))
    got = _flat(dequantize_tree(ttree))
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)


@pytest.mark.parametrize("name", ["gpt2_tiny", "llama_tiny"])
def test_config_groups_match_by_path_substring_and_min_size(name):
    jparams, tparams = _trees(name)
    config = {"weight_quantization": {"post_init_quant": {
        "mlp": {"num_bits": 4, "group_size": 32},
        "layer_1/attn": {"num_bits": 8, "group_size": 64}}}}
    for min_size in (1024, 8192):
        jtree, jstats = jax_quantize_model_params(jparams, config, min_size=min_size)
        ttree, tstats = quantize_model_params(tparams, config, min_size=min_size)
        assert tstats == jstats
        _assert_same_tree(ttree, jtree)
    flat = _flat(ttree)
    assert not isinstance(flat["layer_0/attn/q_proj/kernel"], QuantizedParam)  # no group matches layer_0/attn
    assert all(flat[p].num_bits == 4 for p in flat if "mlp" in p and isinstance(flat[p], QuantizedParam))


def test_quantization_context_uses_the_default_config():
    jparams, tparams = _trees("llama_tiny")
    with JaxContext() as jc, QuantizationContext() as tc:
        _assert_same_tree(tc.quantize(tparams), jc.quantize(jparams))


@pytest.mark.parametrize("bits", [8, 4])
def test_a_reference_flat_param_carried_across_dequantises_equal(bits):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    jqp = jax_quantize_param(jnp.asarray(w), num_bits=bits, group_size=64)
    assert jqp.layout == "flat"
    qp = quantized_from_numpy(np.asarray(jqp.q), np.asarray(jqp.scales), jqp.shape, torch.float32, jqp.num_bits,
                              jqp.layout, device="cpu")
    np.testing.assert_array_equal(dequantize_param(qp).numpy(), np.asarray(jax_dequantize_param(jqp)))
    mine = quantize_param(torch.from_numpy(w), num_bits=bits, group_size=64)
    np.testing.assert_array_equal(mine.q.numpy(), qp.q.numpy())
    np.testing.assert_array_equal(mine.scales.numpy(), qp.scales.numpy())
    with pytest.raises(NotImplementedError):
        quantized_from_numpy(np.asarray(jqp.q), np.asarray(jqp.scales), jqp.shape, torch.float32, bits, "flat+gspmd",
                             device="cpu")


def test_quantize_param_of_bf16_weights_quantises_their_fp32_values():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)).to(torch.bfloat16)
    qp = quantize_param(w, num_bits=8, group_size=64)
    ref = jax_quantize_param(jnp.asarray(w.float().numpy()).astype(jnp.bfloat16), num_bits=8, group_size=64)
    np.testing.assert_array_equal(qp.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(qp.scales.numpy(), np.asarray(ref.scales))
    assert qp.dtype == torch.bfloat16 and dequantize_param(qp).dtype == torch.bfloat16
