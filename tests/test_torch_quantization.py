"""Port parity: group-wise quantisation (the quantise / dequantise kernels through their plain versions).

The same numpy inputs go through JAX ``quantize_groupwise_xla`` /
``dequantize_groupwise_xla`` (the oracle: the v1 engine's ``quantize_param``
takes the XLA form) and the port's ``quantize_groupwise`` /
``dequantize_groupwise`` on CPU tensors (their plain versions), and must be
equal bit for bit: codes and scales at int8 and int4, fp32 and bf16 inputs,
groups of 32, 64 and 128, an all-zero group, values exactly at +-qmax * scale
and at half-way ties, a row count that is not a power of two; the
dequantised values in fp32 and bf16.

Against the Pallas body in interpret mode the codes agree in >= 0.999 of the
elements and the scales within 1 ulp, as ``tests/unit/test_pallas_ops.py``
holds the Pallas body to XLA: the Pallas body computes the scale as
``absmax * (1 / qmax)``, which differs from the oracle's division by one ulp
in some groups, and a code may then round the other way.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch.ops import quantization as tq

ROWS = 37  # not a power of two


def _inputs(rows, group, bits, seed=0):
    """Random rows, one all-zero group, one group whose max sits exactly at
    qmax * scale with the other codes at half-way ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, group)) * rng.uniform(0.01, 3.0, (rows, 1))).astype(np.float32)
    x[3] = 0.0
    qmax = 2**(bits - 1) - 1
    ties = (np.arange(group) % (2 * qmax) - qmax + 0.5).astype(np.float32)  # k + 0.5 for scale 1
    ties[0] = qmax  # absmax = qmax -> scale exactly 1.0
    ties[1] = -qmax
    x[5] = ties
    x[6] = ties * 0.25  # scale 0.25: still exact halves
    return x


def _torch_from(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax_from(x, dtype):
    return jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bf16" else jnp.asarray(x)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [32, 64, 128])
def test_quantize_equals_the_xla_form_bit_for_bit(dtype, bits, group):
    x = _inputs(ROWS, group, bits)
    jqv, jsv = jq.quantize_groupwise_xla(_jax_from(x, dtype), group_size=group, bits=bits)
    q, s = tq.quantize_groupwise(_torch_from(x, dtype), group_size=group, bits=bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (ROWS, group) and s.shape == (ROWS,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy().view(np.uint32), np.asarray(jsv).view(np.uint32))
    assert s[3].item() == 1.0 and not q[3].any()  # the all-zero group
    qmax = 2**(bits - 1) - 1
    assert q.min().item() >= -qmax - 1 and q.max().item() <= qmax
    if dtype == "fp32":
        assert s[5].item() == 1.0 and s[6].item() == 0.25
        # half-way ties round to even: 0.5 -> 0, 1.5 -> 2, -0.5 -> 0
        want = np.clip(np.round(x[5]), -qmax - 1, qmax).astype(np.int8)
        np.testing.assert_array_equal(q[5].numpy(), want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_any_shape_against_the_pallas_body(bits):
    """The Pallas body divides by a scale computed as absmax * (1 / qmax), one
    ulp from the oracle's absmax / qmax in some groups (see the module note)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 40, 64)).astype(np.float32)  # 240 rows of 64
    jqv, jsv = jq.quantize_groupwise(jnp.asarray(x), group_size=64, bits=bits, interpret=True)
    q, s = tq.quantize_groupwise(torch.from_numpy(x), group_size=64, bits=bits)
    assert (q.numpy() == np.asarray(jqv)).mean() >= 0.999
    ulps = np.abs(s.numpy().view(np.int32).astype(np.int64) - np.asarray(jsv).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


@pytest.mark.parametrize("out_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_equals_the_xla_form_bit_for_bit(out_dtype, bits):
    x = _inputs(ROWS, 64, bits, seed=2)
    q, s = tq.quantize_groupwise(torch.from_numpy(x), group_size=64, bits=bits)
    shape = (ROWS * 2, 32)
    tdt = torch.bfloat16 if out_dtype == "bf16" else torch.float32
    jdt = jnp.bfloat16 if out_dtype == "bf16" else jnp.float32
    got = tq.dequantize_groupwise(q, s, out_shape=shape, out_dtype=tdt)
    want = np.asarray(jq.dequantize_groupwise_xla(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), out_shape=shape,
                                                  out_dtype=jdt))
    assert got.shape == shape and got.dtype == tdt
    if out_dtype == "bf16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(ml_dtypes.bfloat16).view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(tq.dequantize_groupwise(q, s).numpy(), tq.dequantize_groupwise_xla(q, s).numpy())


def test_dequantize_against_the_pallas_body():
    rng = np.random.default_rng(3)
    q = rng.integers(-128, 128, (48, 32)).astype(np.int8)
    s = rng.uniform(0.001, 0.1, 48).astype(np.float32)
    want = np.asarray(jq.dequantize_groupwise(jnp.asarray(q), jnp.asarray(s), interpret=True))
    got = tq.dequantize_groupwise(torch.from_numpy(q), torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_a_size_that_does_not_divide_by_the_group_raises():
    x = torch.zeros(100)
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize_groupwise(x, group_size=64)
    with pytest.raises(ValueError, match="not divisible"):
        tq.quantize_groupwise_xla(x, group_size=64)
    with pytest.raises(AssertionError):  # the reference raises too
        jq.quantize_groupwise(jnp.zeros(100), group_size=64, interpret=True)
