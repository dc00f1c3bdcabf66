"""Port parity: deepspeed_tpu_torch.ops.quantized_matmul against the JAX reference.

Weights and activations are drawn with numpy from a seed and fed to both
frameworks on the CPU. The quantiser's codes and scales must equal the
reference's bit for bit (same fp32 operations in the same order: absmax,
one division, round half to even, clip), the packed-int4 nibble order
included. ``quantized_matmul`` on a CPU tensor is its plain version; it is
held to ``quantized_matmul_xla`` and to the Pallas kernel in interpret mode
at 1e-4 of the output's largest value in fp32 (summation order differs) and
at 1e-2 for a bfloat16 x (one rounding step of the output is 2**-8 of a
value). The CUDA kernel's own checks are in ``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.pallas import quantized_matmul as jqm
from deepspeed_tpu_torch.ops import quantized_matmul as tqm
from deepspeed_tpu_torch.ops._utils import block_that_divides

CASES = {
    "int8": dict(K=256, N=64, group_size=128, bits=8, pack=False),
    "int4_unpacked": dict(K=256, N=64, group_size=128, bits=4, pack=False),
    "int4_packed": dict(K=256, N=64, group_size=128, bits=4, pack=True),
    "k_not_multiple_of_128": dict(K=192, N=32, group_size=128, bits=8, pack=False),  # g falls to 64
    "packed_small_group": dict(K=192, N=32, group_size=128, bits=4, pack=True),
    "odd_group_stays_unpacked": dict(K=75, N=16, group_size=128, bits=4, pack=True),  # g = 75
    "tiny": dict(K=64, N=128, group_size=128, bits=8, pack=False),  # K < group_size: one group of 64
}


def _weight(case, seed=0, zero_group=False):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((case["K"], case["N"])) * 0.05).astype(np.float32)
    if zero_group:
        w[:case["K"] // 2, 3] = 0.0  # an all-zero (group, column)
        w[:, 5] = 0.0
    return w


def _both(case, w):
    kw = dict(group_size=case["group_size"], bits=case["bits"], pack=case["pack"])
    jq, js = jqm.quantize_weight_kgroups(jnp.asarray(w), **kw)
    tq, ts = tqm.quantize_weight_kgroups(torch.from_numpy(w), **kw)
    return (np.asarray(jq), np.asarray(js)), (tq, ts)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("zero_group", [False, True])
def test_quantizer_codes_and_scales_equal_jax_bit_for_bit(name, zero_group):
    case = CASES[name]
    (jq, js), (tq, ts) = _both(case, _weight(case, zero_group=zero_group))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    if zero_group:
        assert (ts.numpy()[:, 5] == 1.0).all()  # an all-zero group has scale 1.0
    packed = tq.shape[0] != case["K"]
    assert packed == (name in ("int4_packed", "packed_small_group"))
    want = np.asarray(jqm._dequantize_kgroups(jnp.asarray(jq), jnp.asarray(js), packed))
    np.testing.assert_array_equal(tqm._dequantize_kgroups(tq, ts, packed).numpy(), want)


def test_packed_nibble_order():
    """Byte row r of a group holds code r in the low nibble and code r + g/2 in the high one."""
    K, N, g = 8, 2, 8
    w = np.zeros((K, N), np.float32)
    w[:, 0] = [1, 2, 3, 4, -5, -6, -7, 7]  # absmax 7 -> scale 1: the codes are the values
    q, scales = tqm.quantize_weight_kgroups(torch.from_numpy(w), group_size=g, bits=4, pack=True)
    assert tuple(q.shape) == (4, 2) and float(scales[0, 0]) == 1.0
    byte = q[:, 0].to(torch.int32) & 255
    assert (byte & 15).tolist() == [1, 2, 3, 4]
    assert (byte >> 4).tolist() == [(-5) & 15, (-6) & 15, (-7) & 15, 7]
    assert tqm._unpack_int4(q.to(torch.int32).reshape(1, 4, 2), dim=1)[0, :, 0].tolist() == w[:, 0].tolist()


def test_block_that_divides_matches_jax():
    from deepspeed_tpu.ops.pallas._utils import block_that_divides as jax_block

    for n, want in [(2048, 128), (192, 128), (75, 128), (64, 128), (14336, 128), (100, 64), (7, 4)]:
        assert block_that_divides(n, want) == jax_block(n, want)


@pytest.mark.parametrize("M", [1, 5, 64])
@pytest.mark.parametrize("name", ["int8", "int4_packed"])
def test_quantized_matmul_matches_jax_xla_and_pallas(name, M):
    case = dict(CASES[name], K=256, N=128)  # a shape the Pallas kernel conforms to
    (jq, js), (tq, ts) = _both(case, _weight(case, seed=1))
    packed = case["pack"]
    x = np.random.default_rng(M).standard_normal((M, case["K"])).astype(np.float32)
    assert jqm._conforming(jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js), packed)
    want_xla = np.asarray(jqm.quantized_matmul_xla(jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js), packed=packed))
    want_pallas = np.asarray(jqm.quantized_matmul_pallas(jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js),
                                                         packed=packed, interpret=True))
    before = tqm.quantized_matmul.launches
    got = tqm.quantized_matmul(torch.from_numpy(x), tq, ts, packed=packed)
    assert tqm.quantized_matmul.launches == before  # a CPU call takes the plain version
    assert torch.equal(got, tqm.quantized_matmul_ref(torch.from_numpy(x), tq, ts, packed=packed))
    tol = 1e-4 * np.abs(want_xla).max()
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=0, atol=tol)


@pytest.mark.parametrize("name", ["int8", "int4_packed", "odd_group_stays_unpacked"])
def test_quantized_matmul_bf16_x(name):
    case = CASES[name]
    (jq, js), (tq, ts) = _both(case, _weight(case, seed=2))
    packed = tq.shape[0] != case["K"]
    x = np.random.default_rng(7).standard_normal((5, case["K"])).astype(np.float32)
    want = jqm.quantized_matmul_xla(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(jq), jnp.asarray(js),
                                    packed=packed)
    got = tqm.quantized_matmul(torch.from_numpy(x).to(torch.bfloat16), tq, ts, packed=packed)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2 * np.abs(want).max())


def test_shape_past_the_reference_group_limit():
    """More K-groups than the Pallas kernel unrolls: the reference takes XLA, the port has no limit."""
    case = dict(K=(jqm.MAX_GROUPS + 6) * 16, N=48, group_size=16, bits=8, pack=False)
    (jq, js), (tq, ts) = _both(case, _weight(case, seed=3))
    assert ts.shape[0] == jqm.MAX_GROUPS + 6
    x = np.random.default_rng(8).standard_normal((3, case["K"])).astype(np.float32)
    assert not jqm._conforming(jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js), False)
    want = np.asarray(jqm.quantized_matmul_xla(jnp.asarray(x), jnp.asarray(jq), jnp.asarray(js)))
    got = tqm.quantized_matmul(torch.from_numpy(x), tq, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
