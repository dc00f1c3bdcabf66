"""Port parity: deepspeed_tpu_torch.ops.norms against the JAX reference.

Inputs are drawn with numpy from a seed and fed to both frameworks on the
CPU. The port's ``rms_norm`` and ``layer_norm`` on a CPU tensor are their
plain versions; they are held to the Pallas kernels in interpret mode and to
``rms_norm_xla`` / ``layer_norm_xla`` at 1e-5 (fp32, both compute the same
fp32 statistics; the gap is summation order), outputs and gradients, and at
1e-2 for a bfloat16 input (one rounding step of the output is 2**-8 of a
value). The CUDA kernels' own checks are in ``test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.pallas.norms import layer_norm as jax_layer_norm
from deepspeed_tpu.ops.pallas.norms import layer_norm_xla
from deepspeed_tpu.ops.pallas.norms import rms_norm as jax_rms_norm
from deepspeed_tpu.ops.pallas.norms import rms_norm_xla
from deepspeed_tpu_torch.ops.norms import layer_norm, layer_norm_ref, rms_norm, rms_norm_ref

TOL = 1e-5


# (300, 4096): llama3_8b's width at a few hundred rows; (1, 12, 32, 128): the qk-norm, rows = T x H of head_dim
@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 128), (1, 3, 4096), (300, 4096), (1, 12, 32, 128)])
@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm_matches_jax(shape, offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3.0
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    if offset:  # gemma's (1 + w), added in fp32 by the serving norm
        w = 1.0 + w
    want_pallas = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, interpret=True))
    want_xla = np.asarray(rms_norm_xla(jnp.asarray(x), jnp.asarray(w), 1e-5))
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy()
    np.testing.assert_allclose(got, want_pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_xla, rtol=TOL, atol=TOL)


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    before = rms_norm.launches
    out = rms_norm(x, w)
    assert rms_norm.launches == before
    assert torch.equal(out, rms_norm_ref(x, w))


def test_output_keeps_input_dtype():
    x = torch.ones((2, 16), dtype=torch.bfloat16)
    w = torch.full((16,), 2.0, dtype=torch.float32)
    out = rms_norm(x, w)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), torch.full((2, 16), 2.0))


def test_rms_norm_gradients_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2.0
    w = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    want = jax.grad(lambda a, b: jnp.sum(jax_rms_norm(a, b, 1e-5, interpret=True) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    (rms_norm(tx, tw, 1e-5) * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((tx.grad, tw.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 128), (1, 3, 2048), (300, 2048)])
@pytest.mark.parametrize("mean", [0.0, 50.0])
def test_layer_norm_matches_jax(shape, mean):
    rng = np.random.default_rng(3)
    # a large mean is where E[x^2] - mean^2 would cancel; the reference takes squared deviations
    x = rng.standard_normal(shape).astype(np.float32) * 3.0 + np.float32(mean)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want_pallas = np.asarray(jax_layer_norm(*(jnp.asarray(a) for a in (x, w, b)), 1e-5, interpret=True))
    want_xla = np.asarray(layer_norm_xla(*(jnp.asarray(a) for a in (x, w, b)), 1e-5))
    got = layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5).numpy()
    np.testing.assert_allclose(got, want_pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_xla, rtol=TOL, atol=TOL)


def test_layer_norm_gradients_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2.0 + 1.0
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((3, 5, 64)).astype(np.float32)
    for fn in (lambda *a: jax_layer_norm(*a, 1e-5, interpret=True), lambda *a: layer_norm_xla(*a, 1e-5)):
        want = jax.grad(lambda a, c, d: jnp.sum(fn(a, c, d) * g), argnums=(0, 1, 2))(
            *(jnp.asarray(t) for t in (x, w, b)))
        leaves = [torch.from_numpy(t).requires_grad_(True) for t in (x, w, b)]
        (layer_norm(*leaves, 1e-5) * torch.from_numpy(g)).sum().backward()
        for got, ref in zip(leaves, want):
            np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_layer_norm_bf16_input_and_mixed_parameter_dtype(wdtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 7, 256)).astype(np.float32) * 2.0
    w, b = (rng.standard_normal(256).astype(np.float32) for _ in range(2))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw, tb = torch.from_numpy(w).to(wdtype), torch.from_numpy(b).to(wdtype)
    jdt = jnp.bfloat16 if wdtype == torch.bfloat16 else jnp.float32
    want = layer_norm_xla(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt),
                          1e-5)
    got = layer_norm(tx, tw, tb, 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=1e-2, atol=1e-2)
    # fp32 input with parameters of another dtype keeps fp32 output
    got32 = layer_norm(torch.from_numpy(x), tw, tb, 1e-5)
    want32 = layer_norm_xla(jnp.asarray(x), jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt), 1e-5)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_rms_norm_bf16_input_and_mixed_weight_dtype(wdtype):
    """bf16 activations with the fp32 weights converted from the JAX package (and with bf16 weights), at
    llama3_8b's width; fp32 input with a weight of either dtype keeps fp32 output."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 40, 4096)).astype(np.float32) * 2.0
    w = rng.standard_normal(4096).astype(np.float32)
    tw = torch.from_numpy(w).to(wdtype)
    jw = jnp.asarray(w).astype(jnp.bfloat16 if wdtype == torch.bfloat16 else jnp.float32)
    want = rms_norm_xla(jnp.asarray(x).astype(jnp.bfloat16), jw, 1e-5)
    got = rms_norm(torch.from_numpy(x).to(torch.bfloat16), tw, 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=1e-2, atol=1e-2)
    want_pallas = jax_rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jw, 1e-5, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want_pallas.astype(jnp.float32)), rtol=1e-2,
                               atol=1e-2)
    got32 = rms_norm(torch.from_numpy(x), tw, 1e-5)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(rms_norm_xla(jnp.asarray(x), jw, 1e-5)), rtol=TOL, atol=TOL)


def test_layer_norm_cpu_call_takes_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(6)
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((4, 32), (32,), (32,)))
    before = layer_norm.launches
    out = layer_norm(x, w, b)
    assert layer_norm.launches == before
    assert torch.equal(out, layer_norm_ref(x, w, b))
