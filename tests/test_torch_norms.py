"""Port parity: deepspeed_tpu_torch.ops.norms against the JAX reference.

Inputs are drawn with numpy from a seed and fed to both frameworks on the
CPU. The port's ``rms_norm`` on a CPU tensor is its plain version; it is
held to the Pallas kernel in interpret mode and to ``rms_norm_xla`` at
1e-5 (fp32, both compute the same fp32 statistics; the gap is summation
order). The CUDA kernel's own checks are in ``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.norms import rms_norm as jax_rms_norm
from deepspeed_tpu.ops.pallas.norms import rms_norm_xla
from deepspeed_tpu_torch.ops.norms import rms_norm, rms_norm_ref

TOL = 1e-5


@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 128), (1, 3, 4096)])
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
