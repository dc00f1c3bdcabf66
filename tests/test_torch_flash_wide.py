"""Port parity: flash attention at the Hugging Face families' head dims.

The CUDA bodies at D 80 (phi-2), 96 (phi-3-mini, gpt-neox-20b) and 256
(gemma, gpt-j) are ``csrc/flash_fwd_wide.cu``, ``flash_dq_wide.cu``,
``flash_dkv_wide.cu`` and ``flash_fp32_wide.cu``; their plain versions are
the same functions as at D 32-128. On the CPU the port's ``flash_attention``
runs the autograd function over those plain versions; the same numpy inputs
go through the JAX ``flash_attention(..., interpret=True)`` (the Pallas
kernels in interpret mode, whose BlockSpecs take any D) and ``jax.vjp``.
Causal, window, ALiBi, GQA / MQA and Sq < Sk, at S <= 128.

Tolerance: 2e-5 abs on outputs and gradients, in fp32 (the same fp32 math in
another summation order; values are O(1), and D 256 sums 256 products a score),
as ``test_torch_flash_attention.py``; lse 1e-5 against a float64 numpy lse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.models import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as fa

TOL = 2e-5

# (B, Sq, Sk, H, KVH, D), then the mask
CASES = {
    "d80_causal_mha": ((2, 64, 64, 4, 4, 80), dict(causal=True)),
    "d80_window": ((1, 128, 128, 2, 2, 80), dict(causal=True, window=24)),
    "d96_causal_gqa": ((1, 64, 64, 4, 2, 96), dict(causal=True)),
    "d96_alibi": ((1, 96, 96, 4, 4, 96), dict(causal=True, alibi=True)),
    "d256_causal_mqa": ((1, 64, 64, 8, 1, 256), dict(causal=True)),  # gemma-2b's 8 query heads on 1 KV head
    "d256_noncausal_sq_lt_sk": ((1, 32, 96, 2, 1, 256), dict(causal=False)),
    "d256_window_alibi_sq_lt_sk": ((1, 64, 96, 2, 2, 256), dict(causal=True, window=40, alibi=True)),
}


def _inputs(B, Sq, Sk, H, KVH, D, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, Sq, H, D), mk(B, Sk, KVH, D), mk(B, Sk, KVH, D), mk(B, Sq, H, D)


def _jax_out_and_grads(q, k, v, do, **kw):
    f = lambda q, k, v: jax_flash(q, k, v, interpret=True, **kw)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(do)))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_wide_head_dims_match_jax(name):
    """The autograd function (the plain forward, dq and dk/dv) against JAX's output and vjp."""
    (B, Sq, Sk, H, KVH, D), mask = CASES[name]
    kw = dict(causal=mask["causal"], window=mask.get("window"),
              alibi_slopes=alibi_slopes(H) if mask.get("alibi") else None)
    q, k, v, do = _inputs(B, Sq, Sk, H, KVH, D)
    want = _jax_out_and_grads(q, k, v, do, **kw)
    n0 = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*leaves, **kw)
    o.backward(torch.from_numpy(do))
    got = [o.detach().numpy()] + [t.grad.numpy() for t in leaves]
    # CPU tensors take the plain versions: no launch
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == n0
    for label, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=label)


@pytest.mark.parametrize("D", [80, 96, 256])
def test_each_plain_kernel_at_wide_head_dims(D):
    """The forward's lse against float64 numpy, and dq, dk/dv fed that lse and delta against JAX's vjp: each
    plain version alone, ragged lengths (one past the 64- and 128-row tiles), four query heads a KV head."""
    B, Sq, Sk, H, KVH = 1, 65, 129, 4, 1
    q, k, v, do = _inputs(B, Sq, Sk, H, KVH, D, seed=1)
    scale = D**-0.5
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o, lse = fa.flash_fwd(t[0], t[1], t[2], None, scale, True, 0)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), np.repeat(k, H // KVH, axis=2).astype(np.float64)) * scale
    vis = np.arange(Sk)[None, :] <= np.arange(Sq)[:, None] + (Sk - Sq)
    s = np.where(vis, s, -np.inf)
    m = s.max(-1)
    np.testing.assert_allclose(lse.numpy(), m + np.log(np.exp(s - m[..., None]).sum(-1)), atol=1e-5)
    delta = fa.flash_delta(o, t[3])
    dq = fa.flash_bwd_dq(*t, lse, delta, None, scale, True, 0)
    dk, dv = fa.flash_bwd_dkv(*t, lse, delta, None, scale, True, 0)
    want = _jax_out_and_grads(q, k, v, do, causal=True, scale=scale)
    for label, g, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, err_msg=label)
