"""Port parity: DS4Sci_EvoformerAttention and the flash kernels' bias variants.

The same numpy inputs (fp32) go through the JAX package and the port:
- each plain version of a bias kernel (forward with a bias tile, dq with
  dbias, collapsed dq with summed dbias, dk/dv with a bias), reached through
  the port's wrappers on CPU tensors, against the Pallas bodies in interpret
  mode (``_flash_fwd`` / ``_flash_bwd``), for the four ways programs share a
  bias slice, Sqb in {1, Sq}, an uncollapsed bias, causal on and off;
- ``evoformer_attention``'s output and the gradients of q, k, v and every
  bias: the port's kernel route (``evoformer_flash``, plain versions on the
  CPU) against JAX's ``interpret=True``, and its CPU route against
  ``interpret=False``;
- ``attention_chunked`` with a bias and a chunk smaller than Sk.
Tolerance: 1e-5 max abs (the same fp32 math in another summation order;
values are O(1), dbias sums at most a dozen programs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import attention_chunked as jax_chunked
from deepspeed_tpu.ops.evoformer import evoformer_attention as jax_evoformer
from deepspeed_tpu.ops.pallas.flash_attention import _bh_slopes, _flash_bwd, _flash_fwd
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.attention import attention_chunked
from deepspeed_tpu_torch.ops.evoformer import DS4Sci_EvoformerAttention, evoformer_attention, evoformer_flash

TOL = 1e-5


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.standard_normal(s).astype(np.float32)


# (B, Sq, Sk, H, D, 4-D bias shape, repeat, causal)
KERNEL_CASES = {
    "shared_by_all": (4, 24, 24, 2, 8, (1, 1, 24, 24), 1, False),
    "shared_by_all_one_row": (4, 24, 24, 2, 8, (1, 1, 1, 24), 1, False),
    "batch_repeat_heads_share": (6, 16, 16, 2, 8, (2, 1, 16, 16), 3, False),
    "batch_repeat_heads_share_one_row": (6, 16, 16, 2, 8, (2, 1, 1, 16), 3, False),
    "heads_only": (3, 20, 20, 2, 8, (1, 2, 20, 20), 1, False),
    "heads_only_one_row_causal": (3, 20, 20, 2, 8, (1, 2, 1, 20), 1, True),
    "batch_repeat_and_heads": (4, 20, 28, 2, 8, (2, 2, 20, 28), 2, False),
    "batch_repeat_and_heads_one_row_causal": (4, 20, 28, 2, 8, (2, 2, 1, 28), 2, True),
    "uncollapsed": (2, 24, 24, 2, 8, (2, 2, 24, 24), 1, False),
    "uncollapsed_causal_sq_lt_sk": (2, 18, 30, 2, 8, (2, 2, 18, 30), 1, True),
    "heads_only_causal": (2, 37, 37, 2, 8, (1, 2, 37, 37), 1, True),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_each_plain_bias_kernel_matches_the_pallas_body(name):
    B, Sq, Sk, H, D, shape, repeat, causal = KERNEL_CASES[name]
    mk = _rng(sum(shape) + B)
    q, k, v, do = mk(B, Sq, H, D), mk(B, Sk, H, D), mk(B, Sk, H, D), mk(B, Sq, H, D)
    Bb, Hb, Sqb, _ = shape
    bias = (mk(*shape) * 0.5).reshape(Bb * Hb, Sqb, Sk)
    meta = (Bb, Hb, Sqb, repeat if Bb > 1 else 1)
    scale = D**-0.5
    # JAX: the Pallas bodies in interpret mode over (B*H, S, D)
    to_bh = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], D))
    jargs = (jnp.asarray(bias), scale, causal, True, False, 0, meta, H, H)
    slopes = _bh_slopes(jnp.zeros((H,), jnp.float32), B, H)
    jo, jlse = _flash_fwd(to_bh(q), to_bh(k), to_bh(v), slopes, *jargs)
    jdq, jdk, jdv, jdbias = _flash_bwd(to_bh(q), to_bh(k), to_bh(v), jo, jlse, to_bh(do), slopes, *jargs)
    back = lambda x, S: np.asarray(x).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    # the port: its wrappers on CPU tensors run the plain versions
    t = [torch.from_numpy(x) for x in (q, k, v, do, bias)]
    launches = [fn.launches for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dq_collapsed, fa.flash_bwd_dkv)]
    args = (None, scale, causal, 0, t[4], meta)
    o, lse = fa.flash_fwd(*t[:3], *args)
    bwd = (*t[:3], t[3], lse, fa.flash_delta(o, t[3]), *args)
    if fa.bias_is_collapsed(meta, B, H):
        dq, dbias = fa.flash_bwd_dq_collapsed(*bwd)
    else:
        dbias = torch.empty_like(t[4])
        dq = fa.flash_bwd_dq(*bwd, dbias)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    assert launches == [fn.launches for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dq_collapsed,
                                               fa.flash_bwd_dkv)]
    want = dict(o=back(jo, Sq), lse=np.asarray(jlse)[..., 0].reshape(B, H, Sq), dq=back(jdq, Sq),
                dk=back(jdk, Sk), dv=back(jdv, Sk), dbias=np.asarray(jdbias))
    got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv, dbias=dbias)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, atol=TOL, rtol=0, err_msg=key)


def _evo_inputs(case, seed):
    mk = _rng(seed)
    if case == "batch_broadcast_pair":  # the case of the JAX package's test_dbias_matches_fallback
        B, L, H, D = 2, 12, 2, 8
        q, k, v = mk(B, L, H, D), mk(B, L, H, D), mk(B, L, H, D)
        return q, k, v, [mk(1, H, L, L)]
    B, N, L, H, D = 2, 3, 12, 2, 8
    q, k, v = mk(B, N, L, H, D), mk(B, N, L, H, D), mk(B, N, L, H, D)
    mask = np.where(mk(B, N, 1, 1, L) > 1.0, np.float32(-1e9), np.float32(0.0))  # a mask bias: finite
    mask[..., 0] = 0.0
    biases = {
        "msa_row_mask_and_pair": [mask, mk(B, 1, H, L, L)],  # the summed bias is uncollapsed
        "pair_only": [mk(B, 1, H, L, L)],                    # collapsed: repeat = N
        "mask_only": [mask],                                 # collapsed, one row per slice
        "irregular": [mk(1, N, H, L, L)],                    # broadcast batch before a full dim: expanded
        "no_bias": [],
    }[case]
    return q, k, v, biases


EVO_CASES = ["msa_row_mask_and_pair", "pair_only", "mask_only", "batch_broadcast_pair", "irregular", "no_bias"]


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("case", EVO_CASES)
def test_evoformer_attention_matches_jax(case, route):
    """Output and the gradients of q, k, v and every bias; the kernel route
    against JAX's Pallas route (interpret), the CPU route against its jnp one."""
    q, k, v, biases = _evo_inputs(case, seed=len(case))
    do = _rng(7)(*q.shape)
    interpret = route == "kernel"
    f = lambda q, k, v, *b: jax_evoformer(q, k, v, list(b), interpret=interpret)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, *biases)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, *biases)]
    fn = evoformer_flash if interpret else evoformer_attention
    out = fn(leaves[0], leaves[1], leaves[2], leaves[3:])
    out.backward(torch.from_numpy(do))
    got = [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"output/grad {i}")


def test_cpu_tensors_take_the_plain_route():
    """On the CPU, DS4Sci_EvoformerAttention is the einsum route (no kernel
    launch) and equals the kernel route's plain versions."""
    q, k, v, biases = _evo_inputs("msa_row_mask_and_pair", seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v, *biases)]
    n0 = fa.flash_fwd.launches
    a = DS4Sci_EvoformerAttention(t[0], t[1], t[2], t[3:])
    b = evoformer_flash(t[0], t[1], t[2], t[3:])
    assert fa.flash_fwd.launches == n0
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL)


@pytest.mark.parametrize("kw", [dict(causal=False), dict(causal=True), dict(causal=True, window=9)])
def test_attention_chunked_with_a_bias_matches_jax(kw):
    """The CPU route for huge evoformer inputs, on the same arrays as JAX's
    ``attention_chunked``: chunk 8 < Sk 21 (a padded last chunk), output and
    the gradients of q, k, v and the bias."""
    mk = _rng(11)
    B, S, H, D = 2, 21, 2, 8
    q, k, v, do = mk(B, S, H, D), mk(B, S, H, D), mk(B, S, H, D), mk(B, S, H, D)
    bias = mk(1, H, S, S)
    f = lambda q, k, v, b: jax_chunked(q, k, v, bias=b, chunk=8, **kw)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, bias)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias)]
    out = attention_chunked(*leaves[:3], bias=leaves[3], chunk=8, **kw)
    out.backward(torch.from_numpy(do))
    got = [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"output/grad {i}")
