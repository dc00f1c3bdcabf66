"""Port parity: flash attention (kernels A, B, C through their plain versions).

On the CPU the port's ``flash_attention`` runs the same autograd function as
on the card, with each kernel wrapper taking its plain version. The same
numpy inputs go through the JAX ``flash_attention(..., interpret=True)`` (the
Pallas kernels in interpret mode) and ``jax.grad`` through it.
Tolerance: 2e-5 abs on outputs and gradients, in fp32 (the same fp32 math
in another summation order; values are O(1)); 1e-5 for an additive bias and
its gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.attention import attention_xla as jax_attention_xla
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.models import alibi_slopes
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.attention import attention, attention_xla

TOL = 2e-5


def _inputs(B, Sq, Sk, H, KVH, D, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, Sq, H, D), mk(B, Sk, KVH, D), mk(B, Sk, KVH, D), mk(B, Sq, H, D)


def _jax_out_and_grads(q, k, v, do, **kw):
    f = lambda q, k, v: jax_flash(q, k, v, interpret=True, **kw)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(t) for t in (o, *vjp(jnp.asarray(do)))]


def _torch_out_and_grads(fn, q, k, v, do, **kw):
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    o = fn(*leaves, **kw)
    o.backward(torch.from_numpy(do))
    return [o.detach().numpy()] + [t.grad.numpy() for t in leaves]


CASES = {
    "causal_mha": dict(shape=(2, 64, 64, 4, 4, 16), kw=dict(causal=True)),
    "noncausal_mha": dict(shape=(2, 64, 64, 4, 4, 16), kw=dict(causal=False)),
    "causal_rep2": dict(shape=(1, 64, 64, 4, 2, 16), kw=dict(causal=True)),
    "causal_rep4": dict(shape=(1, 64, 64, 8, 2, 32), kw=dict(causal=True)),
    "window": dict(shape=(1, 128, 128, 4, 2, 16), kw=dict(causal=True, window=24)),
    "alibi": dict(shape=(1, 64, 64, 4, 4, 16), kw=dict(causal=True, alibi_slopes=alibi_slopes(4))),
    "sq_lt_sk": dict(shape=(2, 32, 96, 4, 2, 16), kw=dict(causal=True)),
    "sq_gt_sk": dict(shape=(2, 96, 64, 4, 2, 16), kw=dict(causal=True)),  # leading rows see no key
    "noncausal_sq_lt_sk": dict(shape=(1, 32, 64, 4, 2, 16), kw=dict(causal=False)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    case = CASES[name]
    q, k, v, do = _inputs(*case["shape"])
    want = _jax_out_and_grads(q, k, v, do, **case["kw"])
    n0 = fa.flash_fwd.launches
    got = _torch_out_and_grads(fa.flash_attention, q, k, v, do, **case["kw"])
    assert fa.flash_fwd.launches == n0  # CPU tensors take the plain versions: no launch
    for label, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=label)


def _np_lse(q, k, scale, causal, window, slopes):
    """(B, H, Sq) log-sum-exp of the masked scores in float64; NEG_INF for a row that sees no key."""
    n_rep = q.shape[2] // k.shape[2]
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), np.repeat(k, n_rep, axis=2).astype(np.float64)) * scale
    Sq, Sk = q.shape[1], k.shape[1]
    cols = np.arange(Sk)
    if slopes is not None:
        s = s + slopes.astype(np.float64)[None, :, None, None] * cols
    vis = np.ones((Sq, Sk), bool)
    if causal:
        rows = np.arange(Sq)[:, None] + (Sk - Sq)
        vis = (cols <= rows) & ((cols > rows - window) if window else True)
    seen = vis.any(-1)
    m = np.where(vis, s, -np.inf).max(-1, initial=-np.inf)
    m = np.where(seen, m, 0.0)
    lse = m + np.log(np.where(vis, np.exp(s - m[..., None]), 0.0).sum(-1) + ~seen)
    return np.where(seen, lse, fa.NEG_INF)


# (B, Sq, Sk, H, KVH, D), then the mask: ragged lengths one below and above the CUDA kernels' 64- and
# 128-row tiles, a window whose edge crosses a tile, Sq > Sk with a window (leading rows see no key),
# four query heads a KV head, ALiBi
PIECE_CASES = {
    "causal_rep2_d16": ((1, 64, 64, 4, 2, 16), dict(causal=True, scale=0.25)),
    "ragged_63_65_d32": ((1, 63, 65, 4, 4, 32), dict(causal=True)),
    "ragged_129_127_d64_noncausal": ((1, 129, 127, 2, 2, 64), dict(causal=False)),
    "window_crossing_rep4_d32": ((1, 130, 130, 4, 1, 32), dict(causal=True, window=40)),
    "sq_gt_sk_window_d32": ((1, 96, 65, 4, 2, 32), dict(causal=True, window=24)),
    "alibi_rep4_d64": ((1, 127, 129, 8, 2, 64), dict(causal=True, alibi=True)),
}


@pytest.mark.parametrize("name", sorted(PIECE_CASES))
def test_each_plain_kernel_matches_the_reference_pieces(name):
    """Kernel A's plain version gives JAX's o and the masked log-sum-exp; B and
    C's give the dq and (dk, dv) of JAX's vjp when fed the same lse and delta."""
    (B, Sq, Sk, H, KVH, D), kw = PIECE_CASES[name]
    causal, window = kw["causal"], kw.get("window", 0)
    scale = kw.get("scale", D**-0.5)
    slopes = alibi_slopes(H) if kw.get("alibi") else None
    q, k, v, do = _inputs(B, Sq, Sk, H, KVH, D, seed=1)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    args = (torch.from_numpy(slopes) if slopes is not None else None, scale, causal, window)
    o, lse = fa.flash_fwd(t[0], t[1], t[2], *args)
    np.testing.assert_allclose(lse.numpy(), _np_lse(q, k, scale, causal, window, slopes), atol=1e-5)
    delta = fa.flash_delta(o, t[3])
    dq = fa.flash_bwd_dq(*t[:3], t[3], lse, delta, *args)
    dk, dv = fa.flash_bwd_dkv(*t[:3], t[3], lse, delta, *args)
    want = _jax_out_and_grads(q, k, v, do, causal=causal, scale=scale, window=window or None, alibi_slopes=slopes)
    for label, g, w in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, err_msg=label)


@pytest.mark.parametrize("route", ["segment_ids", "kv_len"])
def test_routes_to_the_plain_path_as_jax_does(route):
    """Packed segments and padded KV go to ``attention_xla`` in both packages."""
    q, k, v, do = _inputs(2, 32, 32, 4, 2, 16, seed=2)
    if route == "segment_ids":
        seg = np.array([[0] * 20 + [1] * 12, [0] * 8 + [1] * 24], np.int32)
        jkw, tkw = dict(segment_ids=jnp.asarray(seg)), dict(segment_ids=torch.from_numpy(seg))
    else:
        jkw, tkw = dict(kv_len=24), dict(kv_len=24)
    assert fa.routes_to_plain(True, **tkw)
    assert not fa.routes_to_plain(True, window=8, alibi_slopes=[1.0])
    assert fa.routes_to_plain(False, window=8) and fa.routes_to_plain(False, alibi_slopes=[1.0])
    want = _jax_out_and_grads(q, k, v, do, causal=True, **jkw)
    got = _torch_out_and_grads(fa.flash_attention, q, k, v, do, causal=True, **tkw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL)


@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False, window=5),
                                dict(causal=True, alibi_slopes=alibi_slopes(4))])
def test_plain_attention_matches_attention_xla(kw):
    """``attention`` on CPU tensors is the plain ``attention_xla``; held to JAX's."""
    q, k, v, _ = _inputs(2, 24, 24, 4, 2, 8, seed=3)
    want = np.asarray(jax_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(attention_xla(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy(), want,
                               atol=TOL)


# (B, Sq, Sk, H, KVH, D, 4-D bias shape, bias_repeat, extra keywords); ``masked_row``: that query row
# carries -1e9 on every key (a finite score, so its p comes out uniform, not zero)
BIAS_CASES = {
    "gqa_bias_repeat": (4, 16, 16, 4, 2, 8, (2, 4, 16, 16), 2, dict(causal=False)),
    "gqa_collapsed_causal": (2, 16, 24, 4, 1, 8, (1, 1, 16, 24), 1, dict(causal=True)),
    "full_bias_causal": (2, 16, 16, 2, 2, 8, (2, 2, 16, 16), 1, dict(causal=True)),
    "mask_row_window": (2, 20, 20, 2, 2, 8, (2, 1, 1, 20), 1, dict(causal=True, window=6)),
    "routed_plain_with_repeat": (4, 16, 16, 2, 2, 8, (2, 1, 16, 16), 2, dict(causal=True, kv_len=12)),
    "full_bias_alibi_window": (2, 24, 24, 2, 2, 8, (2, 2, 24, 24), 1,
                               dict(causal=True, window=7, alibi_slopes=alibi_slopes(2))),
    "full_bias_masked_row": (2, 16, 16, 2, 2, 8, (2, 2, 16, 16), 1, dict(causal=False, masked_row=5)),
}


@pytest.mark.parametrize("name", sorted(BIAS_CASES))
def test_flash_attention_with_a_bias_matches_jax(name):
    """``flash_attention(bias=..., bias_repeat=...)``: output and the gradients
    of q, k, v (collapsed back to the KV heads under GQA) and of the bias, in
    the bias's own shape; on CPU tensors through the kernels' plain versions."""
    B, Sq, Sk, H, KVH, D, shape, repeat, kw = BIAS_CASES[name]
    kw = dict(kw)
    masked_row = kw.pop("masked_row", None)
    q, k, v, do = _inputs(B, Sq, Sk, H, KVH, D, seed=len(name))
    bias = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    if masked_row is not None:
        bias[..., masked_row, :] = -1e9
    f = lambda q, k, v, b: jax_flash(q, k, v, bias=b, bias_repeat=repeat, interpret=True, **kw)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v, bias)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, bias)]
    out = fa.flash_attention(*leaves[:3], bias=leaves[3], bias_repeat=repeat, **kw)
    out.backward(torch.from_numpy(do))
    got = [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    for label, g, w in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == w.shape, label
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=label)


@pytest.mark.parametrize("shape,repeat", [((3, 2, 32, 32), 1), ((4, 2, 32, 31), 1), ((4, 3, 32, 32), 1),
                                          ((4, 2, 7, 32), 1), ((2, 2, 32, 32), 3)])
def test_bad_bias_shape_raises_as_jax_does(shape, repeat):
    q, k, v, _ = _inputs(4, 32, 32, 2, 2, 8, seed=9)
    bias = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="broadcastable") as want:
        jax_flash(*(jnp.asarray(x) for x in (q, k, v)), causal=False, bias=jnp.asarray(bias), bias_repeat=repeat,
                  interpret=True)
    with pytest.raises(ValueError, match="broadcastable") as got:
        fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=False, bias=torch.from_numpy(bias),
                           bias_repeat=repeat)
    assert str(got.value) == str(want.value)
