"""Port parity: int8 paged KV pools against the JAX reference.

Entries, pools and queries are drawn with numpy from a seed and fed to both
frameworks on the CPU in fp32. ``quantize_kv`` must equal the reference bit
for bit (same fp32 operations in the same order), and so must the codes and
scale planes that ``update_kv_pages`` writes into a ``(codes, scales)`` pool.
The port's plain versions of decode, prefill and the mixed routing on int8
pools are held to the JAX Pallas kernels in interpret mode and to the gather
reference at 1e-5 (same fp32 math on the same codes; summation order
differs). The CUDA kernels' own checks are in ``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as tpa

TOL = 1e-5
HEADS = {"gqa": (4, 2), "mha": (2, 2)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _filled(heads, ctx, bs=8, d=16, P=5, seed=0):
    """Both frameworks' int8 pools after the same appends: rows of ``ctx``
    tokens on shuffled blocks, block 0 never written (scale 0, the garbage page)."""
    _, kvh = HEADS[heads]
    rng = np.random.default_rng(seed)
    B = len(ctx)
    n_blocks = B * P + 1
    bt = (1 + rng.permutation(n_blocks - 1)[:B * P]).reshape(B, P).astype(np.int32)
    slots = np.concatenate([bt[b, np.arange(c) // bs] * bs + np.arange(c) % bs for b, c in enumerate(ctx)])
    k_new = (rng.standard_normal((len(slots), kvh, d)) * 2.0).astype(np.float32)
    v_new = rng.standard_normal((len(slots), kvh, d)).astype(np.float32)
    k_new[1] = 0.0  # an all-zero entry: scale 1.0, codes 0
    shape = (n_blocks, bs, kvh, d)
    jk, jv = jpa.update_kv_pages(jpa.make_kv_pool(shape, jnp.float32, 8), jpa.make_kv_pool(shape, jnp.float32, 8),
                                 jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots.astype(np.int32)))
    tk, tv = tpa.make_kv_pool(shape, torch.float32, "cpu", 8), tpa.make_kv_pool(shape, torch.float32, "cpu", 8)
    out = tpa.update_kv_pages(tk, tv, _t(k_new), _t(v_new), _t(slots.astype(np.int32)))
    assert out[0] is tk and out[1] is tv  # written in place
    return rng, bt, np.asarray(ctx, np.int32), (jk, jv), (tk, tv), (k_new, v_new, slots)


def test_quantize_kv_equals_jax_bit_for_bit_and_roundtrip_is_bounded():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 2, 32)) * 3.0).astype(np.float32)
    x[5] = 0.0
    jc, js = jpa.quantize_kv(jnp.asarray(x))
    tc, ts = tpa.quantize_kv(_t(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32 and tuple(ts.shape) == (64, 2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = tpa.dequantize_kv((tc, ts)).numpy()
    np.testing.assert_array_equal(back, np.asarray(jpa.dequantize_kv((jc, js))))
    # symmetric rounding: per-row error <= half a step = amax / 254
    step = np.abs(x).max(axis=-1)[..., None] / 254.0
    assert np.all(np.abs(back - x) <= step + 1e-7)
    assert np.all(back[5] == 0.0) and np.all(ts.numpy()[5] == 1.0)  # all-zero rows stay exact


def test_pool_helpers():
    pool = tpa.make_kv_pool((3, 4, 8, 2, 16), torch.float32, "cpu", kv_quant_bits=8)
    assert tpa.kv_pool_is_quantized(pool) and tpa.kv_pool_shape(pool) == (3, 4, 8, 2, 16)
    assert pool[0].dtype == torch.int8 and pool[1].dtype == torch.float32 and tuple(pool[1].shape) == (3, 4, 8, 2)
    layer = tpa.kv_layer(pool, 1)
    layer[0][2, 3] = 7
    layer[1][2, 3] = 0.5
    assert pool[0][1, 2, 3].eq(7).all() and pool[1][1, 2, 3].eq(0.5).all()  # views of both members
    plain = tpa.make_kv_pool((4, 8, 2, 16), torch.bfloat16, "cpu")
    assert not tpa.kv_pool_is_quantized(plain) and plain.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        tpa.make_kv_pool((4, 8, 2, 16), torch.float32, "cpu", kv_quant_bits=4)


@pytest.mark.parametrize("heads", list(HEADS))
def test_update_kv_pages_on_an_int8_pool_equals_jax(heads):
    _, _, _, (jk, jv), (tk, tv), (k_new, _, slots) = _filled(heads, [5, 17, 8])
    for (jc, js), (tc, ts) in ((jk, tk), (jv, tv)):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.all(tk[1].numpy()[0] == 0.0)  # block 0 was never written: scale 0
    # overwriting one slot rewrites its own scale and no neighbour's
    before = tk[1].clone()
    tpa.update_kv_pages(tk, tv, _t(k_new[:1] * 10.0), _t(k_new[:1]), _t(slots[:1].astype(np.int32)))
    changed = (tk[1] != before).reshape(-1, tk[1].shape[-1]).any(-1).nonzero().flatten().tolist()
    assert changed == [int(slots[0])]


@pytest.mark.parametrize("heads", list(HEADS))
def test_decode_on_int8_pools_matches_jax_kernel_and_ref(heads):
    # contexts at page edges for bs = 8 (1, bs, bs + 1), a full table, and a padded row on the garbage page
    rng, bt, ctx, (jk, jv), (tk, tv), _ = _filled(heads, [1, 8, 9, 23, 40, 1])
    bt[-1] = 0
    h = HEADS[heads][0]
    q = rng.standard_normal((len(ctx), h, 16)).astype(np.float32)
    want = np.asarray(jpa.paged_attention_decode(jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(ctx),
                                                 interpret=True))
    want_ref = np.asarray(jpa.paged_attention_ref(jnp.asarray(q[:, None]), jk, jv, jnp.asarray(bt), jnp.asarray(ctx),
                                                  jnp.asarray((ctx - 1)[:, None]))[:, 0])
    got = tpa.paged_attention_decode(_t(q), tk, tv, _t(bt), _t(ctx)).numpy()
    assert np.all(np.isfinite(got)) and np.all(got[-1] == 0.0)  # never-written slots dequantise to 0
    np.testing.assert_allclose(got[:-1], want[:-1], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[:-1], want_ref[:-1], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("heads", list(HEADS))
def test_prefill_on_int8_pools_matches_jax_kernel_and_ref(heads):
    S = 8
    q0 = np.asarray([0, 13, 8], np.int32)  # fresh; continuing mid-page; continuing from a page edge
    rng, bt, ctx, (jk, jv), (tk, tv), _ = _filled(heads, (q0 + S).tolist(), seed=1)
    h = HEADS[heads][0]
    q = rng.standard_normal((3, S, h, 16)).astype(np.float32)
    pos = (q0[:, None] + np.arange(S, dtype=np.int32)[None]).astype(np.int32)
    args = (jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(pos))
    want = np.asarray(jpa.paged_attention_prefill(jnp.asarray(q), jk, jv, *args, interpret=True))
    want_ref = np.asarray(jpa.paged_attention_ref(jnp.asarray(q), jk, jv, *args))
    got = tpa.paged_attention_prefill(_t(q), tk, tv, _t(bt), _t(ctx), _t(pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)
    got_ref = tpa.paged_attention_ref(_t(q), tk, tv, _t(bt), _t(ctx), _t(pos)).numpy()
    np.testing.assert_allclose(got_ref, want_ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("heads", list(HEADS))
def test_mixed_on_int8_pools_matches_jax(heads):
    """Two decode rows and two 4-token chunks of one fused quantum, pools passed through as tuples."""
    n_dec, chunk = 2, 4
    starts = np.asarray([11, 16, 0, 9], np.int32)  # decode rows query at ctx - 1; chunks start here
    ctx = np.asarray([12, 17, 4, 13], np.int32)
    rng, bt, _, (jk, jv), (tk, tv), _ = _filled(heads, ctx.tolist(), seed=2)
    h = HEADS[heads][0]
    T = n_dec + 2 * chunk
    q = rng.standard_normal((T, h, 16)).astype(np.float32)
    pos = np.concatenate([starts[:2], starts[2] + np.arange(chunk), starts[3] + np.arange(chunk)]).astype(np.int32)
    want = np.asarray(jpa.paged_attention_mixed(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(ctx), jnp.asarray(pos), n_dec=n_dec, chunk=chunk,
        decode_fn=lambda *a: jpa.paged_attention_decode(*a, interpret=True),
        prefill_fn=lambda *a: jpa.paged_attention_prefill(*a, interpret=True)))
    got = tpa.paged_attention_mixed(_t(q), tk, tv, _t(bt), _t(ctx), _t(pos), n_dec=n_dec, chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_int8_error_against_the_fp32_pool_is_bounded():
    """End to end, the quantiser's amax/254 step through softmax-weighted averaging stays under 5e-2."""
    rng, bt, ctx, _, (tk, tv), (k_new, v_new, slots) = _filled("gqa", [5, 17, 8], seed=3)
    shape = tpa.kv_pool_shape(tk)
    fk, fv = tpa.make_kv_pool(shape, torch.float32, "cpu"), tpa.make_kv_pool(shape, torch.float32, "cpu")
    tpa.update_kv_pages(fk, fv, _t(k_new), _t(v_new), _t(slots.astype(np.int32)))
    q = _t(rng.standard_normal((3, 4, 16)).astype(np.float32))
    err = (tpa.paged_attention_decode(q, tk, tv, _t(bt), _t(ctx))
           - tpa.paged_attention_decode(q, fk, fv, _t(bt), _t(ctx))).abs().max().item()
    assert 0.0 < err < 5e-2, err
