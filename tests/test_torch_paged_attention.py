"""Port parity: deepspeed_tpu_torch.ops.paged_attention against the JAX reference.

Random pools, block tables and queries are drawn with numpy from a seed and
fed to both frameworks on the CPU in fp32. The port's plain versions of the
decode and prefill kernels are held to the JAX Pallas kernels in interpret
mode and to the gather reference at 1e-5 (same fp32 math; summation order
differs). The CUDA kernels' own checks are in ``test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import alibi_slopes
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.inference.v2 import modules as v2_modules
from deepspeed_tpu_torch.models import TransformerConfig
from deepspeed_tpu_torch.ops import paged_attention as tpa

TOL = 1e-5


def _pools(rng, n_blocks, bs, kvh, d):
    kp = rng.standard_normal((n_blocks, bs, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, kvh, d)).astype(np.float32)
    return kp, vp


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _decode_case(heads, ctx, bs=8, d=16, seed=0):
    h, kvh = heads
    rng = np.random.default_rng(seed)
    B, P = len(ctx), 5
    n_blocks = B * P + 1
    kp, vp = _pools(rng, n_blocks, bs, kvh, d)
    q = rng.standard_normal((B, h, d)).astype(np.float32)
    bt = (1 + rng.permutation(n_blocks - 1)[:B * P]).reshape(B, P).astype(np.int32)
    return q, kp, vp, bt, np.asarray(ctx, np.int32)


HEADS = {"gqa": (4, 2), "mha": (2, 2)}
EDGE_CTX = [1, 8, 9, 23, 40]  # ctx at page edges for bs = 8: 1, bs, bs + 1; plus a full table


@pytest.mark.parametrize("heads", list(HEADS))
def test_decode_matches_jax_kernel_and_ref(heads):
    q, kp, vp, bt, ctx = _decode_case(HEADS[heads], EDGE_CTX)
    want = np.asarray(jpa.paged_attention_decode(*_j(q, kp, vp, bt, ctx), interpret=True))
    want_ref = np.asarray(jpa.paged_attention_ref(*_j(q[:, None], kp, vp, bt, ctx, (ctx - 1)[:, None]))[:, 0])
    got = tpa.paged_attention_decode(*_t(q, kp, vp, bt, ctx)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("feature", ["alibi", "window", "both"])
def test_decode_alibi_window_plain_matches_jax(feature):
    q, kp, vp, bt, ctx = _decode_case(HEADS["gqa"], [5, 17, 40], seed=1)
    sl = alibi_slopes(4) if feature in ("alibi", "both") else None
    win = 9 if feature in ("window", "both") else None
    want = np.asarray(jpa.paged_attention_decode(*_j(q, kp, vp, bt, ctx), interpret=True, alibi_slopes=sl,
                                                 window=win))
    got = tpa.paged_attention_decode(*_t(q, kp, vp, bt, ctx), alibi_slopes=sl, window=win).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_decode_empty_row_writes_zeros():
    q, kp, vp, bt, ctx = _decode_case(HEADS["gqa"], [0, 5])
    got = tpa.paged_attention_decode(*_t(q, kp, vp, bt, ctx)).numpy()
    assert np.all(got[0] == 0.0)
    assert np.all(np.isfinite(got))


def _prefill_case(heads, S=8, bs=8, d=16, P=5, seed=1):
    h, kvh = heads
    rng = np.random.default_rng(seed)
    B = 2
    n_blocks = B * P + 1
    kp, vp = _pools(rng, n_blocks, bs, kvh, d)
    q = rng.standard_normal((B, S, h, d)).astype(np.float32)
    bt = (1 + rng.permutation(n_blocks - 1)[:B * P]).reshape(B, P).astype(np.int32)
    # row 0: fresh prefill (history 0); row 1: a chunk that continues a context
    q0 = np.asarray([0, 13], np.int32)
    ctx = q0 + S
    pos = (q0[:, None] + np.arange(S, dtype=np.int32)[None, :]).astype(np.int32)
    return q, kp, vp, bt, ctx, pos


@pytest.mark.parametrize("heads", list(HEADS))
def test_prefill_matches_jax_kernel_and_ref(heads):
    q, kp, vp, bt, ctx, pos = _prefill_case(HEADS[heads])
    want = np.asarray(jpa.paged_attention_prefill(*_j(q, kp, vp, bt, ctx, pos), interpret=True))
    want_ref = np.asarray(jpa.paged_attention_ref(*_j(q, kp, vp, bt, ctx, pos)))
    got = tpa.paged_attention_prefill(*_t(q, kp, vp, bt, ctx, pos)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want_ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("feature", ["alibi", "window", "both"])
def test_prefill_alibi_window_plain_matches_jax(feature):
    q, kp, vp, bt, ctx, pos = _prefill_case(HEADS["gqa"], seed=2)
    sl = alibi_slopes(4) if feature in ("alibi", "both") else None
    win = 6 if feature in ("window", "both") else None
    want = np.asarray(jpa.paged_attention_prefill(*_j(q, kp, vp, bt, ctx, pos), interpret=True, alibi_slopes=sl,
                                                  window=win))
    got = tpa.paged_attention_prefill(*_t(q, kp, vp, bt, ctx, pos), alibi_slopes=sl, window=win).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("feature", [None, "alibi", "window"])
def test_gather_reference_matches_jax(feature):
    q, kp, vp, bt, ctx, pos = _prefill_case(HEADS["gqa"], seed=3)
    sl = alibi_slopes(4) if feature == "alibi" else None
    win = 5 if feature == "window" else None
    want = np.asarray(jpa.paged_attention_ref(*_j(q, kp, vp, bt, ctx, pos),
                                              alibi_slopes=None if sl is None else jnp.asarray(sl), window=win))
    got = tpa.paged_attention_ref(*_t(q, kp, vp, bt, ctx, pos), alibi_slopes=sl, window=win).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_update_kv_pages_matches_jax_and_writes_in_place():
    rng = np.random.default_rng(4)
    kp, vp = _pools(rng, 6, 8, 2, 16)
    k_new = rng.standard_normal((5, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((5, 2, 16)).astype(np.float32)
    slots = np.asarray([9, 10, 17, 40, 47], np.int32)
    jk, jv = jpa.update_kv_pages(*_j(kp, vp, k_new, v_new, slots))
    tk, tv, tkn, tvn, ts = _t(kp, vp, k_new, v_new, slots)
    ok, ov = tpa.update_kv_pages(tk, tv, tkn, tvn, ts)
    assert ok is tk and ov is tv  # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _mixed_case(n_dec, n_pre, chunk, seed=5):
    rng = np.random.default_rng(seed)
    H, KVH, D, bs, P = 4, 2, 16, 8, 4
    N = n_dec + n_pre
    T = n_dec + n_pre * chunk
    n_blocks = N * P + 1
    kp, vp = _pools(rng, n_blocks, bs, KVH, D)
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    bt = (1 + rng.permutation(n_blocks - 1)[:N * P]).reshape(N, P).astype(np.int32)
    ctx = np.zeros((N,), np.int32)
    pos = np.zeros((T,), np.int32)
    ctx[:n_dec] = rng.integers(1, P * bs - 1, n_dec)
    pos[:n_dec] = ctx[:n_dec] - 1
    for r in range(n_pre):
        start = int(rng.integers(0, P * bs - chunk))
        ctx[n_dec + r] = start + chunk
        pos[n_dec + r * chunk:n_dec + (r + 1) * chunk] = start + np.arange(chunk)
    return q, kp, vp, bt, ctx, pos


@pytest.mark.parametrize("n_dec,n_pre,chunk,calls", [
    (3, 2, 5, ("decode", "prefill")),  # mixed quantum: both kernels back to back
    (2, 3, 1, ("decode",)),            # one-token chunks are decode-shaped: one decode launch
    (0, 2, 6, ("prefill",)),           # pure prefill
    (4, 0, 0, ("decode",)),            # pure decode
])
def test_mixed_routing_matches_jax(n_dec, n_pre, chunk, calls):
    q, kp, vp, bt, ctx, pos = _mixed_case(n_dec, n_pre, chunk)
    jdec = lambda *a: jpa.paged_attention_decode(*a, interpret=True)
    want = np.asarray(jpa.paged_attention_mixed(*_j(q, kp, vp, bt, ctx, pos), n_dec=n_dec, chunk=chunk,
                                                decode_fn=jdec, prefill_fn=None))
    seen = []

    def dec(*a):
        seen.append("decode")
        return tpa.paged_attention_decode(*a)

    def pre(*a):
        seen.append("prefill")
        return tpa.paged_attention_prefill(*a)

    got = tpa.paged_attention_mixed(*_t(q, kp, vp, bt, ctx, pos), n_dec=n_dec, chunk=chunk, decode_fn=dec,
                                    prefill_fn=pre).numpy()
    assert tuple(seen) == calls
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cpu_calls_count_no_launch():
    q, kp, vp, bt, ctx, pos = _prefill_case(HEADS["gqa"])
    d0, p0 = tpa.paged_attention_decode.launches, tpa.paged_attention_prefill.launches
    tpa.paged_attention_prefill(*_t(q, kp, vp, bt, ctx, pos))
    tpa.paged_attention_decode(*_t(q[:, 0], kp, vp, bt, ctx))
    assert (tpa.paged_attention_decode.launches, tpa.paged_attention_prefill.launches) == (d0, p0)


def _spy_wrappers(monkeypatch):
    """Record calls to the kernel wrappers (they still run: CPU tensors take the plain versions)."""
    seen = []
    for name in ("paged_attention_decode", "paged_attention_prefill"):
        fn = getattr(tpa, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            seen.append(_name.rsplit("_", 1)[1])
            return _fn(*a, **kw)

        monkeypatch.setattr(tpa, name, spy)
        monkeypatch.setattr(v2_modules, name, spy)
    return seen


@pytest.mark.parametrize("feature", [None, "alibi", "window"])
def test_mixed_defaults_to_the_kernel_wrappers(feature, monkeypatch):
    # no decode_fn/prefill_fn: the wrappers run, with scale/ALiBi/window bound
    q, kp, vp, bt, ctx, pos = _mixed_case(3, 2, 5, seed=6)
    sl = alibi_slopes(4) if feature == "alibi" else None
    win = 7 if feature == "window" else None
    want = np.asarray(jpa.paged_attention_mixed(*_j(q, kp, vp, bt, ctx, pos), n_dec=3, chunk=5, scale=0.3,
                                                alibi_slopes=sl, window=win))
    seen = _spy_wrappers(monkeypatch)
    got = tpa.paged_attention_mixed(*_t(q, kp, vp, bt, ctx, pos), n_dec=3, chunk=5, scale=0.3, alibi_slopes=sl,
                                    window=win).numpy()
    assert seen == ["decode", "prefill"]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("decode", [True, False])
def test_attention_module_defaults_to_the_kernel_wrappers(decode, monkeypatch):
    cfg = TransformerConfig(vocab_size=32, n_layers=1, n_heads=4, n_kv_heads=2, d_model=64, dtype=torch.float32,
                            sliding_window=6)
    if decode:
        q, kp, vp, bt, ctx = _decode_case(HEADS["gqa"], [5, 17, 40], seed=7)
        q, pos = q[:, None], (ctx - 1)[:, None]
    else:
        q, kp, vp, bt, ctx, pos = _prefill_case(HEADS["gqa"], seed=7)
    want = np.asarray(jpa.paged_attention_ref(*_j(q, kp, vp, bt, ctx, pos), window=6))
    seen = _spy_wrappers(monkeypatch)
    got = v2_modules.attention_tpu(cfg, *_t(q, kp, vp, bt, ctx, pos), decode=decode).numpy()
    assert seen == ["decode" if decode else "prefill"]
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
