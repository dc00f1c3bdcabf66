"""Port parity: block-sparse attention (SparseSelfAttention) against the JAX package.

The same numpy inputs (fp32) go through ``deepspeed_tpu.ops.sparse_attention``
and ``deepspeed_tpu_torch.ops.sparse_attention``:
- the five sparsity configs' layouts, the active-block lists and the token
  masks, bit for bit, over a grid of blocks, heads, per-head layouts,
  global patterns, directions, seeds and lengths;
- the plain versions of the three kernels (reached through the port's
  wrappers on CPU tensors) against the Pallas bodies in interpret mode
  (``_sp_fwd`` / ``_sp_bwd``), as ``tests/unit/test_sparse_attention.py``
  runs them: o, lse (lane 0), dq, dk, dv;
- ``sparse_attention`` / ``SparseSelfAttention`` output and autograd
  gradients against ``jax.vjp`` of JAX ``sparse_attention(...,
  interpret=True)``, GQA included;
- a layout with an empty query row, the dense layout against plain
  attention, the ``num_heads`` check, and the device rule.
Tolerance: 1e-5 of max(1, max |want|) (the same fp32 math in another
summation order; values are O(1)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jss
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops import sparse_attention as sa
from deepspeed_tpu_torch.ops.attention import attention_xla
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as ss
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

TOL = 1e-5
KINDS = ["DenseSparsityConfig", "FixedSparsityConfig", "BSLongformerSparsityConfig", "BigBirdSparsityConfig",
         "VariableSparsityConfig"]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = TOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _pair(kind, **kw):
    """The same config on each side: (JAX config, port config)."""
    return getattr(jsc, kind)(**kw), getattr(tsc, kind)(**kw)


def _variants(kind, block, heads):
    """Every field combination the grid covers for one kind."""
    out = []
    for per_head in (False, True):
        base = dict(num_heads=heads, block=block, different_layout_per_head=per_head)
        if kind == "DenseSparsityConfig":
            out.append(base)
            continue
        for attention in ("bidirectional", "unidirectional"):
            kw = dict(base, attention=attention)
            if kind == "FixedSparsityConfig":
                out += [dict(kw, num_local_blocks=L, num_global_blocks=G, num_different_global_patterns=P,
                             horizontal_global_attention=hz)
                        for L, G, P, hz in ((4, 1, 1, False), (4, 1, 4, False), (2, 1, 1, True), (3, 2, 1, False))]
            elif kind == "BSLongformerSparsityConfig":
                out += [dict(kw, num_sliding_window_blocks=3, global_block_indices=[0]),
                        dict(kw, num_sliding_window_blocks=5, global_block_indices=[1, 5],
                             global_block_end_indices=[3, 6])]
            elif kind == "BigBirdSparsityConfig":
                out += [dict(kw, num_random_blocks=r, num_global_blocks=g, seed=seed)
                        for r, g, seed in ((1, 1, 0), (3, 1, 1), (2, 2, 0))]
            else:
                out += [dict(kw, num_random_blocks=r, local_window_blocks=w, global_block_indices=[0, 3],
                             horizontal_global_attention=hz, seed=seed)
                        for r, w, hz, seed in ((0, [4], False, 0), (1, [1, 2, 3], True, 0), (2, [2], False, 1))]
    return out


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_layouts_lists_and_masks_equal_jax_bit_for_bit(kind, block, heads):
    for kw in _variants(kind, block, heads):
        jcfg, tcfg = _pair(kind, **kw)
        for S in (64, 128, 256):
            want, got = jcfg.make_layout(S), tcfg.make_layout(S)
            assert got.dtype == want.dtype == np.bool_ and np.array_equal(got, want), (kw, S)
            for causal in (True, False):
                for g, w in zip(ss._active_lists(got, causal), jss._active_lists(want, causal)):
                    assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w), (kw, S, causal)
                assert np.array_equal(ss.layout_to_token_mask(got, block, causal),
                                      jss.layout_to_token_mask(want, block, causal))
    with pytest.raises(ValueError, match="multiple of block"):
        jcfg.make_layout(block * 4 + 8)
    with pytest.raises(ValueError, match="multiple of block"):
        tcfg.make_layout(block * 4 + 8)


def test_active_lists_at_the_main_case_equal_jax():
    """The vectorised list build against the reference's loop at the gpt2_1_3b
    case of chip_smoke.py (S 8192, 32 heads, block 16, causal): A = 131,
    Aq = 509; the cached device lists are the same arrays, built once."""
    kw = dict(num_heads=32, block=16, num_local_blocks=4, num_global_blocks=1, attention="unidirectional")
    jcfg, tcfg = _pair("FixedSparsityConfig", **kw)
    want = jss._active_lists(jcfg.make_layout(8192), True)
    kidx, qidx = ss._device_lists(tcfg, 8192, 32, True, torch.device("cpu"))
    assert kidx.shape == (32, 512, 131) and qidx.shape == (32, 512, 509)
    assert np.array_equal(kidx.numpy(), want[0]) and np.array_equal(qidx.numpy(), want[1])
    again = ss._device_lists(tsc.FixedSparsityConfig(**kw), 8192, 32, True, torch.device("cpu"))
    assert again[0] is kidx and again[1] is qidx
    other = ss._device_lists(tsc.FixedSparsityConfig(**dict(kw, num_local_blocks=8)), 8192, 32, True, "cpu")
    assert other[0] is not kidx and other[0].shape != kidx.shape


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.standard_normal(s).astype(np.float32)


KERNEL_CONFIGS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=2, block=16)),
    "fixed": ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=2, different_layout_per_head=True,
                                          num_different_global_patterns=2)),
    "longformer": ("BSLongformerSparsityConfig", dict(num_heads=2, block=32, global_block_indices=[1])),
    "bigbird": ("BigBirdSparsityConfig", dict(num_heads=2, block=16, num_random_blocks=2,
                                              different_layout_per_head=True)),
    "variable": ("VariableSparsityConfig", dict(num_heads=1, block=16, local_window_blocks=[1, 3],
                                                global_block_indices=[2], num_random_blocks=1)),
}


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", sorted(KERNEL_CONFIGS))
def test_each_plain_kernel_matches_the_pallas_body(name, causal, D):
    B, S, H = 2, 128, 2
    kind, kw = KERNEL_CONFIGS[name]
    jcfg, tcfg = _pair(kind, **kw)
    layout = np.broadcast_to(tcfg.make_layout(S), (H, S // kw["block"], S // kw["block"]))
    kidx, qidx = ss._active_lists(layout, causal)
    mk = _rng(len(name) + D + causal)
    q, k, v, do = (mk(B, S, H, D) for _ in range(4))
    blk, scale = kw["block"], D**-0.5
    # JAX: the Pallas bodies in interpret mode over (B*H, S, D)
    to_bh = lambda x: jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, S, D))
    jlayout = np.broadcast_to(jcfg.make_layout(S), layout.shape)
    jk, jq = (jnp.asarray(x) for x in jss._active_lists(jlayout, causal))
    jo, jlse = jss._sp_fwd(to_bh(q), to_bh(k), to_bh(v), jk, H, blk, scale, causal, True)
    jdq, jdk, jdv = jss._sp_bwd(to_bh(q), to_bh(k), to_bh(v), jo, jlse, to_bh(do), jk, jq, H, blk, scale, causal,
                                True)
    back = lambda x: np.asarray(x).reshape(B, H, S, D).transpose(0, 2, 1, 3)
    # the port: its wrappers on CPU tensors run the plain versions, and launch nothing
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    tk, tq = torch.from_numpy(kidx), torch.from_numpy(qidx)
    counters = (ss.sparse_fwd, ss.sparse_bwd_dq, ss.sparse_bwd_dkv)
    launches = [fn.launches for fn in counters]
    o, lse = ss.sparse_fwd(*t[:3], tk, blk, scale, causal)
    delta = ss.flash_delta(o, t[3])
    dq = ss.sparse_bwd_dq(*t, lse, delta, tk, blk, scale, causal)
    dk, dv = ss.sparse_bwd_dkv(*t, lse, delta, tq, blk, scale, causal)
    assert launches == [fn.launches for fn in counters]
    want = dict(o=back(jo), lse=np.asarray(jlse)[..., 0].reshape(B, H, S), dq=back(jdq), dk=back(jdk), dv=back(jdv))
    for key, got in dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv).items():
        _close(got.numpy(), want[key], key)


# (kind, config fields, B, S, H, KV heads, D, causal)
PATH_CASES = {
    "fixed_uni": ("FixedSparsityConfig", dict(num_heads=2, block=16, num_local_blocks=2, attention="unidirectional"),
                  2, 128, 2, 2, 32, True),
    "fixed_bi_per_head": ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=4,
                                                      different_layout_per_head=True,
                                                      num_different_global_patterns=4), 1, 256, 4, 4, 16, False),
    "bigbird": ("BigBirdSparsityConfig", dict(num_heads=2, block=32, num_random_blocks=1), 2, 128, 2, 2, 16, False),
    "longformer_gqa": ("BSLongformerSparsityConfig", dict(num_heads=4, block=16, attention="unidirectional"),
                       2, 128, 4, 2, 32, True),
    "variable_one_head_layout": ("VariableSparsityConfig", dict(num_heads=1, block=16, local_window_blocks=[2]),
                                 1, 128, 2, 2, 16, True),
    "fixed_gqa_bi": ("FixedSparsityConfig", dict(num_heads=4, block=16, num_local_blocks=2), 1, 128, 4, 2, 32, False),
}


@pytest.mark.parametrize("name", sorted(PATH_CASES))
def test_sparse_attention_and_its_gradients_match_jax(name):
    """Output and the gradients of q, k and v: the port's autograd function
    (the plain versions on the CPU) against jax.vjp through JAX's Pallas
    route in interpret mode."""
    kind, kw, B, S, H, KVH, D, causal = PATH_CASES[name]
    jcfg, tcfg = _pair(kind, **kw)
    mk = _rng(len(name))
    q, k, v, do = mk(B, S, H, D), mk(B, S, KVH, D), mk(B, S, KVH, D), mk(B, S, H, D)
    f = lambda q, k, v: jss.sparse_attention(q, k, v, jcfg, causal=causal, interpret=True)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = sa.SparseSelfAttention(tcfg, causal=causal)(*leaves)
    out.backward(torch.from_numpy(do))
    got = [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"output/grad {i}")


def _hole(base):
    """A test-local config class on top of a side's SparsityConfig: a fixed
    layout whose query block 2 attends nothing (the same numpy layout on
    each side)."""

    @dataclasses.dataclass
    class HoleConfig(base):
        def make_layout(self, seq_len):
            lay = self.setup_layout(seq_len)
            nb = lay.shape[1]
            lay[:, np.arange(nb), np.arange(nb)] = True
            lay[:, :, 0] = True
            lay[:, 2, :] = False
            return lay

    return HoleConfig(num_heads=2, block=16)


@pytest.mark.parametrize("causal", [True, False])
def test_an_empty_query_row_gives_zeros_and_equal_gradients(causal):
    B, S, H, D = 2, 128, 2, 16
    mk = _rng(11)
    q, k, v, do = (mk(B, S, H, D) for _ in range(4))
    f = lambda q, k, v: jss.sparse_attention(q, k, v, _hole(jsc.SparsityConfig), causal=causal, interpret=True)
    o, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = sa.sparse_attention(*leaves, _hole(tsc.SparsityConfig), causal=causal)
    out.backward(torch.from_numpy(do))
    got = [out.detach().numpy()] + [t.grad.numpy() for t in leaves]
    assert np.all(got[0][:, 32:48] == 0.0) and np.all(got[1][:, 32:48] == 0.0)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(g).all()
        _close(g, w, f"output/grad {i}")
    # the dense-masked oracle gives zeros for that row too
    layout = _hole(tsc.SparsityConfig).make_layout(S)
    ref = ss.sparse_attention_xla(*(torch.from_numpy(x) for x in (q, k, v)), layout, 16, causal=causal)
    jref = jss.sparse_attention_xla(*(jnp.asarray(x) for x in (q, k, v)), layout, 16, causal=causal)
    _close(ref.numpy(), np.asarray(jref), "sparse_attention_xla")
    _close(out.detach().numpy(), ref.numpy(), "kernel route vs the dense oracle")


@pytest.mark.parametrize("causal", [True, False])
def test_the_dense_layout_equals_plain_attention(causal):
    mk = _rng(5)
    q, k, v = (torch.from_numpy(mk(2, 64, 2, 32)) for _ in range(3))
    out = sa.sparse_attention(q, k, v, tsc.DenseSparsityConfig(num_heads=2, block=16), causal=causal)
    _close(out.numpy(), attention_xla(q, k, v, causal=causal).numpy(), "dense layout")


def test_the_num_heads_check_matches_jax():
    mk = _rng(6)
    q = mk(1, 64, 4, 16)
    with pytest.raises(ValueError, match="num_heads 2 != attention heads 4") as want:
        jss.sparse_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), jsc.FixedSparsityConfig(num_heads=2),
                             interpret=True)
    with pytest.raises(ValueError, match="num_heads 2 != attention heads 4") as got:
        t = torch.from_numpy(q)
        sa.sparse_attention(t, t, t, tsc.FixedSparsityConfig(num_heads=2))
    assert str(got.value) == str(want.value)


def test_tensors_off_the_cpu_never_take_the_plain_route():
    """The plain versions run only for CPU tensors: any other device goes to
    the kernels, which raise here (no card) before anything is launched."""
    cfg = tsc.FixedSparsityConfig(num_heads=2, block=16)
    q = torch.empty((1, 64, 2, 32), device="meta")
    kidx, qidx = (t.to("meta") for t in ss._device_lists(cfg, 64, 2, True, "cpu"))
    lse = torch.empty((1, 2, 64), device="meta")
    counters = (ss.sparse_fwd, ss.sparse_bwd_dq, ss.sparse_bwd_dkv)
    launches = [fn.launches for fn in counters]
    for call in (lambda: ss.sparse_fwd(q, q, q, kidx, 16, 1.0, True),
                 lambda: ss.sparse_bwd_dq(q, q, q, q, lse, lse, kidx, 16, 1.0, True),
                 lambda: ss.sparse_bwd_dkv(q, q, q, q, lse, lse, qidx, 16, 1.0, True),
                 lambda: sa.sparse_attention(q, q, q, cfg)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert launches == [fn.launches for fn in counters]
