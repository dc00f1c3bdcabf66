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


# ---------------------------------------------------------------- the bf16 dk/dv kernel's plan (numpy, on the host)
def _plan_groups(plan):
    """{(head, members): [(slot, first entry, entries), ...] in slot order}: each group of the plan with its
    pieces (one piece, slot -1, for a walk that is not split)."""
    groups = {}
    for h, off, n, slot, *members in plan.items.tolist():
        groups.setdefault((h, tuple(members)), []).append((slot, off, n))
    return {key: sorted(pieces) for key, pieces in groups.items()}


def _check_plan(qidx, block, plan):
    """The plan's invariants: every key block of every head owned exactly once; each group's union walk
    covers each member's list, in ascending order, with the owner bits of exactly those entries; the split
    ranges partition each walk, in whole steps of at most DKV_SPLIT_TILES; the reduce rows name each split
    group's pieces; the longest walks come first; the plan names the block, rows, heads and key blocks it
    was made for."""
    rows, split_tiles = ss.DKV_ROWS, ss.DKV_SPLIT_TILES
    H, nb, _ = qidx.shape
    assert (plan.block, plan.rows, plan.heads, plan.n_blocks) == (block, rows, H, nb)
    R = min(block, rows)
    per_piece = max(1, split_tiles // max(1, block // ss.DKV_TILE)) * max(1, ss.DKV_TILE // block)
    assert plan.items.shape[1] == plan.reduce.shape[1] == 4 + rows // 16
    owners = np.zeros((H, nb * (block // R)), np.int64)
    reduce = {(h, tuple(members)): (slot, pieces) for h, slot, pieces, _, *members in plan.reduce.tolist()}
    slots = []
    for (h, members), pieces in _plan_groups(plan).items():
        live = [m for m in members if m >= 0]
        assert 1 <= len(live) <= rows // R and list(members[:len(live)]) == live
        assert all(m % R == 0 for m in live)
        for m in live:
            owners[h, m // R] += 1
        # the pieces: one whole walk, or consecutive slots covering it in order
        offs = [off for _, off, _ in pieces]
        walk = np.concatenate([plan.entries[off:off + n] for _, off, n in pieces])
        assert all(off + n == nxt for (_, off, n), nxt in zip(pieces, offs[1:] + [offs[0] + len(walk)]))
        if len(pieces) == 1 and pieces[0][0] == -1:
            assert (h, members) not in reduce and len(walk) <= per_piece
        else:
            assert all(n == per_piece for _, _, n in pieces[:-1]) and 1 <= pieces[-1][2] <= per_piece
            slot0 = pieces[0][0]
            assert [s for s, _, _ in pieces] == list(range(slot0, slot0 + len(pieces)))
            assert reduce.pop((h, members)) == (slot0, len(pieces))
            slots += [s for s, _, _ in pieces]
        blocks = walk.view(np.uint32) & 0xFFFFFF
        bits = walk.view(np.uint32) >> 24
        assert np.all(np.diff(blocks.astype(np.int64)) > 0)  # ascending, no repeats
        assert np.all(bits > 0) and np.all(bits < (1 << len(live)))  # each entry some member's, no other bits
        for i, m in enumerate(live):
            lst = qidx[h, m // block]
            assert np.array_equal(blocks[(bits >> i) & 1 == 1], lst[lst >= 0])
    assert np.all(owners == 1) and not reduce
    assert sorted(slots) == list(range(plan.n_slots))
    steps = ss._walk_steps(plan.items[:, 2], block, ss.DKV_TILE)
    assert np.all(np.diff(steps) <= 0) and plan.max_entries == plan.items[:, 2].max(initial=0)
    assert np.array_equal(plan.table, np.concatenate([plan.items.ravel(), plan.reduce.ravel(), plan.entries]))


def _chip_smoke_shapes():
    import chip_smoke

    return chip_smoke.SPARSE_SHAPES, chip_smoke.sparse_config


@pytest.mark.parametrize("name", ["fixed_uni_gpt2_1_3b", "fixed_bi_bert", "bigbird_base", "longformer_gqa_llama3_8b",
                                  "dense_gpt2_1_3b"])
def test_dkv_plan_at_every_chip_smoke_configuration(name):
    """chip_smoke.py's SPARSE_SHAPES at full S; the Fixed layouts group their global key blocks four to a
    CUDA block, and at S 8192 split their walks."""
    shapes, config = _chip_smoke_shapes()
    c = shapes[name]
    _, S, H, _ = c["q"]
    cfg = config(name)
    layout = np.broadcast_to(cfg.make_layout(S), (H, S // cfg.block, S // cfg.block))
    _, qidx = ss._active_lists(layout, c["causal"])
    plan = ss.dkv_plan(qidx, cfg.block)
    _check_plan(qidx, cfg.block, plan)
    if name.startswith("fixed"):
        assert (plan.items[:, 4:] >= 0).sum(1).max() == 4 and (plan.n_slots > 0) == (S == 8192)


# the test configurations: this file's kernel and path configs, and the card's SPARSE_CASES layouts
PLAN_CASES = [(kind, kw, S, causal) for kind, kw in KERNEL_CONFIGS.values() for S in (128, 256)
              for causal in (True, False)]
PLAN_CASES += [(kind, kw, S, causal) for kind, kw, _, S, _, _, _, causal in PATH_CASES.values()]
PLAN_CASES += [("FixedSparsityConfig", dict(num_heads=4, block=16, attention="unidirectional"), 2048, True),
               ("FixedSparsityConfig", dict(num_heads=4, block=16, different_layout_per_head=True,
                                            num_different_global_patterns=4), 2048, False),
               ("BigBirdSparsityConfig", dict(num_heads=2, block=64, num_random_blocks=3), 1024, False),
               ("VariableSparsityConfig", dict(num_heads=2, block=128, num_random_blocks=1, local_window_blocks=[1, 2],
                                               global_block_indices=[1]), 1024, False)]


@pytest.mark.parametrize("split_tiles", [None, 1, 2, 8])
@pytest.mark.parametrize("case", PLAN_CASES, ids=[f"{c[0][:-14]}-b{c[1]['block']}-S{c[2]}-{'uni' if c[3] else 'bi'}"
                                                  for c in PLAN_CASES])
def test_dkv_plan_invariants(case, split_tiles, monkeypatch):
    """At the test configurations, with the kernel's split length and with walks split every one, two and
    eight steps."""
    if split_tiles:
        monkeypatch.setattr(ss, "DKV_SPLIT_TILES", split_tiles)
    kind, kw, S, causal = case
    cfg = getattr(tsc, kind)(**kw)
    H = kw["num_heads"]
    layout = np.broadcast_to(cfg.make_layout(S), (H, S // cfg.block, S // cfg.block))
    _, qidx = ss._active_lists(layout, causal)
    _check_plan(qidx, cfg.block, ss.dkv_plan(qidx, cfg.block))


def _dkv_by_plan(q, k, v, do, lse, delta, qidx, plan, block, scale, causal):
    """dk and dv as the bf16 kernel computes them from the plan (in fp32): each item's members over the
    walk entries their bits name, whole walks straight out, split ones as partials summed in slot order."""
    B, S, H, D = q.shape
    R = min(block, ss.DKV_ROWS)
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    parts = {}
    for h, off, n, slot, *members in plan.items.tolist():
        walk = plan.entries[off:off + n].view(np.uint32)
        for i, m in enumerate(x for x in members if x >= 0):
            qb = torch.from_numpy((walk[(walk >> (24 + i)) & 1 == 1] & 0xFFFFFF).astype(np.int64))
            qrows = (qb[:, None] * block + torch.arange(block)).flatten()
            keys = m + torch.arange(R)
            s = torch.einsum("bqd,bkd->bkq", q[:, qrows, h], k[:, keys, h]) * scale
            if causal:
                s = torch.where(keys[:, None] <= qrows[None, :], s, torch.full((), ss.NEG_INF))
            p = torch.where(s <= ss.NEG_INF, 0.0, torch.exp(s - lse[:, h, qrows][:, None, :]))
            dp = torch.einsum("bqd,bkd->bkq", do[:, qrows, h], v[:, keys, h])
            ds = p * (dp - delta[:, h, qrows][:, None, :]) * scale
            got = (torch.einsum("bkq,bqd->bkd", ds, q[:, qrows, h]), torch.einsum("bkq,bqd->bkd", p, do[:, qrows, h]))
            if slot < 0:
                dk[:, keys, h], dv[:, keys, h] = got
            else:
                parts[(slot, h, m)] = got
    for h, slot0, pieces, _, *members in plan.reduce.tolist():
        for m in (x for x in members if x >= 0):
            keys = m + torch.arange(R)
            dk[:, keys, h] = sum(parts[(slot0 + p, h, m)][0] for p in range(pieces))
            dv[:, keys, h] = sum(parts[(slot0 + p, h, m)][1] for p in range(pieces))
    return dk, dv


@pytest.mark.parametrize("split_tiles", [None, 1])
@pytest.mark.parametrize("name", ["fixed", "longformer", "bigbird"])
def test_dkv_by_the_plan_equals_the_plain_version(name, split_tiles, monkeypatch):
    """Walking the plan (groups, owner bits, pieces and their reduce) gives the plain dk/dv kernel's dk and
    dv: the plan loses and repeats no (query, key) block pair."""
    if split_tiles:
        monkeypatch.setattr(ss, "DKV_SPLIT_TILES", split_tiles)
    kind, kw = KERNEL_CONFIGS[name]
    B, S, H, D = 1, 256, kw["num_heads"], 16
    cfg = getattr(tsc, kind)(**kw)
    mk = _rng(21)
    q, k, v, do = (torch.from_numpy(mk(B, S, H, D)) for _ in range(4))
    for causal in (True, False):
        layout = np.broadcast_to(cfg.make_layout(S), (H, S // cfg.block, S // cfg.block))
        kidx, qidx = ss._active_lists(layout, causal)
        o, lse = ss.sparse_fwd_ref(q, k, v, torch.from_numpy(kidx), cfg.block, D**-0.5, causal)
        delta = ss.flash_delta(o, do)
        plan = ss.dkv_plan(qidx, cfg.block)
        want = ss.sparse_bwd_dkv_ref(q, k, v, do, lse, delta, torch.from_numpy(qidx), cfg.block, D**-0.5, causal)
        got = _dkv_by_plan(q, k, v, do, lse, delta, qidx, plan, cfg.block, D**-0.5, causal)
        for g, w in zip(got, want):
            _close(g.numpy(), w.numpy(), f"{name} causal={causal}")


def test_the_dkv_plan_is_built_once_beside_the_lists():
    cfg = tsc.FixedSparsityConfig(num_heads=2, block=16)
    plan = ss._device_dkv_plan(cfg, 256, 2, True, "cpu")
    assert ss._device_dkv_plan(tsc.FixedSparsityConfig(num_heads=2, block=16), 256, 2, True, "cpu") is plan
    _, qidx = ss._device_lists(cfg, 256, 2, True, "cpu")
    want = ss.dkv_plan(qidx.numpy(), 16)
    assert plan.table.dtype == torch.int32 and np.array_equal(plan.table.numpy(), want.table)
    assert (plan.n_items, plan.n_reduce, plan.n_slots, plan.max_entries) == (
        len(want.items), len(want.reduce), want.n_slots, want.max_entries)
    assert (plan.block, plan.rows, plan.heads, plan.n_blocks) == (16, ss.DKV_ROWS, 2, 16)


# another configuration's plan: at another length, over other heads, at another layout block
MISMATCHED_PLANS = {"S": (16, 4, 512), "heads": (16, 2, 256), "block": (32, 4, 256)}


@pytest.mark.parametrize("what", list(MISMATCHED_PLANS))
def test_sparse_bwd_dkv_raises_on_another_configurations_plan(what):
    """A plan made for another length, head count or layout block than the call's qidx is refused before
    anything runs (on the card the kernel would read and write past its tensors)."""
    B, S, H, D = 1, 256, 4, 16
    block, plan_H, plan_S = MISMATCHED_PLANS[what]
    cfg = tsc.FixedSparsityConfig(num_heads=H, block=16)
    kidx, qidx = ss._device_lists(cfg, S, H, True, "cpu")
    plan = ss._device_dkv_plan(tsc.FixedSparsityConfig(num_heads=plan_H, block=block), plan_S, plan_H, True, "cpu")
    mk = _rng(5)
    q, k, v, do = (torch.from_numpy(mk(B, S, H, D)) for _ in range(4))
    o, lse = ss.sparse_fwd_ref(q, k, v, kidx, 16, D**-0.5, True)
    delta = ss.flash_delta(o, do)
    launches = ss.sparse_bwd_dkv.launches
    with pytest.raises(ValueError, match="the plan is for"):
        ss.sparse_bwd_dkv(q, k, v, do, lse, delta, qidx, 16, D**-0.5, True, plan=plan)
    assert ss.sparse_bwd_dkv.launches == launches
    # the call's own plan is taken, and the result is the plain version's
    own = ss._device_dkv_plan(cfg, S, H, True, "cpu")
    got = ss.sparse_bwd_dkv(q, k, v, do, lse, delta, qidx, 16, D**-0.5, True, plan=own)
    want = ss.sparse_bwd_dkv_ref(q, k, v, do, lse, delta, qidx, 16, D**-0.5, True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---------------------------------------------------------------- the bf16 forward's and dq's plan (numpy, on the host)
def _check_query_plan(kidx, block, plan):
    """The query plan's invariants: it walks kidx and names the block, rows, heads and query blocks it was
    made for; every query block of every head owned exactly once, by groups of neighbouring members; each
    group's union walk covers each member's list, in ascending order, with the owner bits of exactly those
    entries; no walk is split; the longest walks come first; the table is items, then entries."""
    rows = ss.QUERY_ROWS
    H, nb, _ = kidx.shape
    assert (plan.lists, plan.block, plan.rows, plan.heads, plan.n_blocks) == ("kidx", block, rows, H, nb)
    R = min(block, rows)
    assert plan.items.shape[1] == 4 + rows // 16 and plan.reduce.shape == (0, 4 + rows // 16) and plan.n_slots == 0
    owners = np.zeros((H, nb * (block // R)), np.int64)
    ends = []
    for h, off, n, slot, *members in plan.items.tolist():
        live = [m for m in members if m >= 0]
        assert slot == -1 and 1 <= len(live) <= rows // R and list(members[:len(live)]) == live
        assert live == list(range(live[0], live[0] + R * len(live), R)) and live[0] % rows == 0  # neighbours
        for m in live:
            owners[h, m // R] += 1
        walk = plan.entries[off:off + n]
        ends.append((off, off + n))
        blocks = walk.view(np.uint32) & 0xFFFFFF
        bits = walk.view(np.uint32) >> 24
        assert np.all(np.diff(blocks.astype(np.int64)) > 0)  # ascending, no repeats
        assert np.all(bits > 0) and np.all(bits < (1 << len(live)))  # each entry some member's, no other bits
        for i, m in enumerate(live):
            lst = kidx[h, m // block]
            assert np.array_equal(blocks[(bits >> i) & 1 == 1], lst[lst >= 0])
    assert np.all(owners == 1)
    ends.sort()
    assert all(a == b for (_, b), (a, _) in zip([(0, 0)] + ends, ends)) and ends[-1][1] == len(plan.entries)
    steps = ss._walk_steps(plan.items[:, 2], block, ss.QUERY_TILE)
    assert np.all(np.diff(steps) <= 0) and plan.max_entries == plan.items[:, 2].max(initial=0)
    assert np.array_equal(plan.table, np.concatenate([plan.items.ravel(), plan.entries]))


# (query CUDA blocks, steps over all heads, longest walk) of one batch row at chip_smoke.py's cases
QUERY_PLAN_STATS = {"fixed_uni_gpt2_1_3b": (4096, 70656, 33), "fixed_bi_bert": (768, 13056, 17),
                    "bigbird_base": (768, 7188, 64), "longformer_gqa_llama3_8b": (4096, 12192, 3),
                    "dense_gpt2_1_3b": (512, 4352, 16)}


@pytest.mark.parametrize("name", sorted(QUERY_PLAN_STATS))
def test_query_plan_at_every_chip_smoke_configuration(name):
    """chip_smoke.py's SPARSE_SHAPES at full S: one CUDA block of 64 query rows a group, the walks' steps and
    the longest walk as the lists give them (neighbouring query blocks share their windows and globals)."""
    shapes, config = _chip_smoke_shapes()
    c = shapes[name]
    _, S, H, _ = c["q"]
    cfg = config(name)
    layout = np.broadcast_to(cfg.make_layout(S), (H, S // cfg.block, S // cfg.block))
    kidx, _ = ss._active_lists(layout, c["causal"])
    plan = ss.query_plan(kidx, cfg.block)
    _check_query_plan(kidx, cfg.block, plan)
    steps = ss._walk_steps(plan.items[:, 2], cfg.block, ss.QUERY_TILE)
    assert (len(plan.items), int(steps.sum()), int(steps.max())) == QUERY_PLAN_STATS[name]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[f"{c[0][:-14]}-b{c[1]['block']}-S{c[2]}-{'uni' if c[3] else 'bi'}"
                                                  for c in PLAN_CASES])
def test_query_plan_invariants(case):
    kind, kw, S, causal = case
    cfg = getattr(tsc, kind)(**kw)
    H = kw["num_heads"]
    layout = np.broadcast_to(cfg.make_layout(S), (H, S // cfg.block, S // cfg.block))
    kidx, _ = ss._active_lists(layout, causal)
    _check_query_plan(kidx, cfg.block, ss.query_plan(kidx, cfg.block))


def _fwd_dq_by_plan(q, k, v, do, delta_lse, kidx, plan, block, scale, causal):
    """o, lse and dq as the bf16 kernels compute them from the plan (in fp32): each item's members over the
    walk entries their bits name; dq from the given (lse, delta). A member with no entry: o = 0, lse =
    NEG_INF, dq = 0."""
    B, S, H, D = q.shape
    lse_in, delta = delta_lse
    R = min(block, ss.QUERY_ROWS)
    o, dq = torch.full_like(q, float("nan")), torch.full_like(q, float("nan"))
    lse = torch.full((B, H, S), float("nan"))
    for h, off, n, slot, *members in plan.items.tolist():
        walk = plan.entries[off:off + n].view(np.uint32)
        for i, m in enumerate(x for x in members if x >= 0):
            kb = torch.from_numpy((walk[(walk >> (24 + i)) & 1 == 1] & 0xFFFFFF).astype(np.int64))
            keys = (kb[:, None] * block + torch.arange(block)).flatten()
            rows = m + torch.arange(R)
            if len(keys) == 0:
                o[:, rows, h], lse[:, h, rows], dq[:, rows, h] = 0.0, ss.NEG_INF, 0.0
                continue
            s = torch.einsum("bqd,bkd->bqk", q[:, rows, h], k[:, keys, h]) * scale
            if causal:
                s = torch.where(keys[None, :] <= rows[:, None], s, torch.full((), ss.NEG_INF))
            mx = s.amax(-1, keepdim=True)
            p = torch.where(s <= ss.NEG_INF, 0.0, torch.exp(s - mx))
            l = p.sum(-1, keepdim=True)
            o[:, rows, h] = torch.einsum("bqk,bkd->bqd", p, v[:, keys, h]) / l
            lse[:, h, rows] = (mx + torch.log(l))[..., 0]
            p = torch.where(s <= ss.NEG_INF, 0.0, torch.exp(s - lse_in[:, h, rows][..., None]))
            dp = torch.einsum("bqd,bkd->bqk", do[:, rows, h], v[:, keys, h])
            ds = p * (dp - delta[:, h, rows][..., None]) * scale
            dq[:, rows, h] = torch.einsum("bqk,bkd->bqd", ds, k[:, keys, h])
    return o, lse, dq


QUERY_WALK_CONFIGS = dict(KERNEL_CONFIGS, block128=(
    "VariableSparsityConfig", dict(num_heads=2, block=128, num_random_blocks=1, local_window_blocks=[1, 2],
                                   global_block_indices=[1])))


@pytest.mark.parametrize("name", sorted(QUERY_WALK_CONFIGS) + ["hole"])
def test_fwd_and_dq_by_the_plan_equal_the_plain_versions(name):
    """Walking the query plan (neighbouring query blocks, owner bits) gives the plain forward's o and lse and
    the plain dq's dq: the plan loses and repeats no (query, key) block pair, and a query block that attends
    nothing gets o = 0, lse = NEG_INF and dq = 0."""
    if name == "hole":
        cfg = _hole(tsc.SparsityConfig)
    else:
        kind, kw = QUERY_WALK_CONFIGS[name]
        cfg = getattr(tsc, kind)(**kw)
    B, S, H, D = 1, 512 if cfg.block == 128 else 256, 2, 16
    mk = _rng(31)
    q, k, v, do = (torch.from_numpy(mk(B, S, H, D)) for _ in range(4))
    for causal in (True, False):
        layout = np.broadcast_to(cfg.make_layout(S), (H, S // cfg.block, S // cfg.block))
        kidx, _ = ss._active_lists(layout, causal)
        tk = torch.from_numpy(kidx)
        o, lse = ss.sparse_fwd_ref(q, k, v, tk, cfg.block, D**-0.5, causal)
        delta = ss.flash_delta(o, do)
        dq = ss.sparse_bwd_dq_ref(q, k, v, do, lse, delta, tk, cfg.block, D**-0.5, causal)
        plan = ss.query_plan(kidx, cfg.block)
        got = _fwd_dq_by_plan(q, k, v, do, (lse, delta), kidx, plan, cfg.block, D**-0.5, causal)
        empty = lse <= ss.NEG_INF
        assert torch.equal(got[1][empty], lse[empty]) and (name != "hole" or empty.any())
        _close(got[1][~empty].numpy(), lse[~empty].numpy(), f"{name} lse causal={causal}")
        for g, w, what in ((got[0], o, "o"), (got[2], dq, "dq")):
            _close(g.numpy(), w.numpy(), f"{name} {what} causal={causal}")


def test_the_query_plan_is_built_once_beside_the_lists():
    cfg = tsc.FixedSparsityConfig(num_heads=2, block=16)
    plan = ss._device_query_plan(cfg, 256, 2, True, "cpu")
    assert ss._device_query_plan(tsc.FixedSparsityConfig(num_heads=2, block=16), 256, 2, True, "cpu") is plan
    assert ss._device_dkv_plan(cfg, 256, 2, True, "cpu") is not plan
    kidx, _ = ss._device_lists(cfg, 256, 2, True, "cpu")
    want = ss.query_plan(kidx.numpy(), 16)
    assert plan.table.dtype == torch.int32 and np.array_equal(plan.table.numpy(), want.table)
    assert (plan.n_items, plan.n_reduce, plan.n_slots, plan.max_entries) == (len(want.items), 0, 0, want.max_entries)
    assert (plan.lists, plan.block, plan.rows, plan.heads, plan.n_blocks) == ("kidx", 16, ss.QUERY_ROWS, 2, 16)


@pytest.mark.parametrize("what", list(MISMATCHED_PLANS) + ["lists"])
def test_sparse_fwd_and_dq_raise_on_another_configurations_plan(what):
    """A plan made for another length, head count or layout block, or the dk/dv's plan of qidx, is refused
    by the forward and dq before anything runs; the call's own plan is taken."""
    B, S, H, D = 1, 256, 4, 16
    cfg = tsc.FixedSparsityConfig(num_heads=H, block=16)
    kidx, _ = ss._device_lists(cfg, S, H, True, "cpu")
    if what == "lists":
        plan = ss._device_dkv_plan(cfg, S, H, True, "cpu")
    else:
        block, plan_H, plan_S = MISMATCHED_PLANS[what]
        plan = ss._device_query_plan(tsc.FixedSparsityConfig(num_heads=plan_H, block=block), plan_S, plan_H, True,
                                     "cpu")
    mk = _rng(7)
    q, k, v, do = (torch.from_numpy(mk(B, S, H, D)) for _ in range(4))
    o, lse = ss.sparse_fwd_ref(q, k, v, kidx, 16, D**-0.5, True)
    delta = ss.flash_delta(o, do)
    launches = (ss.sparse_fwd.launches, ss.sparse_bwd_dq.launches)
    with pytest.raises(ValueError, match="the plan is for"):
        ss.sparse_fwd(q, k, v, kidx, 16, D**-0.5, True, plan=plan)
    with pytest.raises(ValueError, match="the plan is for"):
        ss.sparse_bwd_dq(q, k, v, do, lse, delta, kidx, 16, D**-0.5, True, plan=plan)
    assert (ss.sparse_fwd.launches, ss.sparse_bwd_dq.launches) == launches
    own = ss._device_query_plan(cfg, S, H, True, "cpu")
    got = ss.sparse_fwd(q, k, v, kidx, 16, D**-0.5, True, plan=own)
    assert all(torch.equal(g, w) for g, w in zip(got, (o, lse)))
    want = ss.sparse_bwd_dq_ref(q, k, v, do, lse, delta, kidx, 16, D**-0.5, True)
    assert torch.equal(ss.sparse_bwd_dq(q, k, v, do, lse, delta, kidx, 16, D**-0.5, True, plan=own), want)


def test_bf16_off_the_cpu_without_a_plan_raises_before_the_library(monkeypatch):
    """bf16 tensors off the CPU walk a plan: without one, each of the three wrappers raises once the
    tensors pass its checks, before it loads the kernel library or counts a launch."""
    cfg = tsc.FixedSparsityConfig(num_heads=2, block=16)
    kidx, qidx = (t.to("meta") for t in ss._device_lists(cfg, 64, 2, True, "cpu"))
    q = torch.empty((1, 64, 2, 32), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 2, 64), device="meta")
    monkeypatch.setattr(ss, "_check", lambda *args: None)  # the meta tensors stand in for CUDA ones

    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(ss._build, "lib", no_library)
    counters = (ss.sparse_fwd, ss.sparse_bwd_dq, ss.sparse_bwd_dkv)
    launches = [fn.launches for fn in counters]
    for call, helper in ((lambda: ss.sparse_fwd(q, q, q, kidx, 16, 1.0, True), "_device_query_plan"),
                         (lambda: ss.sparse_bwd_dq(q, q, q, q, lse, lse, kidx, 16, 1.0, True), "_device_query_plan"),
                         (lambda: ss.sparse_bwd_dkv(q, q, q, q, lse, lse, qidx, 16, 1.0, True), "_device_dkv_plan")):
        with pytest.raises(ValueError, match=f"walks a plan; pass {helper}"):
            call()
    assert launches == [fn.launches for fn in counters]
