"""Port parity: ``ops/transformer`` (the inference op surface and the training layer).

Mirrors ``tests/unit/test_transformer_ops.py``, and holds each port function
to the JAX function of the same name on the same numpy inputs (fp32):
1e-5 abs and rel (the same fp32 math in another order; the norms' variance
is JAX's E[x^2] - E[x]^2 in flax's LayerNorm and the two-pass form here).
``DeepSpeedTransformerLayer`` with the flax layer's parameters
(``from_flax``): the output and every parameter's gradient of a squared sum
against ``jax.grad``, pre- and post-LN, with a padding mask, within 1e-5 of
each tensor's largest value (``k_proj``'s bias, whose true gradient is zero,
of the largest gradient); remat equal to no remat bit for bit (with
dropout too: the recompute draws the same masks); valid rows independent of
what the pads hold; dropout from an explicit generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops import transformer as J
from deepspeed_tpu_torch.ops import transformer as T

RNG = np.random.RandomState(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def r(*shape):
    return RNG.randn(*shape).astype(np.float32)


def _both(fn_name, *args, **kw):
    """The JAX and the port's ``fn_name`` on the same numpy arguments (None passes through), as numpy."""
    to_jax = lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a
    to_torch = lambda a: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
    want = getattr(J, fn_name)(*map(to_jax, args), **{k: to_jax(v) for k, v in kw.items()})
    got = getattr(T, fn_name)(*map(to_torch, args), **{k: to_torch(v) for k, v in kw.items()})
    as_np = lambda t: tuple(as_np(x) for x in t) if isinstance(t, tuple) else np.asarray(
        t.detach().numpy() if isinstance(t, torch.Tensor) else t)
    return as_np(got), as_np(want)


def _close(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


CASES = {
    "layer_norm": lambda: (r(2, 4, 8), r(8), r(8), 1e-5),
    "layer_norm_residual": lambda: (r(2, 4, 8), r(8), r(2, 4, 8), r(8), r(8), 1e-5, True),
    "layer_norm_residual_no_bias": lambda: (r(2, 4, 8), None, r(2, 4, 8), r(8), r(8)),
    "rms_norm": lambda: (r(2, 3, 8), r(8)),
    "pre_rms_norm": lambda: (r(2, 3, 8), r(2, 3, 8), r(8)),
    "qkv_gemm": lambda: (r(2, 4, 8), r(8, 24), r(24), r(8), r(8)),
    "fused_gemm_gelu": lambda: (r(2, 4, 8), r(8, 16), r(16), r(16, 8)),
    "linear_layer": lambda: (r(2, 4, 8), r(8, 16), r(16)),
    "vector_matmul": lambda: (r(2, 4, 8), r(8, 16)),
    "bias_add": lambda: (r(2, 4, 8), r(8)),
    "bias_gelu": lambda: (r(2, 4, 8), r(8)),
    "bias_relu": lambda: (r(2, 4, 8), r(8)),
    "bias_residual": lambda: (r(2, 4, 8), r(2, 4, 8), r(8)),
    "vector_add": lambda: (r(2, 4, 8), r(2, 4, 8), 0.5),
    "moe_res_matmul": lambda: (r(2, 3, 8), r(2, 3, 16), r(2, 3, 8)),
    "einsum_sec_sm_ecm": lambda: (r(5, 4, 3), r(5, 7)),
    "add_padding": lambda: (r(2, 4, 3, 20), r(2, 4, 3, 20), r(2, 4, 3, 20)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    fn = name.replace("_no_bias", "")
    _close(*_both(fn, *CASES[name]()))


def test_qkv_gemm_rms_flavour():
    x, w, g = r(2, 4, 8), r(8, 24), r(8)
    _close(*_both("qkv_gemm", x, w, None, g, None, eps=1e-6, norm_type="rmsnorm"))


@pytest.mark.parametrize("act", ["gelu", "gelu_exact", "relu", "silu"])
def test_mlp_gemm_activations(act):
    args = (r(2, 4, 8), r(2, 4, 8), r(8), r(8, 16), r(16), r(16, 8), r(8), r(8))
    _close(*_both("mlp_gemm", *args, activation=act))
    with pytest.raises(ValueError, match="unknown activation"):
        T.mlp_gemm(*[torch.from_numpy(a) for a in args], activation="tanh")


@pytest.mark.parametrize("kw", [dict(mlp_after_attn=True, pre_layer_norm=True),
                                dict(mlp_after_attn=True, pre_layer_norm=False),
                                dict(mlp_after_attn=False, add_bias=True), dict(mlp_after_attn=False, add_bias=False)])
def test_residual_add_bias_modes(kw):
    _close(*_both("residual_add_bias", r(2, 3, 8), r(2, 3, 8), r(2, 3, 8), r(8), r(8), mp_size=2, **kw))


@pytest.mark.parametrize("mode", ["silu", "relu", "gelu"])
def test_gated_activation(mode):
    _close(*_both("gated_activation", r(2, 3, 16), r(16), mode=mode))


def test_softmax_with_mask_alibi_and_causal():
    s = r(2, 4, 5, 7)
    mask = RNG.rand(2, 1, 5, 7) > 0.3
    _close(*_both("softmax", s, mask, r(1, 4, 1, 7), 0.5, True))


@pytest.mark.parametrize("kw", [dict(causal=True, kv_len=6), dict(causal=False), dict(causal=True, scale=0.3)])
def test_softmax_context_matches(kw):
    _close(*_both("softmax_context", r(2, 4, 2, 8), r(2, 6, 1, 8), r(2, 6, 1, 8), **kw))


def test_softmax_context_with_an_alibi_bias():
    _close(*_both("softmax_context", r(1, 4, 2, 8), r(1, 4, 2, 8), r(1, 4, 2, 8), alibi=r(1, 2, 4, 4)))


@pytest.mark.parametrize("kw", [dict(rotary_dim=4, max_len=16), dict(style="gptj", max_len=8), dict()])
def test_apply_rotary_pos_emb(kw):
    pos = np.arange(5, dtype=np.int32)[None]
    _close(*_both("apply_rotary_pos_emb", r(1, 5, 2, 8), r(1, 5, 2, 8), pos, **kw))


def test_head_padding():
    assert [T.padded_head_size(n) for n in (20, 64, 80, 256)] == [J.padded_head_size(n) for n in (20, 64, 80, 256)]
    qkv = r(2, 4, 3 * 3 * 20)
    _close(*_both("pad_transform", qkv, 3))


# ---------------------------------------------------------------- the training layer
def _layer_pair(pre_ln, remat=False, **kw):
    jcfg = J.DeepSpeedTransformerConfig(hidden_size=32, intermediate_size=64, heads=4, pre_layer_norm=pre_ln,
                                        remat=remat, **kw)
    tcfg = T.DeepSpeedTransformerConfig(hidden_size=32, intermediate_size=64, heads=4, pre_layer_norm=pre_ln,
                                        remat=remat, **kw)
    x = r(2, 6, 32)
    jl = J.DeepSpeedTransformerLayer(jcfg)
    params = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # LayerNorm scales and biases away from 1 and 0, so that their gradients and the post-LN path are held too
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v + 0.1 * RNG.randn(*v.shape).astype(np.float32) if "ln" in str(p[-2]) else v, params)
    return jl, T.DeepSpeedTransformerLayer.from_flax(tcfg, params, device="cpu"), params, x


@pytest.mark.parametrize("pre_ln", [True, False])
def test_transformer_layer_forward_and_gradients_match_jax(pre_ln):
    jl, tl, params, x = _layer_pair(pre_ln)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    loss = lambda p: jnp.sum(jl.apply(p, jnp.asarray(x), jnp.asarray(mask)) ** 2)
    want_out = np.asarray(jl.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    want_grads = jax.tree.map(np.asarray, jax.grad(loss)(params))["params"]["body"]
    out = tl(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    (out ** 2).sum().backward()
    top = max(np.abs(w).max() for g in want_grads.values() for w in g.values())
    for name in T.DeepSpeedTransformerLayer.NAMES:
        for pname, p in getattr(tl, name).named_parameters():
            w = want_grads[name][pname]
            # k_proj's bias has a zero true gradient (softmax ignores a per-row constant): fp32 noise on both sides
            scale = top if (name, pname) == ("k_proj", "bias") else np.abs(w).max()
            assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * scale, f"{name}/{pname}"
    back = tl.flax_params()["params"]["body"]
    assert all(np.array_equal(back[n][k].detach().numpy(), params["params"]["body"][n][k])
               for n in back for k in back[n])


def test_transformer_layer_without_a_mask_takes_the_attention_entry_point():
    jl, tl, params, x = _layer_pair(True)
    want = np.asarray(jl.apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(tl(torch.from_numpy(x)).detach().numpy(), want, **TOL)


def test_transformer_layer_mask_blocks_pads():
    _, tl, _, x = _layer_pair(True)
    mask = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], dtype=torch.bool)
    x1 = torch.from_numpy(x)
    x2 = x1.clone()
    x2[0, 3:] = 50.0 * torch.from_numpy(r(3, 32))
    x2[1, 5:] = -50.0
    o1, o2 = tl(x1, mask), tl(x2, mask)
    torch.testing.assert_close(o1[0, :3], o2[0, :3], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(o1[1, :5], o2[1, :5], rtol=1e-5, atol=1e-5)


def test_transformer_layer_remat_matches_without_and_with_dropout():
    _, plain, params, x = _layer_pair(True, attn_dropout_ratio=0.1, hidden_dropout_ratio=0.2)
    cfg = T.DeepSpeedTransformerConfig(hidden_size=32, intermediate_size=64, heads=4, remat=True,
                                       attn_dropout_ratio=0.1, hidden_dropout_ratio=0.2)
    remat = T.DeepSpeedTransformerLayer.from_flax(cfg, params, device="cpu")
    for deterministic in (True, False):
        outs, grads = [], []
        for layer in (plain, remat):
            layer.zero_grad()
            xt = torch.from_numpy(x).requires_grad_(True)
            o = layer(xt, deterministic=deterministic, generator=torch.Generator().manual_seed(3))
            (o ** 2).sum().backward()
            outs.append(o.detach())
            grads.append([xt.grad] + [p.grad.clone() for p in layer.parameters()])
        assert torch.equal(outs[0], outs[1])
        assert all(torch.equal(a, b) for a, b in zip(*grads))
    dropped = plain(torch.from_numpy(x), deterministic=False, generator=torch.Generator().manual_seed(4))
    assert not torch.allclose(dropped, plain(torch.from_numpy(x)))


def test_transformer_layer_remat_leaves_a_shared_generator_where_the_plain_stack_does():
    # two layers drawing from one generator: the recompute replays each layer's masks and then gives the generator
    # back its state, so after the backward it stands where the stack without remat leaves it, and the next
    # step's masks are fresh
    _, _, params, x = _layer_pair(True)
    kw = dict(hidden_size=32, intermediate_size=64, heads=4, attn_dropout_ratio=0.1, hidden_dropout_ratio=0.2)
    stacks = {remat: [T.DeepSpeedTransformerLayer.from_flax(T.DeepSpeedTransformerConfig(remat=remat, **kw), params,
                                                            device="cpu") for _ in range(2)] for remat in (False, True)}
    states, outs, grads = {}, {}, {}
    for remat, layers in stacks.items():
        g = torch.Generator().manual_seed(5)
        xt = torch.from_numpy(x).requires_grad_(True)
        o = layers[1](layers[0](xt, deterministic=False, generator=g), deterministic=False, generator=g)
        (o ** 2).sum().backward()
        states[remat], outs[remat], grads[remat] = g.get_state(), o.detach(), xt.grad
    assert torch.equal(states[True], states[False])
    assert torch.equal(outs[True], outs[False]) and torch.equal(grads[True], grads[False])


def test_dropout_keeps_its_share():
    _, tl, _, _ = _layer_pair(True)
    y = tl._dropout(torch.ones(200_000), 0.25, False, torch.Generator().manual_seed(0))
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01 and torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
