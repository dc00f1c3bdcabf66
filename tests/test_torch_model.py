"""Port parity: deepspeed_tpu_torch.models against the JAX reference.

Configuration, presets, rope tables (every scaling kind), ``apply_rope``
(both styles, partial rotary), ALiBi slopes, parameter initialisation
(keys, shapes, initializer scale) and ``params_from_numpy``. The rope
tables are built by the same fp64 numpy code and must agree exactly;
``apply_rope`` is fp32 arithmetic and is held to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import convert, transformer as tt

TOL = 1e-5


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def test_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jt.TransformerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tt.TransformerConfig)}
    assert set(jf) == set(tf)
    for name in jf:
        if name == "dtype":
            assert tf[name] is torch.float32 and jf[name] is jnp.float32
        else:
            assert jf[name] == tf[name], name


@pytest.mark.parametrize("preset", ["gpt2_tiny", "gpt2_125m", "gpt2_1_3b", "llama_tiny", "llama2_7b", "llama3_8b"])
def test_presets_match(preset):
    j, t = getattr(jt, preset)(), getattr(tt, preset)()
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(j, f.name) == getattr(t, f.name), f.name
    for prop in ("kv_heads", "ffn_dim", "head_dim", "rotary_dim", "use_dense_bias"):
        assert getattr(j, prop) == getattr(t, prop)


ROPE_CASES = {
    "none": dict(),
    "linear": dict(rope_scaling="linear", rope_factor=4.0),
    "dynamic": dict(rope_scaling="dynamic", rope_factor=2.0, rope_orig_max_seq=64),
    "llama3": dict(rope_scaling="llama3", rope_factor=8.0, rope_orig_max_seq=64, rope_theta=500000.0),
    "yarn": dict(rope_scaling="yarn", rope_factor=4.0, rope_orig_max_seq=64),
}


@pytest.mark.parametrize("kind", list(ROPE_CASES))
def test_scaled_rope_frequencies_match(kind):
    kw = dict(d_model=64, n_heads=2, max_seq_len=256, pos_emb="rope", **ROPE_CASES[kind])
    jc, tc = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    jcos, jsin = jt.scaled_rope_frequencies(jc, jc.rotary_dim)
    tcos, tsin = tt.scaled_rope_frequencies(tc, tc.rotary_dim)
    np.testing.assert_array_equal(tcos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(tsin.numpy(), np.asarray(jsin))


def test_rope_frequencies_match():
    jcos, jsin = jt.rope_frequencies(16, 64, 10000.0)
    tcos, tsin = tt.rope_frequencies(16, 64, 10000.0)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("style", ["neox", "gptj"])
@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_apply_rope_matches(style, rotary_dim):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    rd = rotary_dim or 16
    cfg_kw = dict(d_model=48, n_heads=3, max_seq_len=128, rope_scaling="llama3", rope_factor=8.0,
                  rope_orig_max_seq=32)
    jcos, jsin = jt.scaled_rope_frequencies(jt.TransformerConfig(**cfg_kw), rd)
    tcos, tsin = tt.scaled_rope_frequencies(tt.TransformerConfig(**cfg_kw), rd)
    want = np.asarray(jt.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos), rotary_dim=rotary_dim,
                                    style=style))
    got = tt.apply_rope(torch.from_numpy(x), tcos, tsin, torch.from_numpy(pos), rotary_dim=rotary_dim,
                        style=style).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [4, 12, 32])
def test_alibi_slopes_match(n):
    np.testing.assert_array_equal(tt.alibi_slopes(n), jt.alibi_slopes(n))


INIT_CASES = {
    "llama": dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=64, norm="rmsnorm",
                  activation="swiglu", pos_emb="rope", tie_embeddings=False),
    "gpt2": dict(vocab_size=128, n_layers=2, n_heads=4, d_model=32, max_seq_len=64),
    "qwen3": dict(vocab_size=128, n_layers=1, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=64, norm="rmsnorm",
                  activation="swiglu", pos_emb="rope", qkv_bias=True, qk_norm=True, tie_embeddings=False),
}


@pytest.fixture(scope="module")
def jax_trees():
    out = {}
    for name, kw in INIT_CASES.items():
        model = jt.CausalLM(jt.TransformerConfig(**kw))
        params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
        out[name] = jax.tree.map(np.asarray, params)
    return out


@pytest.mark.parametrize("name", list(INIT_CASES))
def test_init_params_keys_and_shapes_match(name, jax_trees):
    cfg = tt.TransformerConfig(**INIT_CASES[name])
    got = _flat(tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"))
    want = _flat(jax_trees[name])
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32


def test_init_params_scales():
    cfg = tt.TransformerConfig(**dict(INIT_CASES["llama"], d_model=256, n_heads=4, vocab_size=512))
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = p["layer_0"]["attn"]["q_proj"]["kernel"]  # lecun normal, fan-in d_model
    o = p["layer_0"]["attn"]["o_proj"]["kernel"]  # fan-in H * Dh
    assert abs(q.std().item() - 256**-0.5) < 0.05 * 256**-0.5
    assert abs(o.std().item() - 256**-0.5) < 0.05 * 256**-0.5
    assert abs(p["wte"].std().item() - 0.02) < 0.002
    assert torch.equal(p["RMSNorm_0"]["scale"], torch.ones(256))
    again = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["wte"], p["wte"])  # the generator alone fixes the draw


@pytest.mark.parametrize("name", list(INIT_CASES))
def test_params_from_numpy_maps_every_key(name, jax_trees):
    cfg = tt.TransformerConfig(**INIT_CASES[name])
    tree = jax_trees[name]
    got = _flat(convert.params_from_numpy(tree, "cpu", cfg=cfg))
    want = _flat(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    bf = convert.params_from_numpy(tree, "cpu", torch.bfloat16, cfg=cfg)
    assert bf["wte"].dtype == torch.bfloat16


def test_params_from_numpy_rejects_missing_extra_and_misshapen(jax_trees):
    cfg = tt.TransformerConfig(**INIT_CASES["llama"])
    tree = jax_trees["llama"]
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy(missing, "cpu", cfg=cfg)
    extra = dict(tree, wpe=np.zeros((64, 32), np.float32))
    with pytest.raises(ValueError, match="extra"):
        convert.params_from_numpy(extra, "cpu", cfg=cfg)
    bad = dict(tree, wte=np.zeros((127, 32), np.float32))
    with pytest.raises(ValueError, match="shapes"):
        convert.params_from_numpy(bad, "cpu", cfg=cfg)
