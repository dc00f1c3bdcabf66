"""Port parity: the training forward, loss and gradients against JAX ``CausalLM``.

The JAX package initialises each model; the port takes the same weights
through ``params_from_numpy`` (whose key and shape check covers every
variant below) and runs on the CPU in fp32, where attention is the plain
``attention_xla``. Held to the reference at vocabulary 512:
- ``gpt2_tiny`` and ``llama_tiny``: logits, ``loss_fn`` (fused CE) and the
  gradient of every leaf;
- the block and embedding variants the config flags select: logits;
- ``fused_cross_entropy`` against ``cross_entropy_loss`` with ignored labels,
  a tied head (vd layout) and an untied head with a bias, value and grads.
Tolerances (fp32, another summation order): 2e-5 abs on logits (O(1)) and
the loss; gradients at 1e-5 abs plus 1e-4 of the leaf's largest value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.fused_ce import fused_cross_entropy as jax_fused_ce
from deepspeed_tpu_torch.models import CausalLM, params_from_numpy, transformer as tt
from deepspeed_tpu_torch.ops.fused_ce import fused_cross_entropy

TOL = 2e-5
V = 512


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _models(preset, **kw):
    jcfg = dataclasses.replace(getattr(jt, preset)(), vocab_size=V, **kw)
    tcfg = dataclasses.replace(getattr(tt, preset)(), vocab_size=V, **kw)
    jm = jt.CausalLM(jcfg)
    params = jm.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return jm, params, CausalLM(tcfg), params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=tcfg)


def _ids(B=2, S=32, seed=0):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


@pytest.mark.parametrize("preset", ["gpt2_tiny", "llama_tiny"])
def test_logits_loss_and_every_grad_match(preset):
    jm, jparams, tm, tparams = _models(preset)
    ids = _ids()
    np.testing.assert_allclose(tm.apply(tparams, torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jm.apply(jparams, jnp.asarray(ids))), atol=TOL)
    batch = {"input_ids": jnp.asarray(ids)}
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jparams, batch)
    leaves = _flat(tparams)
    for t in leaves.values():
        t.requires_grad_(True)
    tloss = tm.loss_fn(tparams, {"input_ids": torch.from_numpy(ids)})
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= TOL
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(leaves)
    for path, want in jflat.items():
        got = leaves[path].grad.numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 + 1e-4 * np.abs(want).max(), rtol=0, err_msg=path)


VARIANTS = {
    "gpt2_parallel_rope": ("gpt2_tiny", dict(block_type="parallel", pos_emb="rope", rotary_pct=0.25)),
    "gpt2_parallel_shared_untied": ("gpt2_tiny", dict(block_type="parallel_shared", activation="gelu_exact",
                                                      tie_embeddings=False, lm_head_bias=True)),
    "gpt2_post_ln": ("gpt2_tiny", dict(norm_scheme="post")),
    "bloom_alibi_embedding_norm": ("gpt2_tiny", dict(pos_emb="alibi", embedding_norm=True)),
    "olmo_np_clip": ("gpt2_tiny", dict(norm="layernorm_np", clip_qkv=0.5, dense_bias=False, activation="relu")),
    "qwen3_qk_norm_bias": ("llama_tiny", dict(qk_norm=True, qkv_bias=True)),
    "gemma_offset_scale_geglu": ("llama_tiny", dict(rms_offset=True, embed_scale=True, activation="geglu",
                                                    head_dims=32)),
    "mistral_window_gptj": ("llama_tiny", dict(sliding_window=8, window_layers=(1,), rope_style="gptj")),
    "encoder_bidirectional": ("gpt2_tiny", dict(causal=False)),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_logits_match(name):
    preset, kw = VARIANTS[name]
    jm, jparams, tm, tparams = _models(preset, **kw)
    ids = _ids(B=1, S=24, seed=1)
    np.testing.assert_allclose(tm.apply(tparams, torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jm.apply(jparams, jnp.asarray(ids))), atol=TOL)


def test_remat_gives_the_same_grads():
    _, _, tm, tparams = _models("llama_tiny")
    ids = torch.from_numpy(_ids())
    clone = lambda t: {k: clone(v) if isinstance(v, dict) else v.detach().clone().requires_grad_(True)
                       for k, v in t.items()}
    grads = []
    for model in (tm, CausalLM(dataclasses.replace(tm.cfg, remat=True))):
        params = clone(tparams)
        model.loss_fn(params, {"input_ids": ids}).backward()
        grads.append([t.grad for t in _flat(params).values()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("tied", [True, False])
def test_fused_cross_entropy_matches(tied):
    rng = np.random.default_rng(2)
    B, S, D = 2, 64, 16
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((V, D) if tied else (D, V)) * 0.3).astype(np.float32)
    b = None if tied else (rng.standard_normal(V) * 0.1).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -7:] = -100
    logits = np.einsum("bsd,vd->bsv", x, w) if tied else x @ w + b
    want_loss = float(jt.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))

    def jloss(x, w, b):
        return jax_fused_ce(x, w, jnp.asarray(labels), vd_layout=tied, chunk=16, bias=b)

    jg = jax.grad(jloss, argnums=(0, 1) if tied else (0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                                                  None if tied else jnp.asarray(b))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    tb = None if tied else torch.from_numpy(b).requires_grad_(True)
    loss = fused_cross_entropy(tx, tw, torch.from_numpy(labels), vd_layout=tied, chunk=16, bias=tb)
    plain = tt.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(loss.item() - want_loss) <= TOL and abs(plain.item() - want_loss) <= TOL
    loss.backward()
    got = [tx.grad, tw.grad] + ([] if tied else [tb.grad])
    for g, want in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-6)
