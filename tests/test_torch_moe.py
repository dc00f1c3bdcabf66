"""Port parity: Mixture of Experts (``deepspeed_tpu_torch.moe``, the MoE
blocks of the model and the MoE serving module) against the JAX package.

Seeded numpy inputs go through the JAX function and the port's counterpart,
both in fp32 on the CPU (where ``moe_grouped_gemm`` takes its plain
version). Tolerances:
- gating (``top1gating``, ``topkgating``, ``gate_and_dispatch``): the expert
  choices, dispatch masks and expert counts equal exactly (the same
  comparisons of the same logits); combine weights, the aux loss and the
  dispatched and combined tensors within 1e-6 (two softmax and einsum
  implementations in fp32, values of order 1);
- the ``MoE`` layer's output and aux loss: 1e-6;
- ``moe_grouped_gemm_ref`` against ``jax.lax.ragged_dot``, and the serving
  module against JAX ``moe_tpu``: 1e-5 (sums over 32-64 products);
- the model (a tiny MoE config with every block or every second block MoE):
  logits, the loss with its aux term, and every gradient within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.v2.modules import moe_tpu as jax_moe_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.moe import layer as jl
from deepspeed_tpu.moe import sharded_moe as js
from deepspeed_tpu_torch.inference.v2.modules import build_modules, moe_route, moe_tpu
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, init_params, param_shapes, params_from_numpy
from deepspeed_tpu_torch.moe import MoE, sharded_moe as ts
from deepspeed_tpu_torch.ops.moe_grouped_gemm import GEMM_TILE_ROWS, moe_grouped_gemm, moe_grouped_gemm_ref, tile_rows

GATE_TOL = 1e-6
LAYER_TOL = 1e-6
GEMM_TOL = 1e-5
MODEL_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _tree(tree):
    return {k: _tree(v) for k, v in tree.items()} if isinstance(tree, dict) else _t(np.asarray(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _logits(N, E, seed, tie=False):
    x = np.random.default_rng(seed).standard_normal((N, E)).astype(np.float32)
    if tie:  # an exact tie between the two leading experts of every row: the lower index must win
        top = np.argsort(-x, axis=1)[:, 0]
        x[:, 1] = x[np.arange(N), top]
        x[:, 3] = x[:, 1]
    return x


# ---------------------------------------------------------------- gating
def test_one_hot_gives_zero_rows_out_of_range():
    idx = np.array([0, 3, 4, -1, 2], np.int32)
    np.testing.assert_array_equal(ts._one_hot(_t(idx), 4).numpy(), np.asarray(js._one_hot(jnp.asarray(idx), 4)))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_top_k_breaks_ties_toward_the_lower_index(k):
    x = _logits(32, 6, seed=k, tie=True)
    x[:4] = 0.5  # whole rows tied
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = ts.top_k(_t(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _assert_gating_equal(got, want):
    (tl_aux, tcomb, tdisp, tcounts), (jl_aux, jcomb, jdisp, jcounts) = got, want
    np.testing.assert_array_equal(tdisp.numpy(), np.asarray(jdisp))
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.dtype == {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32}[jcounts.dtype]
    _close(tcomb.numpy(), jcomb, GATE_TOL)
    _close(tl_aux.item(), float(jl_aux), GATE_TOL)


# (N, E, capacity_factor, min_capacity, drop): the last drop case overflows capacity
TOP1_CASES = [(24, 4, 1.0, 4, True), (24, 4, 1.0, 4, False), (40, 8, 0.5, 1, True), (16, 4, 2.0, 32, True)]


@pytest.mark.parametrize("N,E,cf,min_cap,drop", TOP1_CASES)
@pytest.mark.parametrize("tie", [False, True])
def test_top1gating_matches(N, E, cf, min_cap, drop, tie):
    x = _logits(N, E, seed=N + E, tie=tie)
    got = ts.top1gating(_t(x), cf, min_cap, drop_tokens=drop)
    want = js.top1gating(jnp.asarray(x), cf, min_cap, drop_tokens=drop)
    _assert_gating_equal(got, want)
    if drop and cf < 1.0:
        assert got[3].sum().item() < N  # the capacity dropped tokens


def test_top1gating_used_token_mask_matches():
    x = _logits(20, 4, seed=9)
    mask = (np.arange(20) % 3 != 0).astype(np.float32)
    got = ts.top1gating(_t(x), 1.0, 2, used_token_mask=_t(mask))
    want = js.top1gating(jnp.asarray(x), 1.0, 2, used_token_mask=jnp.asarray(mask))
    _assert_gating_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("N,E,cf,min_cap,drop", [(24, 4, 1.0, 4, True), (24, 4, 1.0, 4, False),
                                                   (40, 8, 0.5, 1, True), (16, 4, 1.25, 2, True)])
@pytest.mark.parametrize("tie", [False, True])
def test_topkgating_matches(k, N, E, cf, min_cap, drop, tie):
    x = _logits(N, E, seed=10 * k + N, tie=tie)
    got = ts.topkgating(_t(x), k, cf, min_cap, drop_tokens=drop)
    want = js.topkgating(jnp.asarray(x), k, cf, min_cap, drop_tokens=drop)
    _assert_gating_equal(got, want)
    if drop and cf < 1.0:
        assert got[3].sum().item() < k * N  # the capacity dropped choices


def test_topkgating_without_renormalisation_matches():
    x = _logits(24, 6, seed=4)
    _assert_gating_equal(ts.topkgating(_t(x), 2, 1.0, 4, normalize_weights=False),
                         js.topkgating(jnp.asarray(x), 2, 1.0, 4, normalize_weights=False))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("drop", [True, False])
def test_gate_and_dispatch_and_combine_match(k, drop):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((24, 16)).astype(np.float32)
    logits = _logits(24, 4, seed=20 + k)
    t_aux, t_disp, t_comb, t_counts = ts.gate_and_dispatch(_t(x), _t(logits), k, 0.75, 2, drop_tokens=drop)
    j_aux, j_disp, j_comb, j_counts = js.gate_and_dispatch(jnp.asarray(x), jnp.asarray(logits), k, 0.75, 2,
                                                           drop_tokens=drop)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(j_counts))
    _close(t_disp.numpy(), j_disp, GATE_TOL)
    _close(t_comb.numpy(), j_comb, GATE_TOL)
    _close(t_aux.item(), float(j_aux), GATE_TOL)
    expert_out = rng.standard_normal(t_disp.shape).astype(np.float32)
    _close(ts.combine_output(_t(expert_out), t_comb).numpy(),
           js.combine_output(jnp.asarray(expert_out), j_comb), GATE_TOL)


def test_noise_and_jitter_follow_the_generator():
    x = _t(_logits(64, 8, seed=1))
    assert ts.multiplicative_jitter(x) is x  # no generator: nothing drawn
    j1 = ts.multiplicative_jitter(x, torch.Generator().manual_seed(5), epsilon=0.1)
    j2 = ts.multiplicative_jitter(x, torch.Generator().manual_seed(5), epsilon=0.1)
    assert torch.equal(j1, j2) and not torch.equal(j1, x)
    ratio = j1 / x
    assert ratio.min() >= 0.9 - 1e-6 and ratio.max() <= 1.1 + 1e-6
    plain = ts.top1gating(x, 1.0, 4, drop_tokens=False)[1]
    noisy = [ts.top1gating(x, 1.0, 4, torch.Generator().manual_seed(s), "RSample", drop_tokens=False)[1]
             for s in (7, 7)]
    assert torch.equal(noisy[0], noisy[1]) and not torch.equal(noisy[0], plain)


# ---------------------------------------------------------------- MoE layer
def _layer_pair(use_residual, activation, k=2):
    fields = dict(hidden_size=16, num_experts=4, k=k, capacity_factor=1.0, eval_capacity_factor=1.5, min_capacity=2,
                  use_residual=use_residual, d_ff=24, activation=activation)
    x = np.random.default_rng(2).standard_normal((2, 12, 16)).astype(np.float32)
    jmod = jl.MoE(**fields)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    return jmod, params, MoE(**fields), _tree(jax.tree.map(np.asarray, params)), x


@pytest.mark.parametrize("use_residual", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("activation,k", [("swiglu", 2), ("gelu", 1), ("relu", 3), ("gelu_exact", 2)])
def test_moe_layer_matches(use_residual, train, activation, k):
    jmod, params, tmod, tparams, x = _layer_pair(use_residual, activation, k)
    jout, mods = jmod.apply({"params": params}, jnp.asarray(x), train=train, mutable=["losses", "intermediates"])
    tout, l_aux, counts = tmod(tparams, _t(x), train=train)
    assert tout.shape == x.shape
    _close(tout.numpy(), jout, LAYER_TOL)
    _close(l_aux.item(), float(mods["losses"]["moe_aux_loss"][0]), LAYER_TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(mods["intermediates"]["exp_counts"][0]))
    if not train:  # inference never drops: every choice of every token is counted
        assert counts.sum().item() == k * x.shape[0] * x.shape[1]


def test_moe_layer_param_shapes_match_the_reference():
    for use_residual in (False, True):
        _, params, tmod, _, _ = _layer_pair(use_residual, "swiglu")
        want = {path: tuple(np.shape(v)) for path, v in _flat(jax.tree.map(np.asarray, params)).items()}
        got = {path: tuple(spec[0]) for path, spec in _flat(tmod.param_shapes()).items()}
        assert got == want


# ---------------------------------------------------------------- grouped GEMM
GEMM_SIZES = {"mixed": [5, 0, 9, 3], "one_full_group": [0, 17, 0, 0], "empty_last": [4, 6, 7, 0],
              "single_rows": [1, 1, 1, 1]}


@pytest.mark.parametrize("name", list(GEMM_SIZES))
def test_grouped_gemm_matches_ragged_dot(name):
    sizes = np.asarray(GEMM_SIZES[name], np.int32)
    rng = np.random.default_rng(len(name))
    R, K, N = int(sizes.sum()), 24, 40
    x = rng.standard_normal((R, K)).astype(np.float32)
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes)))
    offsets = _t(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    got = moe_grouped_gemm_ref(_t(x), _t(w), offsets)
    _close(got.numpy(), want, GEMM_TOL)
    assert torch.equal(moe_grouped_gemm(_t(x), _t(w), offsets), got)  # CPU tensors take the plain version
    assert moe_grouped_gemm.launches == 0


# (R, E, dtype) -> the kernel's tile rows: bf16 takes 32 while the mean rows an expert are at most 16 (a decode
# step), else 64; fp32 always 64
TILE_CASES = [(16, 8, torch.bfloat16, 32), (128, 8, torch.bfloat16, 32), (129, 8, torch.bfloat16, 64),
              (4096, 8, torch.bfloat16, 64), (1, 1, torch.bfloat16, 32), (16, 8, torch.float32, 64)]


@pytest.mark.parametrize("R,E,dtype,want", TILE_CASES)
def test_grouped_gemm_tile_rows_follow_host_shapes(R, E, dtype, want):
    """The launch's tile rows depend on R and E only (never on the routing),
    and are one of the kernel's bodies."""
    assert tile_rows(R, E, dtype) == want
    assert want in (GEMM_TILE_ROWS if dtype == torch.bfloat16 else (64,))


# ---------------------------------------------------------------- serving module
def _serving_cfg(k, activation, E=4):
    fields = dict(vocab_size=64, n_layers=1, n_heads=2, d_model=16, d_ff=24, max_seq_len=64, activation=activation,
                  moe_num_experts=E, moe_top_k=k, moe_layer_freq=1)
    return JaxConfig(**fields), TransformerConfig(**fields)


@pytest.mark.parametrize("k,activation", [(1, "swiglu"), (2, "swiglu"), (3, "gelu"), (2, "relu"), (4, "gelu_exact")])
def test_serving_moe_module_matches(k, activation):
    jcfg, cfg = _serving_cfg(k, activation)
    shapes = param_shapes(cfg)["layer_0"]["moe"]
    p = init_params(cfg, torch.Generator().manual_seed(k), device="cpu")["layer_0"]["moe"]
    assert 0.015 < p["experts"]["wi"].std().item() < 0.025  # normal(0.02), as flax's experts
    p["gate"]["kernel"] = p["gate"]["kernel"] * 8.0  # sharper gates: the routing varies across tokens
    assert set(p) == set(shapes)
    x = np.random.default_rng(k).standard_normal((3, 7, 16)).astype(np.float32)
    x[1, 2] = 0.0  # a padded row routes like every other zero row
    want = np.asarray(jax_moe_tpu(jcfg, jax.tree.map(lambda t: jnp.asarray(t.numpy()), p), jnp.asarray(x)))
    got = moe_tpu(cfg, p, _t(x))
    _close(got.numpy(), want, GEMM_TOL)
    assert torch.equal(moe_tpu(cfg, p, _t(x), gemm=moe_grouped_gemm_ref), got)


def test_module_bundle_counts_the_grouped_gemm():
    """The engine's CUDA graphs keep the launch counts of the bundle's kernel
    fields that carry a counter; the grouped GEMM must be one of them."""
    assert moe_grouped_gemm in [f for f in build_modules() if hasattr(f, "launches")]
    assert build_modules(plain=True).grouped_gemm is moe_grouped_gemm_ref


def test_serving_route_matches_the_reference_dispatch():
    """Weights, experts, the stable expert order and the offsets (a bincount's
    cumsum, here without a host read) equal the reference's; ties go to the
    lower expert."""
    _, cfg = _serving_cfg(2, "swiglu", E=6)
    rng = np.random.default_rng(0)
    tokens = rng.standard_normal((40, 16)).astype(np.float32)
    kernel = rng.standard_normal((16, 6)).astype(np.float32)
    kernel[:, 4] = kernel[:, 1]  # experts 1 and 4 tie on every token
    w, e, order, offsets = moe_route(cfg, {"gate": {"kernel": _t(kernel)}}, _t(tokens))
    gates = jax.nn.softmax(jnp.asarray(tokens) @ jnp.asarray(kernel), axis=-1)
    jw, je = jax.lax.top_k(gates, 2)
    jw = jw / jnp.maximum(jnp.sum(jw, axis=-1, keepdims=True), 1e-9)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    _close(w.numpy(), jw, GATE_TOL)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jnp.argsort(je.reshape(-1))))
    want = np.concatenate([[0], np.cumsum(np.bincount(np.asarray(je).reshape(-1), minlength=6))])
    np.testing.assert_array_equal(offsets.numpy(), want)
    assert offsets.dtype == torch.int32


# ---------------------------------------------------------------- model
MOE = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=128, norm="rmsnorm",
           activation="swiglu", pos_emb="rope", tie_embeddings=False, moe_num_experts=4, moe_top_k=2)
_MODELS = {}


def _model(freq):
    if freq not in _MODELS:
        fields = dict(MOE, moe_layer_freq=freq)
        jmodel = JaxCausalLM(JaxConfig(**fields))
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3), {"input_ids": np.zeros((1, 8), np.int32)}))
        cfg = TransformerConfig(**fields)
        _MODELS[freq] = jmodel, params, cfg, params_from_numpy(params, "cpu", cfg=cfg)
    return _MODELS[freq]


IDS = np.random.default_rng(0).integers(0, 128, (2, 16)).astype(np.int32)


@pytest.mark.parametrize("freq", [2, 1])
def test_moe_param_tree_matches(freq):
    _, params, cfg, _ = _model(freq)
    assert ("moe" in params["layer_0"]) == (freq == 1) and "moe" in params["layer_1"]
    assert {p: tuple(s[0]) for p, s in _flat(param_shapes(cfg)).items()} == \
        {p: tuple(np.shape(v)) for p, v in _flat(params).items()}


@pytest.mark.parametrize("freq", [2, 1])
@pytest.mark.parametrize("train", [True, False, None])
def test_moe_logits_match(freq, train):
    jmodel, params, cfg, tparams = _model(freq)
    kw = {} if train is None else {"train": train}
    want = np.asarray(jmodel.apply(params, IDS, **kw))
    got = CausalLM(cfg).apply(tparams, torch.from_numpy(IDS), **kw)
    _close(got.numpy(), want, MODEL_TOL)


@pytest.mark.parametrize("freq", [2, 1])
def test_moe_loss_and_gradients_match(freq):
    jmodel, params, cfg, tparams = _model(freq)
    batch = {"input_ids": IDS}
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(params, batch)
    leaves = {}

    def track(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = track(v, path)
            else:
                out[k] = leaves[path] = v.clone().requires_grad_(True)
        return out

    model = CausalLM(cfg)
    loss = model.loss_fn(track(tparams), {"input_ids": torch.from_numpy(IDS)})
    _close(loss.item(), float(jloss), MODEL_TOL)
    aux = []
    model.apply(tparams, torch.from_numpy(IDS), return_hidden=True, moe_aux=aux)
    assert len(aux) == sum(1 for i in range(cfg.n_layers) if "moe" in tparams[f"layer_{i}"]) > 0
    assert sum(a.item() for a, _ in aux) > 0
    loss.backward()
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(leaves)
    for path, leaf in leaves.items():
        _close(leaf.grad.numpy(), jflat[path], MODEL_TOL)
    gate = [p for p in leaves if p.endswith("moe/gate/kernel")]
    assert gate and all(leaves[p].grad.abs().max().item() > 0 for p in gate)


def test_moe_loss_counts_the_aux_term():
    """The loss is the cross entropy plus ``moe_aux_loss_coef`` times the
    blocks' aux losses: a zero coefficient gives the cross entropy alone."""
    _, _, cfg, tparams = _model(1)
    ids = {"input_ids": torch.from_numpy(IDS)}
    with_aux = CausalLM(cfg).loss_fn(tparams, ids).item()
    without = CausalLM(dataclasses.replace(cfg, moe_aux_loss_coef=0.0)).loss_fn(tparams, ids).item()
    aux = []
    CausalLM(cfg).apply(tparams, ids["input_ids"], return_hidden=True, moe_aux=aux)
    assert with_aux == pytest.approx(without + cfg.moe_aux_loss_coef * sum(a.item() for a, _ in aux), rel=1e-6)


def test_moe_remat_matches_and_counts_each_block_once():
    _, _, cfg, tparams = _model(1)
    ids = torch.from_numpy(IDS)
    aux, aux_remat = [], []
    want = CausalLM(cfg).apply(tparams, ids, moe_aux=aux)
    got = CausalLM(dataclasses.replace(cfg, remat=True)).apply(tparams, ids, moe_aux=aux_remat)
    assert torch.equal(got, want)
    assert len(aux_remat) == len(aux) == cfg.n_layers
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(aux, aux_remat))


@pytest.mark.parametrize("freq", [2, 1])
def test_v1_engine_greedy_tokens_match(freq):
    """The v1 engine serves the MoE config through ``transformer_forward``
    with its dense caches (never dropping a token): greedy tokens equal the
    JAX v1 engine's, and ``forward`` logits (no drop either) within 1e-5."""
    import deepspeed_tpu
    import deepspeed_tpu_torch

    jmodel, params, cfg, tparams = _model(freq)
    prompts = np.array([[5, 17, 3, 99, 4, 23, 7, 1], [7, 2, 8, 11, 40, 41, 42, 3]], np.int32)
    config = {"dtype": "float32", "max_out_tokens": 64}
    jeng = deepspeed_tpu.init_inference(jmodel, config, params=params)
    teng = deepspeed_tpu_torch.init_inference(CausalLM(cfg), {**config, "device": "cpu"}, params=tparams)
    want = np.asarray(jeng.generate(prompts, max_new_tokens=10))
    np.testing.assert_array_equal(teng.generate(prompts, max_new_tokens=10).numpy(), want)
    _close(teng.forward(prompts).numpy(), np.asarray(jeng.forward(prompts)), MODEL_TOL)
