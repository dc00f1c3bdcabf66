"""Port parity: LAMB (the direction kernel through its plain version), and Lion, SGD and Adagrad.

Op level, on the same numpy state:
- the plain direction against the Pallas ``_lamb_direction(...,
  interpret=True)`` over three steps, at N = 1000 (not a multiple of the
  block), with and without weight decay;
- the ``fused_lamb_flat`` op against JAX ``fused_lamb_flat`` (interpret
  mode) and ``lamb_xla``, and a trust ratio that clips at ``max_trust``
  (the scenarios of ``tests/unit/test_pallas_ops.py``);
- the gradient multiplier and the finite flag of the direction.
Tolerance: 1e-6 relative to the largest value of each tensor (fp32; other
rounding order, and the port's m and v are updated in place).

Engine level: five ``train_batch`` steps of ``gpt2_tiny`` (vocabulary 512)
with ``"lamb"``, ``"lion"``, ``"sgd"`` (plain, momentum, nesterov) and
``"adagrad"`` against the JAX engine (optax) on a one-device mesh, with gas
1 and 2, WarmupLR and a clip that fires: losses, the LR sequence, the global
norm (1e-5 relative), and every parameter after the last step (1 % of how
far the reference moved its tensor, see ``_PARAM_TOL``); and a non-finite
gradient that skips the step in both engines.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.ops.pallas.fused_lamb import _lamb_direction
from deepspeed_tpu.ops.pallas.fused_lamb import fused_lamb_flat as jax_fused_lamb_flat
from deepspeed_tpu.ops.pallas.fused_lamb import lamb_xla as jax_lamb_xla
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.models import CausalLM, gpt2_tiny, params_from_numpy
from deepspeed_tpu_torch.ops import fused_lamb as tfl
from deepspeed_tpu_torch.ops.fused_adam import adam_scalars
from deepspeed_tpu_torch.runtime.optimizers import SGD, Adagrad, Lamb, Lion, create_optimizer

N = 1000  # not a multiple of the block (256 here, 1 << 16 by default)
V = 512
STEPS = 5


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_direction_three_steps_match_the_pallas_body(wd):
    rng = np.random.default_rng(0)
    p = rng.standard_normal(N).astype(np.float32)
    jm = jv = jnp.zeros(N, jnp.float32)
    tm, tv = torch.zeros(N), torch.zeros(N)
    for step in (1, 2, 3):
        g = rng.standard_normal(N).astype(np.float32)
        ju, jm, jv = _lamb_direction(jnp.asarray(p), jnp.asarray(g), jm, jv, step, 0.9, 0.999, 1e-6, wd, 256, True)
        tu = tfl.lamb_direction(torch.from_numpy(p), torch.from_numpy(g), tm, tv, adam_scalars(1e-3, step, 0.9, 0.999),
                                eps=1e-6, weight_decay=wd)
        for got, want in ((tu, ju), (tm, jm), (tv, jv)):
            _close(got.numpy(), want)
        p = p - 1e-3 * np.asarray(ju)


def test_the_direction_scales_the_gradient_and_skips_where_not_finite():
    rng = np.random.default_rng(1)
    p, g = (torch.from_numpy(rng.standard_normal(N).astype(np.float32)) for _ in range(2))
    m, v = torch.zeros(N), torch.zeros(N)
    out = torch.empty(N)
    u = tfl.lamb_direction(p, g, m, v, adam_scalars(1e-2, 1, 0.9, 0.999, grad_mult=0.5, finite=False), u_out=out)
    assert u is out and not m.any() and not v.any()
    u = tfl.lamb_direction(p, g, m, v, adam_scalars(1e-2, 1, 0.9, 0.999, grad_mult=0.5), weight_decay=0.01)
    ju, jm, jv = _lamb_direction(jnp.asarray(p.numpy()), jnp.asarray(g.numpy() * 0.5), jnp.zeros(N), jnp.zeros(N), 1,
                                 0.9, 0.999, 1e-6, 0.01, 256, True)
    for got, want in ((u, ju), (m, jm), (v, jv)):
        _close(got.numpy(), want)


@pytest.mark.parametrize("n", [300, N])
def test_fused_lamb_flat_matches_the_reference_forms(n):
    rng = np.random.RandomState(0)
    p0 = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    jp = xp = jnp.asarray(p0)
    jm = jv = xm = xv = jnp.zeros(n, jnp.float32)
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)
    for step in (1, 2, 3):
        jp, jm, jv = jax_fused_lamb_flat(jp, jnp.asarray(g), jm, jv, 1e-2, step, weight_decay=0.01, block=128,
                                         interpret=True)
        xp, xm, xv = jax_lamb_xla(xp, jnp.asarray(g), xm, xv, 1e-2, step, weight_decay=0.01)
        out = tfl.fused_lamb_flat(tp, torch.from_numpy(g), tm, tv, 1e-2, step, weight_decay=0.01)
        assert out[0] is tp
        for got, want, want_xla in ((tp, jp, xp), (tm, jm, xm), (tv, jv, xv)):
            _close(got.numpy(), want)
            _close(got.numpy(), want_xla)
    lp, lm, lv = tfl.lamb_xla(torch.from_numpy(p0), torch.from_numpy(g), torch.zeros(n), torch.zeros(n), 1e-2, 1,
                              weight_decay=0.01)
    jp1, jm1, _ = jax_lamb_xla(jnp.asarray(p0), jnp.asarray(g), jnp.zeros(n), jnp.zeros(n), 1e-2, 1, weight_decay=0.01)
    _close(lp.numpy(), jp1)
    _close(lm.numpy(), jm1)


def test_the_trust_ratio_clips_at_max_trust():
    p = torch.ones(64) * 1e6  # huge weights: ||p|| / ||u|| = 1e6, clipped to 10
    g = torch.ones(64)
    for fn in (tfl.lamb_xla, tfl.fused_lamb_flat):
        p1, _, _ = fn(p.clone(), g, torch.zeros(64), torch.zeros(64), 1.0, 1, max_trust=10.0)
        moved = (p - p1).abs().max().item()
        assert 9.9 <= moved <= 10.0 + 1e-3
    jp1, _, _ = jax_lamb_xla(jnp.ones(64) * 1e6, jnp.ones(64), jnp.zeros(64), jnp.zeros(64), 1.0, 1, max_trust=10.0)
    _close(tfl.fused_lamb_flat(p.clone(), g, torch.zeros(64), torch.zeros(64), 1.0, 1)[0].numpy(), jp1)


# ---------------------------------------------------------------- the optimizers against optax
def _optax_steps(name, params, p0, grads):
    import optax

    from deepspeed_tpu.runtime.optimizers import create_optimizer as jax_create

    tx = jax_create(name, params)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
    return np.asarray(jp)


OPTIMIZERS = [("lamb", {"lr": 1e-2}, Lamb), ("lamb", {"lr": 1e-2, "weight_decay": 0.0, "eps": 1e-6}, Lamb),
              ("lion", {"lr": 1e-3, "weight_decay": 0.1}, Lion), ("sgd", {"lr": 1e-2}, SGD),
              ("sgd", {"lr": 1e-2, "momentum": 0.9}, SGD), ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}, SGD),
              ("adagrad", {"lr": 1e-1}, Adagrad)]


@pytest.mark.parametrize("name,params,cls", OPTIMIZERS)
def test_optimizer_steps_match_optax(name, params, cls):
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((10, 7)).astype(np.float32)
    grads = [rng.standard_normal((10, 7)).astype(np.float32) for _ in range(3)]
    want = _optax_steps(name, params, p0, grads)
    tp = torch.from_numpy(p0.copy())
    opt = create_optimizer(name, params, [tp])
    assert type(opt) is cls
    for step, g in enumerate(grads):
        if step == 1:  # an overflowed step in between: nothing moves, no state or count advances
            tp.grad = torch.from_numpy(g * 7)
            opt.step(finite=torch.tensor(False))
        tp.grad = torch.from_numpy(g)
        opt.step()
    _close(tp.numpy(), want)


def test_lamb_zero_norms_take_a_trust_ratio_of_one():
    p = torch.zeros(8)
    p.grad = torch.ones(8)
    Lamb([p], lr=0.1, weight_decay=0.0).step()  # ||p|| = 0: trust 1, the step is lr * u = lr
    torch.testing.assert_close(p, torch.full((8,), -0.1))
    want = _optax_steps("lamb", {"lr": 0.1, "weight_decay": 0.0}, np.zeros(8, np.float32), [np.ones(8, np.float32)])
    # the whole of p is one step here: 1e-5, not 1e-6. optax's injected betas are fp32, so it forms 1 - b2 in
    # fp32 and it cancels against the bias correction 1 - b2^1; the port (like the Pallas body) rounds 1 - b2
    # from double, 1.3e-5 away, which moves u = m / sqrt(v) by 6.7e-6 at the first step
    _close(p.numpy(), want, tol=1e-5)


# ---------------------------------------------------------------- the engines
def _one_device_mesh():
    return MeshTopology(MeshConfig.from_dict({"data": 1}), devices=jax.devices()[:1])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def jax_model():
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return model, jax.tree.map(np.asarray, params)  # numpy: the JAX engine donates its device buffers


def _config(optimizer, gas):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "optimizer": optimizer,
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0, "warmup_max_lr": optimizer["params"]["lr"],
                                     "warmup_num_steps": 3, "warmup_type": "linear"}},
            "gradient_clipping": 0.5}


# After five steps every parameter is held to the reference at this share of
# its tensor's travel (the most the reference moved any of its elements). The
# engines' fp32 gradients differ in the last bits (another summation order),
# and LAMB and Adagrad divide each element's gradient by its own history, so
# a small gradient's noise moves its element by a visible share of its step.
# Measured at these inputs at most 1.8e-3 (LAMB), 8.1e-4 (Adagrad), 8.7e-5
# (SGD) and 0 (Lion).
_PARAM_TOL = 1e-2

ENGINE_OPTIMIZERS = [
    {"type": "Lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}},
    {"type": "Lion", "params": {"lr": 1e-3, "weight_decay": 0.1}},
    {"type": "SGD", "params": {"lr": 0.5}},
    {"type": "SGD", "params": {"lr": 0.5, "momentum": 0.9}},
    {"type": "SGD", "params": {"lr": 0.5, "momentum": 0.9, "nesterov": True}},
    {"type": "Adagrad", "params": {"lr": 1e-2}},
]


# gas 2 for Lamb and for each optimizer's plain form
ENGINE_CASES = [(o, 1) for o in ENGINE_OPTIMIZERS] + [(o, 2) for o in ENGINE_OPTIMIZERS
                                                      if "momentum" not in o["params"]]


@pytest.mark.parametrize("optimizer,gas", ENGINE_CASES,
                         ids=[f"{o['type']}{'-momentum' if 'momentum' in o['params'] else ''}"
                              f"{'-nesterov' if 'nesterov' in o['params'] else ''}-gas{gas}" for o, gas in ENGINE_CASES])
def test_five_engine_steps_match_the_jax_engine(jax_model, optimizer, gas):
    model, jparams = jax_model
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, V, (2, 32)).astype(np.int32)} for _ in range(STEPS * gas)]
    config = _config(optimizer, gas)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams, config=config,
                                             mesh=_one_device_mesh())
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params_from_numpy(
        jparams, "cpu", cfg=cfg), config=config, device="cpu")
    jit, tit = iter(batches), iter(batches)
    norms = []
    for _ in range(STEPS):
        jl, tl = float(jeng.train_batch(jit)), float(engine.train_batch(tit))
        assert abs(tl - jl) <= 2e-5
        assert engine.get_lr()[0] == jeng.get_lr()[0]
        jn, tn = jeng.get_global_grad_norm(), engine.get_global_grad_norm()
        assert abs(tn - jn) <= 1e-5 * jn
        norms.append(tn)
    assert max(norms) > 0.5  # the clip fired
    assert engine.global_steps == jeng.global_steps == STEPS and engine.skipped_steps == jeng.skipped_steps == 0
    want = _flat(jax.tree.map(np.asarray, jeng.params))
    got = _flat(engine.module_state_dict())
    assert set(got) == set(want)
    init = _flat(jparams)
    for path in want:
        travel = np.abs(want[path] - init[path]).max()  # how far the reference moved this tensor's farthest element
        # k_proj's bias has a zero true gradient (softmax ignores a per-row
        # constant), so each engine turns its own fp32 noise into steps
        tol = 2 * travel if path.endswith("k_proj/bias") else _PARAM_TOL * travel
        np.testing.assert_allclose(got[path].numpy(), want[path], atol=tol, rtol=0, err_msg=path)


def _linear_loss_jax(params, batch, rng=None):
    return jnp.mean(jnp.sum((batch["x"] @ params["w"])**2, -1) * batch["poison"])


def _linear_loss_torch(params, batch, rng=None):
    return torch.mean(torch.sum((batch["x"] @ params["w"])**2, -1) * batch["poison"])


@pytest.mark.parametrize("optimizer", ENGINE_OPTIMIZERS, ids=[o["type"] + str(i) for i, o in
                                                              enumerate(ENGINE_OPTIMIZERS)])
def test_a_non_finite_gradient_skips_the_step_in_both_engines(optimizer):
    rng = np.random.default_rng(3)
    w0 = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    config = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1000, "optimizer": optimizer}
    batches = [{"x": rng.standard_normal((2, 4)).astype(np.float32), "poison": np.ones(2, np.float32)}
               for _ in range(3)]
    batches[1]["poison"] = np.array([1.0, np.inf], np.float32)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=_linear_loss_jax, model_parameters=w0, config=config,
                                             mesh=_one_device_mesh())
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=_linear_loss_torch, model_parameters=w0, config=config,
                                                   device="cpu")
    jit, tit = iter(batches), iter(batches)
    seen = []
    for step in range(3):
        jeng.train_batch(jit)
        teng.train_batch(tit)
        seen.append((jeng.was_step_applied(), teng.was_step_applied()))
        if step == 0:
            after_first = teng.module_state_dict()["w"].clone()
        if step == 1:
            assert torch.equal(teng.module_state_dict()["w"], after_first)
    assert seen == [(True, True), (False, False), (True, True)]
    assert jeng.skipped_steps == teng.skipped_steps == 1
    np.testing.assert_allclose(teng.module_state_dict()["w"].numpy(), np.asarray(jeng.params["w"]), atol=1e-6)
