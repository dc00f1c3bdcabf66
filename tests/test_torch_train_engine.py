"""Port parity: ``initialize(...).train_batch`` against the JAX training engine.

The JAX engine is built on a one-device mesh (``MeshTopology`` over the first
of the 8 faked CPU devices, ``data`` = 1), so both engines see the same
global batch of ``train_micro_batch_size_per_gpu`` x gas rows. Both start
from the JAX initialisation of ``gpt2_tiny`` at vocabulary 512 (converted
with ``params_from_numpy``) and take the same numpy batches; the port runs
on the CPU in fp32 with FusedAdam's plain version. Held to the reference
over 5 steps, with gas 1 and gas 2, WarmupLR, and a clip that fires:
the losses (2e-5 abs), the LR sequence (exact), the global grad norm (1e-5
relative) and every parameter after the last step (2 % of the Adam travel,
the sum of the lr over the steps; measured at most 0.6 %). A non-finite
gradient skips the step in both engines; a config section the port does
not implement raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.models import CausalLM, gpt2_tiny, params_from_numpy
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

V = 512
STEPS = 5
PARAM_TOL = 0.02  # of the Adam travel (sum of lr): Adam divides by sqrt(v), so tiny fp32 gradient
#                   differences on small-gradient elements move them by a visible share of lr


def _one_device_mesh():
    return MeshTopology(MeshConfig.from_dict({"data": 1}), devices=jax.devices()[:1])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _config(gas, fused_step=True):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 3,
                                     "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "fused_step": fused_step}


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, V, (2, 32)).astype(np.int32)} for _ in range(n)]


def _run_port(config, jparams, batches, device="cpu"):
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V)
    params = params_from_numpy(jparams, "cpu", cfg=cfg)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params, config=config,
                                                     device=device)
    it = iter(batches)
    trace = []
    for _ in range(STEPS):
        loss = engine.train_batch(it)
        trace.append((float(loss), engine.get_lr()[0], engine.get_global_grad_norm()))
    return engine, trace


@pytest.fixture(scope="module")
def jax_model():
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return model, jax.tree.map(np.asarray, params)  # numpy: the JAX engine donates its device buffers


@pytest.mark.parametrize("gas", [1, 2])
def test_five_steps_match_the_jax_engine(jax_model, gas):
    model, jparams = jax_model
    batches = _batches(STEPS * gas)
    jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams, config=_config(gas),
                                             mesh=_one_device_mesh())
    it = iter(batches)
    jtrace = []
    for _ in range(STEPS):
        loss = jeng.train_batch(it)
        jtrace.append((float(loss), jeng.get_lr()[0], jeng.get_global_grad_norm()))
    engine, trace = _run_port(_config(gas), jparams, batches)
    for (tl, tlr, tn), (jl, jlr, jn) in zip(trace, jtrace):
        assert abs(tl - jl) <= 2e-5
        assert tlr == jlr
        assert abs(tn - jn) <= 1e-5 * jn
    assert max(n for _, _, n in trace) > 0.5  # the clip fired
    assert engine.global_steps == jeng.global_steps == STEPS and engine.skipped_steps == jeng.skipped_steps == 0
    want = _flat(jax.tree.map(np.asarray, jeng.params))
    got = _flat(engine.module_state_dict())
    assert set(got) == set(want)
    travel = sum(lr for _, lr, _ in trace)  # the most an element can move under Adam
    for path in want:
        # k_proj's bias has a zero true gradient (softmax ignores a per-row
        # constant), so Adam turns fp32 noise into steps in both engines
        tol = 2 * travel if path.endswith("k_proj/bias") else PARAM_TOL * travel
        np.testing.assert_allclose(got[path].numpy(), want[path], atol=tol, rtol=0, err_msg=path)


def test_fused_step_key_runs_the_same_step(jax_model):
    _, jparams = jax_model
    batches = _batches(STEPS)
    _, on = _run_port(_config(1, fused_step=True), jparams, batches)
    _, off = _run_port(_config(1, fused_step=False), jparams, batches)
    assert on == off


def test_train_batch_over_a_repeating_loader(jax_model):
    _, jparams = jax_model
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V)
    params = params_from_numpy(jparams, "cpu", cfg=cfg)
    rng = np.random.default_rng(1)
    data = [{"input_ids": rng.integers(0, V, 32).astype(np.int32)} for _ in range(4)]
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params,
                                                          config=_config(1), training_data=data, device="cpu")
    it = RepeatingLoader(loader)
    losses = [float(engine.train_batch(it)) for _ in range(6)]  # three passes over two batches
    assert all(np.isfinite(losses)) and engine.global_steps == 6


def _linear_loss_jax(params, batch, rng=None):
    return jnp.mean(jnp.sum((batch["x"] @ params["w"])**2, -1) * batch["poison"])


def _linear_loss_torch(params, batch, rng=None):
    return torch.mean(torch.sum((batch["x"] @ params["w"])**2, -1) * batch["poison"])


def test_a_non_finite_gradient_skips_the_step_in_both_engines():
    rng = np.random.default_rng(3)
    w0 = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    config = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1000,
              "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-2}}}
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


@pytest.mark.parametrize("section", [
    {"zero_optimization": {"stage": 1}},
    {"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
    {"pipeline": {"stages": 2}},
    {"hybrid_engine": {"enabled": True}},
    {"compression_training": {"weight_quantization": {}}},
    {"progressive_layer_drop": {"enabled": True}},
    {"curriculum_learning": {"enabled": True}},
    {"random_ltd": {"enabled": True}},
    {"eigenvalue": {"enabled": True}},
    {"mesh": {"data": 2}},
    {"optimizer": {"type": "OneBitLamb"}},
])
def test_unported_config_sections_raise(section):
    with pytest.raises(NotImplementedError):
        deepspeed_tpu_torch.initialize(model=_linear_loss_torch, model_parameters={"w": np.zeros((4, 3), np.float32)},
                                       config={"train_micro_batch_size_per_gpu": 1, **section}, device="cpu")


def test_the_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise here")
    with pytest.raises(RuntimeError, match="cuda"):
        deepspeed_tpu_torch.initialize(model=_linear_loss_torch, model_parameters={"w": np.zeros((4, 3), np.float32)},
                                       config={"train_micro_batch_size_per_gpu": 1})


def test_accumulation_boundary_zero_grad_set_lr_and_eval():
    rng = np.random.default_rng(4)
    w0 = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    batch = {"x": rng.standard_normal((2, 4)).astype(np.float32), "poison": np.ones(2, np.float32)}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_linear_loss_torch, model_parameters=w0, device="cpu",
        config={"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    loss = engine(batch)
    assert torch.allclose(engine.eval_batch(batch), loss.detach())
    engine.backward(loss)
    assert not engine.is_gradient_accumulation_boundary()
    engine.step()  # not a boundary: nothing applied
    assert not engine.was_step_applied() and engine.global_steps == 0
    engine.zero_grad()  # the partial window is dropped: two fresh micro-batches make the next step
    engine.backward(engine(batch))
    assert not engine.is_gradient_accumulation_boundary()
    engine.backward(engine(batch))
    assert engine.is_gradient_accumulation_boundary()
    engine.set_lr(0.5)
    assert engine.get_lr() == [0.5]
    before = engine.module_state_dict()["w"].clone()
    engine.step()
    assert engine.was_step_applied() and engine.global_steps == 1
    # Adam's first step moves every element by lr (plus weight decay)
    moved = (engine.module_state_dict()["w"] - before).abs()
    assert torch.allclose(moved, torch.full_like(moved, 0.5), rtol=0.05)
