"""Port parity: activation checkpointing, and ZeRO stage 3 with the model's remat.

- ``checkpoint(fn, *args)`` gives the plain function's values and
  gradients, bit for bit in fp32, recomputing (``torch.utils.checkpoint``)
  or, under ``cpu_checkpointing``, with the saved residuals in host memory;
  ``CheckpointFunction.apply`` and ``partitioned_checkpoint`` route through
  it; ``configure`` sets its flags from a config and by argument, ``reset``
  clears them, and every engine configures the module from its own config.
- The model's remat checkpoints each block through the module.
- At ZeRO stage 3 (with and without parameter offload) ``remat`` gives the
  losses and masters of stage 3 without it bit for bit in fp32 over 3 steps,
  gathers each block again for its recompute and reduces its gradient once
  (the gathered-byte accounting ends at 0 and peaks within one block plus
  the top-level groups), and holds the JAX remat engine at stage 3 within
  2e-5 (as ``test_torch_train_engine.py``).
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import torch_zero_worker as zw
import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.models import CausalLM, gpt2_tiny, params_from_numpy
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

V = 512
STEPS = 3
LOSS_TOL = 2e-5


@pytest.fixture(autouse=True)
def _fresh_flags():
    ac.reset()
    yield
    ac.reset()


def _block(seed=0):
    g = torch.Generator().manual_seed(seed)
    w1, w2 = torch.randn(16, 32, generator=g), torch.randn(32, 16, generator=g)
    x = torch.randn(4, 16, generator=g)
    return w1, w2, x


def _fn(x, w1, w2, scale=1.0):
    return torch.tanh(x @ w1).relu() @ w2 * scale


def _values_and_grads(call, w1, w2, x):
    w1, w2, x = (t.clone().requires_grad_(True) for t in (w1, w2, x))
    out = call(x, w1, w2)
    out.square().sum().backward()
    return out.detach(), w1.grad, w2.grad, x.grad


@pytest.mark.parametrize("mode", ["recompute", "cpu_checkpointing", "CheckpointFunction", "partitioned"])
def test_checkpoint_equals_the_plain_function(mode):
    w1, w2, x = _block()
    want = _values_and_grads(lambda x, a, b: _fn(x, a, b, scale=0.5), w1, w2, x)
    if mode == "cpu_checkpointing":
        ac.configure(checkpoint_in_cpu=True)
    calls = []

    def counted(x, a, b, scale=1.0):
        calls.append(1)
        return _fn(x, a, b, scale)

    if mode == "CheckpointFunction":
        got = _values_and_grads(lambda x, a, b: ac.CheckpointFunction.apply(
            lambda *t: counted(*t, scale=0.5), x, a, b), w1, w2, x)
    elif mode == "partitioned":
        got = _values_and_grads(lambda x, a, b: ac.partitioned_checkpoint(counted)(x, a, b, scale=0.5), w1, w2, x)
    else:
        got = _values_and_grads(lambda x, a, b: ac.checkpoint(counted, x, a, b, scale=0.5), w1, w2, x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(calls) == (1 if mode == "cpu_checkpointing" else 2)  # the recompute runs the function again


def test_configure_sets_the_flags_from_a_config_and_by_argument(caplog):
    assert not ac.is_configured() and not ac.checkpointing._CONFIG["cpu_checkpointing"]
    cfg = DeepSpeedConfig({"activation_checkpointing": {"partition_activations": True, "cpu_checkpointing": True,
                                                        "contiguous_memory_optimization": True}})
    ac.configure(deepspeed_config=cfg)
    flags = ac.checkpointing._CONFIG
    assert ac.is_configured() and flags["partition_activations"] and flags["cpu_checkpointing"]
    assert flags["contiguous_memory_optimization"]
    ac.configure(deepspeed_config=cfg, checkpoint_in_cpu=False, partition_activations=False)  # arguments win
    assert not flags["cpu_checkpointing"] and not flags["partition_activations"]
    ac.reset()
    assert not ac.is_configured() and not any(flags.values())
    with caplog.at_level(logging.INFO):
        assert ac.model_parallel_cuda_manual_seed(1234) is None
    assert "no-op" in caplog.text


def _linear_loss(params, batch, rng=None):
    return ((batch["x"] @ params["w"]) ** 2).mean()


def test_every_engine_configures_the_module():
    params = {"w": np.zeros((4, 3), np.float32)}
    base = {"train_micro_batch_size_per_gpu": 1}
    deepspeed_tpu_torch.initialize(model=_linear_loss, model_parameters=params, device="cpu",
                                   config={**base, "activation_checkpointing": {"cpu_checkpointing": True}})
    assert ac.is_configured() and ac.checkpointing._CONFIG["cpu_checkpointing"]
    deepspeed_tpu_torch.initialize(model=_linear_loss, model_parameters=params, device="cpu", config=base)
    assert not ac.checkpointing._CONFIG["cpu_checkpointing"]  # one engine's flags never leak into the next


def test_the_models_remat_goes_through_the_module(monkeypatch):
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V, remat=True)
    params = deepspeed_tpu_torch.models.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = []
    real = ac.checkpointing.checkpoint
    monkeypatch.setattr(tt.checkpointing, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, V, (2, 16)))
    CausalLM(cfg).loss_fn(params, {"input_ids": ids})
    assert len(calls) == cfg.n_layers


# ------------------------------------------------------------------ ZeRO stage 3 with remat
def _config(zero):
    return {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 1000,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 3, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "zero_optimization": {"stage3_param_persistence_threshold": 1000, **zero}}


def _batches():
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, V, (2, 32)).astype(np.int32)} for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_params():
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return jax.tree.map(np.asarray, params)


def _port(jparams, zero, remat):
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V, remat=remat)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params_from_numpy(
        jparams, "cpu", cfg=cfg), config=_config(zero), device="cpu")
    it = iter(_batches())
    return eng, [float(eng.train_batch(it)) for _ in range(STEPS)]


ZERO3 = {"plain": {"stage": 3},
         "param-offload": {"stage": 3, "offload_param": {"device": "cpu"}, "offload_optimizer": {"device": "cpu"}}}


@pytest.mark.parametrize("name", list(ZERO3))
def test_stage3_with_remat_equals_stage3_bit_for_bit(jax_params, name):
    base, want = _port(jax_params, ZERO3[name], remat=False)
    eng, got = _port(jax_params, ZERO3[name], remat=True)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(eng.full_masters(), base.full_masters()))
    s = eng._stage3
    limit = zw.gather_limits(eng)
    assert s.gathered_bytes == 0 and 0 < s.peak_gathered_bytes <= limit["limit"], limit
    assert not s._bwd and not s._bwd_trees and not s.in_backward
    # the recompute gathers each block once more and reduces nothing: as many reductions as without remat
    assert eng.comm_stats["all_reduce"] == base.comm_stats["all_reduce"]


def test_stage3_with_remat_matches_the_jax_remat_engine(jax_params):
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V, remat=True))
    mesh = MeshTopology(MeshConfig.from_dict({"data": 1}), devices=jax.devices()[:1])
    jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jax_params,
                                             config=_config({"stage": 3}), mesh=mesh)
    it = iter(_batches())
    want = [float(jeng.train_batch(it)) for _ in range(STEPS)]
    _, got = _port(jax_params, {"stage": 3}, remat=True)
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_TOL, (got, want)
