"""Port parity: ZeRO-Offload through ``DeepSpeedEngine`` against the JAX engine.

Both engines start from the JAX initialisation of ``gpt2_tiny`` at
vocabulary 512, fp32, on one process (the JAX engine on a one-device mesh),
with the same config and the same seeded batches, over 3 steps with WarmupLR
and a clip that fires:

- stage 2 with ``offload_optimizer`` ``cpu`` and ``nvme`` (a swap folder
  under ``tmp_path``, pipelined);
- stage 3 with ``offload_param`` ``cpu`` and ``nvme``, with and without
  ``offload_optimizer`` of the same device (persistence threshold 1,000:
  the biases and norms stay on the device).

Held: the losses within 2e-5 absolute (as ``test_torch_train_engine.py``)
and every master after the last step within 2 % of how far the reference
moved that tensor (as ``test_torch_zero_engine.py``); no optimizer state on
the device under optimizer offload, the threshold's split of the leaves,
the host masters shared with the host optimizer, the swap files. Then: a
native checkpoint resumes bit for bit; universal checkpoints cross packages
both ways with offload on either side and keep the optimizer's step count;
``zero_to_fp32`` merges an offload checkpoint; a non-Adam and a client
optimizer warn and keep their states on the device; the config's aliases.
At world 2 over gloo each rank's host holds its half of the moments and the
losses are world 1's.
"""

import dataclasses
import logging
import os

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
from deepspeed_tpu_torch.checkpoint.zero_to_fp32 import get_fp32_flat_state_dict_from_zero_checkpoint
from deepspeed_tpu_torch.models import CausalLM, gpt2_tiny, params_from_numpy
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.optimizers import Adam
from deepspeed_tpu_torch.runtime.zero.partition import shard_leaf_dim

V = 512
STEPS = 3
LOSS_TOL = 2e-5
PARAM_TOL = 0.02  # of each tensor's travel in the reference
THRESHOLD = 1000
ENGINE_LOG = "deepspeed_tpu_torch.runtime.engine"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _zero(case: str, folder) -> dict:
    """The zero_optimization section of a case (NVMe files under ``folder``)."""
    nvme = {"device": "nvme", "nvme_path": str(folder)}
    return {
        "stage2-cpu": {"stage": 2, "offload_optimizer": {"device": "cpu"}},
        "stage2-nvme": {"stage": 2, "offload_optimizer": {**nvme, "pipeline_read": True}},
        "stage3-param-cpu-opt-cpu": {"stage": 3, "offload_param": {"device": "cpu"},
                                     "offload_optimizer": {"device": "cpu"}},
        "stage3-param-nvme-opt-nvme": {"stage": 3, "offload_param": nvme, "offload_optimizer": nvme},
        "stage3-param-cpu": {"stage": 3, "offload_param": {"device": "cpu"}},
        "stage3-param-nvme": {"stage": 3, "offload_param": nvme},
    }[case]


CASES = ["stage2-cpu", "stage2-nvme", "stage3-param-cpu-opt-cpu", "stage3-param-nvme-opt-nvme", "stage3-param-cpu",
         "stage3-param-nvme"]


def _config(zero: dict, micro: int = 2, optimizer: str = "FusedAdam") -> dict:
    return {"train_micro_batch_size_per_gpu": micro, "steps_per_print": 1000,
            "optimizer": {"type": optimizer, "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 3, "warmup_type": "linear"}},
            "gradient_clipping": 0.5,
            "zero_optimization": {"stage3_param_persistence_threshold": THRESHOLD, **zero}}


def _batches(n, rows=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, V, (rows, 32)).astype(np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def jax_params():
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return model, jax.tree.map(np.asarray, params)


def _jax_engine(model, jparams, config):
    mesh = MeshTopology(MeshConfig.from_dict({"data": 1}), devices=jax.devices()[:1])
    eng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams, config=config, mesh=mesh)
    return eng


def _port_engine(jparams, config):
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V)
    eng, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params_from_numpy(
        jparams, "cpu", cfg=cfg), config=config, device="cpu")
    return eng


def _train(engine, batches):
    it = iter(batches)
    return [float(engine.train_batch(it)) for _ in range(len(batches))]


def _files(folder) -> list:
    return sorted(f for _, _, files in os.walk(folder) for f in files)


@pytest.mark.parametrize("case", CASES)
def test_offload_engine_matches_the_jax_engine(jax_params, tmp_path, case):
    model, jparams = jax_params
    (tmp_path / "jax").mkdir()  # the JAX engine maps its master files into an existing folder
    port = _port_engine(jparams, _config(_zero(case, tmp_path / "port")))
    got = _train(port, _batches(STEPS))
    jeng = _jax_engine(model, jparams, _config(_zero(case, tmp_path / "jax")))
    want = _train(jeng, _batches(STEPS))
    for a, b in zip(got, want):
        assert abs(a - b) <= LOSS_TOL, (got, want)
    init, ref = _flat(jparams), _flat(jax.tree.map(np.asarray, jeng.params))
    masters = dict(zip(port._paths, port.full_masters()))
    for path, w in ref.items():
        travel = np.abs(w - init[path]).max()
        tol = 2 * travel if path.endswith("k_proj/bias") else PARAM_TOL * travel
        np.testing.assert_allclose(masters[path].numpy(), w, atol=tol, rtol=0, err_msg=path)

    opt_off = "offload_optimizer" in _zero(case, tmp_path)
    param_off = case.startswith("stage3-param")
    assert (port._host_opt is not None) == opt_off == (jeng._host_offload is not None)
    if opt_off:  # the device holds no optimizer state, the host all of it
        assert not port.optimizer.state and port.optimizer_step_count == STEPS
        assert port.offload_stats["steps"] == STEPS and port.offload_stats["d2h_bytes"] > 0
    else:
        assert port.optimizer.state
    want_off = [lf.numel >= THRESHOLD for lf in port.plan.leaves] if param_off else [False] * len(port.plan.leaves)
    assert port._param_offloaded == want_off
    if param_off:
        assert 0 < sum(want_off) < len(want_off)  # the threshold keeps the biases and norms on the device
        for i, off in enumerate(want_off):
            assert port._masters[i].requires_grad is not off
            if off and opt_off:
                assert port._masters[i] is port._host_opt.master[i]  # one host copy, stepped in place
        assert port.offload_stats["param_h2d_bytes"] > 0
        assert port.zero_gathered_bytes[0] == 0
    if case == "stage2-nvme" or case == "stage3-param-nvme-opt-nvme":
        swp = [f for f in _files(tmp_path / "port") if f.endswith(".swp")]
        assert len(swp) == 2 * len(port.plan.leaves)
    if case == "stage3-param-nvme-opt-nvme":  # the masters are files too
        assert sum(f.startswith("master_") for f in _files(tmp_path / "port")) == len(port.plan.leaves)
    if case == "stage3-param-nvme":  # without a host optimizer the masters stay in host memory
        assert not any(f.startswith("master_") for f in _files(tmp_path / "port"))


@pytest.mark.parametrize("case", ["stage2-cpu", "stage3-param-nvme-opt-nvme"])
def test_an_offload_checkpoint_resumes_bit_for_bit(jax_params, tmp_path, case):
    _, jparams = jax_params
    batches = _batches(4)
    straight = _port_engine(jparams, _config(_zero(case, tmp_path / "a")))
    want = _train(straight, batches)
    first = _port_engine(jparams, _config(_zero(case, tmp_path / "b")))
    got = _train(first, batches[:2])
    first.save_checkpoint(str(tmp_path / "ckpt"), tag="two")
    saved = dict(zip(first._paths, [t.clone() for t in first.full_masters()]))
    merged = get_fp32_flat_state_dict_from_zero_checkpoint(str(tmp_path / "ckpt"))
    assert set(merged) == set(saved) and all(torch.equal(merged[p], saved[p]) for p in saved)
    resumed = _port_engine(jparams, _config(_zero(case, tmp_path / "c")))
    resumed.load_checkpoint(str(tmp_path / "ckpt"))
    assert resumed.optimizer_step_count == 2 and resumed.global_steps == 2
    got += _train(resumed, batches[2:])
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(resumed.full_masters(), straight.full_masters()))


def _optax_counts(engine):
    return [int(np.asarray(x)) for x in jax.tree_util.tree_leaves(engine.opt_state)
            if np.asarray(x).ndim == 0 and np.asarray(x).dtype.kind == "i"]


def test_universal_checkpoints_cross_packages_with_offload(jax_params, tmp_path):
    model, jparams = jax_params
    batches = _batches(5)
    # the JAX offload engine writes one; the port without offload and with it resume it
    jeng = _jax_engine(model, jparams, _config(_zero("stage2-cpu", tmp_path)))
    _train(jeng, batches[:2])
    jeng.save_universal_checkpoint(str(tmp_path / "from_jax"), tag="jax")
    jax_next = _train(jeng, batches[2:3])
    for zero in ({"stage": 2}, _zero("stage3-param-cpu-opt-cpu", tmp_path)):
        port = _port_engine(jparams, _config(zero))
        port.load_universal_checkpoint(str(tmp_path / "from_jax"))
        assert port.optimizer_step_count == 2 and port.global_steps == 2
        got = _train(port, batches[2:3])
        assert abs(got[0] - jax_next[0]) <= LOSS_TOL, (got, jax_next)
    # the port's offload engine writes one; the JAX engine with offload and without resumes it
    port = _port_engine(jparams, _config(_zero("stage3-param-cpu-opt-cpu", tmp_path)))
    _train(port, batches[:3])
    port.save_universal_checkpoint(str(tmp_path / "from_port"), tag="port")
    port_next = _train(port, batches[3:5])
    for zero in (_zero("stage2-cpu", tmp_path), {"stage": 2}):
        back = _jax_engine(model, jparams, _config(zero))
        back.load_universal_checkpoint(str(tmp_path / "from_port"))
        if back._host_offload is not None:
            assert back._host_offload.step_count == 3
        else:
            assert 3 in _optax_counts(back), _optax_counts(back)
        got = _train(back, batches[3:5])
        for a, b in zip(got, port_next):
            assert abs(a - b) <= LOSS_TOL, (got, port_next)
    # and within the port, offload to the device optimizer
    dev = _port_engine(jparams, _config({"stage": 2}))
    dev.load_universal_checkpoint(str(tmp_path / "from_port"))
    assert dev.optimizer_step_count == 3
    for a, b in zip(_train(dev, batches[3:5]), port_next):
        assert abs(a - b) <= LOSS_TOL


def test_other_optimizers_warn_and_keep_their_states_on_the_device(jax_params, caplog):
    _, jparams = jax_params
    with caplog.at_level(logging.WARNING, logger=ENGINE_LOG):
        lamb = _port_engine(jparams, _config(_zero("stage2-cpu", None), optimizer="Lamb"))
    assert lamb._host_opt is None and "adam-family" in caplog.text
    _train(lamb, _batches(1))
    assert lamb.optimizer.state
    caplog.clear()
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V)
    params = params_from_numpy(jparams, "cpu", cfg=cfg)
    probe = _port_engine(jparams, _config({"stage": 0}))
    client = Adam(probe.parameters(), lr=1e-3)
    with caplog.at_level(logging.WARNING, logger=ENGINE_LOG):
        eng, opt, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params,
                                                        optimizer=client, device="cpu",
                                                        config=_config(_zero("stage2-cpu", None) | {"stage": 0}))
    assert eng._host_opt is None and opt is client and "client optimizer" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        stage2 = _port_engine(jparams, _config({"stage": 2, "offload_param": {"device": "cpu"}}))
    assert not any(stage2._param_offloaded) and "requires ZeRO stage 3" in caplog.text


def test_the_config_reads_the_offload_sections():
    zc = DeepSpeedConfig({"zero_optimization": {"stage": 2, "cpu_offload": True}}).zero_config
    assert zc.offload_optimizer.device == "cpu" and zc.offload_param.device == "none"
    zc = DeepSpeedConfig({"zero_optimization": {"stage": 3, "cpu_offload_params": True,
                                                "offload_optimizer": {"device": "nvme", "nvme_path": "/x"}}}).zero_config
    assert zc.offload_param.device == "cpu" and zc.offload_optimizer.device == "nvme"
    assert zc.offload_optimizer.nvme_path == "/x" and zc.offload_optimizer.buffer_count == 4
    full = DeepSpeedConfig({"aio": {"thread_count": 3}, "activation_checkpointing": {"cpu_checkpointing": True}})
    assert full.aio.thread_count == 3 and full.activation_checkpointing.cpu_checkpointing
    assert DeepSpeedConfig({}).aio.thread_count == 1
    with pytest.raises(ValueError, match="offload_param.device"):
        DeepSpeedConfig({"zero_optimization": {"offload_param": {"device": "disk"}}})
    # ZeRO++ and MiCS's shard size sit beside the offload sections and are read, not refused
    zpp = DeepSpeedConfig({"zero_optimization": {"stage": 3, "zero_quantized_gradients": True,
                                                 "zero_hpz_partition_size": 2, "mics_shard_size": 4}})
    assert zpp.zero_config.zero_quantized_gradients and zpp.zero_config.zero_hpz_partition_size == 2
    assert zpp.mesh.fsdp == 4 and zpp.zero_config.offload_param.device == "none"


def test_two_gloo_ranks_hold_half_the_moments_each(jax_params, tmp_path):
    _, jparams = jax_params
    np.savez(tmp_path / "params.npz", **_flat(jparams))
    world, micro = 2, 2
    bs = _batches(STEPS, rows=world * micro, seed=1)
    np.savez(tmp_path / "batches.npz", **{f"{k}__{j}": v for j, b in enumerate(bs) for k, v in b.items()})
    cases = [dict(name=n, config={**_config(_zero(n, tmp_path / "nvme"), micro), "mesh": {"data": world}})
             for n in ("stage2-cpu", "stage3-param-cpu-opt-cpu")]
    (tmp_path / "out").mkdir()
    zw.spawn(world, zw.train_cases, cases, str(tmp_path / "params.npz"), [str(tmp_path / "batches.npz")] * 2, V,
             STEPS, str(tmp_path / "out"))
    for i, case in enumerate(cases):
        ranks = [torch.load(tmp_path / "out" / f"case{i}_rank{r}.pt", weights_only=False) for r in range(world)]
        one = _port_engine(jparams, _config(_zero(case["name"], tmp_path / "one"), world * micro))
        want = _train(one, bs)
        for r in ranks:
            assert r["losses"] == ranks[0]["losses"]
            for a, b in zip(r["losses"], want):
                assert abs(a - b) <= LOSS_TOL, (r["losses"], want)
        whole = one.offload_stats["host_bytes"]["moments"]
        plan = sum(_chunk_numel(lf.shape, world) * 8 for lf in one.plan.leaves)
        for r in ranks:
            assert r["offload"]["host_bytes"]["moments"] == plan < whole
            assert r["held"]["moments"] == 0  # nothing on the device
        assert 2 * plan - whole <= 0.01 * whole  # the leaves no dimension of which two divides are few
        init = _flat(jparams)
        for path, w in zip(one._paths, one.full_masters()):
            travel = np.abs(w.numpy() - init[path]).max()
            tol = 2 * travel if path.endswith("k_proj/bias") else PARAM_TOL * travel
            np.testing.assert_allclose(ranks[0]["masters"][path], w.numpy(), atol=tol, rtol=0, err_msg=path)


def _chunk_numel(shape, world: int) -> int:
    n = int(np.prod(shape)) if shape else 1
    return n if shard_leaf_dim(shape, world) is None else n // world
