"""The port's checkpoints: native ZeRO files, universal checkpoints across
packages, zero_to_fp32 and the asynchronous engine.

- A save at step 3 and a resume into a fresh engine continue a 6-step run
  bit for bit (losses and masters), at world 2 over gloo: stage 2 with
  FusedAdam written synchronously, stage 3 with LAMB written on the
  background thread. An engine at another stage refuses the files and
  points to the universal checkpoint; ``python -m
  deepspeed_tpu_torch.checkpoint.zero_to_fp32`` merges the rank files into
  the masters the engine held, bit for bit.
- Universal checkpoints cross packages: the JAX engine at ``data: 2`` stage 2
  trains 3 steps and writes one, the port at world 4 stage 3 resumes it and
  trains 3 steps beside the JAX engine's own next 3 (losses within 2e-5,
  as ``test_torch_train_engine.py``); the port then writes one, and a fresh
  JAX engine at ``data: 2`` stage 2 resumes it beside the port's own next 3.
- ``AsyncCheckpointEngine`` behaves as the JAX package's: ``save`` returns
  before the bytes land, ``commit`` does not block, ``wait`` drains every
  write and raises a failure, ``load`` waits.
- At world 1, the partial loads, the universal route of ``load_checkpoint``
  and ``save_16bit_model``.
"""

import dataclasses
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import torch_zero_worker as zw
import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime import checkpoint_engine as jax_ckpt
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.runtime import checkpoint_engine as port_ckpt

V = 512
LOSS_TOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(stage, optimizer, micro, mesh, async_save=False):
    lr = 1e-3 if optimizer == "FusedAdam" else 1e-2
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": lr,
                                                         "warmup_num_steps": 4, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "mesh": mesh, "checkpoint": {"async_save": async_save},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0,
                                  "reduce_bucket_size": 20000}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _save_batches(path, n, rows, seed=0):
    rng = np.random.default_rng(seed)
    bs = [{"input_ids": rng.integers(0, V, (rows, 32)).astype(np.int32)} for _ in range(n)]
    np.savez(path, **{f"{k}__{j}": v for j, b in enumerate(bs) for k, v in b.items()})
    return bs


@pytest.fixture(scope="module")
def jax_params():
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return model, jax.tree.map(np.asarray, params)


ROUND_TRIP = [dict(name="stage2-FusedAdam-sync", config=_config(2, "FusedAdam", 2, {"data": 2})),
              dict(name="stage3-Lamb-async", config=_config(3, "Lamb", 2, {"data": 2}, async_save=True))]


@pytest.fixture(scope="module")
def round_trip(jax_params, tmp_path_factory):
    _, jparams = jax_params
    d = tmp_path_factory.mktemp("ckpt")
    np.savez(d / "params.npz", **_flat(jparams))
    _save_batches(d / "batches.npz", 6, 4)
    (d / "out").mkdir()
    zw.spawn(2, zw.ckpt_round_trip, ROUND_TRIP, str(d / "params.npz"), str(d / "batches.npz"), V, str(d / "ckpt"),
             str(d / "out"))
    return d, [[torch.load(d / "out" / f"case{i}_rank{r}.pt", weights_only=False) for r in range(2)]
               for i in range(len(ROUND_TRIP))]


@pytest.mark.parametrize("i", range(len(ROUND_TRIP)), ids=[c["name"] for c in ROUND_TRIP])
def test_a_resumed_run_continues_bit_for_bit(round_trip, i):
    _, cases = round_trip
    for rank, r in enumerate(cases[i]):
        assert r["got"] == r["want"], (r["got"], r["want"])
        assert r["exact"] and r["steps"] == 6
        assert r["client"] == {"note": "kept", "rank_seen": 0}  # rank 0's client state
        assert "universal" in r["refused"]


@pytest.mark.parametrize("i", range(len(ROUND_TRIP)), ids=[c["name"] for c in ROUND_TRIP])
def test_zero_to_fp32_cli_merges_the_rank_files(round_trip, i, tmp_path):
    d, cases = round_trip
    out = tmp_path / "fp32.pt"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.checkpoint.zero_to_fp32", str(d / "ckpt" / f"case{i}"),
                    str(out)], check=True, env=env, timeout=120)
    merged = torch.load(out, weights_only=True)
    want = cases[i][0]["saved_masters"]
    assert set(merged) == set(want)
    for path, t in merged.items():
        assert t.dtype == torch.float32 and np.array_equal(t.numpy(), want[path]), path


def _jax_engine(model, jparams, stage, micro, world):
    mesh = MeshTopology(MeshConfig.from_dict({"data": world}), devices=jax.devices()[:world])
    eng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams,
                                            config=_config(stage, "FusedAdam", micro, {"data": world}), mesh=mesh)
    return eng


def test_universal_checkpoints_cross_packages(jax_params, tmp_path):
    model, jparams = jax_params
    np.savez(tmp_path / "params.npz", **_flat(jparams))
    batches = _save_batches(tmp_path / "batches.npz", 9, 4)
    jeng = _jax_engine(model, jparams, 2, 2, 2)
    it = iter(batches)
    for _ in range(3):
        jeng.train_batch(it)
    jeng.save_universal_checkpoint(str(tmp_path / "from_jax"), tag="jax")
    jax_next = [float(jeng.train_batch(it)) for _ in range(3)]
    (tmp_path / "out").mkdir()
    zw.spawn(4, zw.universal_resume, dict(config=_config(3, "FusedAdam", 1, {"data": 4})),
             str(tmp_path / "params.npz"), str(tmp_path / "batches.npz"), V, str(tmp_path / "from_jax"),
             str(tmp_path / "from_port"), str(tmp_path / "out"))
    port = torch.load(tmp_path / "out" / "rank0.pt", weights_only=False)
    assert port["steps_loaded"] == 3
    for got, want in zip(port["before"], jax_next):
        assert abs(got - want) <= LOSS_TOL, (port["before"], jax_next)
    back = _jax_engine(model, jparams, 2, 2, 2)
    back.load_universal_checkpoint(str(tmp_path / "from_port"))
    assert back.global_steps == 6
    it = iter(batches[6:])
    jax_after = [float(back.train_batch(it)) for _ in range(3)]
    for got, want in zip(port["after"], jax_after):
        assert abs(got - want) <= LOSS_TOL, (port["after"], jax_after)


class _SlowTorch(port_ckpt.TorchCheckpointEngine):
    def __init__(self, gate, fail=False):
        super().__init__()
        self.gate, self.fail = gate, fail

    def save(self, state, path):
        self.gate.wait(30)
        if self.fail:
            raise OSError("disk full")
        super().save(state, path)


class _SlowMsgpack(jax_ckpt.MsgpackCheckpointEngine):
    def __init__(self, gate, fail=False):
        super().__init__()
        self.gate, self.fail = gate, fail

    def _write_host(self, host_state, path):
        self.gate.wait(30)
        if self.fail:
            raise OSError("disk full")
        super()._write_host(host_state, path)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_async_engine_wait_and_commit(package, tmp_path):
    gate = threading.Event()
    base = _SlowTorch(gate) if package == "port" else _SlowMsgpack(gate)
    eng = (port_ckpt.AsyncCheckpointEngine if package == "port" else jax_ckpt.AsyncCheckpointEngine)(base=base)
    path = str(tmp_path / "state")
    state = {"w": np.arange(4, dtype=np.float32)}
    eng.save(state, path)
    assert not os.path.exists(path)  # save returned before the bytes landed
    assert eng.commit("t") is True  # and commit does not wait for them
    gate.set()
    loaded = eng.load(path)  # load drains first
    assert os.path.exists(path) and np.array_equal(np.asarray(loaded["w"]), state["w"])
    fail_gate = threading.Event()
    failing = (port_ckpt.AsyncCheckpointEngine if package == "port" else jax_ckpt.AsyncCheckpointEngine)(
        base=_SlowTorch(fail_gate, fail=True) if package == "port" else _SlowMsgpack(fail_gate, fail=True))
    failing.save(state, str(tmp_path / "other"))
    fail_gate.set()
    with pytest.raises(OSError, match="disk full"):
        failing.wait()
    failing.wait()  # the failure was reported once; nothing is pending


def test_partial_loads_and_the_16bit_model(tmp_path):
    """One rank (a world of one): ``load_module_only`` and
    ``load_optimizer_states=False`` restore the masters and keep the fresh
    counters and optimizer; ``checkpoint.load_universal`` routes
    ``load_checkpoint`` through the universal layout; ``save_16bit_model``
    writes bf16 leaves, and refuses at stage 3 without
    ``stage3_gather_16bit_weights_on_model_save``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, init_params

    cfg = zw.model_cfg(V)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batches = [{"input_ids": np.random.default_rng(i).integers(0, V, (2, 16)).astype(np.int32)} for i in range(3)]

    def engine(stage, **zero):
        config = dict(_config(stage, "FusedAdam", 2, {"data": 1}), zero_optimization={"stage": stage, **zero})
        return deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params, config=config,
                                              device="cpu")[0]

    trained = engine(1)
    for b in batches:
        trained.train_batch(iter([b]))
    trained.save_checkpoint(str(tmp_path / "native"))
    trained.save_universal_checkpoint(str(tmp_path / "universal"))
    want = trained.module_state_dict()
    for kw in (dict(load_module_only=True), dict(load_optimizer_states=False)):
        fresh = engine(1)
        fresh.load_checkpoint(str(tmp_path / "native"), **kw)
        got = fresh.module_state_dict()
        assert all(torch.equal(a, b) for a, b in zip(_sorted_leaves(got), _sorted_leaves(want)))
        assert fresh.global_steps == 0 and fresh.optimizer_step_count == 0
    routed = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params, device="cpu", config=dict(
        _config(3, "FusedAdam", 2, {"data": 1}), checkpoint={"load_universal": True}))[0]
    path, _ = routed.load_checkpoint(str(tmp_path / "universal"))
    assert path.endswith("global_step3") and routed.global_steps == 3 and routed.optimizer_step_count == 3
    assert all(torch.equal(a, b) for a, b in zip(_sorted_leaves(routed.module_state_dict()), _sorted_leaves(want)))
    out = trained.save_16bit_model(str(tmp_path / "export"))
    weights = torch.load(out, weights_only=True)
    assert set(weights) == set(trained._paths) and all(t.dtype == torch.bfloat16 for t in weights.values())
    assert engine(3).save_16bit_model(str(tmp_path / "refused")) is False
    assert engine(3, stage3_gather_16bit_weights_on_model_save=True).save_16bit_model(
        str(tmp_path / "gathered")).endswith("pytorch_model.bin")


def _sorted_leaves(tree):
    return [v for _, v in sorted(_flat(tree).items())]
