"""Port parity: ZeRO-Offload's host code against the JAX package.

The host C++ optimizers (``deepspeed_tpu_torch/csrc/host/cpu_adam.cpp``
through ``ops/adam/cpu_adam.py``) step the same seeded numpy inputs as the
JAX package's ``DeepSpeedCPUAdam`` / ``DeepSpeedCPUAdagrad`` /
``DeepSpeedCPULion`` (its own build of ``csrc/cpu_adam.cpp``) and must give
the same bits, for five steps; the plain PyTorch versions agree within
1e-6 relative. The async file I/O (``csrc/host/aio.cpp``) and the swappers
write files the JAX handle reads back, and the other way; the pipelined
optimizer swapper gives the states of the unpipelined one. A host build
that fails raises (there is no fallback).
"""

import os

import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdagrad as JaxAdagrad
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxAdam
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPULion as JaxLion
from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxAIO
from deepspeed_tpu.runtime.swap_tensor import AsyncTensorSwapper as JaxSwapper
from deepspeed_tpu_torch.ops.adam import cpu_adam as ca
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle, aio_available
from deepspeed_tpu_torch.ops.native import NativeOpBuilder, native_available
from deepspeed_tpu_torch.runtime.swap_tensor import AsyncTensorSwapper, PartitionedOptimizerSwapper
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer

N = 10_007  # odd: the vector loop's tail runs too
STEPS = 5
PLAIN_RTOL = 1e-6


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy())


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


OPTIMIZERS = {
    "adamw": dict(jax=lambda: JaxAdam(lr=1e-2, weight_decay=0.01, adamw_mode=True),
                  port=lambda: ca.DeepSpeedCPUAdam(lr=1e-2, weight_decay=0.01, adamw_mode=True), states=2),
    "adam_l2": dict(jax=lambda: JaxAdam(lr=1e-2, betas=(0.8, 0.99), weight_decay=0.1, adamw_mode=False),
                    port=lambda: ca.DeepSpeedCPUAdam(lr=1e-2, betas=(0.8, 0.99), weight_decay=0.1, adamw_mode=False),
                    states=2),
    "adagrad": dict(jax=lambda: JaxAdagrad(lr=1e-2, weight_decay=0.01),
                    port=lambda: ca.DeepSpeedCPUAdagrad(lr=1e-2, weight_decay=0.01), states=1),
    "lion": dict(jax=lambda: JaxLion(lr=1e-3, weight_decay=0.01),
                 port=lambda: ca.DeepSpeedCPULion(lr=1e-3, weight_decay=0.01), states=1),
}


def _plain_step(name, opt, p, g, states, step):
    if name in ("adamw", "adam_l2"):
        b1, b2 = opt.betas
        ca.cpu_adam_ref(p, g, *states, opt.lr, b1, b2, opt.eps, opt.weight_decay, step, opt.adamw_mode)
    elif name == "adagrad":
        ca.cpu_adagrad_ref(p, g, *states, opt.lr, opt.eps, opt.weight_decay)
    else:
        ca.cpu_lion_ref(p, g, *states, opt.lr, *opt.betas, opt.weight_decay)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_host_optimizers_equal_the_jax_cpp_bit_for_bit(name):
    spec = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    p = rng.standard_normal(N).astype(np.float32)
    states = [np.zeros(N, np.float32) for _ in range(spec["states"])]
    if name == "adagrad":
        states[0] += 0.1
    jopt, topt = spec["jax"](), spec["port"]()
    jp, jst = p.copy(), [s.copy() for s in states]
    tp, tst = _t(p), [_t(s) for s in states]
    rp, rst = _t(p), [_t(s) for s in states]
    for step in range(1, STEPS + 1):
        g = rng.standard_normal(N).astype(np.float32)
        jopt.step(jp, g, *jst)
        topt.step(tp, _t(g), *tst)
        _plain_step(name, topt, rp, _t(g), rst, step)
    np.testing.assert_array_equal(tp.numpy(), jp)
    for t, j in zip(tst, jst):
        np.testing.assert_array_equal(t.numpy(), j)
    assert _rel(rp, tp) <= PLAIN_RTOL
    for r, t in zip(rst, tst):
        assert _rel(r, t) <= PLAIN_RTOL


def test_the_wrappers_count_their_calls_and_refuse_bad_tensors():
    before = ca.cpu_adam_step.launches
    p, g, m, v = (torch.zeros(8) for _ in range(4))
    ca.DeepSpeedCPUAdam().step(p, g, m, v)
    assert ca.cpu_adam_step.launches == before + 1
    with pytest.raises(ValueError, match="contiguous fp32 CPU"):
        ca.cpu_adam_step(p.double(), g, m, v, 1e-3, 0.9, 0.999, 1e-8, 0.0, 1)
    with pytest.raises(ValueError, match="contiguous fp32 CPU"):
        ca.cpu_adam_step(torch.zeros(4, 4).t(), torch.zeros(16), torch.zeros(16), torch.zeros(16),
                         1e-3, 0.9, 0.999, 1e-8, 0.0, 1)


@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_the_gradient_pass_equals_its_plain_version(scale):
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(300_001).astype(np.float32))
    want = g.clone()
    got_sq = ca.scale_sq_norm(g, scale)
    want_sq = ca.scale_sq_norm_ref(want, scale)
    assert torch.equal(g, want)
    assert abs(got_sq - want_sq) <= 1e-12 * want_sq
    ca.scale_(g, 0.5)
    assert torch.equal(g, want * 0.5)


def test_the_host_libraries_build_here():
    assert native_available("ds_cpu_optim") and native_available("ds_aio") and aio_available()


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        NativeOpBuilder("ds_bad", ["bad.cpp"], source_dir=str(tmp_path), build_dir=str(tmp_path / "out")).load()
    with pytest.raises(RuntimeError, match="missing sources"):
        NativeOpBuilder("ds_gone", ["gone.cpp"], source_dir=str(tmp_path), build_dir=str(tmp_path / "out")).build()
    (tmp_path / "ok.cpp").write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ is not on PATH"):
        NativeOpBuilder("ds_ok", ["ok.cpp"], source_dir=str(tmp_path), build_dir=str(tmp_path / "out")).build()


# ------------------------------------------------------------------ async I/O and the swappers
def test_aio_files_cross_packages(tmp_path):
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal(1000 + 37 * i).astype(np.float32) for i in range(4)]
    port, jax_h = AsyncIOHandle(num_threads=2), JaxAIO(num_threads=2)
    for i, a in enumerate(arrs):  # the port writes, at offset 0 and after a header of 64 bytes
        port.async_pwrite(_t(a), str(tmp_path / f"p{i}.bin"))
        port.async_pwrite(_t(a), str(tmp_path / f"p{i}_off.bin"), offset=64)
    assert port.wait() == 0 and port.bytes_written == 2 * sum(a.nbytes for a in arrs)
    outs = [np.empty_like(a) for a in arrs] + [np.empty_like(a) for a in arrs]
    for i, a in enumerate(arrs):
        jax_h.async_pread(outs[i], str(tmp_path / f"p{i}.bin"))
        jax_h.async_pread(outs[4 + i], str(tmp_path / f"p{i}_off.bin"), offset=64)
    assert jax_h.wait() == 0
    for i, a in enumerate(arrs):
        np.testing.assert_array_equal(outs[i], a)
        np.testing.assert_array_equal(outs[4 + i], a)
    for i, a in enumerate(arrs):  # and the other way
        jax_h.async_pwrite(a * 2, str(tmp_path / f"j{i}.bin"), offset=128)
    assert jax_h.wait() == 0
    back = [torch.empty(a.shape, dtype=torch.float32) for a in arrs]
    for i, b in enumerate(back):
        port.async_pread(b, str(tmp_path / f"j{i}.bin"), offset=128)
    assert port.wait() == 0
    for a, b in zip(arrs, back):
        np.testing.assert_array_equal(b.numpy(), a * 2)
    port.async_pread(torch.empty(4), str(tmp_path / "missing.bin"))
    assert port.wait() == 1  # a failed read is counted, as in the JAX handle
    port.close()
    jax_h.close()


def test_swapper_files_cross_packages(tmp_path):
    port, jax_sw = AsyncTensorSwapper(str(tmp_path), num_threads=2), JaxSwapper(str(tmp_path), num_threads=2)
    assert port._path("layer_0/attn/w") == jax_sw._path("layer_0/attn/w")
    a = np.arange(2048, dtype=np.float32).reshape(64, 32)
    port.swap_out("layer_0/attn/w", _t(a))
    port.synchronize()
    jax_sw._shapes["layer_0/attn/w"] = (a.shape, a.dtype)  # a reader registers what it expects
    got = jax_sw.swap_in("layer_0/attn/w")
    jax_sw.synchronize()
    np.testing.assert_array_equal(got, a)
    jax_sw.swap_out("wte", -a)
    jax_sw.synchronize()
    port.swap_out("wte", torch.zeros(64, 32))  # register the shape, then overwrite from the JAX side
    port.synchronize()
    jax_sw.swap_out("wte", -a)
    jax_sw.synchronize()
    back = port.swap_in("wte")
    port.synchronize()
    np.testing.assert_array_equal(back.numpy(), -a)
    assert sorted(os.listdir(tmp_path)) == ["layer_0--attn--w.swp", "wte.swp"]
    port.release("wte")
    assert not port.contains("wte") and not (tmp_path / "wte.swp").exists()
    port.close()
    jax_sw.close()


def test_the_optimizer_swapper_round_trips_states(tmp_path):
    sw = PartitionedOptimizerSwapper(str(tmp_path), num_threads=2)
    states = {f"p{i}": {"exp_avg": torch.full((128,), float(i)), "exp_avg_sq": torch.full((128,), i * 10.0)}
              for i in range(4)}
    for n, st in states.items():
        sw.initialize(n, st)
    sw.prefetch("p0", ["exp_avg", "exp_avg_sq"])
    for i in range(4):
        st = sw.fetch(f"p{i}", ["exp_avg", "exp_avg_sq"])
        if i + 1 < 4:
            sw.prefetch(f"p{i + 1}", ["exp_avg", "exp_avg_sq"])
        assert torch.equal(st["exp_avg"], states[f"p{i}"]["exp_avg"])
        st["exp_avg"] += 1
        sw.commit(f"p{i}", st)
    sw.synchronize()
    assert torch.equal(sw.fetch("p2", ["exp_avg", "exp_avg_sq"])["exp_avg"], states["p2"]["exp_avg"] + 1)
    sw.close()


def _host_optimizer_run(device, tmp, pipeline=True):
    rng = np.random.default_rng(3)
    shapes = [(33, 17), (5,), (64, 8), (1,)]
    masters = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    opt = HostOffloadOptimizer(masters, {"lr": 1e-2}, torch.device("cpu"), offload_device=device,
                               nvme_path=tmp, pipeline=pipeline)
    for _ in range(3):
        grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
        gnorm, overflow = opt.step(grads, 1e-2, inv_scale=0.5, grad_clip=1.0)
        assert not overflow and gnorm > 1.0
    return opt


def test_the_pipelined_swapper_gives_the_unpipelined_states(tmp_path):
    runs = {"cpu": _host_optimizer_run("cpu", None),
            "nvme": _host_optimizer_run("nvme", str(tmp_path / "a"), pipeline=True),
            "nvme_unpipelined": _host_optimizer_run("nvme", str(tmp_path / "b"), pipeline=False)}
    want = runs["cpu"]
    for name, opt in runs.items():
        assert opt.step_count == 3
        for i in range(4):
            assert torch.equal(opt.master[i], want.master[i]), name
            for k, v in opt.leaf_state(i).items():
                assert torch.equal(v, want.leaf_state(i)[k]), (name, i, k)
    assert len([f for f in os.listdir(tmp_path / "a" / "rank0") if f.endswith(".swp")]) == 8


def test_the_host_step_skips_on_overflow_and_clips():
    masters = [torch.ones(10), torch.ones(3)]
    opt = HostOffloadOptimizer(masters, {"lr": 1e-2}, torch.device("cpu"))
    out = [torch.zeros(10), torch.zeros(3)]
    gnorm, overflow = opt.step([torch.full((10,), float("inf")), torch.ones(3)], 1e-2, out=out)
    assert overflow and opt.step_count == 0 and torch.equal(opt.master[0], torch.ones(10))
    assert torch.equal(out[0], torch.zeros(10))  # nothing returned to the device
    g = [torch.full((10,), 3.0), torch.full((3,), 4.0)]
    gnorm, overflow = opt.step(g, 1e-2, grad_clip=1.0, out=out)
    want = float(np.sqrt(10 * 9 + 3 * 16))
    assert not overflow and abs(gnorm - want) < 1e-9 and opt.step_count == 1
    assert torch.equal(out[0], opt.master[0]) and torch.equal(out[1], opt.master[1])
    assert opt.stats["steps"] == 1 and opt.stats["h2d_bytes"] == 13 * 4


def test_the_host_optimizers_state_round_trips(tmp_path):
    """``state_dict`` / ``load_state_dict`` and ``moments_trees`` / ``set_moments_trees`` (the JAX names), in RAM
    and on NVMe: a fresh optimizer loaded from another's state steps to the same bits."""
    src = _host_optimizer_run("nvme", str(tmp_path / "src"))
    g = [torch.full(m.shape, 0.25) for m in src.master]
    for device in ("cpu", "nvme"):
        fresh = HostOffloadOptimizer([torch.zeros(m.shape) for m in src.master], {"lr": 1e-2}, torch.device("cpu"),
                                     offload_device=device, nvme_path=str(tmp_path / device))
        fresh.load_state_dict(src.state_dict())
        assert fresh.step_count == 3
        other = HostOffloadOptimizer([torch.zeros(m.shape) for m in src.master], {"lr": 1e-2}, torch.device("cpu"))
        other.set_master(src.master)
        other.set_moments_trees(src.moments_trees())
        other.step_count = src.step_count
        assert [list(t.shape) for t in fresh.template_state_dict()["master"]] == [list(m.shape) for m in src.master]
        for opt in (fresh, other):
            opt.step([x.clone() for x in g], 1e-2)
        for a, b in zip(fresh.master, other.master):
            assert torch.equal(a, b)
        for i in range(len(src.master)):
            for k, v in fresh.leaf_state(i).items():
                assert torch.equal(v, other.leaf_state(i)[k])
