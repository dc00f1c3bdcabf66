"""Port parity: ZeRO++ (qwZ, qgZ, hpZ), MiCS's shard size and the compressed
collectives, over gloo ranks against the JAX package.

- The compressed collectives (``runtime/comm/compressed.py``) on 2 and 4
  ranks against the JAX functions under ``shard_map`` on as many faked
  devices, on the same seeded arrays: ``_quantize_int8``'s codes and scales
  equal; ``all_to_all_quant_reduce`` and ``compressed_allreduce`` within one
  code step of their scale (a value on a rounding boundary may round the
  other way); ``reduce_scatter_coalesced`` within 1e-6. ``Collectives``'
  bucketed qgZ sum equals the per-leaf function times the group size bit
  for bit.
- The training engine at stage 3 (``torch_zero_worker.train_cases``, gpt2_tiny
  at vocabulary 512, fp32, 5 steps) against the JAX engine's ZeRO++ step on
  the same mesh: at world 4 on ``{data: 2, fsdp: 2}`` qwZ, qgZ, hpZ 2 and
  all three, hpZ 2 on ``{fsdp: 4}`` (groups of 2 inside fsdp 4), and at
  world 2 on ``{fsdp: 2}`` all three. Tolerances, as
  ``test_torch_zero_engine.py`` unless said: losses 2e-5, grad norms 1e-5
  relative, masters within 2 % of their leaf's travel (``k_proj``'s bias,
  whose true gradient is zero, within twice its travel). Where int8 codes
  travel (qwZ, qgZ) a code may round the other way once the two engines'
  masters differ by float noise, and one code moves a weight or a gradient
  by absmax / 127: losses within 1e-4, the first step's norm within 1e-5
  (same masters, same codes) and the later ones within 1e-3 relative, and
  the masters by Adam's steps: a gradient element that one engine codes 0
  and the other +-1 takes a step of about lr in one of them, so at most 1 %
  of the elements off by more than 2 % of their leaf's travel and none by
  more than half of it. hpZ alone is exact: bit-equal to the port's own
  plain stage 3.
- Collective bytes: a stage-3 forward's gathers move rows x 2048 + 4 rows
  bytes a chunk under qwZ (n + 4 ceil(n / 2048) for these chunks) against
  4n in fp32; under hpZ the backward regathers over groups of k
  (``hpz_all_gather``), one call for each plain stage 3 regather.
- The fallback: stage 2, ``fsdp`` 1 and ``expert`` 2 give
  ``zeropp_applicable``'s JAX reasons, the engine logs it and trains plain
  stage 3; hpZ 3 over ``fsdp`` 2 raises.
- MiCS: ``mics_shard_size: 2`` at world 4 sizes the mesh ``{data: 2, fsdp:
  2}`` as the JAX config does and trains bit for bit like that mesh
  written out; a mesh whose fsdp differs raises.
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
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.parallel.mesh import MeshTopology as JaxMesh
from deepspeed_tpu.runtime.comm import compressed as jax_compressed
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.config import MeshConfig as JaxMeshConfig
from deepspeed_tpu.runtime.zero import zeropp as jax_zeropp
from deepspeed_tpu_torch.parallel import MeshTopology
from deepspeed_tpu_torch.runtime.comm import compressed as port_compressed
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, MeshConfig
from deepspeed_tpu_torch.runtime.zero import zeropp as port_zeropp

try:  # jax >= 0.6
    from jax import shard_map
    _SHARD_MAP_KW = {"check_vma": False}
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map
    _SHARD_MAP_KW = {"check_rep": False}
from jax.sharding import Mesh, PartitionSpec as P

V = 512
STEPS = 5
MICRO = 2
LOSS_TOL, NORM_TOL, PARAM_TOL = 2e-5, 1e-5, 0.02
Q_LOSS_TOL, Q_NORM_TOL, Q_SHARE, Q_WORST = 1e-4, 1e-3, 0.01, 0.5  # where int8 codes travel (see the module note)
OPS_N = 6144


def _config(mesh, **zero):
    return {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 3, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, **({"mesh": mesh} if mesh is not None else {}),
            "zero_optimization": {"stage": 3, "stage3_param_persistence_threshold": 0, "reduce_bucket_size": 20000,
                                  **zero}}


QWZ, QGZ = {"zero_quantized_weights": True}, {"zero_quantized_gradients": True}
ALL3 = {**QWZ, **QGZ, "zero_hpz_partition_size": 2}
DF = {"data": 2, "fsdp": 2}
CASES = {
    4: [dict(name="plain", config=_config(DF)),
        dict(name="qwz", config=_config(DF, **QWZ), jax=True),
        dict(name="qgz", config=_config(DF, **QGZ), jax=True),
        dict(name="hpz2", config=_config(DF, zero_hpz_partition_size=2), jax=True),
        dict(name="all3", config=_config(DF, **ALL3), jax=True),
        dict(name="mics2", config=_config(None, mics_shard_size=2)),
        dict(name="fsdp4-hpz2", config=_config({"fsdp": 4}, zero_hpz_partition_size=2), jax=True)],
    2: [dict(name="fsdp2-all3", config=_config({"fsdp": 2}, **ALL3), jax=True)],
}
IDS = [(w, i) for w in CASES for i in range(len(CASES[w]))]


def _quantized(case) -> bool:
    z = case["config"]["zero_optimization"]
    return bool(z.get("zero_quantized_weights") or z.get("zero_quantized_gradients"))


def _batches(world):
    rng = np.random.default_rng(0)
    return [{"input_ids": rng.integers(0, V, (world * MICRO, 32)).astype(np.int32)} for _ in range(STEPS)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def jax_params():
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def workdir(jax_params, tmp_path_factory):
    d = tmp_path_factory.mktemp("zeropp")
    np.savez(d / "params.npz", **_flat(jax_params[1]))
    return d


@pytest.fixture(scope="module")
def port_runs(workdir):
    """Every case of each world size in one spawn, with the world-2 refusals and byte counts."""
    d, results = workdir, {}
    for world, cases in CASES.items():
        bfile = str(d / f"batches_{world}.npz")
        np.savez(bfile, **{f"{k}__{j}": v for j, b in enumerate(_batches(world)) for k, v in b.items()})
        out = d / f"out{world}"
        out.mkdir()
        zw.spawn(world, zw.train_cases, cases, str(d / "params.npz"), [bfile] * len(cases), V, STEPS, str(out))
        for i in range(len(cases)):
            results[(world, i)] = [torch.load(out / f"case{i}_rank{r}.pt", weights_only=False) for r in range(world)]
    return results


def _jax_run(model, jparams, world, case):
    config = case["config"]
    mesh = JaxMesh(JaxMeshConfig.from_dict(config["mesh"]), devices=jax.devices()[:world])
    jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams, config=config, mesh=mesh)
    it = iter(_batches(world))
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(jeng.train_batch(it)))
        norms.append(jeng.get_global_grad_norm())
    return losses, norms, _flat(jax.tree.map(np.asarray, jeng.params))


JAX_IDS = [(w, i) for w, i in IDS if CASES[w][i].get("jax")]


@pytest.mark.parametrize("world,i", JAX_IDS, ids=[f"world{w}-{CASES[w][i]['name']}" for w, i in JAX_IDS])
def test_zeropp_ranks_match_the_jax_engine(jax_params, port_runs, world, i):
    model, jparams = jax_params
    case = CASES[world][i]
    ranks = port_runs[(world, i)]
    assert all(r["zeropp"] == (True, "") for r in ranks)
    jl, jn, want = _jax_run(model, jparams, world, case)
    got_l, got_n = ranks[0]["losses"], ranks[0]["norms"]
    for r in ranks[1:]:
        assert r["losses"] == got_l and r["norms"] == got_n
    q = _quantized(case)
    for step, (tl, l, tn, n) in enumerate(zip(got_l, jl, got_n, jn)):
        assert abs(tl - l) <= (Q_LOSS_TOL if q else LOSS_TOL), (got_l, jl)
        assert abs(tn - n) <= (Q_NORM_TOL if q and step > 0 else NORM_TOL) * n, (got_n, jn)
    got, init = ranks[0]["masters"], _flat(jparams)
    assert set(got) == set(want)
    off = total = 0
    for path in want:
        travel = np.abs(want[path] - init[path]).max()
        err = np.abs(got[path] - want[path])
        scale = 2 if path.endswith("k_proj/bias") else 1
        if not q:
            np.testing.assert_allclose(got[path], want[path], atol=scale * PARAM_TOL * travel if scale == 1
                                       else 2 * travel, rtol=0, err_msg=path)
            continue
        assert err.max() <= (2 * travel if scale == 2 else Q_WORST * travel), path
        if scale == 1:
            off += int((err > PARAM_TOL * travel).sum())
        total += err.size
    assert off <= Q_SHARE * max(total, 1), (off, total)
    for r in ranks:
        h = r["held"]
        assert h["masters"] == h["planned_masters"] and h["moments"] == h["planned_moments"], h


def test_hpz_is_bit_equal_to_plain_stage3_and_regathers_over_its_groups(port_runs):
    plain, hpz = port_runs[(4, 0)], port_runs[(4, 3)]
    assert hpz[0]["losses"] == plain[0]["losses"] and hpz[0]["norms"] == plain[0]["norms"]
    for path, t in plain[0]["masters"].items():
        assert np.array_equal(hpz[0]["masters"][path], t), path
    cp, ch = plain[0]["comm"], hpz[0]["comm"]
    # each backward regather of a block comes from the slices over the hpZ group, in the same buckets
    assert ch["hpz_all_gather"][0] > 0
    assert ch["all_gather"][0] + ch["hpz_all_gather"][0] == cp["all_gather"][0]
    assert ch["all_gather"][1] + ch["hpz_all_gather"][1] == cp["all_gather"][1]
    # inside fsdp 4, groups of 2: the same bytes a regather, gathered from two slices of half a block
    c4 = port_runs[(4, 6)][0]["comm"]
    assert c4["hpz_all_gather"][0] > 0
    assert all(r["secondary"] == 0 for r in hpz)  # every slice freed with its block's gradient


def test_mics_shard_size_is_the_mesh_written_out(port_runs):
    plain, mics = port_runs[(4, 0)], port_runs[(4, 5)]
    assert mics[0]["losses"] == plain[0]["losses"]
    for path, t in plain[0]["masters"].items():
        assert np.array_equal(mics[0]["masters"][path], t), path
    d = {"train_micro_batch_size_per_gpu": 1, "zero_optimization": {"stage": 3, "mics_shard_size": 2}}
    port, ref = DeepSpeedConfig(d), JaxConfig(d)
    assert (port.mesh.data, port.mesh.fsdp) == (ref.mesh.data, ref.mesh.fsdp) == (-1, 2)
    topo = MeshTopology(port.mesh, world_size=4, rank=0)
    assert topo.axis_sizes["data"] == 2 and topo.axis_sizes["fsdp"] == 2
    named = DeepSpeedConfig({**d, "mesh": {"fsdp": 4}})
    assert named.mesh.fsdp == JaxConfig({**d, "mesh": {"fsdp": 4}}).mesh.fsdp == 4


def test_refusals_and_qwz_bytes(workdir):
    d = workdir
    out = d / "refusals"
    out.mkdir()
    bad_hpz = dict(config=_config({"fsdp": 2}, zero_hpz_partition_size=3))
    zw.spawn(2, zw.refused, [bad_hpz], str(d / "params.npz"), V, str(out))
    assert torch.load(out / "refused_rank0.pt")[0] == "zero_hpz_partition_size 3 must divide the fsdp axis size 2"
    zw.spawn(4, zw.refused, [dict(config=_config({"fsdp": 4}, mics_shard_size=2))], str(d / "params.npz"), V,
             str(out))
    assert "mics_shard_size=2 but the mesh fsdp axis is 4" in torch.load(out / "refused_rank0.pt")[0]
    zw.spawn(2, zw.qwz_bytes, str(d / "params.npz"), V, str(out))
    got = torch.load(out / "bytes_rank0.pt")
    W = 2
    assert got["plain"] == sum(W * 4 * n for n in got["chunks"])
    assert got["qwz"] == sum(W * (rows * g + 4 * rows) for rows, g in got["rows"])
    assert all(rows * g == n for n, (rows, g) in zip(got["chunks"], got["rows"]))  # no padding at these chunks
    assert got["qwz"] == sum(W * (n + 4 * -(-n // 2048)) for n in got["chunks"])


@pytest.mark.parametrize("stage,mesh", [(2, {"fsdp": 2}), (3, {"data": 2}), (3, {"fsdp": 2, "expert": 2}),
                                        (3, {"fsdp": 2}), (1, {"data": 4})])
def test_fallback_reasons_equal_jax(stage, mesh):
    n = int(np.prod(list(mesh.values())))
    for zero in (QWZ, QGZ, {"zero_hpz_partition_size": 2}, {}):
        d = {"train_micro_batch_size_per_gpu": 1, "zero_optimization": {"stage": stage, **zero}}
        jtopo = JaxMesh(JaxMeshConfig.from_dict(mesh), devices=jax.devices()[:n])
        topo = MeshTopology(MeshConfig.from_dict(mesh), world_size=n, rank=0)
        assert port_zeropp.zeropp_requested(DeepSpeedConfig(d)) == jax_zeropp.zeropp_requested(JaxConfig(d))
        assert port_zeropp.zeropp_applicable(DeepSpeedConfig(d), topo) == \
            jax_zeropp.zeropp_applicable(JaxConfig(d), jtopo)


def test_fallback_at_world_one_logs_and_trains_plain_stage3(jax_params, caplog):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, params_from_numpy

    _, jparams = jax_params
    cfg = zw.model_cfg(V)
    losses = {}
    for name, zero in (("plain", {}), ("zeropp", ALL3)):
        with caplog.at_level(logging.WARNING):
            eng, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params_from_numpy(
                jparams, "cpu", cfg=cfg), config=_config(None, **zero), device="cpu")
        it = iter(_batches(1))
        losses[name] = [float(eng.train_batch(it)) for _ in range(2)]
        if zero:
            assert eng.zeropp_active is False and eng.zeropp_reason == "ZeRO++ needs an fsdp axis > 1"
            assert "ZeRO++ requested but falling back to plain ZeRO: ZeRO++ needs an fsdp axis > 1" in caplog.text
    assert losses["zeropp"] == losses["plain"]


def _ops_inputs(world, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((world, OPS_N)).astype(np.float32)
    x[:, 7] = 0.0  # a zero column: codes 0
    return dict(x=x, we=(0.01 * rng.standard_normal((world, OPS_N))).astype(np.float32),
                se=(0.01 * rng.standard_normal((world, OPS_N // world))).astype(np.float32),
                t0=rng.standard_normal((world, 16, 24)).astype(np.float32),
                t1=rng.standard_normal((world, 128)).astype(np.float32),
                t2=rng.standard_normal((world, 8, 12)).astype(np.float32))


def _jax_ops(world, a):
    mesh = Mesh(np.array(jax.devices()[:world]), ("x",))

    def run(fn, *args, outs=1):
        f = jax.jit(shard_map(lambda *xs: fn(*[x[0] for x in xs]), mesh=mesh, in_specs=tuple(P("x") for _ in args),
                              out_specs=tuple(P("x") for _ in range(outs)) if outs > 1 else P("x"), **_SHARD_MAP_KW))
        return f(*args)

    quant = run(lambda x: jax_compressed.all_to_all_quant_reduce(x, "x")[None], a["x"])
    out, we, se = run(lambda x, w, s: tuple(t[None] for t in jax_compressed.compressed_allreduce(x, w, s, "x")),
                      a["x"], a["we"], a["se"], outs=3)
    scat = run(lambda t0, t1, t2: jax_compressed.reduce_scatter_coalesced([t0, t1, t2], "x")[None],
               a["t0"], a["t1"], a["t2"])
    return {k: np.asarray(v) for k, v in dict(quant=quant, out=out, worker_error=we, server_error=se,
                                             scattered=scat).items()}


def test_quantize_int8_equals_jax():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((64, 2048)) * rng.uniform(0.01, 10, (64, 1))).astype(np.float32)
    x[3] = 0.0  # an all-zero row: scale 1
    x[5, :4] = [0.5, -0.5, 1.5, 2.5]  # halves round to even
    jq, js = jax_compressed._quantize_int8(x, axis=1)
    q, s = port_compressed._quantize_int8(torch.from_numpy(x), dim=1)
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))
    jq, js = jax_zeropp._quant_int8(x[:3, :1000])
    q, s = port_zeropp.quant_int8(torch.from_numpy(x[:3, :1000]))  # 3000 elements: one full group, one padded
    assert np.array_equal(q.numpy(), np.asarray(jq)) and np.array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_collectives_equal_jax(world, tmp_path):
    a = _ops_inputs(world, seed=world)
    np.savez(tmp_path / "ops.npz", **a)
    zw.spawn(world, zw.compressed_ops, str(tmp_path / "ops.npz"), str(tmp_path))
    want = _jax_ops(world, a)
    n = OPS_N // world
    for r in range(world):
        got = torch.load(tmp_path / f"ops_rank{r}.pt", weights_only=False)
        assert got["bucketed_equal"]
        assert set(got["comm"]) == {"quant_all_to_all", "quant_all_gather"}
        # one code step of each chunk's final scale
        step = np.abs(want["quant"][r]).reshape(world, n).max(axis=1, keepdims=True) / 127.0
        assert (np.abs(got["quant"].numpy().reshape(world, n) - want["quant"][r].reshape(world, n))
                <= step * 1.0001).all()
        # 1-bit: a sign is a code step of 2 x the chunk's scale
        step = np.abs(want["out"][r]).reshape(world, n).max(axis=1, keepdims=True)
        assert (np.abs(got["out"].numpy().reshape(world, n) - want["out"][r].reshape(world, n))
                <= 2 * step * 1.0001).all()
        np.testing.assert_allclose(got["worker_error"].numpy(), want["worker_error"][r], atol=1e-6, rtol=0)
        np.testing.assert_allclose(got["scattered"].numpy(), want["scattered"][r], atol=1e-6, rtol=0)
        assert np.abs(got["server_error"].numpy() - want["server_error"][r]).max() <= 2 * step.max()
