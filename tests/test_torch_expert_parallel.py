"""Port parity: expert parallelism over the mesh's ``expert`` axis in the
training engine, against the JAX engine on a CPU mesh of the same shape.

The model is a tiny Mixtral-shaped MoE (``torch_zero_worker.MOE``: 4
experts, top-2, every block MoE, RMSNorm, SwiGLU, RoPE, untied head), fp32,
5 steps from the JAX initialisation. The JAX package splits the batch over
``data`` x ``fsdp`` only: the ranks of an expert group see the same rows,
and the gate routes the whole data-parallel batch (GSPMD's global view),
which the port's MoE layer reproduces (``moe/layer.py``).

- ``{expert: 2}`` at world 2 and ``{data: 2, expert: 2}`` at world 4, ZeRO
  stages 0, 2 and 3 with FusedAdam, and LAMB at stage 1 at world 2: losses within 2e-5, grad norms within 1e-5 relative,
  masters within 2 % of each leaf's travel, as ``test_torch_zero_engine.py``
  (the non-expert masters too: without the backward's exchange over the
  expert group the gate, attention and embeddings would take each rank's
  share of the token gradients). Each rank holds E / 2 experts and exactly
  its planned bytes of masters and moments.
- The MoE layer alone over an expert group of 2 and 4 ranks, with RSample
  gate noise from generators seeded alike: output, aux loss, expert counts
  and every gradient equal the one-device layer's bit for bit.
- Checkpoints: at ``{data: 2, expert: 2}`` stage 3 a native checkpoint
  resumes bit for bit and ``zero_to_fp32`` merges every expert; a universal
  checkpoint of step 3 moves from ep 2 to a ``{data: 2}`` run (ep 1) and
  back, each continuing within 2e-5 of the other mesh's own run.
- ``utils/groups.py``: the expert getters and ``initialize(ep_size)``.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import torch_zero_worker as zw
import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxTransformerConfig
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig

V = zw.MOE["vocab_size"]
E = zw.MOE["moe_num_experts"]
STEPS = 5
MICRO = 2
LOSS_TOL, NORM_TOL, PARAM_TOL = 2e-5, 1e-5, 0.02
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(stage, mesh, optimizer="FusedAdam"):
    lr = 1e-3 if optimizer == "FusedAdam" else 1e-2
    return {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": lr,
                                                         "warmup_num_steps": 3, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "mesh": mesh,
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0,
                                  "reduce_bucket_size": 20000}}


MESHES = {2: {"expert": 2}, 4: {"data": 2, "expert": 2}}
CASES = {w: [dict(name=f"stage{s}", config=_config(s, m), model=zw.MOE) for s in (0, 2, 3)]
         for w, m in MESHES.items()}
# LAMB's trust ratio needs whole-leaf norms: an expert leaf's over the expert group
CASES[2].append(dict(name="stage1-Lamb", config=_config(1, MESHES[2], "Lamb"), model=zw.MOE))
IDS = [(w, i) for w in CASES for i in range(len(CASES[w]))]


def _dp(world):
    return world // MESHES.get(world, {}).get("expert", 1)


def _batches(dp, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, V, (dp * MICRO, 32)).astype(np.int32)} for _ in range(n)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _save_batches(path, batches):
    np.savez(path, **{f"{k}__{j}": v for j, b in enumerate(batches) for k, v in b.items()})


@pytest.fixture(scope="module")
def jax_params():
    model = JaxCausalLM(JaxTransformerConfig(**zw.MOE))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def workdir(jax_params, tmp_path_factory):
    d = tmp_path_factory.mktemp("expert_parallel")
    np.savez(d / "params.npz", **_flat(jax_params[1]))
    return d


@pytest.fixture(scope="module")
def port_runs(workdir):
    d, results = workdir, {}
    for world, cases in CASES.items():
        bfile = str(d / f"batches_{world}.npz")
        _save_batches(bfile, _batches(_dp(world)))
        out = d / f"out{world}"
        out.mkdir()
        zw.spawn(world, zw.train_cases, cases, str(d / "params.npz"), [bfile] * len(cases), V, STEPS, str(out))
        for i in range(len(cases)):
            results[(world, i)] = [torch.load(out / f"case{i}_rank{r}.pt", weights_only=False) for r in range(world)]
    return results


def _jax_run(model, jparams, world, case):
    config = case["config"]
    mesh = MeshTopology(MeshConfig.from_dict(config["mesh"]), devices=jax.devices()[:world])
    jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams, config=config, mesh=mesh)
    it = iter(_batches(_dp(world)))
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(jeng.train_batch(it)))
        norms.append(jeng.get_global_grad_norm())
    return losses, norms, _flat(jax.tree.map(np.asarray, jeng.params))


@pytest.mark.parametrize("world,i", IDS, ids=[f"world{w}-{CASES[w][i]['name']}" for w, i in IDS])
def test_expert_parallel_ranks_match_the_jax_engine(jax_params, port_runs, world, i):
    model, jparams = jax_params
    ranks = port_runs[(world, i)]
    jl, jn, want = _jax_run(model, jparams, world, CASES[world][i])
    got_l, got_n = ranks[0]["losses"], ranks[0]["norms"]
    for r in ranks[1:]:
        assert r["losses"] == got_l and r["norms"] == got_n
    for tl, l, tn, n in zip(got_l, jl, got_n, jn):
        assert abs(tl - l) <= LOSS_TOL, (got_l, jl)
        assert abs(tn - n) <= NORM_TOL * n, (got_n, jn)
    got, init = ranks[0]["masters"], _flat(jparams)
    assert set(got) == set(want)
    for path in want:
        travel = np.abs(want[path] - init[path]).max()
        tol = 2 * travel if path.endswith("k_proj/bias") else PARAM_TOL * travel
        np.testing.assert_allclose(got[path], want[path], atol=tol, rtol=0, err_msg=path)
    paths = sorted(got)
    for r in ranks:
        h = r["held"]
        assert h["masters"] == h["planned_masters"] and h["moments"] == h["planned_moments"], h
        for path, e, shape in zip(paths, r["expert_dims"], r["local"]):
            if path.rsplit("/", 1)[-1] in ("wi", "wo", "wg"):
                assert e == 0 and shape[0] == E // 2, (path, shape)
            else:
                assert e is None, path


def test_each_rank_holds_half_the_expert_bytes(port_runs):
    """At stage 0 an expert leaf's masters and moments are half their size on each rank of the expert group."""
    held = port_runs[(2, 0)][0]["held"]
    one = sum(int(np.prod(v.shape)) * 4 for v in port_runs[(2, 0)][0]["masters"].values())
    expert = sum(int(np.prod(v.shape)) * 4 for p, v in port_runs[(2, 0)][0]["masters"].items()
                 if p.rsplit("/", 1)[-1] in ("wi", "wo", "wg"))
    assert held["masters"] == one - expert // 2
    assert held["moments"] == 2 * held["masters"]


def _layer_inputs(seed=0):
    rng = np.random.default_rng(seed)
    d, f = 16, 24
    return dict(x=rng.standard_normal((2, 10, d)).astype(np.float32),
                gate=(0.5 * rng.standard_normal((d, E))).astype(np.float32),
                wi=(0.2 * rng.standard_normal((E, d, f))).astype(np.float32),
                wg=(0.2 * rng.standard_normal((E, d, f))).astype(np.float32),
                wo=(0.2 * rng.standard_normal((E, f, d))).astype(np.float32))


@pytest.mark.parametrize("world", [2, 4])
def test_moe_layer_over_an_expert_group_equals_one_device(world, tmp_path):
    from deepspeed_tpu_torch.moe import MoE

    a = _layer_inputs()
    np.savez(tmp_path / "layer.npz", **a)
    zw.spawn(world, zw.moe_layer_ep, str(tmp_path / "layer.npz"), str(tmp_path))
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    p = {"gate": {"kernel": torch.from_numpy(a["gate"]).requires_grad_(True)},
         "experts": {k: torch.from_numpy(a[k]).requires_grad_(True) for k in ("wi", "wo", "wg")}}
    layer = MoE(hidden_size=16, num_experts=E, k=1, capacity_factor=1.0, min_capacity=1,
                noisy_gate_policy="RSample", d_ff=24, activation="swiglu")
    out, l_aux, counts = layer(p, x, train=True, generator=torch.Generator().manual_seed(7))
    (out.square().sum() + l_aux).backward()
    n = E // world
    assert counts.sum() < x.shape[0] * x.shape[1]  # capacity 1.0 drops some tokens
    for r in range(world):
        got = torch.load(tmp_path / f"moe_rank{r}.pt", weights_only=False)
        assert got["world"] == world
        assert torch.equal(got["out"], out.detach()) and torch.equal(got["l_aux"], l_aux.detach())
        assert torch.equal(got["counts"], counts)
        assert torch.equal(got["dx"], x.grad) and torch.equal(got["dgate"], p["gate"]["kernel"].grad)
        for k, g in got["dexperts"].items():
            assert torch.equal(g, p["experts"][k].grad[r * n:(r + 1) * n]), k


def test_checkpoints_move_between_expert_meshes(workdir, tmp_path):
    d = workdir
    bfile = str(tmp_path / "batches.npz")
    bs = _batches(2, n=6, seed=5)  # two data-parallel ranks in both meshes
    _save_batches(bfile, bs)
    ep2 = dict(config=_config(3, {"data": 2, "expert": 2}), model=zw.MOE)
    ep1 = dict(config=_config(3, {"data": 2}), model=zw.MOE)
    a, b = tmp_path / "ep2", tmp_path / "ep1"
    for sub in ("out_a", "out_b", "out_c"):
        (tmp_path / sub).mkdir()
    zw.spawn(2, zw.expert_ckpt, ep1, str(d / "params.npz"), bfile, V, str(b), None, str(tmp_path / "out_b"))
    zw.spawn(4, zw.expert_ckpt, ep2, str(d / "params.npz"), bfile, V, str(a), str(b / "universal"),
             str(tmp_path / "out_a"))
    zw.spawn(2, zw.expert_ckpt, ep1, str(d / "params.npz"), bfile, V, str(tmp_path / "ep1_again"),
             str(a / "universal"), str(tmp_path / "out_c"))
    r_a = [torch.load(tmp_path / "out_a" / f"ckpt_rank{r}.pt", weights_only=False) for r in range(4)]
    r_b = torch.load(tmp_path / "out_b" / "ckpt_rank0.pt", weights_only=False)
    r_c = torch.load(tmp_path / "out_c" / "ckpt_rank0.pt", weights_only=False)
    for r in r_a:
        assert r["exact"] and r["first"] + r["resumed"] == r["straight"]
        assert r["local"]["layer_0/moe/experts/wi"][0] == E // 2
    # the two meshes train alike, and each resumes the other's universal checkpoint of step 3
    np.testing.assert_allclose(r_a[0]["straight"], r_b["straight"], atol=LOSS_TOL, rtol=0)
    assert r_a[0]["loaded_steps"] == r_c["loaded_steps"] == 3
    for path, t in r_b["saved"].items():
        assert np.array_equal(r_a[0]["loaded"][path], t), path
    for path, t in r_a[0]["saved"].items():
        assert np.array_equal(r_c["loaded"][path], t), path
    np.testing.assert_allclose(r_a[0]["crossed"], r_b["straight"][3:], atol=LOSS_TOL, rtol=0)
    np.testing.assert_allclose(r_c["crossed"], r_a[0]["straight"][3:], atol=LOSS_TOL, rtol=0)
    # zero_to_fp32 gathers every expert of the ep-2 native checkpoint
    out = tmp_path / "fp32.pt"
    subprocess.run([sys.executable, "-m", "deepspeed_tpu_torch.checkpoint.zero_to_fp32", str(a), str(out), "-t",
                    "native3"], check=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    merged = torch.load(out, weights_only=False)
    assert set(merged) == set(r_a[0]["saved"])
    for path, t in r_a[0]["saved"].items():
        assert np.array_equal(merged[path].numpy(), t), path
    assert merged["layer_1/moe/experts/wo"].shape[0] == E


def test_expert_group_getters(tmp_path):
    zw.spawn(4, zw.expert_groups, {"data": 2, "expert": 2}, str(tmp_path))
    got = [torch.load(tmp_path / f"groups_rank{r}.pt", weights_only=False) for r in range(4)]
    for r, g in enumerate(got):
        assert g["ok"] and "ep_size 3 conflicts with mesh expert axis 2" in g["bad"]
        assert (g["ep"], g["ep_rank"], g["edp"], g["dp_rank"]) == (2, r % 2, 2, r // 2)
        assert g["ep_ranks"] == [r - r % 2, r - r % 2 + 1]
        assert g["edp_ranks"] == [r % 2, r % 2 + 2]


def test_expert_config_no_longer_raises():
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    cfg = DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1, "mesh": {"expert": 2}})
    assert cfg.mesh.expert == 2
    with pytest.raises(NotImplementedError, match="expert parallelism beside tensor parallelism"):
        DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1, "mesh": {"tensor": 2, "expert": 2}})


@pytest.mark.parametrize("mesh", [{"expert": 2}, {"data": 2, "expert": 2}, {"fsdp": 2, "expert": 2}])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_plans_with_partition_rules_equal_the_jax_planner(jax_params, mesh, stage):
    """Under the model's rules the expert dimension goes to ``expert`` and
    ZeRO's dimension is chosen among the others, as the JAX planner does."""
    import optax
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.runtime import zero as jax_zero
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
    from deepspeed_tpu_torch import zero as port_zero
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig
    from deepspeed_tpu_torch.parallel import MeshTopology as PortMesh
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, MeshConfig as PortMeshConfig

    model, jparams = jax_params
    n = int(np.prod(list(mesh.values())))
    d = {"train_micro_batch_size_per_gpu": 1,
         "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}
    jtopo = MeshTopology(MeshConfig.from_dict(mesh), devices=jax.devices()[:n])
    shapes = jax.eval_shape(lambda: jparams)
    rules = model.partition_rules()
    axis = jax_zero.zero_axes_for(jtopo)[0]
    jp = jax_zero.plan_param_specs(shapes, JaxConfig(d), jtopo, rules)
    jg = jax_zero.plan_grad_specs(shapes, jp, JaxConfig(d), jtopo)
    jo, _ = jax_zero.plan_opt_state_specs(optax.adam(1e-3), shapes, jp, JaxConfig(d), jtopo)

    def dims(tree, name):
        out = {}
        for path, spec in jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P)):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            hit = [i for i, e in enumerate(spec) if e == name or (isinstance(e, tuple) and name in e)]
            out[key] = hit[0] if hit else None
        return out

    want = {p: (v, dims(jg, axis)[p], dims(jo[0].mu, axis)[p], dims(jp, "expert")[p])
            for p, v in dims(jp, axis).items()}
    tree = jax.tree.map(lambda s: tuple(s.shape), shapes)
    port_rules = CausalLM(TransformerConfig(**zw.MOE)).partition_rules()
    for rank in range(n):
        plan = port_zero.plan_zero(tree, DeepSpeedConfig(d), PortMesh(PortMeshConfig.from_dict(mesh), world_size=n,
                                                                      rank=rank), port_rules)
        assert {lf.path: (lf.param_dim, lf.grad_dim, lf.opt_dim, lf.expert_dim) for lf in plan.leaves} == want
        assert sum(lf.expert_dim is not None for lf in plan.leaves) == 3 * zw.MOE["n_layers"]
