"""Port parity: ZeRO stages 0-3 over gloo ranks against the JAX engine on a
CPU mesh of the same size.

The port's ranks are spawned processes (``torch_zero_worker.spawn``: gloo
over a ``file://`` store, one configuration after another in one spawn per
world size); the JAX engine runs on a ``MeshTopology`` over 2 or 4 of the 8
faked CPU devices with the same config. Both start from the JAX
initialisation of ``gpt2_tiny`` at vocabulary 512 and 2 layers, fp32, and
see the same global micro-batches (each port rank its own rows of them).

Cases: stages 0-3 x {FusedAdam, Lamb} x gas {1, 2} on ``data: 2``; at
world 4 stage 3 on ``data: 2, fsdp: 2`` (ZeRO over fsdp, the data groups
all-reduce the chunks) and stage 2 with LAMB on ``data: 4``; and a batch
whose ignored labels fall unevenly over the ranks, at world 2 and 4.

Held to the reference over 5 steps with WarmupLR and a clip that fires:
the losses (2e-5 absolute, as ``test_torch_train_engine.py``), the global
grad norm (1e-5 relative) and every master after the last step within
2 % of how far the reference moved that tensor's farthest element
(``k_proj``'s bias, whose true gradient is zero, within twice its travel).
Each rank holds exactly its planned bytes of masters and optimizer state,
and stage 3's gathered copies never exceed one block plus the embedding,
the final norm and the other top-level groups (the engine's accounting).
"""

import dataclasses

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
from deepspeed_tpu.runtime.config import MeshConfig

V = 512
STEPS = 5
MICRO = 2
LOSS_TOL = 2e-5
NORM_TOL = 1e-5
PARAM_TOL = 0.02  # of each tensor's travel in the reference


def _config(stage, optimizer, gas, mesh, threshold=0):
    lr = 1e-3 if optimizer == "FusedAdam" else 1e-2
    return {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": lr,
                                                         "warmup_num_steps": 3, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "mesh": mesh,
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": threshold,
                                  "reduce_bucket_size": 20000}}


CASES = {
    2: [dict(name=f"stage{s}-{o}-gas{g}", config=_config(s, o, g, {"data": 2}))
        for s in (0, 1, 2, 3) for o in ("FusedAdam", "Lamb") for g in (1, 2)]
       + [dict(name="uneven-labels-stage1", config=_config(1, "FusedAdam", 1, {"data": 2}), uneven=True)],
    4: [dict(name="stage3-FusedAdam-gas2-data2-fsdp2", config=_config(3, "FusedAdam", 2, {"data": 2, "fsdp": 2},
                                                                       threshold=1000)),
        dict(name="stage2-Lamb-gas1-data4", config=_config(2, "Lamb", 1, {"data": 4})),
        dict(name="uneven-labels-stage3-fsdp2", config=_config(3, "FusedAdam", 1, {"data": 2, "fsdp": 2}),
             uneven=True)],
}
IDS = [(w, i) for w in CASES for i in range(len(CASES[w]))]


def _batches(world, gas, uneven, seed=0):
    """STEPS x gas global micro-batches of world x MICRO rows; ``uneven``: rank
    0's rows ignore most labels, the other ranks' few."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS * gas):
        ids = rng.integers(0, V, (world * MICRO, 32)).astype(np.int32)
        b = {"input_ids": ids}
        if uneven:
            labels = np.concatenate([ids[:, 1:], np.full((len(ids), 1), -100, np.int32)], axis=1)
            keep = np.ones_like(labels, bool)
            keep[:MICRO, 5:] = False  # rank 0 keeps 5 labels a row
            keep[MICRO:, 28:] = False
            b["labels"] = np.where(keep, labels, -100).astype(np.int32)
        out.append(b)
    return out


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
def port_runs(jax_params, tmp_path_factory):
    """Every case of each world size in one spawn: {(world, i): [rank results]}."""
    _, jparams = jax_params
    d = tmp_path_factory.mktemp("zero_engine")
    np.savez(d / "params.npz", **_flat(jparams))
    results = {}
    for world, cases in CASES.items():
        files = []
        for i, case in enumerate(cases):
            bs = _batches(world, case["config"]["gradient_accumulation_steps"], case.get("uneven", False))
            files.append(str(d / f"batches_{world}_{i}.npz"))
            np.savez(files[-1], **{f"{k}__{j}": v for j, b in enumerate(bs) for k, v in b.items()})
        out = d / f"out{world}"
        out.mkdir()
        zw.spawn(world, zw.train_cases, cases, str(d / "params.npz"), files, V, STEPS, str(out))
        for i in range(len(cases)):
            results[(world, i)] = [torch.load(out / f"case{i}_rank{r}.pt", weights_only=False) for r in range(world)]
    return results


def _jax_run(model, jparams, world, case):
    config = case["config"]
    mesh = MeshTopology(MeshConfig.from_dict(config["mesh"]), devices=jax.devices()[:world])
    jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams, config=config, mesh=mesh)
    it = iter(_batches(world, config["gradient_accumulation_steps"], case.get("uneven", False)))
    losses, norms = [], []
    for _ in range(STEPS):
        losses.append(float(jeng.train_batch(it)))
        norms.append(jeng.get_global_grad_norm())
    return losses, norms, _flat(jax.tree.map(np.asarray, jeng.params))


@pytest.mark.parametrize("world,i", IDS, ids=[f"world{w}-{CASES[w][i]['name']}" for w, i in IDS])
def test_zero_ranks_match_the_jax_engine(jax_params, port_runs, world, i):
    model, jparams = jax_params
    case = CASES[world][i]
    ranks = port_runs[(world, i)]
    jl, jn, want = _jax_run(model, jparams, world, case)
    got_l, got_n = ranks[0]["losses"], ranks[0]["norms"]
    for r in ranks[1:]:  # every rank reports the same global loss and norm
        assert r["losses"] == got_l and r["norms"] == got_n
    for tl, l, tn, n in zip(got_l, jl, got_n, jn):
        assert abs(tl - l) <= LOSS_TOL, (got_l, jl)
        assert abs(tn - n) <= NORM_TOL * n, (got_n, jn)
    assert max(got_n) > 0.5  # the clip fired
    got = ranks[0]["masters"]
    init = _flat(jparams)
    assert set(got) == set(want)
    for path in want:
        travel = np.abs(want[path] - init[path]).max()
        tol = 2 * travel if path.endswith("k_proj/bias") else PARAM_TOL * travel
        np.testing.assert_allclose(got[path], want[path], atol=tol, rtol=0, err_msg=path)
    for r in ranks:
        h = r["held"]
        assert h["masters"] == h["planned_masters"] and h["moments"] == h["planned_moments"], h
        if r["gather"]:
            assert r["gather"]["now"] == 0 and 0 < r["gather"]["peak"] <= r["gather"]["limit"], r["gather"]


def test_the_uneven_batch_weighs_ranks_by_tokens(port_runs):
    """A mean of the ranks' means would differ: rank 0 holds 5 labels a row, rank 1 28."""
    world, i = 2, len(CASES[2]) - 1
    assert CASES[world][i].get("uneven")
    first = _batches(world, 1, True)[0]
    ids, labels = first["input_ids"], first["labels"]
    assert (labels[:MICRO] != -100).sum() * 5 < (labels[MICRO:] != -100).sum()
    assert np.isfinite(port_runs[(world, i)][0]["losses"]).all()


def test_stages_shard_what_the_plan_says(port_runs):
    """At world 2 stage 0 holds every byte on each rank; stage 1 halves the
    moments, stage 3 the masters too; stages 1-3 reduce-scatter and gather."""
    held = {CASES[2][i]["name"]: port_runs[(2, i)][0]["held"] for i in range(len(CASES[2]))}
    comm = {CASES[2][i]["name"]: port_runs[(2, i)][0]["comm"] for i in range(len(CASES[2]))}
    s0, s1, s3 = held["stage0-FusedAdam-gas1"], held["stage1-FusedAdam-gas1"], held["stage3-FusedAdam-gas1"]
    assert s1["moments"] * 2 == s0["moments"] and s1["masters"] == s0["masters"]
    assert s3["masters"] * 2 == s0["masters"]
    assert set(comm["stage0-FusedAdam-gas1"]) == {"all_reduce"}
    for name in ("stage1-FusedAdam-gas1", "stage2-FusedAdam-gas1", "stage3-FusedAdam-gas1"):
        assert comm[name]["reduce_scatter"][0] > 0 and comm[name]["all_gather"][0] > 0


def test_zero_init_builds_each_ranks_chunks(tmp_path):
    zw.spawn(2, zw.zero_init_matches, V, str(tmp_path))
    for r in range(2):
        got = torch.load(tmp_path / f"init_rank{r}.pt", weights_only=False)
        assert got["equal"] and got["sharded"] > 0
        assert got["chunk_elems"] < got["whole_elems"]
