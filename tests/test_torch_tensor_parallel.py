"""Port parity: tensor-parallel training against the JAX engine.

The port's ranks are spawned processes (``torch_zero_worker.spawn``: gloo
over a ``file://`` store, every case of a world size in one spawn); the JAX
``DeepSpeedEngine`` / ``PipelineEngine`` runs on a ``MeshTopology`` over as
many of the 8 faked CPU devices with the same config, where GSPMD shards
the leaves over ``tensor`` by ``CausalLM.partition_rules()``. Both start
from the JAX initialisation (fp32) and see the same global micro-batches
(each port rank its data rank's rows of them; the ranks of a tensor group
the same rows).

Cases: ``{tensor: 2}`` with a tied GPT (biases on every projection) and
FusedAdam, an untied llama (GQA: 4 / 2 heads, 2 / 1 a rank, vocab-parallel
head) with LAMB, and the GPT with remat under ``partition_activations``;
``{data: 2, tensor: 2}`` at ZeRO 0, 1, 2 and 3; ``{fsdp: 2, tensor: 2}``
at stage 3; ``{pipe: 2, tensor: 2}`` with 1F1B; and a vocabulary of 511
that tp 2 does not divide (``wte`` whole on both ranks), held against the
JAX engine at tensor 1.

Held as ``test_torch_zero_engine.py`` holds ZeRO: the losses to 2e-5, the
global grad norm to 1e-5 relative, every master after the last step within
2 % of how far the reference moved that tensor (``k_proj``'s bias, whose
true gradient is zero, within twice its travel or 2 lr a step). Every rank
reports the same loss and norm, and the ranks of a tensor group end with
bit-equal copies of every leaf they hold whole, the column-parallel biases
among them. The checkpoints: a native save and resume at ``{data: 2,
tensor: 2}`` bit-exact, with ``zero_to_fp32`` equal to the whole masters;
universal resizes ``{data: 2, tensor: 2}`` -> ``{data: 4}``, ``{tensor:
2}`` -> ``{data: 2}`` and ``{data: 2}`` -> ``{tensor: 2}`` at a fixed
global batch, their trajectories held to the JAX engine's uninterrupted
run (2e-5, as ``test_torch_zero_engine.py``) and to the port's own (JAX
``test_universal_resize``'s rtol 2e-4, atol 2e-5).
"""

import threading

import jax
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import torch_tp_train_worker as tw
import torch_zero_worker as zw
import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig

from deepspeed_tpu_torch.models import TransformerConfig, stage_params_to_pipe
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, check_tensor
from deepspeed_tpu_torch.runtime.engine import train_flops

LOSS_TOL = 2e-5
NORM_TOL = 1e-5
PARAM_TOL = 0.02  # of each tensor's travel in the reference
STEPS = 3
SEQ = 16
MICRO = 2

GPT = dict(vocab_size=512, n_layers=2, n_heads=4, d_model=32, max_seq_len=64)
LLAMA = dict(GPT, n_kv_heads=2, norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False)


def _config(mesh, stage=0, optimizer="FusedAdam", micro=MICRO, gas=1, **extra):
    lr = 1e-3 if optimizer == "FusedAdam" else 1e-2
    return {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "optimizer": {"type": optimizer, "params": {"lr": lr, "weight_decay": 0.01}},
            "gradient_clipping": 0.5, "mesh": mesh,
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0,
                                  "reduce_bucket_size": 20000}, **extra}


CASES = {
    2: [dict(name="tensor2-gpt-FusedAdam", model=GPT, config=_config({"tensor": 2})),
        dict(name="tensor2-llama-Lamb", model=LLAMA, config=_config({"tensor": 2}, optimizer="Lamb")),
        dict(name="tensor2-gpt-remat-partitioned", model=dict(GPT, remat=True),
             config=_config({"tensor": 2}, activation_checkpointing={"partition_activations": True})),
        dict(name="tensor2-vocab511-against-tensor1", model=dict(GPT, vocab_size=511),
             config=_config({"tensor": 2}), jax_mesh={"data": 1})],
    4: [dict(name="data2-tensor2-stage0-gpt", model=GPT, config=_config({"data": 2, "tensor": 2})),
        dict(name="data2-tensor2-stage1-llama-Lamb", model=LLAMA,
             config=_config({"data": 2, "tensor": 2}, stage=1, optimizer="Lamb")),
        dict(name="data2-tensor2-stage2-gpt-Lamb", model=GPT,
             config=_config({"data": 2, "tensor": 2}, stage=2, optimizer="Lamb")),
        dict(name="data2-tensor2-stage3-llama", model=LLAMA, config=_config({"data": 2, "tensor": 2}, stage=3)),
        dict(name="fsdp2-tensor2-stage3-gpt", model=GPT, config=_config({"fsdp": 2, "tensor": 2}, stage=3)),
        dict(name="pipe2-tensor2-1f1b-gpt", model=GPT,
             config=_config({"pipe": 2, "tensor": 2}, gas=4, pipeline={"schedule": "1f1b"}))],
}
IDS = [(w, i) for w in CASES for i in range(len(CASES[w]))]


def _rows(case) -> int:
    mesh = case["config"]["mesh"]
    return mesh.get("data", 1) * mesh.get("fsdp", 1) * case["config"]["train_micro_batch_size_per_gpu"]


def _batches(case, steps, seed=0):
    rng = np.random.default_rng(seed)
    n = steps * case["config"]["gradient_accumulation_steps"]
    return [{"input_ids": rng.integers(0, case["model"]["vocab_size"], (_rows(case), SEQ)).astype(np.int32)}
            for _ in range(n)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _jax_params(model_fields):
    model = JaxCausalLM(JaxConfig(**model_fields))
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, SEQ),
                                                                                                    np.int32)}))


def _jax_run(case, bs, steps):
    """The JAX engine's losses, norms and final flat params (stacked for a pipeline)."""
    model, params = _jax_params(case["model"])
    cfg = dict(case["config"], mesh=case.get("jax_mesh", case["config"]["mesh"]))
    cfg.pop("activation_checkpointing", None)  # the JAX model remats each block through nn.remat
    world = int(np.prod(list(cfg["mesh"].values())))
    mesh = MeshTopology(MeshConfig.from_dict(cfg["mesh"]), devices=jax.devices()[:world])
    eng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=params, config=cfg, mesh=mesh)
    init = _flat(jax.device_get(eng.params))
    it = iter(bs)
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(eng.train_batch(it)))
        norms.append(eng.get_global_grad_norm())
    return dict(losses=losses, norms=norms, init=init, after=_flat(jax.device_get(eng.params)))


def _save_batches(path, bs):
    np.savez(path, **{f"{k}__{j}": v for j, b in enumerate(bs) for k, v in b.items()})


def _spawn_behind(jobs):
    """Run the spawns ``(world, fn, *args)`` one after another on a thread while the caller runs the JAX
    engines; the returned ``join()`` waits and re-raises a spawn's failure."""
    failed = []

    def run():
        try:
            for job in jobs:
                zw.spawn(*job)
        except BaseException as e:  # noqa: B902 (re-raised by join)
            failed.append(e)

    t = threading.Thread(target=run)
    t.start()

    def join():
        t.join()
        if failed:
            raise failed[0]

    return join


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the JAX engine's run and the port's ranks."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    jobs, data = [], {}
    for world, cases in CASES.items():
        params_files, batch_files = [], []
        for i, case in enumerate(cases):
            bs = _batches(case, STEPS)
            data[(world, i)] = bs
            batch_files.append(str(d / f"batches_{world}_{i}.npz"))
            _save_batches(batch_files[-1], bs)
            params_files.append(str(d / f"params_{world}_{i}.npz"))
            np.savez(params_files[-1], **_flat(_jax_params(case["model"])[1]))
        (d / f"out{world}").mkdir()
        jobs.append((world, tw.train_cases, cases, params_files, batch_files, STEPS, str(d / f"out{world}")))
    join = _spawn_behind(jobs)
    jax_runs = {key: _jax_run(CASES[key[0]][key[1]], bs, STEPS) for key, bs in data.items()}
    join()
    return {(w, i): dict(jax=jax_runs[(w, i)], ranks=[torch.load(d / f"out{w}" / f"case{i}_rank{r}.pt",
                                                                 weights_only=False) for r in range(w)])
            for w, i in IDS}


def _port_masters(ranks):
    """The whole masters of the port, flat; a pipeline's stages stacked as the JAX engine holds them."""
    if ranks[0]["cls"] != "PipelineEngine":
        return ranks[0]["masters"]
    stages = sorted((r for r in ranks if r["dp"] == 0 and r["tp"][1] == 0), key=lambda r: r["stage"])
    trees = []
    for r in stages:
        tree = {}
        for path, v in r["masters"].items():
            node = tree
            *parents, name = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = v
        trees.append(tree)
    return _flat(stage_params_to_pipe(trees))


@pytest.mark.parametrize("world,i", IDS, ids=[CASES[w][i]["name"] for w, i in IDS])
def test_tensor_parallel_ranks_match_the_jax_engine(runs, world, i):
    case = CASES[world][i]
    want, ranks = runs[(world, i)]["jax"], runs[(world, i)]["ranks"]
    got_l, got_n = ranks[0]["losses"], ranks[0]["norms"]
    for r in ranks[1:]:  # every rank reports the same global loss and norm
        assert r["losses"] == got_l and r["norms"] == got_n
    for tl, l, tn, n in zip(got_l, want["losses"], got_n, want["norms"]):
        assert abs(tl - l) <= LOSS_TOL, (got_l, want["losses"])
        assert abs(tn - n) <= NORM_TOL * n, (got_n, want["norms"])
    got = _port_masters(ranks)
    assert set(got) == set(want["after"])
    lr = case["config"]["optimizer"]["params"]["lr"]
    for path, w in want["after"].items():
        travel = np.abs(w - want["init"][path]).max()
        tol = max(2 * travel, 2 * STEPS * lr) if path.endswith("k_proj/bias") else PARAM_TOL * travel
        np.testing.assert_allclose(got[path], w, atol=tol, rtol=0, err_msg=path)
    assert all(r["tp"][0] == 2 for r in ranks)
    assert all(r["comm"]["tp_all_reduce"][0] > 0 for r in ranks)


@pytest.mark.parametrize("world,i", IDS, ids=[CASES[w][i]["name"] for w, i in IDS])
def test_tensor_ranks_hold_bit_equal_replicas(runs, world, i):
    """Every leaf a tensor group holds whole (norms, row-parallel and column-parallel biases, wpe, a whole
    wte) is bit-equal on its ranks after the last step: the column-parallel biases' gradients were summed."""
    case = CASES[world][i]
    ranks = runs[(world, i)]["ranks"]
    by = {}
    for r in ranks:
        by.setdefault((r["stage"], r["dp"], r["zero"]), []).append(r)
    for group in by.values():
        assert len(group) == 2 and {r["tp"][1] for r in group} == {0, 1}
        a, b = (r["whole"] for r in group)
        assert set(a) == set(b) and a
        for path in a:
            assert np.array_equal(a[path], b[path]), path
    partial = set(ranks[0]["partial"])
    if case["model"].get("tie_embeddings", True):  # the GPT's column-parallel biases are partial
        assert any(p.endswith("q_proj/bias") for p in partial) and any(p.endswith("up_proj/bias") for p in partial)
        assert all(p in ranks[0]["whole"] for p in partial)
    dims = ranks[0]["tensor_dims"]
    split_wte = [p for p in dims if p.endswith("wte") and dims[p] == 0]
    assert bool(split_wte) == (case["model"]["vocab_size"] % 2 == 0)


def test_the_llama_heads_split_two_and_one_a_rank(runs):
    ranks = runs[(2, 1)]["ranks"]
    paths = sorted(ranks[0]["tensor_dims"])
    local = dict(zip(paths, ranks[0]["local"]))
    assert local["layer_0/attn/q_proj/kernel"] == (32, 2, 8)
    assert local["layer_0/attn/k_proj/kernel"] == (32, 1, 8)
    assert local["lm_head/kernel"] == (32, 256)
    assert local["wte"] == (256, 32)


def test_train_flops_count_a_ranks_share(runs):
    cfg = TransformerConfig(**GPT)
    whole = train_flops(cfg, MICRO, SEQ)
    assert train_flops(cfg, MICRO, SEQ, tp=2) == whole // 2
    assert runs[(2, 0)]["ranks"][0]["step_flops"] == whole // 2


def test_remat_partitions_the_saved_block_inputs(runs):
    """Under partition_activations each block input is all-gathered in the forward and at the recompute, and its
    gradient once: 3 gathers a block a step."""
    comm = runs[(2, 2)]["ranks"][0]["comm"]
    assert comm["tp_all_gather"][0] == 3 * GPT["n_layers"] * STEPS
    assert "tp_all_gather" not in runs[(2, 0)]["ranks"][0]["comm"]


# ---------------------------------------------------------------- checkpoints
PRE, POST = 3, 2
CKPT_MODEL = GPT


def _ckpt_case(mesh, micro, universal, dst=None, stage=1):
    case = dict(model=CKPT_MODEL, config=_config(mesh, stage=stage, micro=micro), universal=universal)
    if dst is not None:
        case["dst"] = _config(dst[0], stage=stage, micro=dst[1])
    return case


CKPT_CASES = {
    4: [_ckpt_case({"data": 2, "tensor": 2}, 2, False),
        _ckpt_case({"data": 2, "tensor": 2}, 2, True, dst=({"data": 4}, 1))],
    2: [_ckpt_case({"tensor": 2}, 2, True, dst=({"data": 2}, 1)),
        _ckpt_case({"data": 2}, 1, True, dst=({"tensor": 2}, 2))],
}


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel_ckpt")
    _, params = _jax_params(CKPT_MODEL)
    np.savez(d / "params.npz", **_flat(params))
    rng = np.random.default_rng(7)
    bs = [{"input_ids": rng.integers(0, CKPT_MODEL["vocab_size"], (4, SEQ)).astype(np.int32)}
          for _ in range(PRE + POST)]
    jobs = []
    for world, cases in CKPT_CASES.items():
        rows = _rows(cases[0])
        _save_batches(d / f"batches{world}.npz", [{k: v[:rows] for k, v in b.items()} for b in bs])
        (d / f"out{world}").mkdir()
        jobs.append((world, tw.ckpt_cases, cases, str(d / "params.npz"), str(d / f"batches{world}.npz"), PRE, POST,
                     str(d / f"ckpt{world}"), str(d / f"out{world}")))
    join = _spawn_behind(jobs)
    jax_runs = {}
    for world, cases in CKPT_CASES.items():
        rows = _rows(cases[0])
        for case in cases:  # the native and universal cases at world 4 share their source run
            key = repr(case["config"])
            if key not in jax_runs:
                jax_runs[key] = _jax_run(case, [{k: v[:rows] for k, v in b.items()} for b in bs], PRE + POST)
    join()
    return {(world, i): dict(ranks=[torch.load(d / f"out{world}" / f"ckpt{i}_rank{r}.pt", weights_only=False)
                                    for r in range(world)], jax=jax_runs[repr(case["config"])]["losses"])
            for world, cases in CKPT_CASES.items() for i, case in enumerate(cases)}


def test_native_checkpoint_resumes_bit_exact_at_data2_tensor2(ckpt_runs):
    ranks = ckpt_runs[(4, 0)]["ranks"]
    for r in ranks:
        assert r["exact"] and r["got"] == r["want"] and r["steps_loaded"] == PRE
        assert r["merged_equal"]  # zero_to_fp32 over the four rank files gives the whole masters
    np.testing.assert_allclose(ranks[0]["want"], ckpt_runs[(4, 0)]["jax"], atol=LOSS_TOL, rtol=0)


@pytest.mark.parametrize("world,i", [(4, 1), (2, 0), (2, 1)],
                         ids=["data2-tensor2->data4", "tensor2->data2", "data2->tensor2"])
def test_universal_checkpoints_resize_across_tensor_degrees(ckpt_runs, world, i):
    run = ckpt_runs[(world, i)]
    for r in run["ranks"]:
        assert r["steps_loaded"] == PRE and r["got"] == run["ranks"][0]["got"]
        np.testing.assert_allclose(r["got"][:PRE], r["want"][:PRE], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["got"][PRE:], r["want"][PRE:], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["got"], run["jax"], atol=LOSS_TOL, rtol=0)


# ---------------------------------------------------------------- refusals
REFUSED = [
    ({"tensor": 2, "seq": 2}, {}, "sequence parallelism beside tensor parallelism"),
    ({"tensor": 2, "context": 2}, {}, "sequence parallelism beside tensor parallelism"),
    ({"tensor": 2, "expert": 2}, {}, "expert parallelism beside tensor parallelism"),
    ({"tensor": 2}, {"offload_optimizer": {"device": "cpu"}}, "ZeRO-Offload .* under tensor parallelism"),
    ({"tensor": 2}, {"offload_param": {"device": "cpu"}}, "ZeRO-Offload .* under tensor parallelism"),
]


@pytest.mark.parametrize("mesh,zero,match", REFUSED, ids=["seq", "context", "expert", "offload_optimizer",
                                                          "offload_param"])
def test_tensor_combinations_left_out_raise(mesh, zero, match):
    with pytest.raises(NotImplementedError, match=match):
        DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1, "mesh": mesh, "zero_optimization": {"stage": 2, **zero}})


def test_an_moe_model_under_tensor_raises_and_an_mpu_is_accepted(tmp_path):
    moe = dict(GPT, moe_num_experts=4, moe_top_k=2, moe_layer_freq=1, tie_embeddings=False)
    cases = [dict(model=moe, config=_config({"tensor": 2})),
             dict(model=moe, config=_config({"pipe": 2, "tensor": 1}, gas=2)),
             dict(model=GPT, config=_config({"tensor": 2}), mpu=True),
             dict(model=dict(GPT, n_kv_heads=1), config=_config({"tensor": 2}))]
    zw.spawn(2, tw.refusals, cases, None, str(tmp_path))
    got = torch.load(tmp_path / "refused_rank0.pt", weights_only=False)
    assert got[0][0] == "NotImplementedError" and "MoE model under tensor parallelism" in got[0][1]
    assert got[1] == ("", "")  # MoE stages under pipe at tensor 1 still run
    assert got[2] == ("", "")
    assert got[3][0] == "ValueError" and "not divisible by the tensor axis 2" in got[3][1]  # 1 KV head over 2
    with pytest.raises(NotImplementedError, match="MoE model under tensor parallelism"):
        check_tensor({"tensor": 2}, DeepSpeedConfig({}).zero_config, moe=True)
