"""Port parity: pipeline parallelism against the JAX package.

The schedules' instruction streams, the partitions and ``PipelineModule``'s
stage ranges equal the JAX package's; ``CausalLM.to_pipeline`` refuses what
the JAX one refuses, with its messages; the stacked-tree converters invert
each other and agree with the JAX ``to_pipeline``'s split.

The engine: each rank of the port is one stage (``torch_zero_worker.spawn``:
gloo over a ``file://`` store, every case of a world size in one spawn), the
JAX ``PipelineEngine`` runs on a mesh over as many of the 8 faked CPU
devices, both from the JAX initialisation and on the same global
micro-batches (each port rank its data rank's rows of them). Cases at pipe 2
(1F1B and GPipe; tied and untied heads; MoE stages; window layers;
``embedding_norm`` with ALiBi, ``layernorm_np``, ``embed_scale``;
recompute from the stashed input; a ``PipelineModule`` of ``LayerSpec`` and
``TiedLayerSpec``), at pipe 4 and at pipe 2 x data 2 (ZeRO 0 and 1). Held
as ``test_torch_zero_engine.py`` holds ZeRO: the losses to 2e-5, the global
grad norm to 1e-5 relative, every master after the last step within 2 % of
how far the reference moved that tensor (``k_proj``'s bias, whose true
gradient is zero, within twice its travel); every stage reports the same
loss and norm, the tied ``wte`` is bit-equal on the first and the last
stage, and 1F1B's stash holds the same micro-batches at M 4 and 8 (at most
``num_pipe_buffers()``), GPipe's all M.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import torch_pipe_worker as pw
import torch_zero_worker as zw
import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.runtime.pipe import module as jax_module
from deepspeed_tpu.runtime.pipe import schedule as jax_schedule

from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, pipe_params_to_stage, stage_params_to_pipe
from deepspeed_tpu_torch.runtime.pipe import module as port_module
from deepspeed_tpu_torch.runtime.pipe import schedule as port_schedule

LOSS_TOL = 2e-5
NORM_TOL = 1e-5
PARAM_TOL = 0.02  # of each tensor's travel in the reference
LR = 1e-2
SEQ = 16
MICRO = 2

GPT = dict(vocab_size=128, n_layers=4, n_heads=2, d_model=32, max_seq_len=32)
LLAMA = dict(GPT, n_kv_heads=1, norm="rmsnorm", activation="swiglu", pos_emb="rope", tie_embeddings=False)


def _config(pipe, data=1, schedule="1f1b", gas=4, stage=0, **pipeline):
    return {"train_micro_batch_size_per_gpu": MICRO, "gradient_accumulation_steps": gas, "steps_per_print": 1000,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-2, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
                                                         "warmup_num_steps": 2, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "mesh": {"pipe": pipe, "data": data},
            "pipeline": {"schedule": schedule, **pipeline}, "zero_optimization": {"stage": stage}}


CASES = {
    2: [dict(name="tied-1f1b", model=GPT, config=_config(2)),
        dict(name="untied-llama-gpipe", model=LLAMA, config=_config(2, schedule="gpipe")),
        dict(name="moe-1f1b", model=dict(GPT, moe_num_experts=4, moe_top_k=2, moe_layer_freq=2,
                                         tie_embeddings=False), config=_config(2)),
        dict(name="window-gpipe", model=dict(GPT, sliding_window=8, window_layers=(1, 3)),
             config=_config(2, schedule="gpipe")),
        dict(name="embedding_norm-alibi-1f1b", model=dict(GPT, pos_emb="alibi", embedding_norm=True),
             config=_config(2)),
        dict(name="layernorm_np-1f1b", model=dict(GPT, norm="layernorm_np", tie_embeddings=False),
             config=_config(2)),
        dict(name="embed_scale-1f1b", model=dict(GPT, n_layers=2, norm="rmsnorm", embed_scale=True, rms_offset=True),
             config=_config(2)),
        dict(name="recompute-1f1b", model=GPT, config=_config(2, activation_checkpoint_interval=1)),
        dict(name="layerspec-1f1b", model="layerspec", config=_config(2)),
        dict(name="tied-1f1b-m8", model=GPT, config=_config(2, gas=8), port_only=True)],
    4: [dict(name="pipe4-llama-1f1b", model=LLAMA, config=_config(4)),
        dict(name="pipe4-tied-gpipe", model=GPT, config=_config(4, schedule="gpipe")),
        dict(name="pipe2-data2-zero1-1f1b", model=GPT, config=_config(2, data=2, stage=1)),
        dict(name="pipe2-data2-untied-gpipe", model=dict(GPT, tie_embeddings=False),
             config=_config(2, data=2, schedule="gpipe"))],
}
IDS = [(w, i) for w in CASES for i in range(len(CASES[w])) if not CASES[w][i].get("port_only")]
STEPS = 3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _batches(case, seed=0):
    """STEPS x M global micro-batches of data x MICRO rows (labels for the LayerSpec model)."""
    cfg = case["config"]
    rng = np.random.default_rng(seed)
    vocab = 64 if case["model"] == "layerspec" else case["model"]["vocab_size"]
    out = []
    for _ in range(STEPS * cfg["gradient_accumulation_steps"]):
        ids = rng.integers(0, vocab, (cfg["mesh"]["data"] * MICRO, 8 if case["model"] == "layerspec" else SEQ))
        b = {"input_ids": ids.astype(np.int32)}
        if case["model"] == "layerspec":
            b["labels"] = np.roll(b["input_ids"], -1, axis=-1)
        out.append(b)
    return out


def _jax_layerspec():
    import flax.linen as nn
    import jax.numpy as jnp

    class _Embed(nn.Module):
        vocab: int
        d: int

        @nn.compact
        def __call__(self, ids):
            return self.param("wte", nn.initializers.normal(0.02), (self.vocab, self.d), jnp.float32)[ids]

    class _Block(nn.Module):
        d: int

        @nn.compact
        def __call__(self, x):
            return x + nn.Dense(self.d, name="down")(nn.gelu(nn.Dense(2 * self.d, name="up")(x)))

    def head(module, p, x):
        return x @ p["wte"].T

    def ce(logits, labels):
        logz = jax.nn.logsumexp(logits, axis=-1)
        return jnp.mean(logz - jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0])

    return jax_module.PipelineModule(
        [jax_module.TiedLayerSpec("embed", _Embed, 64, 16)] + [jax_module.LayerSpec(_Block, 16) for _ in range(4)]
        + [jax_module.TiedLayerSpec("embed", _Embed, 64, 16, forward_fn=head)], loss_fn=ce)


def _layerspec_to_port(pipe_params, num_stages=2):
    """The JAX stacked tree of the LayerSpec model as the port's ``{"tied_embed", "layer_<i>"}`` tree."""
    out = {"tied_embed/wte": np.asarray(pipe_params["embed"]["tied_embed"]["wte"])}
    lps = len(pipe_params["stages"])
    for s in range(num_stages):
        for j in range(lps):
            sub = pipe_params["stages"][f"sub_{j}"]
            i = 1 + s * lps + j
            for name in ("up", "down"):
                out[f"layer_{i}/{name}.weight"] = np.asarray(sub[name]["kernel"][s]).T
                out[f"layer_{i}/{name}.bias"] = np.asarray(sub[name]["bias"][s])
    return out


def _port_layerspec_stacked(stage_masters, num_stages=2, lps=2):
    """The port's LayerSpec stage masters as the JAX stacked tree (flat paths)."""
    out = {"embed/tied_embed/wte": stage_masters[0]["tied_embed/wte"]}
    for j in range(lps):
        for name in ("up", "down"):
            w = [stage_masters[s][f"layer_{1 + s * lps + j}/{name}.weight"].T for s in range(num_stages)]
            b = [stage_masters[s][f"layer_{1 + s * lps + j}/{name}.bias"] for s in range(num_stages)]
            out[f"stages/sub_{j}/{name}/kernel"] = np.stack(w)
            out[f"stages/sub_{j}/{name}/bias"] = np.stack(b)
    return out


def _jax_params(case):
    model = JaxCausalLM(JaxConfig(**case["model"]))
    return model, jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0),
                                                      {"input_ids": np.zeros((1, SEQ), np.int32)}))


def _jax_engine(case, world):
    cfg = case["config"]
    mesh = MeshTopology(MeshConfig.from_dict(cfg["mesh"]), devices=jax.devices()[:world])
    if case["model"] == "layerspec":
        eng, _, _, _ = deepspeed_tpu.initialize(model=_jax_layerspec(), config=cfg, mesh=mesh,
                                                example_batch={"input_ids": np.zeros((1, 8), np.int32)})
        return eng, None
    model, params = _jax_params(case)
    eng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=params, config=cfg, mesh=mesh)
    return eng, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the JAX engine's initial and final stacked params, losses and norms, and the port's ranks."""
    d = tmp_path_factory.mktemp("pipe")
    out = {}
    for world, cases in CASES.items():
        params_files, batch_files, jax_runs = [], [], []
        for i, case in enumerate(cases):
            bs = _batches(case)
            batch_files.append(str(d / f"batches_{world}_{i}.npz"))
            np.savez(batch_files[-1], **{f"{k}__{j}": v for j, b in enumerate(bs) for k, v in b.items()})
            params_files.append(str(d / f"params_{world}_{i}.npz"))
            if case.get("port_only"):
                np.savez(params_files[-1], **_flat(_jax_params(case)[1]))
                jax_runs.append(None)
                continue
            eng, full = _jax_engine(case, world)
            init = jax.tree.map(np.asarray, jax.device_get(eng.params))
            np.savez(params_files[-1], **(_layerspec_to_port(init) if full is None else _flat(full)))
            it = iter(bs)
            losses, norms = [], []
            for _ in range(STEPS):
                losses.append(float(eng.train_batch(it)))
                norms.append(eng.get_global_grad_norm())
            jax_runs.append(dict(init=_flat(init), after=_flat(jax.tree.map(np.asarray, jax.device_get(eng.params))),
                                 losses=losses, norms=norms))
        res = d / f"out{world}"
        res.mkdir()
        zw.spawn(world, pw.pipe_cases, cases, params_files, batch_files, STEPS, str(res))
        for i in range(len(cases)):
            ranks = [torch.load(res / f"case{i}_rank{r}.pt", weights_only=False) for r in range(world)]
            out[(world, i)] = dict(jax=jax_runs[i], ranks=ranks)
    return out


def _stacked(case, ranks):
    """The port's stage masters at data rank 0, stacked as the JAX engine holds them (flat paths)."""
    stages = sorted((r for r in ranks if r["data"] == 0), key=lambda r: r["stage"])
    masters = [r["masters"] for r in stages]
    if case["model"] == "layerspec":
        return _port_layerspec_stacked(masters)
    trees = []
    for m in masters:
        tree = {}
        for path, v in m.items():
            node = tree
            *parents, name = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = v
        trees.append(tree)
    return _flat(stage_params_to_pipe(trees))


@pytest.mark.parametrize("world,i", IDS, ids=[CASES[w][i]["name"] for w, i in IDS])
def test_pipeline_engine_matches_the_jax_engine(runs, world, i):
    case = CASES[world][i]
    run = runs[(world, i)]
    want, ranks = run["jax"], run["ranks"]
    assert all(r["cls"] == "PipelineEngine" for r in ranks)
    got_l, got_n = ranks[0]["losses"], ranks[0]["norms"]
    for r in ranks[1:]:  # every stage and data rank reports the same loss and norm
        assert r["losses"] == got_l and r["norms"] == got_n
    for tl, l, tn, n in zip(got_l, want["losses"], got_n, want["norms"]):
        assert abs(tl - l) <= LOSS_TOL, (got_l, want["losses"])
        assert abs(tn - n) <= NORM_TOL * n, (got_n, want["norms"])
    got = _stacked(case, ranks)
    assert set(got) == set(want["after"])
    for path, w in want["after"].items():
        travel = np.abs(w - want["init"][path]).max()
        # k_proj's bias has a zero true gradient: Adam moves each engine's element by up to lr a step in the
        # direction of its own fp32 noise, so two engines may part by up to 2 lr a step
        tol = max(2 * travel, 2 * STEPS * LR) if path.endswith("k_proj/bias") else PARAM_TOL * travel
        np.testing.assert_allclose(got[path], w, atol=tol, rtol=0, err_msg=path)
    by_stage = {(r["stage"], r["data"]): r for r in ranks}
    S = max(s for s, _ in by_stage) + 1
    tied = case["model"] == "layerspec" or case["model"].get("tie_embeddings", True)
    key = "tied_embed/wte" if case["model"] == "layerspec" else "embed/wte"
    for (s, dr), r in by_stage.items():
        if tied and s == S - 1:  # the tied copy steps exactly as the first stage's
            assert np.array_equal(r["masters"][key], by_stage[(0, dr)]["masters"][key])
        assert "not ported" in r["ckpt"]
        if s < S - 1:
            assert r["sent"] > 0


def test_the_1f1b_stash_does_not_grow_with_micro_batches(runs):
    names = [c["name"] for c in CASES[2]]
    m4, m8 = (runs[(2, names.index(n))]["ranks"] for n in ("tied-1f1b", "tied-1f1b-m8"))
    gpipe = runs[(2, names.index("untied-llama-gpipe"))]["ranks"]
    for a, b in zip(m4, m8):
        assert a["peak_stash"] == b["peak_stash"] == 2 - a["stage"] <= a["nbuf"] == b["nbuf"]
    assert all(r["peak_stash"] == 4 for r in gpipe)
    # the M = 8 run trains too: its losses are finite and every stage reports them
    assert np.isfinite(m8[0]["losses"]).all() and m8[0]["losses"] == m8[1]["losses"]


@pytest.mark.parametrize("M,S", [(4, 2), (8, 4), (2, 4), (1, 2), (5, 3)])
def test_schedules_equal_the_jax_schedules(M, S):
    for s in range(S):
        for name in ("TrainSchedule", "InferenceSchedule", "DataParallelSchedule"):
            got = [[repr(c) for c in step] for step in getattr(port_schedule, name)(M, S, s)]
            want = [[repr(c) for c in step] for step in getattr(jax_schedule, name)(M, S, s)]
            assert got == want, (name, s)
            assert getattr(port_schedule, name)(M, S, s).num_pipe_buffers() == \
                getattr(jax_schedule, name)(M, S, s).num_pipe_buffers()
        # GPipe: 1F1B's instructions (each micro-batch its own buffer), every forward before every backward
        key = lambda c: (c.name, c.kwargs.get("micro_batch_id", -1))  # noqa: E731
        gpipe = [c for step in port_schedule.GPipeSchedule(M, S, s) for c in step]
        one = [c for step in port_schedule.TrainSchedule(M, S, s) for c in step]
        assert sorted(map(key, gpipe)) == sorted(map(key, one))
        names = [c.name for c in gpipe]
        assert max(i for i, n in enumerate(names) if n == "ForwardPass") < names.index("BackwardPass")


def test_partitions_and_pipeline_modules_equal_the_jax_ones():
    for n, p in [(10, 4), (8, 4), (3, 5), (7, 2)]:
        assert port_module.partition_uniform(n, p) == jax_module.partition_uniform(n, p)
    for w, p in [([1, 1, 10, 1, 1], 2), ([3, 1, 4, 1, 5, 9, 2, 6], 3), ([1] * 6, 4)]:
        assert port_module.partition_balanced(w, p) == jax_module.partition_balanced(w, p)

    class Dummy:
        pass

    for method in ("uniform", "parameters", "type:dummy"):
        specs_p = [port_module.LayerSpec(Dummy) for _ in range(8)]
        specs_j = [jax_module.LayerSpec(Dummy) for _ in range(8)]
        pm_p = port_module.PipelineModule(specs_p, num_stages=4, partition_method=method)
        pm_j = jax_module.PipelineModule(specs_j, num_stages=4, partition_method=method)
        assert pm_p.parts == pm_j.parts
        assert [list(pm_p.stage_layer_range(s)) for s in range(4)] == [list(pm_j.stage_layer_range(s))
                                                                          for s in range(4)]
    pm = pw.layerspec_model()
    pm_j = _jax_layerspec()
    assert pm.tied_keys() == pm_j.tied_keys() == {"embed": [0, 5]}
    stage = pm.to_pipeline(2, stage_id=1)
    assert pm.parts == [0, 3, 6] and pm.tied_stages() == {"embed": (0, 1)}
    assert sorted(stage.params) == ["layer_3", "layer_4", "tied_embed"] and stage.embed_fn is None
    assert [type(x).__name__ for x in pm.build_stage(0)] == ["Embed", "Block", "Block"]
    # a tied layer is built alike on each of its stages
    assert torch.equal(pm.to_pipeline(2, stage_id=0).params["tied_embed"]["wte"], stage.params["tied_embed"]["wte"])


REFUSED = [dict(GPT, n_layers=3), dict(GPT, scan_layers=True),
           dict(GPT, moe_num_experts=4, moe_layer_freq=2, tie_embeddings=False),
           dict(GPT, sliding_window=8, window_layers=(1, 3))]


@pytest.mark.parametrize("fields", REFUSED, ids=["indivisible", "scan_layers", "moe-misaligned", "window-misaligned"])
def test_to_pipeline_refuses_what_the_jax_one_refuses(fields):
    with pytest.raises((ValueError, NotImplementedError)) as want:
        JaxCausalLM(JaxConfig(**fields)).to_pipeline(4, rng=jax.random.PRNGKey(0),
                                                     example_batch={"input_ids": np.zeros((1, SEQ), np.int32)})
    with pytest.raises(want.type) as got:
        CausalLM(TransformerConfig(**fields)).to_pipeline(4, stage_id=0)
    assert str(got.value) == str(want.value)


def test_bert_heads_refuse_the_pipeline():
    cfg = dataclasses.replace(TransformerConfig(**GPT), mlm_head=True)
    with pytest.raises(NotImplementedError, match="BERT-style"):
        CausalLM(cfg).pipeline_checks(2)


def test_converters_split_as_the_jax_to_pipeline(tmp_path):
    for fields in (GPT, LLAMA, dict(GPT, embedding_norm=True, pos_emb="alibi")):
        model = JaxCausalLM(JaxConfig(**fields))
        params = model.init(jax.random.PRNGKey(1), {"input_ids": np.zeros((1, SEQ), np.int32)})
        stacked = jax.tree.map(np.asarray, model.to_pipeline(2, params=params)[0])
        full = jax.tree.map(np.asarray, params)
        cfg = TransformerConfig(**fields)
        stages = [CausalLM(cfg).to_pipeline(2, params=full, stage_id=s).params for s in range(2)]
        for s in range(2):
            conv = pipe_params_to_stage(stacked, s, 2, cfg.tie_embeddings)
            assert _flat(conv).keys() == _flat(stages[s]).keys()
            for path, v in _flat(conv).items():
                np.testing.assert_array_equal(v, _flat(stages[s])[path], err_msg=path)
        back = _flat(stage_params_to_pipe(stages))
        assert back.keys() == _flat(stacked).keys()
        for path, v in _flat(stacked).items():
            np.testing.assert_array_equal(back[path], v, err_msg=path)


def test_zero2_and_pld_refuse_the_pipeline():
    from deepspeed_tpu_torch.runtime.pipe.engine import PipelineEngine

    with pytest.raises(ValueError, match="PipelineEngine supports ZeRO stages 0-1"):
        PipelineEngine(model=CausalLM(TransformerConfig(**GPT)), config=_config(2, stage=2), device="cpu")
    with pytest.raises(ValueError, match="progressive_layer_drop is not supported under the pipeline engine"):
        PipelineEngine(model=CausalLM(TransformerConfig(**GPT)),
                       config=dict(_config(2), progressive_layer_drop={"enabled": True}), device="cpu")
    with pytest.raises(ValueError, match="PipelineEngine supports ZeRO stages 0-1"):
        jax_model = JaxCausalLM(JaxConfig(**GPT))
        deepspeed_tpu.initialize(model=jax_model, model_parameters=jax_model.init(
            jax.random.PRNGKey(0), {"input_ids": np.zeros((1, SEQ), np.int32)}), config=_config(2, stage=2),
            mesh=MeshTopology(MeshConfig.from_dict({"pipe": 2, "data": 1}), devices=jax.devices()[:2]))
