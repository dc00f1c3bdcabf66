"""Port parity: sequence parallelism (Ulysses over ``seq``, ring attention
over ``context``) against the JAX package.

The attention ops: each port rank (``torch_zero_worker.spawn``, gloo) holds
its slice of seeded q, k, v; ``ulysses_attention`` and ``ring_attention`` at
2 and 4 ranks (causal, non-causal, GQA with KV heads the group does not
divide) give the slices of JAX ``ulysses_sharded_attention`` /
``ring_sharded_attention`` on a mesh of as many faked CPU devices, to 2e-5
(where JAX's all-to-all cannot split the KV heads, the slices of JAX
``attention_xla``);
the gradients of the sum of squares of the output, through the exchanges
(``_SeqAllToAll``, ``_RingAttention``'s backward), the slices of
``jax.grad`` of JAX ``attention_xla``, to which the JAX package's own
ring-gradient test holds its sharded form, to 5e-4 (the bounds of JAX
``tests/unit/test_sequence.py``).

The engine: ``initialize`` at ``seq: 2`` and ``context: 2`` with ZeRO
stages 0-3 (a GQA llama with rope), and at JAX
``test_ulysses_with_zero3_matches_dp``'s mesh (``data 2, fsdp 2, seq 2``,
stage 3, 8 ranks), against the JAX engine on the same mesh, weights and
batches: losses to 2e-5, the grad norm to 1e-5 relative, every master
within 2 % of the reference's travel, as ``test_torch_zero_engine.py``.
Every refusal names what is missing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import torch_pipe_worker as pw
import torch_zero_worker as zw
import deepspeed_tpu
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.ops.attention import attention_xla
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu.sequence import ring_sharded_attention, ulysses_sharded_attention

import deepspeed_tpu_torch
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

OUT_TOL = 2e-5
GRAD_TOL = 5e-4
LOSS_TOL = 2e-5
NORM_TOL = 1e-5
PARAM_TOL = 0.02
LR = 1e-2
STEPS = 3

SHAPES = {"mha": dict(B=2, S=32, H=8, D=16, kvH=8), "gqa": dict(B=2, S=32, H=8, D=8, kvH=2)}
OPS = [(name, kind, causal) for name in SHAPES for kind in ("ulysses", "ring") for causal in (True, False)]


def _qkv(name, seed=0):
    sh = SHAPES[name]
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(sh["B"], sh["S"], h, sh["D"]).astype(np.float32) for h in (sh["H"], sh["kvH"], sh["kvH"]))


@pytest.fixture(scope="module")
def op_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_ops")
    inputs = {f"{n}_{t}": a for n in SHAPES for t, a in zip("qkv", _qkv(n))}
    np.savez(d / "inputs.npz", **inputs)
    out = {}
    for world in (2, 4):
        res = d / f"out{world}"
        res.mkdir()
        zw.spawn(world, pw.attention_cases, str(d / "inputs.npz"), OPS, str(res))
        out[world] = [torch.load(res / f"attn_rank{r}.pt", weights_only=False) for r in range(world)]
    return out


def _jax_grads(q, k, v, causal):
    return jax.grad(lambda q, k, v: jnp.sum(attention_xla(q, k, v, causal=causal)**2), argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,kind,causal", OPS, ids=[f"{n}-{k}-{'causal' if c else 'full'}" for n, k, c in OPS])
def test_attention_slices_match_the_jax_sharded_attention(op_runs, world, name, kind, causal):
    q, k, v = (jnp.asarray(a) for a in _qkv(name))
    axis = "seq" if kind == "ulysses" else "context"
    mesh = MeshTopology(MeshConfig.from_dict({axis: world}), devices=jax.devices()[:world]).mesh
    fn = ulysses_sharded_attention if kind == "ulysses" else ring_sharded_attention
    if kind == "ulysses" and k.shape[2] % world:
        # the JAX all-to-all cannot split 2 KV heads over 4 ranks; the port repeats each just enough, which
        # leaves the attention that of JAX attention_xla
        with pytest.raises(ValueError, match="divisible"):
            fn(q, k, v, mesh, axis_name=axis, causal=causal)
        want = np.asarray(attention_xla(q, k, v, causal=causal))
    else:
        want = np.asarray(fn(q, k, v, mesh, axis_name=axis, causal=causal))
    grads = [np.asarray(g) for g in _jax_grads(q, k, v, causal)]
    ranks = op_runs[world]
    assert ranks[0]["world"] == world
    got = np.concatenate([r[(name, kind, causal)]["out"].numpy() for r in ranks], axis=1)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=0)
    for key, g in zip(("dq", "dk", "dv"), grads):
        got_g = np.concatenate([r[(name, kind, causal)][key].numpy() for r in ranks], axis=1)
        np.testing.assert_allclose(got_g, g, atol=GRAD_TOL, rtol=0, err_msg=key)


# ---------------------------------------------------------------- the engine
LLAMA = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=64, norm="rmsnorm",
             activation="swiglu", pos_emb="rope", tie_embeddings=False)
GPT = dict(vocab_size=64, n_layers=2, n_heads=4, d_model=32, max_seq_len=32)  # JAX test_ulysses_with_zero3's


def _config(mesh, stage, micro):
    return {"train_micro_batch_size_per_gpu": micro, "steps_per_print": 1000,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-2, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
                                                         "warmup_num_steps": 2, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "mesh": mesh,
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}


ENGINE = {2: [dict(name=f"{axis}2-stage{s}", model=LLAMA, config=_config({axis: 2}, s, 2))
              for axis in ("seq", "context") for s in (0, 1, 2, 3)],
          8: [dict(name="data2-fsdp2-seq2-stage3", model=GPT, config=_config({"data": 2, "fsdp": 2, "seq": 2}, 3, 1))]}
ENGINE_IDS = [(w, i) for w in ENGINE for i in range(len(ENGINE[w]))]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _engine_batches(world, model, seed=0):
    rows = 4 if world == 8 else 2
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, model["vocab_size"], (rows, 32)).astype(np.int32)} for _ in range(STEPS)]


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq_engine")
    out = {}
    for world, cases in ENGINE.items():
        model = JaxCausalLM(JaxConfig(**cases[0]["model"]))
        params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 16), np.int32)}))
        np.savez(d / f"params{world}.npz", **_flat(params))
        batches = _engine_batches(world, cases[0]["model"])
        np.savez(d / f"batches{world}.npz", **{f"{k}__{j}": v for j, b in enumerate(batches) for k, v in b.items()})
        res = d / f"out{world}"
        res.mkdir()
        zw.spawn(world, pw.seq_cases, cases, str(d / f"params{world}.npz"), str(d / f"batches{world}.npz"), STEPS,
                 str(res))
        for i, case in enumerate(cases):
            mesh = MeshTopology(MeshConfig.from_dict(case["config"]["mesh"]), devices=jax.devices()[:world])
            jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=params, config=case["config"],
                                                     mesh=mesh)
            it = iter(batches)
            losses, norms = [], []
            for _ in range(STEPS):
                losses.append(float(jeng.train_batch(it)))
                norms.append(jeng.get_global_grad_norm())
            out[(world, i)] = dict(jax=dict(losses=losses, norms=norms, init=_flat(params),
                                            after=_flat(jax.tree.map(np.asarray, jeng.params))),
                                   ranks=[torch.load(res / f"case{i}_rank{r}.pt", weights_only=False)
                                          for r in range(world)])
    return out


@pytest.mark.parametrize("world,i", ENGINE_IDS, ids=[ENGINE[w][i]["name"] for w, i in ENGINE_IDS])
def test_sequence_parallel_engine_matches_the_jax_engine(engine_runs, world, i):
    case = ENGINE[world][i]
    run = engine_runs[(world, i)]
    want, ranks = run["jax"], run["ranks"]
    got_l, got_n = ranks[0]["losses"], ranks[0]["norms"]
    for r in ranks[1:]:
        assert r["losses"] == got_l and r["norms"] == got_n
    for tl, l, tn, n in zip(got_l, want["losses"], got_n, want["norms"]):
        assert abs(tl - l) <= LOSS_TOL, (got_l, want["losses"])
        assert abs(tn - n) <= NORM_TOL * n, (got_n, want["norms"])
    got = ranks[0]["masters"]
    assert set(got) == set(want["after"])
    for path, w in want["after"].items():
        travel = np.abs(w - want["init"][path]).max()
        # k_proj's bias has a zero true gradient: Adam moves each engine's element by up to lr a step in the
        # direction of its own fp32 noise, so two engines may part by up to 2 lr a step
        tol = max(2 * travel, 2 * STEPS * LR) if path.endswith("k_proj/bias") else PARAM_TOL * travel
        np.testing.assert_allclose(got[path], w, atol=tol, rtol=0, err_msg=path)
    mesh = case["config"]["mesh"]
    axis = "seq" if "seq" in mesh else "context"
    P = mesh[axis]
    for rank, r in enumerate(ranks):
        kind, size, sp_rank = r["sp"]
        assert (kind, size) == (axis, P)
        seq_ws, seq_r, ctx_ws, ctx_r, pipe_ws, group = r["getters"]
        assert (seq_ws, ctx_ws, pipe_ws) == ((P, 1, 1) if axis == "seq" else (1, P, 1))
        assert (seq_r if axis == "seq" else ctx_r) == sp_rank == rank % P  # seq / context are inner axes
        assert rank in group and len(group) == P
    comm = ranks[0]["comm"]
    assert comm["all_reduce"][0] > 0


REFUSED = [
    ("moe-seq", dict(LLAMA, moe_num_experts=4, moe_top_k=2, moe_layer_freq=2), {"seq": 2}, 16,
     "NotImplementedError", "MoE under sequence parallelism"),
    ("alibi-context", dict(LLAMA, pos_emb="alibi"), {"context": 2}, 16, "NotImplementedError",
     "ALiBi and sliding windows under context parallelism"),
    ("window-context", dict(LLAMA, sliding_window=8), {"context": 2}, 16, "NotImplementedError",
     "ALiBi and sliding windows under context parallelism"),
    ("heads-indivisible", dict(LLAMA, n_heads=3, n_kv_heads=None, d_model=24), {"seq": 2}, 16, "ValueError",
     "Ulysses splits the 3 query heads over the sequence group of 2"),
    ("length-indivisible", LLAMA, {"seq": 2}, 15, "ValueError", "sequence length 15 does not split over mesh.seq=2"),
]


def test_engine_refusals_name_the_missing_piece(tmp_path):
    cases = [dict(model=m, config=_config(mesh, 0, 2), seq_len=n) for _, m, mesh, n, _, _ in REFUSED]
    zw.spawn(2, pw.refusals, cases, str(tmp_path))
    for r in range(2):
        got = torch.load(tmp_path / f"refused_rank{r}.pt", weights_only=False)
        for (name, _, _, _, typ, msg), (got_t, got_m) in zip(REFUSED, got):
            assert got_t == typ and msg in got_m, (name, got_t, got_m)


@pytest.mark.parametrize("mesh,msg", [({"seq": 2, "context": 2}, "seq and context both above 1"),
                                      ({"pipe": 2, "seq": 2}, "sequence parallelism inside pipeline stages"),
                                      ({"pipe": 2, "context": 2}, "sequence parallelism inside pipeline stages")])
def test_config_refusals(mesh, msg):
    with pytest.raises(NotImplementedError, match=msg):
        DeepSpeedConfig({"train_micro_batch_size_per_gpu": 1, "mesh": mesh})


def test_an_mpu_raises():
    """An mpu no longer raises: as in the JAX package (``engine.py:101``) it is accepted and unused, the mesh
    section laying out the tensor axis."""
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=lambda p, b, r: p["w"].sum(),
                                                     model_parameters={"w": np.zeros(2, np.float32)}, mpu=object(),
                                                     config={"train_micro_batch_size_per_gpu": 1}, device="cpu")
    assert engine.topology.model_parallel_size == 1
