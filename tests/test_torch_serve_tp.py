"""Port parity: tensor-parallel serving at tp = 2 against the JAX engine at tp = 2.

The JAX package serves on this suite's 8 forced host devices (a ``data`` 4 x
``tensor`` 2 mesh); the port runs two gloo ranks on the CPU
(``torch_tp_worker.serve_tp_cases``, one spawn for every case), each
holding its shard of the heads, of the MLP or expert hidden dim and of the
pool's KV heads. The weights come from the JAX initialisation
(``params_from_numpy``); everything runs in fp32, the port's kernels through
their plain versions. The config and prompts are ``tests/unit/test_serve_tp.py``'s
(an out-of-vocab id 999 included). Held:

- greedy tokens at tp 2 equal the JAX engine's at tp 2 and the port's at
  tp 1: the fused loop, the prefix-cache re-serve and speculative decoding
  (``decode_burst=0``); ``top_k=1`` sampling equals greedy; both ranks'
  tokens and logits are the same bits;
- a prefill's logits within 1e-5 of JAX tp 2's, relative to max |logit|;
- ``tp_all_reduce`` on each rank's row against JAX ``tp_all_reduce`` under
  ``shard_map`` on the same arrays: exact within 1e-6 (relative), the
  interleaved reduce bit-equal to the exact one, 8 and 4 bits within the
  EQuARX bound (``tp * scale / 2``), each rank the same bits;
- ``shard_pool_geometry`` equal to JAX's, with the same refusals; the pool
  holds KVH / 2 heads a rank;
- ``TPContext.signature()`` in the JAX format, the step keys ending in the
  shard signature (``"tp1"`` at tp 1, where the engine takes no group);
- the journal fingerprint's topology fields, a tp 2 session replayed token
  for token, and the replay gate's refusals (a world tp does not divide, a
  recorded signature the rebuilt engine does not reproduce);
- ``kv_quant_bits`` and ``kv_spill`` refused under TP, as in JAX;
- MoE at tp 2 (``test_moe_expert_tp_serving``'s config: each expert's
  hidden dim split) equal to JAX tp 2 and to the dense oracle;
- int8 and int4 quantised after sharding: each rank's codes, scales and
  layouts equal JAX's shard, logits within JAX's own 0.06 / 0.5 (relative)
  of the dense tp 2 engine's;
- v1 ``init_inference`` at ``tp_size`` 2 with int8: tokens equal tp 1's and
  JAX tp 2's (``test_v1_weight_only_quant_tp2``);
- ``shard_params``: each rank's slice of every leaf of a dense (MHA, tied),
  a GQA and an MoE tree equals the JAX ``NamedSharding``'s shard;
- ``drop_tokens`` / ``gather_tokens`` over the tensor group.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import torch_tp_worker as tw
import torch_zero_worker as zw
from deepspeed_tpu.comm.collectives import tp_all_reduce as jax_tp_all_reduce
from deepspeed_tpu.inference.quantization import QuantizedParam as JaxQuantizedParam
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.model_runner import _SHARD_MAP_KW, shard_map
from deepspeed_tpu.inference.v2.model_runner import TPContext as JaxTPContext
from deepspeed_tpu.inference.v2.ragged.blocked_allocator import shard_pool_geometry as jax_geometry
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.module_inject.load_checkpoint import shard_params as jax_shard_params
from deepspeed_tpu.parallel.mesh import reset_mesh, serving_mesh
from deepspeed_tpu_torch.inference.v2.ragged.blocked_allocator import shard_pool_geometry
from deepspeed_tpu_torch.inference.v2.ragged.manager import DSStateManager, RaggedBatchConfig

TP = 2
LOGIT_TOL = 1e-5
REDUCE_TOL = 1e-6
QUANT_TOL = {8: 0.06, 4: 0.5}  # the JAX tests' own bounds (test_quant_tp2_serving, test_quant_int4_tp2_serving)


def _init(fields, seed):
    model = JaxCausalLM(JaxConfig(**fields))
    return model, model.init(jax.random.PRNGKey(seed), {"input_ids": np.zeros((1, 8), np.int32)})


def _jax_engine(model, params, tp=1, blocks=64, **kw):
    reset_mesh()
    smc = JaxBatchConfig(kv_block_size=8, max_context=model.cfg.max_seq_len, num_kv_blocks=blocks)
    return JaxEngine(model, params, JaxEngineConfig(state_manager=smc, dtype="float32", tensor_parallel=tp, **kw))


def _toks(rows):
    return [list(map(int, r)) for r in rows]


def _dense_generate(model, params, prompt, n_new):
    toks = list(prompt)
    for _ in range(n_new):
        toks.append(int(jnp.argmax(model.apply(params, jnp.asarray([toks], jnp.int32))[0, -1])))
    return toks[len(prompt):]


def _paths(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


def _shard_of(arr, mesh, r):
    """The addressable shard of ``arr`` on the device at tensor index ``r`` (data index 0)."""
    devs = np.asarray(mesh.devices)
    idx = [0] * devs.ndim
    idx[list(mesh.axis_names).index("tensor")] = r
    dev = devs[tuple(idx)]
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)


def _reduce_on_mesh(x, **kw):
    from jax.sharding import PartitionSpec as P

    fn = shard_map(lambda s: jax_tp_all_reduce(s, group="tensor", **kw), mesh=serving_mesh(tp=TP).mesh,
                   in_specs=P("tensor"), out_specs=P("tensor"), **_SHARD_MAP_KW)
    return np.asarray(fn(x))


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))) / max(np.max(np.abs(want)), 1e-6))


@pytest.fixture(scope="module")
def models():
    return {"tiny": _init(tw.TINY, 0), "moe": _init(tw.MOE, 6), "mha": _init(tw.MHA, 1), "v1": _init(tw.V1, 0)}


@pytest.fixture(scope="module")
def ref(models):
    """What the JAX package gives at tensor = 2 on the forced host devices."""
    out = {}
    model, params = models["tiny"]
    e2 = _jax_engine(model, params, TP)
    out["fused"] = _toks(e2.generate(tw.PROMPTS, max_new_tokens=tw.NEW))
    out["logits"] = np.asarray(e2.put([100], [tw.LOGIT_PROMPT])[0])
    out["fingerprint"] = e2._journal_fingerprint()["engine"]
    out["sig"] = e2._shard_sig
    s2 = _jax_engine(model, params, TP, spec_decode=True, spec_k=4, decode_burst=0)
    out["spec"] = _toks(s2.generate(tw.MOTIFS, max_new_tokens=32))
    mm, mp = models["moe"]
    out["moe"] = list(map(int, _jax_engine(mm, mp, TP, blocks=48).generate([tw.MOE_PROMPT], max_new_tokens=6)[0]))
    out["moe_oracle"] = _dense_generate(mm, mp, tw.MOE_PROMPT, 6)
    for bits in (8, 4):
        q = _jax_engine(model, params, TP, quant_bits=bits, quant_min_size=256)
        leaves = _paths(q.params, is_leaf=lambda x: isinstance(x, JaxQuantizedParam))
        out[f"q{bits}_leaves"] = {p: (np.asarray(v.q), np.asarray(v.scales), v.layout) for p, v in leaves.items()
                                  if isinstance(v, JaxQuantizedParam)}
    vm, vp = models["v1"]
    reset_mesh()
    qcfg = {"dtype": "fp32", "quant": {"enabled": True, "bits": 8, "group_size": 64}, "tensor_parallel": {"tp_size": TP}}
    out["v1"] = np.asarray(deepspeed_tpu.init_inference(vm, config=qcfg, params=vp).generate(
        np.asarray(tw.V1_IDS, np.int32), max_new_tokens=6)).tolist()
    for name in ("mha", "tiny", "moe"):
        m, p = models[name]
        reset_mesh()
        topo = serving_mesh(TP)
        sharded = _paths(jax_shard_params(p, m, mesh=topo, tp_size=TP))
        out[f"shard_{name}"] = [{k: _shard_of(v, topo.mesh, r) for k, v in sharded.items()} for r in range(TP)]
    reset_mesh()
    red = {"x": jax.random.normal(jax.random.PRNGKey(1), (2, 4, 64), jnp.float32),
           "q8": jax.random.normal(jax.random.PRNGKey(2), (2, 8, 128), jnp.float32),
           "agree": jax.random.normal(jax.random.PRNGKey(3), (2, 4, 32), jnp.float32)}
    red["q4"] = red["q8"]
    out["red_in"] = {k: np.asarray(v) for k, v in red.items()}
    out["red"] = {"exact": _reduce_on_mesh(red["x"]), "il4": _reduce_on_mesh(red["x"], interleave=4),
                  "b8": _reduce_on_mesh(red["q8"], bits=8), "b4": _reduce_on_mesh(red["q4"], bits=4)}
    out["jax_ctx_sig"] = JaxTPContext(mesh=serving_mesh(tp=TP).mesh, tp=TP, bits=8, interleave=2).signature()
    reset_mesh()
    return out


@pytest.fixture(scope="module")
def ranks(models, ref, tmp_path_factory):
    """Each port rank's results from one spawn of two gloo ranks."""
    inputs = tmp_path_factory.mktemp("tp_inputs")
    for name, (_, params) in models.items():
        tw.save_tree(str(inputs / f"{name}.npz"), jax.tree.map(np.asarray, params))
    np.savez(str(inputs / "reduce.npz"), **ref["red_in"])
    out = tmp_path_factory.mktemp("tp_out")
    zw.spawn(TP, tw.serve_tp_cases, str(inputs), str(out))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(TP)]


@pytest.fixture(scope="module")
def tp1(models):
    """The port at tp 1: the engine it always was."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, params_from_numpy

    tiny = jax.tree.map(np.asarray, models["tiny"][1])
    e1 = tw.engine(tw.TINY, tiny)
    out = {"engine": e1, "fused": e1.generate(tw.PROMPTS, max_new_tokens=tw.NEW)}
    out["reserve"] = e1.generate(tw.PROMPTS, max_new_tokens=tw.NEW)
    out["spec"] = tw.engine(tw.TINY, tiny, spec_decode=True, spec_k=4, decode_burst=0).generate(
        tw.MOTIFS, max_new_tokens=32)
    cfg = TransformerConfig(**tw.V1)
    v1 = params_from_numpy(jax.tree.map(np.asarray, models["v1"][1]), "cpu", cfg=cfg)
    out["v1"] = deepspeed_tpu_torch.init_inference(CausalLM(cfg), config={
        "dtype": "fp32", "device": "cpu", "quant": {"enabled": True, "bits": 8, "group_size": 64}}, params=v1).generate(
        np.asarray(tw.V1_IDS, np.int32), max_new_tokens=6).tolist()
    return out


def test_tp1_takes_no_group_and_its_keys_end_in_tp1(tp1):
    e1 = tp1["engine"]
    assert e1._tp == 1 and e1._tp_ctx is None and e1._mesh_topo is None and e1._mods.tp is None
    assert e1._shard_sig == "tp1" and e1._fused_fns and all(k[-1] == "tp1" for k in e1._fused_fns)
    assert all(k[-1] == "tp1" for k in e1._bursts)
    assert {"prefill:tp1", "decode:tp1"} <= set(e1._program_signatures())
    f = e1._journal_fingerprint()["engine"]
    assert (f["tensor_parallel"], f["tp_allreduce_bits"], f["shard_sig"], f["mesh"]) == (1, 0, "tp1", "mesh[none]")
    assert e1._residency_summary()["tp_degree"] == 1


def test_tp2_greedy_equals_jax_tp2_and_port_tp1(ranks, ref, tp1):
    assert ranks[0]["fused"] == ref["fused"] == tp1["fused"]
    assert ranks[1]["fused"] == ranks[0]["fused"]
    assert ranks[0]["tp_ctx"] == (2, 0) and ranks[1]["tp_ctx"] == (2, 1)


def test_tp2_prefix_cache_reserve_equals(ranks, tp1):
    assert ranks[0]["prefix_cache"]
    assert ranks[0]["reserve"] == ranks[0]["fused"] == tp1["reserve"]


def test_tp2_spec_decode_equals(ranks, ref, tp1):
    assert ranks[0]["spec"] == ref["spec"] == tp1["spec"] == ranks[1]["spec"]
    assert ranks[0]["spec_keys"] and ranks[0]["spec_accepted"] > 0


def test_tp2_topk1_sampling_equals_greedy(ranks):
    for r in ranks:
        assert r["sampled"] == r["fused"]


def test_tp2_logits_match_jax_tp2(ranks, ref):
    assert _rel(ranks[0]["logits"], ref["logits"]) < LOGIT_TOL
    np.testing.assert_array_equal(ranks[0]["logits"], ranks[1]["logits"])  # every rank ends with the same row


def test_tp_all_reduce_exact_and_interleaved(ranks, ref):
    x = ref["red_in"]["x"]
    want = x[0] + x[1]
    for r in range(TP):
        got = ranks[r]["reduce"]
        np.testing.assert_allclose(got["exact"].numpy(), ref["red"]["exact"][r], rtol=REDUCE_TOL)
        np.testing.assert_allclose(got["exact"].numpy(), want, rtol=REDUCE_TOL)
        assert torch.equal(got["il4"], got["exact"])  # each element reduced exactly once either way
        np.testing.assert_allclose(got["odd"].numpy(), want[:, :63], rtol=REDUCE_TOL)  # 63 % 4: one reduce
        np.testing.assert_allclose(ref["red"]["il4"][r], ref["red"]["exact"][r], rtol=REDUCE_TOL)
    assert torch.equal(ranks[0]["reduce"]["exact"], ranks[1]["reduce"]["exact"])


@pytest.mark.parametrize("bits", [8, 4])
def test_tp_all_reduce_quantized_bound(ranks, ref, bits):
    x = ref["red_in"][f"q{bits}"]
    want = x[0] + x[1]
    qmax = (1 << (bits - 1)) - 1
    amax = np.max(np.abs(x), axis=(0, -1), keepdims=True)[0]
    bound = TP * (amax / qmax) / 2 + 1e-6  # EQuARX: each rank's rounding is at most scale / 2
    for r in range(TP):
        got = ranks[r]["reduce"][f"b{bits}"].numpy()
        assert np.all(np.abs(got - want) <= bound) and np.max(np.abs(got - want)) > 0
        assert np.all(np.abs(ref["red"][f"b{bits}"][r] - want) <= bound)
    assert torch.equal(ranks[0]["reduce"][f"b{bits}"], ranks[1]["reduce"][f"b{bits}"])


def test_tp_all_reduce_quantized_ranks_agree(ranks):
    # an integer-code sum does not depend on the order of its terms: both ranks decode the same bits
    assert torch.equal(ranks[0]["reduce"]["agree"], ranks[1]["reduce"]["agree"])


def test_shard_pool_geometry_matches_jax():
    for args in [(64, 4096, 2), (8, 128, 1), (16, 512, 4), (3, 96, 3)]:
        assert shard_pool_geometry(*args) == jax_geometry(*args)
    for args in [(8, 100, 3), (8, 128, 0)]:
        with pytest.raises(ValueError):
            shard_pool_geometry(*args)
        with pytest.raises(ValueError):
            jax_geometry(*args)
    sm = DSStateManager(RaggedBatchConfig(kv_block_size=4, max_context=64), num_kv_blocks=16)
    g = sm.shard_geometry(block_bytes=512, shard_degree=4)
    assert g["num_blocks"] == 16 and g["block_bytes_per_shard"] == 128


def test_pool_is_head_sharded(ranks, tp1):
    e1 = tp1["engine"]
    full = tuple(e1.k_pages.shape)
    for r in ranks:
        shape, nbytes = r["pool"]
        assert shape == full[:3] + (full[3] // TP, full[4])
        assert nbytes * TP == e1.k_pages.numel() * e1.k_pages.element_size()
        res = r["residency"]
        assert res["tp_degree"] == TP and res["block_bytes_per_shard"] * TP == res["block_bytes"]
        assert res["block_bytes"] == e1._residency_summary()["block_bytes"]
        assert r["manifest"]["backend"] == "gloo" and r["manifest"]["steps"] == "eager"


def test_tpcontext_signature_and_step_keys(ranks, ref):
    r = ranks[0]
    assert r["mesh_sig"] == "mesh[tensor2]"
    assert r["ctx_sig"] == "tp2:tensor:b8:il2:mesh[tensor2]"
    # the JAX signature has the same fields; its mesh also names the host devices' data axis
    assert r["ctx_sig"].rsplit(":", 1)[0] == ref["jax_ctx_sig"].rsplit(":", 1)[0]
    assert r["shard_sig"] == "tp2:tensor:b0:il2:mesh[tensor2]"
    assert r["shard_sig"].rsplit(":", 1)[0] == ref["sig"].rsplit(":", 1)[0]
    assert r["keys"]["fused"] and all(k[-1] == r["shard_sig"] for k in r["keys"]["fused"])
    assert all(k[-1] == r["shard_sig"] for k in r["keys"]["bursts"] + r["spec_keys"])
    assert f"prefill:{r['shard_sig']}" in r["programs"]


def test_journal_fingerprint_topology(ranks, ref):
    f, want = ranks[0]["fingerprint"], ref["fingerprint"]
    assert set(f) == set(want)
    assert f["tensor_parallel"] == want["tensor_parallel"] == 2
    assert f["tp_allreduce_bits"] == want["tp_allreduce_bits"] == 0
    assert f["mesh"] == "mesh[tensor2]" and "tensor2" in want["mesh"]
    assert f["shard_sig"] == ranks[0]["shard_sig"]


def test_replay_token_exact_and_topology_gate(ranks):
    for r in ranks:
        ok, n_replayed, n_recorded, header = r["replay"]
        assert ok and n_replayed == n_recorded > 0
        assert header["tensor_parallel"] == 2 and header["mesh"] == "mesh[tensor2]"
        assert r["refuse_world"].startswith("RuntimeError") and "mismatched topology" in r["refuse_world"]
        assert r["refuse_sig"].startswith("RuntimeError") and "does not reproduce" in r["refuse_sig"]


def test_tp_refuses_kv_quant_and_spill(ranks):
    for r in ranks:
        assert r["refuse_kvq"].startswith("ValueError") and "tensor_parallel=2" in r["refuse_kvq"]
        assert r["refuse_spill"].startswith("ValueError") and "tensor_parallel=2" in r["refuse_spill"]


def test_moe_tp2_equals_jax_tp2_and_the_dense_oracle(ranks, ref):
    assert ranks[0]["moe"] == ranks[1]["moe"] == ref["moe"] == ref["moe_oracle"]
    assert ranks[0]["moe_wi"] == (4, 32, 64 // TP)  # ("expert", None, "tensor"): each expert's hidden dim split


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_tp2_codes_equal_jax_shards(ranks, ref, bits):
    want = ref[f"q{bits}_leaves"]
    assert want and set(ranks[0][f"q{bits}_leaves"]) == set(want)
    for r in range(TP):
        got = ranks[r][f"q{bits}_leaves"]
        for path, (gq, gs, layout) in want.items():
            lq = got[path]
            assert lq["layout"] == layout and layout.endswith("+gspmd")
            dim = next(i for i in range(2) if gq.shape[i] != lq["q"].shape[i])
            n, ns = lq["q"].shape[dim], lq["scales"].shape[dim]
            np.testing.assert_array_equal(lq["q"], np.take(gq, range(r * n, (r + 1) * n), axis=dim), err_msg=path)
            np.testing.assert_array_equal(lq["scales"], np.take(gs, range(r * ns, (r + 1) * ns), axis=dim),
                                          err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_tp2_logits_within_the_jax_bounds(ranks, bits):
    for r in ranks:
        assert _rel(r[f"q{bits}_logits"], r["dense_quant_prompt"]) < QUANT_TOL[bits]
        assert len(r[f"q{bits}_gen"]) == 4
    np.testing.assert_array_equal(ranks[0][f"q{bits}_logits"], ranks[1][f"q{bits}_logits"])


def test_v1_int8_tp2_tokens_equal_tp1(ranks, ref, tp1):
    assert ranks[0]["v1"] == ranks[1]["v1"] == tp1["v1"] == ref["v1"]
    assert ranks[0]["v1_kv_heads"] == tw.V1["n_heads"] // TP


@pytest.mark.parametrize("name", ["mha", "tiny", "moe"])
def test_shard_params_equal_jax_shards(ranks, ref, name):
    for r in range(TP):
        got, want = ranks[r][f"shard_{name}"], ref[f"shard_{name}"][r]
        assert set(got) == set(want)
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    assert ranks[0]["shard_tiny"]["wte"].shape[0] == tw.TINY["vocab_size"] // TP


def test_token_mappings_over_the_tensor_group(ranks):
    for r in ranks:
        assert r["mappings"] == ((2, 3, 4), True, True)
