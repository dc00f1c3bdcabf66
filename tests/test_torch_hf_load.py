"""Port parity: Hugging Face checkpoints into the port (``module_inject``).

Each case builds a tiny seeded ``transformers`` model (``torch_hf_models``:
the configs and seeds of ``tests/unit/test_hf_interop.py`` and
``test_hf_interop_archs.py``, case for case), saves it with
``save_pretrained`` (safetensors; gpt2 also as ``pytorch_model.bin``) and
loads the directory through the JAX ``load_hf_checkpoint`` and the port's
(``device="cpu"``). Held, for every ``model_type`` the JAX
``config_from_hf`` maps:

- the two configs equal field for field (the compute dtype aside);
- the two trees have the same keys and every leaf bit-equal (fp32);
- AutoTP's rules over the port's tree equal JAX ``AutoTP(tp).tp_parser``'s
  over the JAX tree at tp 2 and 4 (paths, and specs as strings);
- fp32 logits within 1e-5 of JAX's, relative to max |logit|
  (``JAX_TOL``: the same fp32 math in another order);
- logits within the JAX test's own tolerance of the Hugging Face model's
  (3e-4; 2e-4 for the llama and gpt2 checkpoints of ``test_hf_interop``);
- for every decoder family, the v2 engine's prefill logits on the loaded
  tree within 1e-5 of the model's own forward (the serving runner carries
  each family's blocks, rotary, norms, biases and windows).

Also: the longrope refusal and the other ``config_from_hf`` refusals, the
safetensors reader against the ``safetensors`` package (bf16, and a sharded
index), a ``pytorch_model.bin`` and a live model.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

import jax  # noqa: E402

import torch_hf_models as hm  # noqa: E402
from deepspeed_tpu.module_inject import AutoTP as JaxAutoTP  # noqa: E402
from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load  # noqa: E402
from deepspeed_tpu.module_inject.load_checkpoint import config_from_hf as jax_config_from_hf  # noqa: E402
from deepspeed_tpu_torch.module_inject import (AutoTP, config_from_hf, load_hf_checkpoint, load_hf_model,  # noqa: E402
                                               load_hf_state_dict)
from deepspeed_tpu_torch.module_inject.load_checkpoint import read_safetensors  # noqa: E402

JAX_TOL = 1e-5
HF_TOL = dict(rtol=3e-4, atol=3e-4)  # test_hf_interop_archs.py's TOL


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(float(np.max(np.abs(want))), 1e-30))


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def _rules(rules):
    return [(tuple(names), tuple(str(a) for a in spec)) for names, spec in rules]


def _check(d, tm, ids, hf_tol=None, apply_kw=None, hf_kw=None):
    """Load ``d`` through both packages and hold them (and the Hugging Face
    model ``tm``) to each other. Returns the port's (model, params)."""
    apply_kw, hf_kw = apply_kw or {}, hf_kw or {}
    jm, jp = jax_load(d)
    pm, pp = load_hf_checkpoint(d, device="cpu")
    assert _fields(pm.cfg) == _fields(jm.cfg)
    jf, pf = _flat(jax.tree.map(np.asarray, jp)), _flat(pp)
    assert sorted(jf) == sorted(pf)
    for k in jf:
        assert pf[k].dtype == torch.float32 and np.array_equal(pf[k].numpy(), jf[k]), k
    for tp in (2, 4):
        assert _rules(AutoTP(tp).tp_parser(pp)) == _rules(JaxAutoTP(tp).tp_parser(jp))
    want = np.asarray(jm.apply(jp, np.asarray(ids, np.int32), **apply_kw))
    tkw = {k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in apply_kw.items() if k == "token_type_ids"}
    tkw.update({k: v for k, v in apply_kw.items() if k != "token_type_ids"})
    got = pm.apply(pp, torch.from_numpy(np.asarray(ids, np.int64)), **tkw).numpy()
    assert _rel(got, want) <= JAX_TOL, _rel(got, want)
    np.testing.assert_allclose(got, hm.hf_logits(tm, ids, **hf_kw), **(hf_tol or HF_TOL))
    return pm, pp


ARCHS = ["opt", "gpt_neox", "gpt_neox_sequential", "gptj", "falcon", "phi", "bloom", "qwen2", "mistral_window",
         "falcon40", "gpt_bigcode_mq", "gpt_bigcode_mha", "gemma", "stablelm", "stablelm_qkv_bias", "phi3",
         "olmo_clip_qkv", "olmo", "qwen3", "bert", "gpt_neo", "gpt_neo_global", "distilbert", "qwen2_suffix_window",
         "llama_attention_bias"]


def _v2_prefill(pm, pp, ids):
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig

    eng = InferenceEngineV2(pm, pp, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(kv_block_size=8, max_context=64, num_kv_blocks=32), dtype="float32",
        device="cpu"))
    return np.asarray(eng.put([0], [list(map(int, ids[0]))])[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_family_loads_like_jax(tmp_path, arch):
    tm = hm.build(arch)
    ids = np.random.RandomState(0).randint(0, 128, size=(1, 16)) if arch == "mistral_window" else hm.IDS
    pm, pp = _check(hm.save(tm, tmp_path), tm, ids)
    cfg = pm.cfg
    if cfg.causal:
        want = pm.apply(pp, torch.from_numpy(np.asarray(ids, np.int64))).numpy()[0, -1]
        assert _rel(_v2_prefill(pm, pp, ids), want) <= JAX_TOL
    if arch.startswith("gpt_bigcode"):
        assert cfg.kv_heads == (1 if arch.endswith("_mq") else 4) and cfg.pos_emb == "learned"
    if arch == "falcon40":
        assert cfg.block_type == "parallel" and cfg.kv_heads == 2
    if arch == "gemma":
        assert cfg.head_dim == 32 and cfg.rms_offset and cfg.embed_scale and cfg.activation == "geglu"
    if arch in ("bert", "distilbert"):
        assert not cfg.causal and cfg.norm_scheme == "post" and cfg.mlm_head
        assert cfg.type_vocab_size == (2 if arch == "bert" else 0)
    if arch == "olmo":
        assert not any("Norm" in k for k in _flat(pp))
    if arch == "qwen2_suffix_window":
        assert cfg.sliding_window == 4 and cfg.window_layers == (1, 2)
    if arch == "llama_attention_bias":
        assert cfg.use_qkv_bias and cfg.use_attn_out_bias and "bias" in pp["layer_0"]["attn"]["o_proj"]


@pytest.mark.parametrize("name,ids,tol", [("llama", hm.LLAMA_IDS, 2e-4), ("gpt2", hm.GPT2_IDS, 2e-4)])
def test_interop_checkpoints_load_like_jax(tmp_path, name, ids, tol):
    """test_hf_interop.py's two checkpoints (its tolerance 2e-4)."""
    tm = hm.build(name)
    _check(hm.save(tm, tmp_path), tm, ids, hf_tol=dict(rtol=tol, atol=tol))


def test_torch_bin_checkpoint_loads_like_jax(tmp_path):
    tm = hm.build("gpt2")
    d = hm.save(tm, tmp_path, safe=False)
    assert (tmp_path / "pytorch_model.bin").exists()
    _check(d, tm, hm.GPT2_IDS, hf_tol=dict(rtol=2e-4, atol=2e-4))


@pytest.mark.parametrize("scaling", hm.ROPE_SCALINGS, ids=lambda s: "-".join(f"{v}" for v in s.values()))
def test_rope_scaling_loads_like_jax(tmp_path, scaling):
    tm = hm.build_rope(scaling)
    pm, _ = _check(hm.save(tm, tmp_path), tm, hm.IDS)
    assert pm.cfg.rope_scaling == scaling["rope_type"] and pm.cfg.rope_factor == scaling["factor"]


def test_bert_token_type_ids(tmp_path):
    tm = hm.build("bert", seed=12)
    tti = np.array([[0, 0, 0, 0, 0, 1, 1, 1, 1, 1]], dtype=np.int32)
    pm, pp = _check(hm.save(tm, tmp_path), tm, hm.IDS, apply_kw={"token_type_ids": tti},
                    hf_kw={"token_type_ids": torch.from_numpy(tti.astype(np.int64))})
    got0 = pm.apply(pp, torch.from_numpy(hm.IDS.astype(np.int64))).numpy()
    got1 = pm.apply(pp, torch.from_numpy(hm.IDS.astype(np.int64)), token_type_ids=torch.from_numpy(tti)).numpy()
    assert np.abs(got1 - got0).max() > 1e-3  # type-1 segments change the output


def test_mixtral_loads_like_jax(tmp_path):
    tm = hm.build("mixtral", seed=12)
    ids = np.random.RandomState(0).randint(0, 128, size=(1, 32))
    pm, _ = _check(hm.save(tm, tmp_path), tm, ids, apply_kw={"train": False})
    assert pm.cfg.moe_num_experts == 4 and pm.cfg.moe_top_k == 2


@pytest.mark.parametrize("model_type", ["internlm", ""])
def test_llama_layout_model_types(tmp_path, model_type):
    """internlm (config.bias: q/k/v and o biases) and an empty model_type share
    the llama converter; the oracle is the llama checkpoint they are written from."""
    tm = hm.build("llama_attention_bias")
    d = hm.save(tm, tmp_path)
    cfg = json.loads((tmp_path / "config.json").read_text())
    cfg["model_type"] = model_type
    cfg["bias"] = True
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    pm, _ = _check(d, tm, hm.IDS)
    if model_type == "internlm":
        assert pm.cfg.use_qkv_bias and pm.cfg.use_attn_out_bias


REFUSED = [
    ({"model_type": "llama", "rope_scaling": {"rope_type": "longrope", "factor": 4.0, "short_factor": [1.0],
                                              "long_factor": [2.0]}}, "longrope"),
    ({"model_type": "opt", "word_embed_proj_dim": 16}, "word_embed_proj_dim"),
    ({"model_type": "opt", "do_layer_norm_before": False}, "do_layer_norm_before"),
    ({"model_type": "falcon", "multi_query": False}, "multi_query"),
    ({"model_type": "falcon", "parallel_attn": False}, "parallel_attn"),
    ({"model_type": "stablelm", "qk_layernorm": True}, "qk_layernorm"),
    ({"model_type": "stablelm", "use_parallel_residual": True}, "use_parallel_residual"),
    ({"model_type": "distilbert", "sinusoidal_pos_embds": True}, "sinusoidal"),
    ({"model_type": "gpt2", "rope_scaling": {"rope_type": "linear", "factor": 2.0}}, "non-rope"),
    ({"model_type": "t5"}, "not supported"),
]


@pytest.mark.parametrize("hf,match", REFUSED, ids=[m for _, m in REFUSED])
def test_config_from_hf_refuses_as_jax_does(hf, match):
    hf = {"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2, **hf}
    with pytest.raises(NotImplementedError, match=match):
        jax_config_from_hf(hf)
    with pytest.raises(NotImplementedError, match=match):
        config_from_hf(hf)


def test_safetensors_reader_matches_the_package(tmp_path):
    """bf16 tensors written by save_pretrained, then a sharded index."""
    tm = hm.build("llama").to(torch.bfloat16)
    d = hm.save(tm, tmp_path / "one")
    want = safetensors_torch.load_file(str(tmp_path / "one" / "model.safetensors"))
    got = read_safetensors(str(tmp_path / "one" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.bfloat16 and torch.equal(got[k], want[k]), k
    tm.save_pretrained(tmp_path / "sharded", safe_serialization=True, max_shard_size="60KB")
    index = json.loads((tmp_path / "sharded" / "model.safetensors.index.json").read_text())
    shards = sorted(set(index["weight_map"].values()))
    assert len(shards) > 1
    want = {}
    for shard in shards:
        want.update(safetensors_torch.load_file(str(tmp_path / "sharded" / shard)))
    got = load_hf_state_dict(str(tmp_path / "sharded"))
    assert sorted(got) == sorted(want) == sorted(load_hf_state_dict(d))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the bf16 checkpoint loads into fp32 leaves, each the exact widening of its bf16 value
    _, params = load_hf_checkpoint(str(tmp_path / "sharded"), device="cpu")
    assert torch.equal(params["layer_1"]["mlp"]["up_proj"]["kernel"],
                       want["model.layers.1.mlp.up_proj.weight"].float().t())


def test_live_model_loads_like_its_checkpoint(tmp_path):
    """load_hf_model reads config.to_dict() and state_dict() alone: the same
    config and leaves as the saved directory."""
    tm = hm.build("gpt2")
    d = hm.save(tm, tmp_path)
    m1, p1 = load_hf_model(tm, device="cpu")
    m2, p2 = load_hf_checkpoint(d, device="cpu")
    assert _fields(m1.cfg) == _fields(m2.cfg)
    f1, f2 = _flat(p1), _flat(p2)
    assert sorted(f1) == sorted(f2) and all(torch.equal(f1[k], f2[k]) for k in f1)


def test_loader_casts_and_shards(tmp_path):
    """dtype casts every leaf; tp_size keeps rank r's slice of each split leaf."""
    tm = hm.build("llama")
    d = hm.save(tm, tmp_path)
    _, whole = load_hf_checkpoint(d, device="cpu")
    m, half = load_hf_checkpoint(d, dtype=torch.bfloat16, device="cpu")
    assert m.cfg.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in _flat(half).values())
    for rank in (0, 1):
        _, part = load_hf_checkpoint(d, device="cpu", tp_size=2, rank=rank)
        q = whole["layer_0"]["attn"]["q_proj"]["kernel"]
        assert torch.equal(part["layer_0"]["attn"]["q_proj"]["kernel"], q[:, 2 * rank:2 * rank + 2])
        down = whole["layer_1"]["mlp"]["down_proj"]["kernel"]
        assert torch.equal(part["layer_1"]["mlp"]["down_proj"]["kernel"], down[48 * rank:48 * (rank + 1)])
        assert torch.equal(part["wte"], whole["wte"][128 * rank:128 * (rank + 1)])
        assert torch.equal(part["RMSNorm_0"]["scale"], whole["RMSNorm_0"]["scale"])


def test_cpu_load_owns_its_leaves(tmp_path):
    """A CPU load at the stored dtype keeps no view of the file's mapping or of
    a live model's tensors: rewriting the file in place, or zeroing the model,
    leaves the loaded tree as it was."""
    tm = hm.build("gpt2")
    d = hm.save(tm, tmp_path)
    _, from_file = load_hf_checkpoint(d, device="cpu")
    _, from_model = load_hf_model(tm, device="cpu")
    want = {k: v.clone() for k, v in _flat(from_file).items()}
    path = tmp_path / "model.safetensors"
    with open(path, "r+b") as f:
        n = int.from_bytes(f.read(8), "little")
        f.seek(8 + n)
        f.write(bytes(path.stat().st_size - 8 - n))
    with torch.no_grad():
        for p in tm.parameters():
            p.zero_()
    for tree in (from_file, from_model):
        got = _flat(tree)
        assert all(torch.equal(got[k], want[k]) for k in want)
