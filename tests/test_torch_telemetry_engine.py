"""Port parity: telemetry on the serving and training paths.

After ``tests/unit/test_request_trace.py``, ``test_perf_accounting.py``
(the engine parts), ``test_ops_plane.py`` and ``test_telemetry.py``
(``test_engine_train_step_telemetry``), on the CPU in fp32:
- the JAX ``InferenceEngineV2`` and the port's, on one workload (a
  ``generate`` call, then an SLA arrival trace with a shared system prompt,
  every prefix evicted to the host tier, the trace again), speculative
  decoding and the host spill tier on, int8 KV pages off and on, in both
  serving loops: the same tokens, the same span-name sequence with the same
  attributes (rows, tokens, steps, bucket, k, uid, prompt), the same
  accountant counters (useful and slot tokens, prefix-hit and re-admitted
  tokens, spec proposed and accepted, COW bytes), the same residency
  section and the same registry metric names (each package's singletons
  made anew for the case; the names only the reference has by design are
  listed in ``REFERENCE_ONLY``); on an int8 pool the same dequant error;
- FLOPs from shapes: each step's card equals ``FlopCounterMode``'s count of
  the same products on the plain CPU step (attention stubbed out:
  ``attention_macs`` is held to a brute-force count of visible pairs
  instead), for a dense GQA config, a GPT-2-shaped one and an MoE one, both
  loops, speculative decoding on; a training micro-batch's products likewise;
- training: the port's ``DeepSpeedEngine`` and the JAX engine over 3 tiny
  steps set the same ``train_*`` metrics and flush the same events into a
  CSV monitor.
No test bounds a wall-clock time.
"""

import csv
import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
import deepspeed_tpu
import deepspeed_tpu.telemetry as jt
import deepspeed_tpu_torch
import deepspeed_tpu_torch.telemetry as tt
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2 import sla as jax_sla
from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import gpt2_tiny as jax_gpt2_tiny
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime.config import MeshConfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig, sla
from deepspeed_tpu_torch.inference.v2.model_runner import make_step_fns
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig, gpt2_tiny, init_params, params_from_numpy
from deepspeed_tpu_torch.runtime.engine import train_flops
from deepspeed_tpu_torch.telemetry.costs import attention_macs, forward_macs

TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=256, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
LOAD = dict(n_requests=6, arrival_rate=float("inf"), prompt_len_range=(4, 20), max_new_tokens=12, vocab_size=128,
            seed=0, shared_prefix_len=24)
# metric families only the reference registers, by design: its comm facade's counters (the port's comm facade
# counts nothing); health_alerts_total depends on wall time (the SLO-burn detector reads each request's TTFT
# against 1 s), so neither side's is compared
REFERENCE_ONLY = ("comm_bytes_total", "comm_ops_total")
TIMED = ("health_alerts_total",)
LEDGER_COUNTS = ("useful_tokens", "slot_tokens", "goodput_fraction", "spec_proposed_tokens", "spec_accepted_tokens",
                 "spec_rejected_tokens", "prefix_hit_tokens", "readmit_tokens", "cow_copy_bytes")
SINGLETONS = ("registry._REGISTRY", "tracing._TRACER", "events._EVENT_LOG", "health._MONITOR", "costs._ACCOUNTANT",
              "flight._RECORDER", "profiler._PROFILER")


def _fresh(monkeypatch):
    """Each package's telemetry singletons made anew (restored after the test)."""
    import importlib

    for pkg in ("deepspeed_tpu.telemetry", "deepspeed_tpu_torch.telemetry"):
        for path in SINGLETONS:
            mod, name = path.split(".")
            monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod}"), name, None)


@pytest.fixture(scope="module")
def tiny():
    model = JaxCausalLM(JaxConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def engines(fused, kvq):
        kw = dict(dtype="float32", fused_step=fused, enable_prefix_cache=True, kv_spill=True, spec_decode=True,
                  spec_k=3, kv_quant_bits=kvq)
        smc = dict(kv_block_size=8, max_context=256, num_kv_blocks=64)
        return (JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(**smc), **kw)),
                InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
                    state_manager=RaggedBatchConfig(**smc), device="cpu", **kw)))

    return engines


def _serve(engine, sla_mod, tel):
    """The workload, its tokens, spans, ledger counters and metric names."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 128, 16).tolist()
    out = [engine.generate([shared + rng.integers(0, 128, n).tolist() for n in (3, 9)], max_new_tokens=6)]
    for i in range(2):
        if i:
            engine.state.prefix_cache.evict(engine.state.total_blocks)  # the shared prompt leaves for the host tier
        out.append([s.tokens for s in sla_mod.run_load(engine, sla_mod.LoadSpec(**LOAD))])
    acct = tel.get_perf_accountant()
    ledger = acct.ledger()
    names = {n.split(".")[0] for n, _ in tel.get_registry().series()}
    return (out, [(s["name"], s["attrs"]) for s in tel.get_tracer().spans()], {k: ledger[k] for k in LEDGER_COUNTS},
            engine._residency_summary(), names, tel.get_registry().peek("kv_quant_dequant_error"))


@pytest.mark.parametrize("kvq", [0, 8])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_serving_telemetry_matches_reference(tiny, fused, kvq, monkeypatch):
    monkeypatch.setenv("DS_TPU_KV_HOST_POOL_MB", "1")
    _fresh(monkeypatch)
    je, te = tiny(fused, kvq)
    want = _serve(je, jax_sla, jt)
    got = _serve(te, sla, tt)
    assert got[0] == want[0]  # tokens
    assert got[1] == want[1]  # spans, in order, with their attributes
    names = {n for n, _ in got[1]}
    assert {"infer/prefix_match", "infer/spec_verify", "infer/fused_step" if fused else "infer/prefill"} <= names
    assert got[2] == want[2]  # accountant counters
    assert got[2]["readmit_tokens"] > 0 and got[2]["spec_proposed_tokens"] > 0 and got[2]["prefix_hit_tokens"] > 0
    assert got[2]["cow_copy_bytes"] > 0
    assert got[3] == want[3]  # residency
    assert got[4] - set(TIMED) == want[4] - set(REFERENCE_ONLY + TIMED)
    if kvq:
        assert got[5] == pytest.approx(want[5], rel=1e-6) and got[5] > 0
    # every step attributed: the cards' timed calls are the steps the engine ran
    cards = tt.get_perf_accountant().cards().values()
    assert sum(c.timed_calls for c in cards) == te.dispatches
    assert {c.program for c in cards} >= {"spec", "cow_copy", "kv_readmit", "kv_spill_gather"}


def test_engine_hooks_health_flight_and_hbm(tiny, tmp_path, monkeypatch):
    """Engine construction wires the detectors, the flight recorder's
    residency provider and the HBM gauges (a CPU engine: no limit, no
    pressure); the serving loop polls the health monitor."""
    _fresh(monkeypatch)
    monkeypatch.setenv("DS_TPU_FLIGHT_DIR", str(tmp_path))
    _, te = tiny(True, 0)
    hm = tt.get_health_monitor()
    assert {"queue_stall", "slo_burn", "hbm_pressure"} <= set(hm._detectors)
    polls = []
    monkeypatch.setattr(hm, "poll", lambda now=None: polls.append(now))
    te.generate([[1, 2, 3, 4]], max_new_tokens=4)
    assert polls
    cap = tt.get_flight_recorder().capture("unit")
    manifest = tt.get_flight_recorder().read_manifest(os.path.basename(cap))
    assert manifest["residency"] == te._residency_summary() and manifest["jit_cache"] == {"enabled": False}
    hbm = tt.get_perf_accountant().hbm()
    assert hbm["pressure"] == 0.0 and "limit" not in hbm
    assert hbm["weights"] == sum(t.numel() * t.element_size() for t in _leaves(te.params))
    assert hbm["kv_pages"] == sum(t.numel() * t.element_size() for t in te._pool_leaves())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------- FLOPs from shapes
def _zeros_attention(q, *args, **kwargs):
    return torch.zeros_like(q)


FLOP_CONFIGS = {
    "llama_gqa": TINY,
    "gpt2": dict(vocab_size=128, n_layers=2, n_heads=4, d_model=32, max_seq_len=256),
    "moe": dict(TINY, moe_num_experts=4, moe_top_k=2, moe_layer_freq=2),
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("name", sorted(FLOP_CONFIGS))
def test_step_flops_equal_the_flop_counter(name, fused, monkeypatch):
    """Every step's card: its FLOPs equal FlopCounterMode's count of the plain
    CPU step with attention stubbed, and its attention FLOPs the visible
    pairs counted one by one."""
    _fresh(monkeypatch)
    cfg = TransformerConfig(**FLOP_CONFIGS[name])
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    engine = InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
        state_manager=RaggedBatchConfig(kv_block_size=8, max_context=256, num_kv_blocks=96), device="cpu",
        dtype="float32", fused_step=fused, spec_decode=True, spec_k=3, decode_burst=4))
    engine._mods = engine._mods._replace(decode_attn=_zeros_attention, prefill_attn=_zeros_attention)
    engine._prefill_fn, engine._decode_fn = make_step_fns(engine._run_cfg, mods=engine._mods)
    counted, pairs = {}, {}
    run = engine._run_step

    def counting(key, step, arrays, rows, sampled, head):
        with FlopCounterMode(display=False) as fc:
            out = run(key, step, arrays, rows, sampled, head)
        counted.setdefault(key, set()).add(fc.get_total_flops())
        pairs.setdefault(key, []).append(_visible_pairs(cfg, *rows))
        return out

    engine._run_step = counting
    engine._drafter = types.SimpleNamespace(propose=lambda hist, cap: [1, 2, 3][:cap])  # every decode row drafts
    rng = np.random.default_rng(0)
    motif = rng.integers(0, cfg.vocab_size, 6).tolist()
    prompts = [motif * 3 + rng.integers(0, cfg.vocab_size, n).tolist() for n in (2, 11, 30, 5)]
    engine.generate(prompts, max_new_tokens=10)
    engine._drafter = types.SimpleNamespace(propose=lambda hist, cap: [])  # no drafts: plain steps and bursts
    engine.generate(prompts[:2], max_new_tokens=10, eos_token_id=cfg.vocab_size - 1)
    kinds = set()
    acct = tt.get_perf_accountant()
    for card in acct.cards().values():
        if card.program not in ("prefill", "decode", "burst", "fused", "spec"):
            continue  # the untimed copies: bytes only
        key = eval(card.signature)[:-len(engine._cost_sig)]  # the graph key
        kinds.add(key[0])
        assert counted[key] == {card.flops}, key
        assert card.attn_flops == sum(2 * 2 * cfg.n_heads * cfg.head_dim * p for p in pairs[key]), key
    assert kinds >= ({"fused", "spec"} if fused else {"prefill", "decode", "burst", "spec"})


def _visible_pairs(cfg, q_lens, ctx_end):
    """(query, key) pairs the rows' queries see, counted one by one, summed
    over layers (each with its own window)."""
    total = 0
    for layer in range(cfg.n_layers):
        w = cfg.window_for(layer)
        for q, end in zip(q_lens, ctx_end):
            for pos in range(int(end) - int(q), int(end)):
                total += pos + 1 if w is None else min(pos + 1, w)
    return total


def test_attention_macs_counts_visible_pairs():
    rng = np.random.default_rng(0)
    for window, layers in ((None, None), (5, None), (7, (1,))):
        cfg = TransformerConfig(**dict(TINY, sliding_window=window, window_layers=layers))
        q = rng.integers(1, 9, 12)
        end = q + rng.integers(0, 30, 12)
        assert attention_macs(cfg, q, end) == 2 * cfg.n_heads * cfg.head_dim * _visible_pairs(cfg, q, end)


def test_training_flops_equal_the_flop_counter(monkeypatch):
    """A training micro-batch's products (forward and backward, attention
    stubbed) against FlopCounterMode on the plain CPU step; the fused CE
    recomputes the head's logits in its backward, one product more than the
    model FLOPs count."""
    import deepspeed_tpu_torch.ops.attention as attn_mod

    monkeypatch.setattr(attn_mod, "attention", lambda q, k, v, **kw: q + (k.sum() + v.sum()) * 0)
    for cfg in (dataclasses.replace(gpt2_tiny(), vocab_size=96), TransformerConfig(**TINY)):
        params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params, config={
            "train_micro_batch_size_per_gpu": 2, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}},
            device="cpu")
        B, S = 2, 24
        batch = {"input_ids": np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int64)}
        with FlopCounterMode(display=False) as fc:
            engine.backward(engine.forward(batch))
        attn = 3 * 2 * attention_macs(cfg, [S] * B, [S] * B)
        recompute = 2 * B * S * cfg.d_model * cfg.vocab_size
        assert fc.get_total_flops() == train_flops(cfg, B, S) - attn + recompute
        assert train_flops(cfg, B, S) == 3 * 2 * (forward_macs(cfg, B * S, B * S) + attention_macs(cfg, [S] * B,
                                                                                                 [S] * B))


# ---------------------------------------------------------------- training
V = 512
TRAIN_SERIES = ("Train_Samples_lr", "Telemetry_train_steps_total", "Telemetry_train_microbatches_total",
                "Telemetry_train_samples_total", "Telemetry_train_tokens_total", "Telemetry_train_lr",
                "Telemetry_train_loss_scale", "Telemetry_train_overflow_steps_total")


def _train_config(out_dir):
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2, "steps_per_print": 2,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                                                         "warmup_num_steps": 3, "warmup_type": "linear"}},
            "gradient_clipping": 0.5, "csv_monitor": {"enabled": True, "output_path": str(out_dir),
                                                      "job_name": "job"}}


def _csv(root):
    return {f[:-4]: list(csv.reader(open(os.path.join(root, f)))) for f in sorted(os.listdir(root))}


def test_training_telemetry_matches_reference(tmp_path, monkeypatch):
    _fresh(monkeypatch)
    model = JaxCausalLM(dataclasses.replace(jax_gpt2_tiny(), vocab_size=V))
    jparams = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)}))
    rng = np.random.default_rng(0)
    batches = [{"input_ids": rng.integers(0, V, (2, 32)).astype(np.int32)} for _ in range(6)]
    mesh = MeshTopology(MeshConfig.from_dict({"data": 1}), devices=jax.devices()[:1])
    jeng, _, _, _ = deepspeed_tpu.initialize(model=model, model_parameters=jparams,
                                             config=_train_config(tmp_path / "jax"), mesh=mesh)
    cfg = dataclasses.replace(gpt2_tiny(), vocab_size=V)
    teng, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), model_parameters=params_from_numpy(
        jparams, "cpu", cfg=cfg), config=_train_config(tmp_path / "torch"), device="cpu")
    spans = []
    for eng, tel in ((jeng, jt), (teng, tt)):
        it = iter(batches)
        for _ in range(3):
            eng.train_batch(it)
        spans.append([s["name"] for s in tel.get_tracer().spans() if s["name"].startswith("train/")])
    assert spans[1] == spans[0] and spans[1].count("train/step") == 3
    want, got = ({n: v for n, v in tel.get_registry().series() if n.startswith("train_")} for tel in (jt, tt))
    assert set(got) == set(want)
    exact = ("train_steps_total", "train_microbatches_total", "train_samples_total", "train_tokens_total",
             "train_overflow_steps_total", "train_lr", "train_loss_scale")
    assert {n: got[n] for n in exact} == {n: want[n] for n in exact}
    assert got["train_loss"] == pytest.approx(want["train_loss"], abs=2e-5)
    assert got["train_grad_norm"] == pytest.approx(want["train_grad_norm"], rel=1e-5)
    assert got["train_steps_total"] == 3 and got["train_tokens_total"] == 6 * 2 * 32
    jcsv, tcsv = _csv(tmp_path / "jax" / "job"), _csv(tmp_path / "torch" / "job")
    assert set(TRAIN_SERIES) <= set(tcsv)
    for name in TRAIN_SERIES:
        assert tcsv[name] == jcsv[name], name
    loss = [[float(v) for v in row] for row in tcsv["Train_Samples_train_loss"][1:]]
    want_loss = [[float(v) for v in row] for row in jcsv["Train_Samples_train_loss"][1:]]
    np.testing.assert_allclose(loss, want_loss, atol=2e-5)
    # one writer a series: the port's CSV files are the reference's, less its comm and TP series
    assert {n for n in set(jcsv) - set(tcsv) if not n.startswith(("Telemetry_comm_", "Telemetry_tp_"))} == set()
