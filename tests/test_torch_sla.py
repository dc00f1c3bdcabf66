"""Port parity: the serving SLA harness (``inference/v2/sla.py``).

After ``tests/unit/test_serve_sla.py``: ``run_load`` drives the port's engine
(fp32, on the CPU) through the fused loop and the unfused one, and its tokens
equal batch ``generate``'s and the JAX engine's on the same weights and
prompts, with bursts too; the timestamps are ordered; the KV pool drains;
``summarize`` and ``effective_throughput_at_sla`` equal the JAX functions'
output exactly on the same ``RequestStat`` lists; ``sweep`` has one row per
rate.
"""

import dataclasses

import jax
import numpy as np
import pytest

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2 import sla as jax_sla
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2 import sla
from deepspeed_tpu_torch.models import TransformerConfig, params_from_numpy

TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=256, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
SMC = dict(kv_block_size=8, max_context=256, num_kv_blocks=128)


@pytest.fixture(scope="module")
def tiny():
    model = CausalLM(JaxConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def engine(burst=0, fused=True):
        return InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(**SMC), dtype="float32", device="cpu", decode_burst=burst,
            fused_step=fused))

    def jax_generate(prompts, max_new_tokens):
        je = JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(**SMC), dtype="float32",
                                                      decode_burst=8))
        return je.generate(prompts, max_new_tokens=max_new_tokens)

    return engine, jax_generate


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("burst", [0, 8])
def test_run_load_tokens_match_generate(tiny, fused, burst):
    """Open-loop scheduling does not change greedy tokens: every request's
    tokens equal batch generate's, on the port and on the JAX engine."""
    engine, jax_generate = tiny
    spec = sla.LoadSpec(n_requests=6, arrival_rate=300.0, prompt_len_range=(4, 10), max_new_tokens=12,
                        vocab_size=128, seed=3, shared_prefix_len=8)
    stats = sla.run_load(engine(burst, fused), spec)
    _, prompts = sla.load_prompts(spec)
    assert [s.prompt_len for s in stats] == [len(p) for p in prompts]
    ref = engine().generate(prompts, max_new_tokens=12)
    assert [s.tokens for s in stats] == ref == jax_generate(prompts, 12)


def test_load_prompts_are_the_reference_draws():
    spec = sla.LoadSpec(n_requests=5, arrival_rate=7.0, prompt_len_range=(3, 9), vocab_size=50, seed=4,
                        shared_prefix_len=3)
    rng = np.random.default_rng(spec.seed)  # the draws of the JAX run_load, in its order
    arrivals = np.cumsum(rng.exponential(1.0 / spec.arrival_rate, spec.n_requests))
    lens = rng.integers(3, 10, spec.n_requests)
    shared = rng.integers(0, 50, size=3).tolist()
    prompts = [shared + rng.integers(0, 50, size=int(n)).tolist() for n in lens]
    got_arrivals, got_prompts = sla.load_prompts(spec)
    assert got_arrivals.tolist() == arrivals.tolist() and got_prompts == prompts
    saturated, _ = sla.load_prompts(dataclasses.replace(spec, arrival_rate=float("inf")))
    assert saturated.tolist() == [0.0] * 5


@pytest.mark.parametrize("fused", [True, False])
def test_timestamps_ordered_and_pool_drains(tiny, fused):
    engine, _ = tiny
    eng = engine(burst=8, fused=fused)
    free0 = eng.state.free_blocks
    spec = sla.LoadSpec(n_requests=5, arrival_rate=50.0, prompt_len_range=(4, 8), max_new_tokens=4,
                        vocab_size=128, seed=1)
    stats = sla.run_load(eng, spec)
    for s in stats:
        assert s.admitted >= s.arrival
        assert s.first_token >= s.admitted
        assert s.done >= s.first_token
        assert s.n_new == spec.max_new_tokens
        assert s.ttft > 0.0 and s.tpot >= 0.0
    # full-block prompts stay cached for prefix reuse; the pool drains once the cache lets go
    cached = eng.state.prefix_cache.cached_blocks if eng.state.prefix_cache else 0
    assert eng.state.free_blocks + cached == free0
    eng.state.reset_prefix_cache()
    assert eng.state.free_blocks == free0


def _stats(mod, rows):
    return [mod.RequestStat(uid=i, prompt_len=8, arrival=a, admitted=a, first_token=a + ttft,
                            done=a + ttft + tpot * (n - 1), n_new=n) for i, (a, ttft, tpot, n) in enumerate(rows)]


SUMMARY_CASES = [
    [(0.0, 0.1, 0.01, 8), (0.5, 2.0, 0.01, 8), (1.0, 0.2, 0.50, 8), (1.5, 0.3, 0.02, 8)],  # TTFT, TPOT misses
    [(0.0, 0.5, 0.5, 8), (0.0, 0.5, 0.5, 8)],  # span-based throughput
    [(0.0, 0.05, 0.0, 1), (0.2, 1.5, 0.3, 3), (0.25, 0.013, 0.0271, 32)],  # one-token requests have no TPOT
    [(float(a), float(t), float(p), int(n)) for a, t, p, n in zip(
        np.cumsum(np.random.default_rng(0).exponential(0.3, 24)), np.random.default_rng(1).uniform(0, 3, 24),
        np.random.default_rng(2).uniform(0, 0.4, 24), np.random.default_rng(3).integers(1, 40, 24))],
]


@pytest.mark.parametrize("case", range(len(SUMMARY_CASES)))
@pytest.mark.parametrize("slas", [(1.0, 0.25), (0.5, 0.1)])
def test_summarize_equals_the_reference(case, slas):
    rows = SUMMARY_CASES[case]
    got = sla.summarize(_stats(sla, rows), *slas)
    assert got == jax_sla.summarize(_stats(jax_sla, rows), *slas)
    assert [s.ttft for s in _stats(sla, rows)] == [s.ttft for s in _stats(jax_sla, rows)]
    assert [s.tpot for s in _stats(sla, rows)] == [s.tpot for s in _stats(jax_sla, rows)]


def test_effective_throughput_equals_the_reference():
    tables = [
        [{"tokens_per_sec": 100.0, "sla_miss_frac": 0.0}, {"tokens_per_sec": 180.0, "sla_miss_frac": 0.01},
         {"tokens_per_sec": 250.0, "sla_miss_frac": 0.30}],
        [{"tokens_per_sec": 250.0, "sla_miss_frac": 0.30}],
        [jax_sla.summarize(_stats(jax_sla, rows)) for rows in SUMMARY_CASES],
    ]
    for rows in tables:
        for max_miss in (0.0, 0.01, 0.5):
            assert sla.effective_throughput_at_sla(rows, max_miss) == \
                jax_sla.effective_throughput_at_sla(rows, max_miss)
    assert sla.effective_throughput_at_sla(tables[0]) == 180.0
    assert sla.TTFT_BUCKETS == jax_sla.TTFT_BUCKETS and sla.TPOT_BUCKETS == jax_sla.TPOT_BUCKETS


def test_sweep_shape(tiny):
    engine, _ = tiny
    base = sla.LoadSpec(n_requests=3, prompt_len_range=(4, 6), max_new_tokens=3, vocab_size=128, seed=9)
    rows = sla.sweep(engine(), rates=[50.0, 200.0], base=base)
    assert [r["arrival_rate"] for r in rows] == [50.0, 200.0]
    for r in rows:
        # the reference's columns, with the perf accountant's (DS_TPU_PERF_ACCOUNT defaults to 1): model FLOPs
        # attributed in the row's window, MFU over it (None without a known peak, as on the CPU), goodput
        assert set(r) == {"n_requests", "tokens_per_sec", "requests_per_sec", "ttft_p50_s", "ttft_p95_s",
                          "ttft_p99_s", "tpot_p50_s", "tpot_p95_s", "sla_miss_frac", "arrival_rate",
                          "model_flops", "mfu", "goodput_fraction"}
        assert r["n_requests"] == 3
        assert r["model_flops"] > 0 and r["mfu"] is None and 0.0 < r["goodput_fraction"] <= 1.0
