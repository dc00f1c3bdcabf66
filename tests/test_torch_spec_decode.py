"""Port parity: speculative decoding on the v2 engine against the JAX package.

Mirrors ``tests/unit/test_spec_decode.py``. The JAX package initialises its
tiny GQA llama (vocab 128, 2 layers, 4/2 heads, d 32) from seed 0; the port
takes the same weights through ``params_from_numpy`` and serves on the CPU
in fp32, where every kernel wrapper runs its plain version. All checks are
exact:
- the drafters propose what the JAX drafters propose;
- ``select_committed`` in greedy mode gives the JAX function's committed ids
  and accepted counts on the same logits; sampled mode, drawn from a
  ``torch.Generator``, preserves the target distribution over 4,096 draws
  (``atol`` 0.03, as the JAX test), also on int8-grid logits;
- ``rollback_tokens`` passes the JAX rollback cases and property test;
- the engine: greedy tokens with speculation on equal the port's tokens with
  it off and the JAX engine's with it on, in the fused and the unfused loop;
  ``top_k=1`` sampling, an EOS inside a verify window (every block
  returned), streaming, a null and a wrong drafter (same dispatches as
  plain decode), the budget clamp, ``sla.run_load``, int8 KV pools, and the
  acceptance and tokens per decode step on a repetitive workload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2.spec import PromptLookupDrafter as JaxPromptLookupDrafter
from deepspeed_tpu.inference.v2.spec import select_committed as jax_select_committed
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2, NullDrafter, PromptLookupDrafter, RaggedBatchConfig,
                                              RaggedInferenceEngineConfig, make_drafter, select_committed)
from deepspeed_tpu_torch.inference.v2.ragged.manager import DSStateManager
from deepspeed_tpu_torch.models import TransformerConfig, params_from_numpy
from deepspeed_tpu_torch.ops.paged_attention import dequantize_kv, quantize_kv

TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=256, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
# repetitive-motif prompts (prompt lookup's case) beside arbitrary ones (acceptance about 0 there)
PROMPTS = [[5, 9, 13] * 3, [7] * 6, [100, 2, 55, 44, 33, 22, 11], [3, 17, 42, 3, 17, 42]]


@pytest.fixture(scope="module")
def spec_setup():
    model = CausalLM(JaxConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def engine(spec, fused=True, drafter="prompt_lookup", k=4, burst=8, blocks=192, **kw):
        smc = RaggedBatchConfig(kv_block_size=8, max_context=256, num_kv_blocks=blocks)
        return InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
            state_manager=smc, dtype="float32", device="cpu", fused_step=fused, decode_burst=burst, spec_decode=spec,
            spec_k=k, spec_drafter=drafter, **kw))

    def jax_engine(spec, fused=True, k=4, burst=8, blocks=192, **kw):
        smc = JaxBatchConfig(kv_block_size=8, max_context=256, num_kv_blocks=blocks)
        return JaxEngine(model, params, JaxEngineConfig(state_manager=smc, dtype="float32", fused_step=fused,
                                                        decode_burst=burst, spec_decode=spec, spec_k=k, **kw))

    return engine, jax_engine


# ---------------------------------------------------------------- drafters
class TestDrafter:

    def test_cycle_continuation(self):
        assert PromptLookupDrafter().propose([5, 6, 7, 5, 6, 7, 5, 6, 7], 4) == [5, 6, 7, 5]

    def test_overlapping_copy_extends_short_cycle(self):
        assert PromptLookupDrafter().propose([1, 2, 33, 33, 33, 33], 4) == [33, 33, 33, 33]

    def test_weak_match_gets_short_window(self):
        assert PromptLookupDrafter().propose([9, 1, 2, 7, 8, 1, 2], 4) == [7, 8]

    def test_no_match_no_proposal(self):
        d = PromptLookupDrafter()
        assert d.propose([1, 2, 3, 4, 5], 4) == []
        assert d.propose([1, 2, 3], 0) == []
        assert d.propose([1], 4) == []

    def test_null_drafter(self):
        assert NullDrafter().propose([1, 1, 1, 1], 4) == []

    def test_registry(self):
        assert isinstance(make_drafter("prompt_lookup"), PromptLookupDrafter)
        assert isinstance(make_drafter("ngram"), PromptLookupDrafter)
        assert isinstance(make_drafter("null"), NullDrafter)
        with pytest.raises(ValueError):
            make_drafter("medusa")
        with pytest.raises(ValueError):
            PromptLookupDrafter(max_ngram=1, min_ngram=2)


def test_prompt_lookup_matches_the_jax_drafter():
    rng = np.random.default_rng(0)
    ours, theirs = PromptLookupDrafter(), JaxPromptLookupDrafter()
    for _ in range(300):
        hist = rng.integers(0, 6, rng.integers(0, 24)).tolist()
        k = int(rng.integers(0, 6))
        assert ours.propose(hist, k) == theirs.propose(hist, k)


# ---------------------------------------------------------------- acceptance
def _peaked_logits(token_rows, V, peak=25.0):
    """(B, chunk, V) logits with a hard argmax at token_rows[b][i]."""
    out = np.zeros((len(token_rows), len(token_rows[0]), V), np.float32)
    for b, row in enumerate(token_rows):
        for i, t in enumerate(row):
            out[b, i, t] = peak
    return out


def _select(logits, drafts, n_draft, generator=None, **kw):
    committed, accepted = select_committed(torch.from_numpy(np.asarray(logits)), torch.tensor(drafts),
                                           torch.tensor(n_draft, dtype=torch.int32), generator, **kw)
    assert committed.dtype == accepted.dtype == torch.int32
    return committed.numpy(), accepted.numpy()


class TestSelectCommitted:

    def test_greedy_prefix_acceptance(self):
        logits = _peaked_logits([[4, 5, 6, 7], [8, 9, 10, 11]], V=16)
        committed, accepted = _select(logits, [[4, 5, 0], [8, 9, 10]], [3, 3])
        assert accepted.tolist() == [2, 3]
        assert committed[0, :3].tolist() == [4, 5, 6]
        assert committed[1, :4].tolist() == [8, 9, 10, 11]

    def test_padding_never_accepted(self):
        logits = _peaked_logits([[4, 4, 4, 4]], V=16)
        committed, accepted = _select(logits, [[4, 4, 4]], [0])
        assert accepted.tolist() == [0]
        assert committed[0, 0] == 4  # the plain next token still emits

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_greedy_equals_the_jax_function(self, seed):
        # random logits, drafts that follow the argmax for a random prefix and then stray, random
        # draft counts (padding included): committed ids and accepted counts equal JAX's
        rng = np.random.default_rng(seed)
        B, chunk, V = 9, 5, 24
        logits = rng.standard_normal((B, chunk, V)).astype(np.float32)
        tgt = logits.argmax(-1)
        drafts = rng.integers(0, V, (B, chunk - 1)).astype(np.int32)
        for b in range(B):
            good = int(rng.integers(0, chunk))
            drafts[b, :good] = tgt[b, :good]
        n_draft = rng.integers(0, chunk, B).astype(np.int32)
        committed, accepted = _select(logits, drafts, n_draft)
        j_committed, j_accepted = jax_select_committed(jnp.asarray(logits), jnp.asarray(drafts),
                                                       jnp.asarray(n_draft), jax.random.PRNGKey(0))
        assert accepted.tolist() == np.asarray(j_accepted).tolist()
        assert committed.tolist() == np.asarray(j_committed).tolist()
        assert (accepted <= n_draft).all() and len(set(accepted.tolist())) > 1

    def test_rejection_sampling_fixed_seed(self):
        # peaked target: p(draft) is about 1 where the drafts match the peak, about 0 where they do
        # not, so the sampled path is deterministic for any seed
        logits = _peaked_logits([[4, 5, 6, 7], [8, 9, 10, 11]], V=16, peak=40.0)
        committed, accepted = _select(logits, [[4, 5, 0], [8, 9, 10]], [3, 3], torch.Generator().manual_seed(7),
                                      do_sample=True, temperature=1.0)
        assert accepted.tolist() == [2, 3]
        assert committed[0, :3].tolist() == [4, 5, 6]
        assert committed[1, :4].tolist() == [8, 9, 10, 11]

    @pytest.mark.parametrize("grid", [False, True])
    def test_rejection_sampling_preserves_target_distribution(self, grid):
        # with a fixed, mediocre draft token, the committed first token is distributed as the
        # target softmax, not as the draft's delta: 4,096 rows in one call, each its own draws; with
        # ``grid`` the logits lie on the int8 KV quantiser's grid, as over int8 pools
        V, n = 4, 4096
        base = torch.tensor([1.0, 0.5, 0.0, -0.5])
        row = dequantize_kv(quantize_kv(base[None, None].expand(1, 2, V).contiguous()))[0] if grid else \
            base[None].expand(2, V)
        if grid:
            assert (row[0] - base).abs().max().item() > 1e-4  # the grid moved the target
        logits = row[None].expand(n, 2, V).contiguous()
        committed, _ = select_committed(logits, torch.full((n, 1), 2, dtype=torch.int32),
                                        torch.ones((n,), dtype=torch.int32), torch.Generator().manual_seed(0),
                                        do_sample=True, temperature=1.0)
        freq = np.bincount(committed[:, 0].numpy(), minlength=V) / n
        np.testing.assert_allclose(freq, torch.softmax(row[0], -1).numpy(), atol=0.03)


# ---------------------------------------------------------------- rollback
class TestRollback:

    def _manager(self, blocks=64, cache=False):
        return DSStateManager(RaggedBatchConfig(kv_block_size=8, max_context=256, num_kv_blocks=blocks),
                              num_kv_blocks=blocks, enable_prefix_cache=cache)

    def _commit(self, mgr, seq, toks):
        mgr.allocate_for(seq, len(toks))
        seq.record_tokens(toks)
        seq.pre_forward(len(toks))
        seq.post_forward()

    def test_releases_exact_tail(self):
        mgr = self._manager()
        seq = mgr.get_or_create_sequence(0)
        self._commit(mgr, seq, list(range(40)))  # 5 blocks
        free0 = mgr.free_blocks
        assert mgr.rollback_tokens(seq, 17) == 2  # 40 -> 23 seen -> 3 blocks
        assert seq.seen_tokens == 23 and len(seq.blocks) == 3
        assert mgr.free_blocks == free0 + 2
        assert mgr.spec_rollback_tokens == 17

    def test_guards(self):
        mgr = self._manager()
        seq = mgr.get_or_create_sequence(0)
        self._commit(mgr, seq, [1, 2, 3])
        assert mgr.rollback_tokens(seq, 0) == 0
        with pytest.raises(ValueError):
            mgr.rollback_tokens(seq, 4)  # overdraw
        seq.pre_forward(2)
        with pytest.raises(RuntimeError):
            mgr.rollback_tokens(seq, 1)  # tokens in flight
        seq.post_forward()

    def test_shared_blocks_never_released(self):
        mgr = self._manager(cache=True)
        prompt = list(range(17))  # 2 full blocks cacheable + 1 partial
        a = mgr.admit_sequence(0, prompt)
        self._commit(mgr, a, prompt)
        mgr.flush_sequence(0)  # donates blocks 0..1 to the radix tree
        b = mgr.admit_sequence(1, prompt)
        assert b.shared_blocks == 2 and b.seen_tokens == 16
        shared_ids = list(b.blocks[:2])
        rc_before = [mgr._allocator.refcount(x) for x in shared_ids]
        self._commit(mgr, b, prompt[16:] + [200] * 7)  # seen 16 -> 24
        assert mgr.rollback_tokens(b, 14) == 1  # 24 -> 10 seen; the floor keeps both shared blocks
        assert b.seen_tokens == 10 and b.blocks[:2] == shared_ids and len(b.blocks) == 2
        assert [mgr._allocator.refcount(x) for x in shared_ids] == rc_before

    def test_property_alloc_rollback_conservation(self):
        # random commit / rollback / flush churn: the pool conserves blocks, no refcount goes below
        # zero (the allocator raises on a double free), and every live block list covers its tokens
        mgr = self._manager(blocks=96)
        alloc = mgr._allocator
        rng = np.random.RandomState(0)
        live = {}
        next_uid = 0
        for _ in range(300):
            op = rng.randint(3)
            if op == 0 or not live:
                uid = next_uid
                next_uid += 1
                seq = mgr.get_or_create_sequence(uid)
                live[uid] = seq
                self._commit(mgr, seq, rng.randint(0, 99, size=rng.randint(1, 30)).tolist())
            elif op == 1:
                seq = live[rng.choice(list(live))]
                if seq.seen_tokens > 1:
                    mgr.rollback_tokens(seq, int(rng.randint(1, seq.seen_tokens)))
            else:
                uid = rng.choice(list(live))
                mgr.flush_sequence(uid)
                del live[uid]
            held = sum(len(s.blocks) for s in live.values())
            assert alloc.free_blocks + held == alloc.total_blocks
            for s in live.values():
                assert len(s.blocks) == -(-s.seen_tokens // 8) or s.seen_tokens == 0
                assert all(alloc.refcount(b) == 1 for b in s.blocks)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("fused", [True, False])
def test_greedy_parity_with_spec_off_and_the_jax_engine(spec_setup, fused):
    engine, jax_engine = spec_setup
    on = engine(True, fused=fused)
    out_on = on.generate(PROMPTS, max_new_tokens=32)
    assert out_on == engine(False, fused=fused).generate(PROMPTS, max_new_tokens=32)
    assert out_on == jax_engine(True, fused=fused).generate(PROMPTS, max_new_tokens=32)
    assert on.spec_accepted > 0 and on.state.spec_rollback_tokens > 0


def test_spec_on_through_the_knob(spec_setup, monkeypatch):
    engine, _ = spec_setup
    monkeypatch.setenv("DS_TPU_SPEC_DECODE", "1")
    monkeypatch.setenv("DS_TPU_SPEC_K", "2")
    eng = engine(None, k=None)
    assert eng._spec_enabled and eng._spec_k == 2
    assert eng.generate(PROMPTS, max_new_tokens=12) == engine(False).generate(PROMPTS, max_new_tokens=12)
    assert eng.spec_proposed > 0


def test_spec_engages_and_cuts_decode_steps(spec_setup):
    engine, _ = spec_setup
    on, off = engine(True, burst=0), engine(False, burst=0)
    out = on.generate(PROMPTS, max_new_tokens=32)
    assert out == off.generate(PROMPTS, max_new_tokens=32)
    assert on.spec_accepted > 0 and on.decode_steps < off.decode_steps
    assert on.decode_tokens == off.decode_tokens
    assert all(len(o) == 32 for o in out)


def test_sampled_topk1_parity(spec_setup):
    engine, _ = spec_setup
    on = engine(True)
    s_on = on.generate(PROMPTS, max_new_tokens=16, do_sample=True, top_k=1, seed=3)
    assert s_on == engine(False).generate(PROMPTS, max_new_tokens=16, do_sample=True, top_k=1, seed=3)
    assert on.spec_accepted > 0


@pytest.mark.parametrize("fused", [True, False])
def test_eos_mid_window(spec_setup, fused):
    # an EOS inside a multi-token commit cuts the stream there, and every KV block comes back
    engine, _ = spec_setup
    eos = engine(False).generate(PROMPTS, max_new_tokens=32)[0][13]
    e_on, e_off = engine(True, fused=fused), engine(False, fused=fused)
    e_on.generate(PROMPTS, max_new_tokens=32)  # warm the prefix cache
    free0 = e_on.state.free_blocks
    out_on = e_on.generate(PROMPTS, max_new_tokens=32, eos_token_id=eos)
    assert e_on.state.free_blocks == free0
    assert out_on == e_off.generate(PROMPTS, max_new_tokens=32, eos_token_id=eos)
    assert any(eos in o and len(o) < 32 for o in out_on)
    for o in out_on:  # nothing follows the first EOS
        assert eos not in o or o.index(eos) == len(o) - 1


def test_blocks_return_after_generate(spec_setup):
    engine, _ = spec_setup
    eng = engine(True, enable_prefix_cache=False)
    free0 = eng.state.free_blocks
    eng.generate(PROMPTS, max_new_tokens=29)
    assert eng.state.free_blocks == free0 and eng.state.n_tracked_sequences == 0


def test_streaming_parity(spec_setup):
    engine, _ = spec_setup
    streams = {}
    out = engine(True).generate(PROMPTS, max_new_tokens=16,
                                on_token=lambda u, t: streams.setdefault(u, []).append(t))
    assert [streams[i] for i in range(len(PROMPTS))] == out
    assert out == engine(False).generate(PROMPTS, max_new_tokens=16)


def test_null_drafter_degrades_to_plain_decode(spec_setup):
    engine, _ = spec_setup
    null, off = engine(True, drafter="null", burst=0), engine(False, burst=0)
    assert null.generate(PROMPTS, max_new_tokens=12) == off.generate(PROMPTS, max_new_tokens=12)
    assert (null.spec_proposed, null.state.spec_rollback_tokens) == (0, 0)
    assert null.dispatches == off.dispatches and null.decode_steps == off.decode_steps


def test_zero_acceptance_wrong_drafter(spec_setup):
    # a drafter that always proposes one wrong token: every verify rejects it and commits the
    # correction, so the engine retires one token a step, in as many steps as plain decode
    engine, _ = spec_setup
    off = engine(False, burst=0)
    out_off = off.generate(PROMPTS, max_new_tokens=12)
    full = [tuple(p) + tuple(o) for p, o in zip(PROMPTS, out_off)]

    class WrongDrafter:
        def propose(self, history, k):
            h = tuple(int(t) for t in history)
            for seq in full:
                if len(h) < len(seq) and seq[:len(h)] == h:
                    return [seq[len(h)] ^ 1] if k > 0 else []
            return []

    eng = engine(True, burst=0)
    eng._drafter = WrongDrafter()
    assert eng.generate(PROMPTS, max_new_tokens=12) == out_off
    assert eng.spec_accepted == 0 and eng.spec_proposed > 0
    assert eng.dispatches == off.dispatches and eng.decode_steps == off.decode_steps


@pytest.mark.parametrize("n", [5, 7, 13])
def test_budget_clamp_on_last_window(spec_setup, n):
    engine, _ = spec_setup
    out_on = engine(True).generate(PROMPTS, max_new_tokens=n)
    assert out_on == engine(False).generate(PROMPTS, max_new_tokens=n)
    assert all(len(o) == n for o in out_on)


@pytest.mark.parametrize("fused", [True, False])
def test_sla_loop_parity_32_requests(spec_setup, fused):
    from deepspeed_tpu_torch.inference.v2.sla import LoadSpec, run_load

    engine, _ = spec_setup
    spec = LoadSpec(n_requests=32, arrival_rate=2000.0, prompt_len_range=(6, 20), max_new_tokens=12, vocab_size=128,
                    seed=0)

    def tokens(spec_on):
        eng = engine(spec_on, fused=fused, blocks=256)
        stats = run_load(eng, spec)
        assert all(s.n_new == 12 for s in stats)
        return [s.tokens for s in sorted(stats, key=lambda s: s.uid)], eng

    (on, eng_on), (off, _) = tokens(True), tokens(False)
    assert on == off
    assert eng_on.spec_proposed > 0


def test_spec_over_int8_kv_pools(spec_setup):
    # over int8 pages the verify writes quantised KV optimistically and rolls rejected positions
    # back: the tokens equal the int8 engine's without speculation and the JAX engine's with it
    SHARED = [(7 * i + 3) % 128 for i in range(32)]
    prompts = [SHARED + [100 + i] * 5 for i in range(4)]
    engine, jax_engine = spec_setup
    on = engine(True, blocks=64, kv_quant_bits=8, enable_prefix_cache=True)
    out = on.generate(prompts, max_new_tokens=12)
    assert out == engine(False, blocks=64, kv_quant_bits=8, enable_prefix_cache=True).generate(
        prompts, max_new_tokens=12)
    assert out == jax_engine(True, blocks=64, kv_quant_bits=8, enable_prefix_cache=True).generate(
        prompts, max_new_tokens=12)
    assert on.spec_proposed > 0 and isinstance(on.k_pages, tuple)


def test_acceptance_and_decode_step_reduction_on_repetitive_workload():
    # a greedy model that falls into short output cycles, served with prompt lookup: at least half
    # the proposals are accepted and at least twice the tokens a decode step retire (bursts off)
    tiny = dict(TINY, vocab_size=64, max_seq_len=512)
    model = CausalLM(JaxConfig(**tiny))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**tiny)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 64, size=3).tolist() * 3 for _ in range(4)]

    def run(spec_on):
        eng = InferenceEngineV2(cfg, tparams, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(kv_block_size=8, max_context=512, num_kv_blocks=256), dtype="float32",
            device="cpu", decode_burst=0, spec_decode=spec_on, spec_k=4))
        return eng.generate([p[:] for p in prompts], max_new_tokens=192), eng

    (out_off, off), (out_on, on) = run(False), run(True)
    assert out_on == out_off
    assert on.spec_accepted / max(1, on.spec_proposed) >= 0.5
    assert on.decode_tokens / on.decode_steps >= 2.0 * off.decode_tokens / off.decode_steps
