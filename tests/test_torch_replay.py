"""Port parity: telemetry (registry, request events), the serving journal
and the replay oracle.

After ``tests/unit/test_replay.py`` and the reference's telemetry, on the CPU
in fp32:
- the registry's text exposition equals the JAX registry's for the same
  operations (labels, escaping, help text, histograms, a reset);
- the request-lifecycle events of a ``generate`` (fused, unfused,
  speculative, with the prefix cache hit) equal the JAX engine's event for
  event (kind, uid and attributes, timestamps aside), so every request's
  ``lifecycle_signature`` is equal, and every timeline is valid;
- a journal the JAX engine records (a ``generate`` session and a ``sla``
  session) replays on the port, rebuilt from the journal with the JAX
  parameters converted (``params_from_numpy``): ``replay_oracle`` is ok and
  every digest equals the recorded one; the port's own journal of the same
  trace has the same request, commit and end digests as the JAX journal;
- the journal file round trip with a torn last line; a journal the port
  records replays on an engine rebuilt from it alone (``meta.param_seed``);
  divergence injection names the request and the quantum;
  ``determinism_audit``; ``replay_whatif``.
"""

import jax
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference.v2 import RaggedBatchConfig as JaxBatchConfig
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JaxEngineConfig
from deepspeed_tpu.inference.v2 import sla as jax_sla
from deepspeed_tpu.models import CausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.telemetry import events as jax_events
from deepspeed_tpu.telemetry import journal as jax_journal
from deepspeed_tpu.telemetry import registry as jax_registry_mod
from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedBatchConfig, RaggedInferenceEngineConfig, sla
from deepspeed_tpu_torch.inference.v2.replay import (build_engine_from_session, determinism_audit, replay_oracle,
                                                     replay_whatif)
from deepspeed_tpu_torch.models import TransformerConfig, init_params, params_from_numpy
from deepspeed_tpu_torch.telemetry import (Journal, MetricsRegistry, get_event_log, journal_override,
                                           lifecycle_signature, read_journal, request_timelines, roll_digest,
                                           sessions_from_records, set_journal, validate_timeline)

TINY = dict(vocab_size=128, n_layers=2, n_heads=4, n_kv_heads=2, d_model=32, max_seq_len=128, norm="rmsnorm",
            activation="swiglu", pos_emb="rope", tie_embeddings=False)
SMC = dict(kv_block_size=8, max_context=128, num_kv_blocks=64)
# the last two prompts share two blocks: served in two waves, the second one's admission hits the prefix cache
PROMPTS = [[5, 9, 2, 44], [7, 7, 1], [3, 14, 15, 92, 6], list(range(20, 40)), list(range(20, 36)) + [1, 2]]
SLA_SPEC = dict(n_requests=8, arrival_rate=1e9, prompt_len_range=(4, 12), max_new_tokens=6, vocab_size=128, seed=11,
                shared_prefix_len=8)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    set_journal(None)
    jax_journal.set_journal(None)
    get_event_log().clear()
    jax_events.get_event_log().clear()


@pytest.fixture(scope="module")
def tiny():
    model = CausalLM(JaxConfig(**TINY))
    params = model.init(jax.random.PRNGKey(0), {"input_ids": np.zeros((1, 8), np.int32)})
    cfg = TransformerConfig(**TINY)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu", cfg=cfg)

    def kw(fused=True, spec=False):
        return dict(dtype="float32", fused_step=fused, spec_decode=spec, spec_k=2 if spec else None, decode_burst=8)

    def jax_engine(**loop):
        return JaxEngine(model, params, JaxEngineConfig(state_manager=JaxBatchConfig(**SMC), **kw(**loop)))

    def engine(params=tparams, **loop):
        return InferenceEngineV2(cfg, params, RaggedInferenceEngineConfig(
            state_manager=RaggedBatchConfig(**SMC), device="cpu", **kw(**loop)))

    return cfg, tparams, jax_engine, engine


# ------------------------------------------------------------- registry
def _registry_ops(reg):
    reg.describe("req_total", 'requests "served"\nby the engine \\ all')
    reg.counter("req_total", route="a").inc(3)
    reg.counter("req_total", route='b"q\\n').inc(0.5)
    reg.gauge("fill").set(0.25)
    reg.gauge("depth", pool="kv").inc(4)
    reg.gauge("depth", pool="kv").dec(1.5)
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v)
    reg.histogram("other_seconds").observe(2e-3)
    text = reg.render_prometheus()
    peek = (reg.peek("req_total", route="a"), reg.peek("lat_seconds"), reg.peek("missing"))
    reg.reset()
    return text, peek, reg.render_prometheus()


def test_registry_exposition_matches_reference():
    got = _registry_ops(MetricsRegistry())
    want = _registry_ops(jax_registry_mod.MetricsRegistry())
    assert got == want
    assert 'req_total{route="b\\"q\\\\n"} 0.5' in got[0]
    with pytest.raises(ValueError, match="already registered as a counter"):
        r = MetricsRegistry()
        r.counter("x")
        r.gauge("x")
    off = MetricsRegistry(enabled=False)
    off.counter("y").inc()
    assert off.peek("y") == 0.0


# ------------------------------------------------------------- events
@pytest.mark.parametrize("loop", [dict(fused=True), dict(fused=False), dict(fused=False, spec=True)],
                         ids=["fused", "unfused", "spec"])
def test_request_events_match_reference(tiny, loop):
    _, _, jax_engine, engine = tiny
    runs = []
    for make, log in ((jax_engine, jax_events.get_event_log()), (engine, get_event_log())):
        e = make(**loop)
        log.clear()
        e.generate(PROMPTS[:4], max_new_tokens=6)
        e.generate(PROMPTS[4:] + PROMPTS[:1], max_new_tokens=6)
        runs.append(log.events())
    want, got = (_events_of(r) for r in runs)
    assert got == want
    kinds = {k for k, _, _ in got}
    assert {"enqueue", "admit", "prefill_chunk", "quantum", "first_token", "decode", "finish"} <= kinds
    for tls in request_timelines(runs[1]).values():
        for tl in tls:
            assert validate_timeline(tl) == []
    sig = lambda evs: {u: [lifecycle_signature(t) for t in tls] for u, tls in request_timelines(evs).items()}  # noqa
    assert sig(runs[1]) == sig(runs[0])
    hits = [a["hit"] for k, _, a in got if k == "admit"]
    assert max(hits) > 0  # the second wave hit the prefix cache


def _events_of(evs):
    return [(e["kind"], e["uid"], {k: v for k, v in e.items() if k not in ("ts", "kind", "uid")}) for e in evs]


# ------------------------------------------------------------- journal
def _record(journal_mod, journal, fn):
    with journal_mod.journal_override(journal):
        fn()
    return journal_mod.sessions_from_records(journal.records)[-1]


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "ts_unix", "wall_s", "summary")}


@pytest.mark.parametrize("kind", ["generate", "sla"])
def test_jax_journal_replays_on_port(tiny, kind):
    cfg, tparams, jax_engine, engine = tiny
    if kind == "generate":
        jfn = lambda: jax_engine().generate(PROMPTS, max_new_tokens=6)  # noqa: E731
        tfn = lambda: engine().generate(PROMPTS, max_new_tokens=6)  # noqa: E731
    else:
        jfn = lambda: jax_sla.run_load(jax_engine(), jax_sla.LoadSpec(**SLA_SPEC))  # noqa: E731
        tfn = lambda: sla.run_load(engine(), sla.LoadSpec(**SLA_SPEC))  # noqa: E731
    jsession = _record(jax_journal, jax_journal.Journal(), jfn)
    assert jsession.kind == kind and jsession.header["engine"]["shard_sig"] == "tp1"
    rebuilt = build_engine_from_session(jsession, model=cfg, params=tparams, device="cpu")
    assert rebuilt._fused_enabled and rebuilt._n_kv_blocks == SMC["num_kv_blocks"]
    report = replay_oracle(jsession, engine=rebuilt)
    assert report.ok, report.divergences
    assert report.n_tokens == sum(len(t) for t in jsession.tokens_by_uid().values()) > 0

    # the port's own journal of the same trace: the same requests, quanta, commits and final digests
    tj = Journal()
    with journal_override(tj):
        tfn()
    tsession = sessions_from_records(tj.records)[-1]
    assert tsession.digests() == jsession.digests()
    assert [_strip(r) for r in tsession.requests.values()] == [_strip(r) for r in jsession.requests.values()]
    assert [_strip(q) for q in tsession.quanta] == [_strip(q) for q in jsession.quanta]
    assert [_strip(c) for c in tsession.commits] == [_strip(c) for c in jsession.commits]
    assert set(tsession.header["engine"]) == set(jsession.header["engine"])


def test_journal_file_roundtrip_and_torn_line(tmp_path):
    path = str(tmp_path / "j.jsonl")
    journal = Journal(path)
    journal.begin_session({"engine": {"dtype": "float32"}}, kind="generate", run={"seed": 3})
    journal.record_request(0, [1, 2, 3], arrival_s=0.0, arrival_q=0, max_new_tokens=4)
    journal.record_quantum(1, [0], [(0, 0, 3, True)])
    journal.record_commit(0, 1, [9, 8])
    journal.end_session({"note": "done"})
    journal.close()
    with open(path, "a") as f:
        f.write('{"kind": "commit", "uid": 0, "torn...\n')  # a crashed writer
    sessions = read_journal(path)
    assert len(sessions) == 1
    s = sessions[0]
    assert s.kind == "generate" and s.tokens_by_uid() == {0: [9, 8]}
    assert s.digests() == {0: roll_digest("", [9, 8])} == {0: jax_journal.roll_digest("", [9, 8])}
    assert s.quanta[0]["digest"] and s.end["summary"] == {"note": "done"}
    # chunking-sensitive rolling digest; an inactive journal records nothing
    assert roll_digest(roll_digest("", [1, 2]), [3]) != roll_digest(roll_digest("", [1, 2]), [4])
    idle = Journal()
    idle.record_commit(0, 1, [1])
    assert idle.records == []
    assert jax_journal.read_journal(path)[0].digests() == s.digests()


def test_port_journal_replays_from_seed_and_pinpoints_divergence(tiny, tmp_path):
    cfg, _, _, engine = tiny
    seeded = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    path = str(tmp_path / "sla.jsonl")
    journal = Journal(path)
    journal.meta["param_seed"] = 3
    with journal_override(journal):
        sla.run_load(engine(params=seeded), sla.LoadSpec(**SLA_SPEC))
    journal.close()
    session = read_journal(path)[-1]
    assert session.kind == "sla" and len(session.requests) == SLA_SPEC["n_requests"]
    assert session.header["knobs"]["DS_TPU_KV_SPILL"]["default"] == "0" and session.header["programs"]
    report = replay_oracle(session, engine=build_engine_from_session(session, device="cpu"))
    assert report.ok, report.divergences
    assert report.n_tokens == SLA_SPEC["n_requests"] * SLA_SPEC["max_new_tokens"]

    victim = next(c for c in session.commits if int(c["uid"]) == 2)
    victim["tokens"][0] = (int(victim["tokens"][0]) + 1) % 128
    session.end = None  # digests come from the tampered commit stream
    report = replay_oracle(session, engine=engine(params=seeded))
    assert not report.ok
    first = report.first
    assert first.uid == 2 and first.position == 0 and first.quantum == int(victim["q"])
    assert first.recorded != first.replayed and first.events


def test_determinism_audit_and_whatif(tiny):
    cfg, tparams, _, engine = tiny
    spec = sla.LoadSpec(**dict(SLA_SPEC, n_requests=4))
    result = determinism_audit(lambda: engine(), spec=spec)
    assert result["deterministic"] and result["quanta_equal"] and result["n_requests"] == 4

    journal = Journal()
    with journal_override(journal):
        sla.run_load(engine(), spec)
    session = sessions_from_records(journal.records)[-1]
    factory = lambda ov: build_engine_from_session(session, overrides=ov, model=cfg, params=tparams,  # noqa: E731
                                                   device="cpu")
    report = replay_whatif(session, {"DS_TPU_SPEC_K": 3, "spec_decode": True, "DS_TPU_KV_SPILL_WATERMARK": "0.5"},
                           engine_factory=factory, timing="logical")
    assert report["overrides"]["DS_TPU_SPEC_K"] == 3
    assert {"ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tokens_per_sec", "sla_miss_frac", "dispatches"} <= {
        r["metric"] for r in report["rows"]}
    assert report["candidate"]["tokens_per_sec"] > 0 and report["baseline"]["tokens_per_sec"] > 0
    assert report["candidate"]["dispatches"] > 0
    with pytest.raises(RuntimeError, match="tensor_parallel=2"):
        build_engine_from_session(session, overrides={"DS_TPU_TP": 2}, model=cfg, params=tparams, device="cpu")
