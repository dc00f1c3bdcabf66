"""Replay harness for recorded serving sessions (``telemetry/journal.py``).

Port of ``deepspeed_tpu/inference/v2/replay.py``. Three consumers of one
journal:

- :func:`replay_oracle`: re-drive a fresh engine from the recorded arrivals
  and compare the committed token streams with the recorded ones, digest for
  digest; on divergence, report the first divergent request and quantum with
  the event-ring context around it.
- :func:`replay_whatif`: replay the same arrival trace under overridden knobs
  or config fields (spec K, KV quant bits, spill, scheduler budgets) and
  report TTFT/TPOT/throughput/steps beside the recorded baseline.
- :func:`determinism_audit`: record the same workload twice on fresh engines
  and diff the digest streams, catching host-side nondeterminism.

Why replay is exact: serving is greedy during SLA runs and the decode math is
per-row (paged attention reads only a row's own KV), so the committed tokens
do not depend on admission timing under the logical clock; sampled
``generate`` runs re-derive the same draws from the recorded seed.

A journal either package recorded replays here: the schema is one. The
engine is rebuilt from the recorded fingerprint, with the parameters

- passed by the caller (``model=`` and ``params=``): how a journal of the JAX
  engine replays, with its parameters converted (``models.params_from_numpy``);
- else drawn by the port's ``init_params`` from the recorded
  ``meta.param_seed``: a journal the port recorded replays on its own (the
  JAX package's ``model.init`` draws other numbers from the same seed).

The topology gate (JAX ``replay.py:188-210``): a journal recorded at
``tensor_parallel`` > 1 replays only in a process world whose size is a
multiple of that degree (each rank builds its engine and replays), and the
rebuilt engine's sharding signature must equal the recorded one, unless the
caller overrode the topology (``tensor_parallel``, ``DS_TPU_TP``,
``DS_TPU_TP_ALLREDUCE_BITS``); a mismatch raises ``RuntimeError``. The
recorded ``programs`` are not compared (each package writes its own).
"""

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from ... import comm as dist
from ...telemetry import get_event_log, get_registry as get_telemetry_registry
from ...telemetry.journal import Journal, Session, journal_override, sessions_from_records
from .sla import Arrival, run_load, serve_trace, summarize

# journal-knob name -> engine config field, for what-if overrides given in env-knob spelling
_KNOB_TO_FIELD = {
    "DS_TPU_SPEC_K": "spec_k",
    "DS_TPU_SPEC_DECODE": "spec_decode",
    "DS_TPU_SERVE_FUSED": "fused_step",
    "DS_TPU_KV_QUANT": "kv_quant_bits",
    "DS_TPU_KV_SPILL": "kv_spill",
    "DS_TPU_PREFIX_CACHE": "enable_prefix_cache",
    "DS_TPU_DECODE_BURST": "decode_burst",
    "DS_TPU_MIN_DECODE_BUCKET": "min_decode_bucket",
    "DS_TPU_TP": "tensor_parallel",
}
# engine-dict keys that live on RaggedBatchConfig, not the engine config
_STATE_FIELDS = ("max_ragged_batch_size", "max_ragged_sequence_count", "num_kv_blocks", "kv_block_size",
                 "max_context")
_BOOL_FIELDS = ("spec_decode", "fused_step", "kv_spill", "enable_prefix_cache")


def _coerce(value):
    """Parse CLI-style string override values ("true", "2", "0.5") into the
    types the config dataclasses expect; non-strings pass through."""
    if not isinstance(value, str):
        return value
    low = value.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


@dataclass
class Divergence:
    uid: int
    position: int  # first divergent token index within the request
    quantum: Optional[int]  # recorded quantum that committed that token
    recorded: List[int]
    replayed: List[int]
    events: List[Dict] = field(default_factory=list)  # replay-side event-ring context


@dataclass
class OracleReport:
    ok: bool
    n_requests: int
    n_tokens: int
    digests_match: bool
    divergences: List[Divergence] = field(default_factory=list)

    @property
    def first(self) -> Optional[Divergence]:
        return self.divergences[0] if self.divergences else None


@contextlib.contextmanager
def _env_overrides(env: Dict[str, str]):
    """Scoped os.environ writes for knob-spelled what-if overrides that have
    no engine-config field (spill watermark, host pool size, ...)."""
    saved = {}
    for name, value in env.items():
        saved[name] = os.environ.get(name)
        os.environ[name] = str(value)
    try:
        yield
    finally:
        for name, prev in saved.items():
            if prev is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = prev


def build_engine_from_session(session: Session, overrides: Optional[Dict] = None, model=None, params=None,
                              device="cuda"):
    """Rebuild an engine on ``device`` from a session header's fingerprint.

    ``model`` (a ``TransformerConfig`` or anything with ``.cfg``) and
    ``params`` (the port's parameter tree) short-circuit the rebuild;
    otherwise the config comes from the recorded ``model_cfg`` and the
    parameters from ``init_params`` seeded with ``meta.param_seed``."""
    from ...models import TransformerConfig, init_params
    from .engine_v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    from .ragged.manager import RaggedBatchConfig

    overrides = dict(overrides or {})
    header = session.header
    eng = dict(header.get("engine", {}))

    # split the overrides: engine-config fields (possibly knob-spelled), state-manager fields, and residual
    # DS_TPU_* env knobs
    env: Dict[str, str] = {}
    for key in list(overrides):
        name = _KNOB_TO_FIELD.get(key, key)
        if name in _STATE_FIELDS or name == "tensor_parallel" or name in {
                f.name for f in dataclasses.fields(RaggedInferenceEngineConfig)}:
            if name != key:
                overrides[name] = overrides.pop(key)
        elif key.startswith("DS_TPU_"):
            env[key] = str(overrides.pop(key))
    eng.update({k: _coerce(v) for k, v in overrides.items()})
    for name in _BOOL_FIELDS:
        if eng.get(name) is not None:
            eng[name] = bool(eng[name])
    # topology gate: a journal recorded under TP must replay on a topology that realises the same sharding; a
    # silently different mesh would diverge token streams with no fingerprint to blame
    tp = int(eng.get("tensor_parallel", 1) or 1)
    world = dist.get_world_size()
    if tp > 1 and (world < tp or world % tp):
        raise RuntimeError(f"journal recorded tensor_parallel={tp} (mesh {eng.get('mesh', '?')}) but the process "
                           f"world has {world} rank(s): refusing to replay on a mismatched topology (start a "
                           f"multiple of {tp} ranks with comm.init_distributed and replay on each)")

    if model is None:
        mc = dict(header.get("model_cfg", {}))
        mc.pop("dtype", None)  # the run dtype is the engine's to choose
        names = {f.name for f in dataclasses.fields(TransformerConfig)}
        mc = {k: v for k, v in mc.items() if k in names}
        if mc.get("window_layers") is not None:
            mc["window_layers"] = tuple(mc["window_layers"])
        model = TransformerConfig(**mc)
    cfg = model if isinstance(model, TransformerConfig) else model.cfg
    dev = torch.device(device)
    if params is None:
        seed = int((header.get("meta") or {}).get("param_seed", 0))
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)

    smc = RaggedBatchConfig(
        max_ragged_batch_size=int(eng.get("max_ragged_batch_size", 768)),
        max_ragged_sequence_count=int(eng.get("max_ragged_sequence_count", 512)),
        max_context=int(eng.get("max_context", 8192)),
        kv_block_size=int(eng.get("kv_block_size", 128)),
        num_kv_blocks=eng.get("num_kv_blocks"))
    config = RaggedInferenceEngineConfig(
        state_manager=smc,
        dtype=str(eng.get("dtype", "bfloat16")),
        device=str(dev),
        fused_step=eng.get("fused_step"),
        spec_decode=eng.get("spec_decode"),
        spec_k=eng.get("spec_k"),
        spec_drafter=str(eng.get("spec_drafter", "prompt_lookup")),
        decode_burst=None if eng.get("decode_burst") is None else int(eng["decode_burst"]),
        min_decode_bucket=None if eng.get("min_decode_bucket") is None else int(eng["min_decode_bucket"]),
        quant_bits=int(eng.get("quant_bits", 0)),
        kv_quant_bits=eng.get("kv_quant_bits"),
        kv_spill=eng.get("kv_spill"),
        enable_prefix_cache=eng.get("enable_prefix_cache"),
        tensor_parallel=tp)
    with _env_overrides(env):
        engine = InferenceEngineV2(cfg, params, config)
    want_sig = eng.get("shard_sig")
    overridden = "tensor_parallel" in overrides or "DS_TPU_TP" in env or "DS_TPU_TP_ALLREDUCE_BITS" in env
    if want_sig and not overridden and engine._shard_sig != want_sig:
        raise RuntimeError(f"rebuilt engine sharding {engine._shard_sig!r} != recorded {want_sig!r}: the replay "
                           "topology does not reproduce the recorded mesh and allreduce layout")
    return engine


def _session_trace(session: Session) -> List[Arrival]:
    """A session's recorded requests as a trace for ``sla.serve_trace`` (the
    loop ``sla.run_load`` runs), in recorded arrival order. On the logical
    clock each request is re-admitted once the scheduler's quantum clock
    passes its recorded admission quantum (deterministic, wall-clock-free:
    the oracle's mode); on the wall clock, at its recorded arrival second,
    so latency percentiles are comparable (the what-if mode)."""
    recs = session.requests
    return [Arrival(uid=u, prompt=list(recs[u]["prompt"]),
                    max_new_tokens=int(recs[u].get("max_new_tokens", 0)) or 1 << 30,
                    arrival_s=float(recs[u].get("arrival_s", 0.0)), arrival_q=int(recs[u].get("arrival_q", 0)))
            for u in sorted(recs, key=lambda u: (float(recs[u].get("arrival_s", 0.0)), int(u)))]


def _recorded_eos(session: Session) -> Optional[int]:
    return (session.header.get("run") or {}).get("eos_token_id")


def replay_tokens(session: Session, engine) -> Dict[int, List[int]]:
    """Re-drive ``engine`` from ``session`` and return uid -> tokens.

    ``generate`` sessions re-run ``engine.generate`` with the recorded
    arguments; ``sla`` sessions re-drive the recorded arrival trace on the
    logical quantum clock. Recording is muted for the duration: a replay
    never journals over itself."""
    with journal_override(None):
        if session.kind == "generate":
            run = dict(session.header.get("run") or {})
            prompts = [session.requests[u]["prompt"] for u in sorted(session.requests)]
            out = engine.generate(prompts, max_new_tokens=int(run.get("max_new_tokens", 32)),
                                  eos_token_id=run.get("eos_token_id"), do_sample=bool(run.get("do_sample", False)),
                                  temperature=float(run.get("temperature", 1.0)), top_k=int(run.get("top_k", 0)),
                                  top_p=float(run.get("top_p", 1.0)), seed=int(run.get("seed", 0)))
            return {u: out[i] for i, u in enumerate(sorted(session.requests))}
        results, _ = serve_trace(engine, _session_trace(session), clock="logical",
                                 eos_token_id=_recorded_eos(session))
        return results


def replay_oracle(session: Session, engine=None, engine_factory: Optional[Callable] = None,
                  context_events: int = 16) -> OracleReport:
    """Token-exact replay check: re-drive a fresh engine and compare the
    committed streams with the recorded ones, digest for digest."""
    if engine is None:
        engine = (engine_factory or (lambda: build_engine_from_session(session)))()
    recorded = session.tokens_by_uid()
    replayed = replay_tokens(session, engine)
    m_div = get_telemetry_registry().counter("replay_divergences_total")
    events = get_event_log()

    divergences: List[Divergence] = []
    for uid in sorted(recorded):
        rec, rep = recorded[uid], replayed.get(uid, [])
        if rec == rep:
            continue
        pos = next((i for i, (a, b) in enumerate(zip(rec, rep)) if a != b), min(len(rec), len(rep)))
        ctx = [dict(e) for e in events.events(uid=uid)[-context_events:]]
        divergences.append(Divergence(uid=uid, position=pos, quantum=session.quantum_of_commit(uid, pos),
                                      recorded=rec[max(0, pos - 4):pos + 4], replayed=rep[max(0, pos - 4):pos + 4],
                                      events=ctx))
        m_div.inc()
    divergences.sort(key=lambda d: (d.quantum if d.quantum is not None else 1 << 30, d.uid))
    return OracleReport(ok=not divergences, n_requests=len(recorded), n_tokens=sum(len(t) for t in recorded.values()),
                        digests_match=not divergences, divergences=divergences)


def replay_whatif(session: Session, overrides: Dict, engine_factory: Optional[Callable] = None,
                  timing: str = "recorded") -> Dict:
    """Replay the recorded arrival trace under overridden knobs and report
    it beside the session's recorded baseline. ``timing``: ``"recorded"``
    (admissions at the recorded arrival seconds) or ``"logical"`` (at the
    recorded quanta)."""
    if timing not in ("logical", "recorded"):
        raise ValueError(f"timing must be 'logical' or 'recorded', got {timing!r}")
    factory = engine_factory or (lambda ov: build_engine_from_session(session, overrides=ov))
    engine = factory(overrides)
    tele = get_telemetry_registry()
    d0 = tele.peek("infer_dispatches_total") or 0.0
    t0 = time.perf_counter()
    _, stats = serve_trace(engine, _session_trace(session), clock="logical" if timing == "logical" else "wall",
                           eos_token_id=_recorded_eos(session))
    wall = time.perf_counter() - t0
    d1 = tele.peek("infer_dispatches_total") or 0.0

    candidate = summarize(stats) if any(s.done is not None for s in stats) else {}
    candidate["dispatches"] = d1 - d0
    candidate["wall_s"] = round(wall, 4)

    end = session.end or {}
    baseline = dict((end.get("summary") or {}).get("sla") or {})
    baseline["dispatches"] = (end.get("summary") or {}).get("dispatches")
    baseline["wall_s"] = end.get("wall_s")

    keys = ("tokens_per_sec", "requests_per_sec", "ttft_p50_s", "ttft_p95_s", "ttft_p99_s", "tpot_p50_s",
            "tpot_p95_s", "sla_miss_frac", "dispatches", "wall_s")
    rows = []
    for key in keys:
        b, c = baseline.get(key), candidate.get(key)
        delta = round(c - b, 4) if isinstance(b, (int, float)) and isinstance(c, (int, float)) else None
        rows.append({"metric": key, "baseline": b, "candidate": c, "delta": delta})
    return {"overrides": dict(overrides), "timing": timing, "baseline": baseline, "candidate": candidate,
            "rows": rows}


def determinism_audit(engine_factory: Callable, drive: Optional[Callable] = None, spec=None) -> Dict:
    """Record the same workload twice on fresh engines and diff the digest
    streams: the tripwire for host-side nondeterminism (unordered dict
    walks, stray wall-clock branches, generator misuse).

    ``drive(engine)`` runs the workload (default ``sla.run_load`` with
    ``spec``); each run records into its own in-memory journal."""
    if drive is None:
        if spec is None:
            raise ValueError("determinism_audit needs a drive callable or a LoadSpec")
        drive = lambda eng: run_load(eng, spec)  # noqa: E731

    runs = []
    for _ in range(2):
        j = Journal()  # memory mode
        with journal_override(j):
            drive(engine_factory())
        runs.append(sessions_from_records(j.records)[-1])

    a, b = runs
    da, db = a.digests(), b.digests()
    mismatches = sorted(u for u in set(da) | set(db) if da.get(u) != db.get(u))
    qa = [q.get("digest") for q in a.quanta]
    qb = [q.get("digest") for q in b.quanta]
    if mismatches:
        get_telemetry_registry().counter("replay_divergences_total").inc(len(mismatches))
    return {"deterministic": not mismatches and qa == qb, "n_requests": len(da), "request_mismatches": mismatches,
            "quanta_equal": qa == qb, "n_quanta": (len(qa), len(qb))}
