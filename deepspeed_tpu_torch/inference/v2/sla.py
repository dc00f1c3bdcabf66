"""Serving load generator and SLA metrics for the v2 engine.

Port of ``deepspeed_tpu/inference/v2/sla.py``. The FastGen serving claim is a
throughput-latency curve and an "effective throughput under SLA" headline,
not one throughput point. Open-loop Poisson arrivals drive the
continuous-batching engine the way a frontend would; each request's time to
first token (TTFT) and mean time per output token after it (TPOT) are
recorded at host-visible boundaries (after each step's tokens reach the
host), and a rate sweep yields the table.

- ``run_load`` (through ``serve_trace``, the loop the replay harness
  shares) drives the fused loop (one step per scheduler quantum, pure-
  decode quanta with nothing due extended to bursts) or, on an engine built
  with ``fused_step=False``, the unfused loop (``put``, and bursts when
  nothing is pending or due). A request that arrives during a burst waits it
  out; that TTFT cost is part of what the harness measures.
- On an engine with speculative decoding on, a pure-decode situation with
  nothing due first runs a draft -> verify quantum (either loop), as the
  engine's own loops do.
- ``LoadSpec(arrival_rate=float("inf"))`` puts every arrival at t = 0
  (saturation).

- Telemetry as in the reference: every arrival emits ``enqueue`` stamped
  with its scheduled arrival, commits emit ``first_token`` and ``finish``,
  and TTFT and TPOT go into the ``infer_ttft_seconds`` and
  ``infer_tpot_seconds`` histograms (SLA-shaped buckets). With a journal
  installed the run is recorded as a ``sla`` session (the engine's
  fingerprint, the ``LoadSpec``, each request with its scheduled arrival and
  the quantum current at admission, each commit, and the summary), which
  ``replay.py`` re-drives. A recorded run feeds the health monitor (the
  queue-stall and SLO-burn detectors: each finished request's TTFT and
  TPOT, a poll each loop turn), ``run_load`` starts the ops plane when
  ``DS_TPU_OPS_PORT`` is set, and ``sweep`` adds the perf accountant's
  columns to each row (``model_flops``, ``mfu`` over the row's wall window,
  ``goodput_fraction``). The reference's tuned profile is not ported.
"""

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...telemetry import get_event_log, get_journal, get_registry as get_telemetry_registry
from ...telemetry.costs import get_perf_accountant
from ...telemetry.health import QueueStallDetector, SLOBurnRateDetector, get_health_monitor
from ...telemetry.ops_plane import maybe_start_ops_server
from .scheduler import RaggedRequest

# SLA-shaped buckets: the FastGen streaming SLA (TTFT <= 1 s, TPOT <= 250 ms)
# falls on bucket edges
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0)
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


@dataclasses.dataclass
class LoadSpec:
    """A Poisson open-loop workload."""
    n_requests: int = 32
    arrival_rate: float = 4.0  # requests/s (Poisson); inf: every arrival at t = 0
    prompt_len_range: Sequence[int] = (16, 64)  # inclusive bounds
    max_new_tokens: int = 32
    vocab_size: int = 256
    seed: int = 0
    # shared-system-prompt workload: every prompt starts with the same shared_prefix_len tokens (drawn once
    # per run) followed by a unique tail in prompt_len_range, the prefix-cache serving case
    shared_prefix_len: int = 0


@dataclasses.dataclass
class RequestStat:
    uid: int
    prompt_len: int
    arrival: float  # seconds since run start (scheduled)
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    done: Optional[float] = None
    n_new: int = 0
    tokens: Optional[List[int]] = None  # the generated tokens (greedy)

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival

    @property
    def tpot(self) -> float:
        """Mean per-output-token latency after the first token."""
        if self.n_new <= 1:
            return 0.0
        return (self.done - self.first_token) / (self.n_new - 1)


def load_prompts(spec: LoadSpec):
    """(arrival times, prompts) of ``spec``, drawn from its seed."""
    rng = np.random.default_rng(spec.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / spec.arrival_rate, spec.n_requests))
    lo, hi = spec.prompt_len_range
    lens = rng.integers(lo, hi + 1, spec.n_requests)
    shared = rng.integers(0, spec.vocab_size, size=spec.shared_prefix_len).tolist()
    return arrivals, [shared + rng.integers(0, spec.vocab_size, size=int(n)).tolist() for n in lens]


@dataclasses.dataclass
class Arrival:
    """One request of a trace: its prompt and token budget, and when it is
    due: ``arrival_s`` seconds after the run starts (wall clock), or once
    the scheduler's quantum clock has reached ``arrival_q`` (logical clock)."""
    uid: int
    prompt: List[int]
    max_new_tokens: int
    arrival_s: float
    arrival_q: int = 0


def serve_trace(engine, trace: Sequence[Arrival], clock: str = "wall", eos_token_id: Optional[int] = None,
                record: bool = False) -> Tuple[Dict[int, List[int]], List[RequestStat]]:
    """Drive ``engine`` through ``trace`` (in admission order) with the
    serving loop ``run_load`` and the replay harness share: per quantum, a
    speculative draft -> verify when nothing is pending or due, else one
    fused step (a burst when only decodes are left and nothing is due), else
    a decode burst or an unfused ``put``. Greedy decoding.

    ``clock="wall"`` admits a request once its ``arrival_s`` has passed and
    sleeps to the next one when idle; ``clock="logical"`` admits it once the
    scheduler's quantum clock passes its ``arrival_q`` and, when idle, admits
    the next one at once (the clock cannot advance while idle).
    ``record``: emit the lifecycle events, observe the TTFT / TPOT histograms,
    feed the health monitor and write requests and commits to the installed
    journal.

    Returns (uid -> committed tokens, the requests' stats in trace order)."""
    if clock not in ("wall", "logical"):
        raise ValueError(f"clock must be 'wall' or 'logical', got {clock!r}")
    stats = {a.uid: RequestStat(uid=a.uid, prompt_len=len(a.prompt), arrival=a.arrival_s) for a in trace}
    prompts = {a.uid: list(a.prompt) for a in trace}
    reqs: Dict[int, RaggedRequest] = {}
    pending: List[RaggedRequest] = []
    decode_ready: Dict[int, int] = {}
    results: Dict[int, List[int]] = {}
    next_i = 0
    engine._sampling = None
    tele = get_telemetry_registry()
    h_ttft = tele.histogram("infer_ttft_seconds", buckets=TTFT_BUCKETS)
    h_tpot = tele.histogram("infer_tpot_seconds", buckets=TPOT_BUCKETS)
    events = get_event_log()
    journal = get_journal() if record else None
    health = None
    if record:
        health = get_health_monitor()
        health.ensure_detector(QueueStallDetector())
        health.ensure_detector(SLOBurnRateDetector())
    t0 = time.perf_counter()

    def now() -> float:
        return time.perf_counter() - t0

    def due(i: int, t: Optional[float] = None) -> bool:
        """Whether arrival i is due at ``t`` (default: now)."""
        if i >= len(trace):
            return False
        if clock == "logical":
            return trace[i].arrival_q <= engine.scheduler.last_quantum_id
        return trace[i].arrival_s <= (now() if t is None else t)

    def admit(force: bool = False) -> None:
        nonlocal next_i
        t = now()  # one admission time: a request that falls due while the loop runs waits for the next call
        while next_i < len(trace) and (force or due(next_i, t)):
            a = trace[next_i]
            reqs[a.uid] = RaggedRequest(uid=a.uid, tokens=list(a.prompt), max_new_tokens=a.max_new_tokens)
            stats[a.uid].admitted = t
            results[a.uid] = []
            pending.append(reqs[a.uid])
            if record:
                # stamped with the SCHEDULED arrival: event-derived TTFT then equals (first_token - arrival)
                events.emit("enqueue", a.uid, ts=t0 + a.arrival_s, prompt=len(a.prompt))
            if journal is not None:
                # the scheduled arrival AND the scheduler's logical clock: replay re-admits by either
                journal.record_request(a.uid, a.prompt, arrival_s=a.arrival_s,
                                       arrival_q=engine.scheduler.last_quantum_id, max_new_tokens=a.max_new_tokens)
            next_i += 1
            force = False  # force admits exactly one

    def commit(uid: int, toks_out: List[int]) -> None:
        req = reqs[uid]
        # multi-token commits (bursts) clamp to the remaining request budget before anything is recorded
        toks_out = list(toks_out)[:req.max_new_tokens - len(results[uid])]
        if not toks_out:
            return
        if eos_token_id is not None and eos_token_id in toks_out:
            toks_out = toks_out[:toks_out.index(eos_token_id) + 1]
        if journal is not None:
            journal.record_commit(uid, engine.scheduler.last_quantum_id, toks_out)
        t = now()
        if not results[uid]:
            stats[uid].first_token = t
            if record:
                h_ttft.observe(t - stats[uid].arrival)
                events.emit("first_token", uid, ts=t0 + t)
        results[uid].extend(toks_out)
        stats[uid].n_new = len(results[uid])
        if (len(results[uid]) >= req.max_new_tokens or
                (eos_token_id is not None and toks_out[-1] == eos_token_id)):
            req.done = True
            stats[uid].done = t
            if record:
                if stats[uid].n_new > 1:
                    h_tpot.observe(stats[uid].tpot)
                events.emit("finish", uid, ts=t0 + t, n_new=stats[uid].n_new)
                health.observe_request(ttft_s=stats[uid].ttft, tpot_s=stats[uid].tpot)
            engine.flush([uid])
        else:
            decode_ready[uid] = toks_out[-1]

    fused = bool(getattr(engine, "_fused_enabled", False))
    spec_on = bool(getattr(engine, "_spec_enabled", False))

    while next_i < len(trace) or pending or decode_ready:
        admit()
        if health is not None:
            health.poll()
        if not pending and not decode_ready:
            if clock == "logical":
                admit(force=True)
            else:  # idle: sleep to the next arrival (open-loop source)
                time.sleep(max(0.0, trace[next_i].arrival_s - now()))
            continue
        arrivals_due = due(next_i)
        if spec_on and not pending and not arrivals_due and decode_ready:
            # draft -> verify over the pure-decode batch; a dry drafter falls through to the plain paths
            if engine._spec_quantum(decode_ready, prompts, results, reqs, commit):
                continue
        if fused:
            # one step per scheduler quantum; a pure-decode quantum with nothing due extends to a burst
            quantum = engine.scheduler.schedule_fused([r for r in pending if r.remaining_prefill],
                                                      list(decode_ready))
            if quantum.empty:
                raise RuntimeError("scheduler deadlock: no work schedulable (KV pool too small?)")
            for pf in quantum.prefills:
                reqs[pf.uid].tokens = reqs[pf.uid].tokens[len(pf.tokens):]
            steps = 1
            if quantum.decode_uids and not quantum.prefills and not pending and not arrivals_due:
                rem = min(reqs[u].max_new_tokens - len(results[u]) for u in quantum.decode_uids)
                steps = max(1, engine._burst_steps({u: True for u in quantum.decode_uids}, rem))
            carry = [decode_ready.pop(u) for u in quantum.decode_uids]
            rows = engine._run_fused(quantum, carry, steps, False, eos_token_id)
            for uid, row in rows.items():
                if row is not None:
                    commit(uid, row.tolist())
            pending = [r for r in pending if not r.done and r.remaining_prefill]
            continue
        if not pending and not arrivals_due and decode_ready:
            # everyone is decoding and nothing is due: K decode steps in one step function
            cap = min(engine.scheduler.max_sequences, engine.scheduler.max_batch_tokens)
            burst_uids = list(decode_ready)[:cap]
            rem = min(reqs[u].max_new_tokens - len(results[u]) for u in burst_uids)
            k = engine._burst_steps({u: decode_ready[u] for u in burst_uids}, rem)
            if k >= 2:
                toks = [decode_ready.pop(u) for u in burst_uids]
                out = engine._run_decode_burst(burst_uids, toks, k)
                for uid, row in zip(burst_uids, out):
                    commit(uid, row.tolist())
                continue
        step = engine.scheduler.schedule([r for r in pending if r.remaining_prefill], list(decode_ready))
        if step.empty:
            raise RuntimeError("scheduler deadlock: no work schedulable (KV pool too small?)")
        uids, toks = [], []
        for uid in step.decode_uids:
            uids.append(uid)
            toks.append([decode_ready.pop(uid)])
        for pf in step.prefills:
            req = reqs[pf.uid]
            uids.append(pf.uid)
            toks.append(pf.tokens)
            req.tokens = req.tokens[len(pf.tokens):]
        nxt = engine.put(uids, toks, return_tokens=True)
        for uid, tok in zip(uids, nxt):
            if reqs[uid].remaining_prefill:
                continue
            commit(uid, [int(tok)])
        pending = [r for r in pending if not r.done and r.remaining_prefill]

    for uid, toks in results.items():
        stats[uid].tokens = toks
    return results, [stats[a.uid] for a in trace]


def run_load(engine, spec: LoadSpec, eos_token_id: Optional[int] = None) -> List[RequestStat]:
    """Drive ``engine`` with ``spec``'s arrival process (``serve_trace`` on
    the wall clock, recorded); returns per-request stats in uid order.
    Greedy decoding (the SLA story is scheduling, not sampling). Starts the
    ops plane for the run when ``DS_TPU_OPS_PORT`` is set (a live SLA run is
    what an operator wants to scrape)."""
    maybe_start_ops_server()
    arrivals, prompts = load_prompts(spec)
    trace = [Arrival(uid=i, prompt=prompts[i], max_new_tokens=spec.max_new_tokens, arrival_s=float(arrivals[i]))
             for i in range(spec.n_requests)]
    journal = get_journal()
    if journal is not None:
        journal.begin_session(getattr(engine, "_journal_fingerprint", lambda: {})(), kind="sla",
                              run={"eos_token_id": eos_token_id}, load=dataclasses.asdict(spec))
    _, out = serve_trace(engine, trace, eos_token_id=eos_token_id, record=True)
    if journal is not None:
        summary = getattr(engine, "_journal_run_summary", lambda: {})()
        summary["sla"] = summarize(out)
        journal.end_session(summary)
    return out


def summarize(stats: Sequence[RequestStat], ttft_sla: float = 1.0, tpot_sla: float = 0.25) -> Dict:
    """Aggregate a run: throughput, latency percentiles, SLA misses. The
    default SLA is the FastGen blog's streaming standard: first token within
    1 s, then at least 4 tokens/s per request (TPOT <= 250 ms)."""
    ttfts = np.asarray([s.ttft for s in stats])
    tpots = np.asarray([s.tpot for s in stats if s.n_new > 1])
    total_new = int(sum(s.n_new for s in stats))
    span = max(s.done for s in stats) - min(s.arrival for s in stats)
    miss = np.asarray([(s.ttft > ttft_sla) or (s.n_new > 1 and s.tpot > tpot_sla) for s in stats])

    def pct(a, q):
        return float(np.percentile(a, q)) if a.size else 0.0

    return {
        "n_requests": len(stats),
        "tokens_per_sec": round(total_new / max(span, 1e-9), 2),
        "requests_per_sec": round(len(stats) / max(span, 1e-9), 3),
        "ttft_p50_s": round(pct(ttfts, 50), 4),
        "ttft_p95_s": round(pct(ttfts, 95), 4),
        "ttft_p99_s": round(pct(ttfts, 99), 4),
        "tpot_p50_s": round(pct(tpots, 50), 4),
        "tpot_p95_s": round(pct(tpots, 95), 4),
        "sla_miss_frac": round(float(miss.mean()), 4),
    }


def sweep(engine, rates: Sequence[float], base: Optional[LoadSpec] = None, ttft_sla: float = 1.0,
          tpot_sla: float = 0.25) -> List[Dict]:
    """The throughput-latency table: one ``summarize`` row per arrival rate
    (the FastGen blog's table shape). The engine's KV pool is reused across
    rows; each row waits for full drain, so rows are independent. With
    accounting on, each row also carries the model FLOPs attributed in its
    wall window, the MFU they make over it (None without a known peak) and
    the goodput fraction."""
    base = base or LoadSpec()
    acct = get_perf_accountant()
    rows = []
    for rate in rates:
        spec = dataclasses.replace(base, arrival_rate=float(rate))
        before = acct.totals() if acct.enabled else None
        t0 = time.perf_counter()
        row = summarize(run_load(engine, spec), ttft_sla=ttft_sla, tpot_sla=tpot_sla)
        if before is not None:
            dt = time.perf_counter() - t0
            after = acct.totals()
            flops = after["flops"] - before["flops"]
            slot = after["slot_tokens"] - before["slot_tokens"]
            mfu = acct.mfu(flops=flops, time_s=dt)
            row["model_flops"] = int(flops)
            row["mfu"] = round(mfu, 4) if mfu is not None else None
            row["goodput_fraction"] = round((after["useful_tokens"] - before["useful_tokens"]) / slot, 4) if slot else 0.0
        row["arrival_rate"] = float(rate)
        rows.append(row)
    return rows


def effective_throughput_at_sla(rows: Sequence[Dict], max_miss: float = 0.01) -> float:
    """The headline scalar: the best tokens/s among rows meeting the SLA
    (FastGen's "effective throughput" at <= 1 % SLA misses)."""
    ok = [r["tokens_per_sec"] for r in rows if r["sla_miss_frac"] <= max_miss]
    return max(ok) if ok else 0.0
