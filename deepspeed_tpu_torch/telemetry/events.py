"""Structured request-lifecycle event log.

Port of ``deepspeed_tpu/telemetry/events.py`` (framework-free, the same
event schema and derivations). Aggregate counters (registry) answer "how
much"; this log answers "what happened to request N, in order". Every
serving request leaves an append-only timeline

    enqueue -> admit(hit) -> prefill_chunk(q, tokens)* -> first_token
            -> decode(q, k)* -> finish(n_new)

plus out-of-band ``quantum`` / ``cow`` / ``evict`` / ``spill`` /
``readmit`` / ``alert`` records, emitted from the scheduler, the engine's
dispatch and commit sites, the ragged state manager, the prefix cache, the
SLA harness and the health monitor. Listeners (``add_listener``: the
health monitor) see every emit. Design constraints mirror the registry:

- **hot-path cheap**: an enabled ``emit`` is one attribute check, one
  dict build, and one bounded ``deque.append``; no event reads a device
  value;
- **off the hot path for durability**: the optional JSONL sink
  (``DS_TPU_EVENT_LOG=<path>``) feeds a bounded queue drained by a
  daemon thread, so the emitter never touches the filesystem. Default is
  ring-only;
- **derivable**: ``request_timelines`` / ``request_metrics`` /
  ``latency_summary`` reconstruct per-request queue/prefill/decode time
  splits and per-request TTFT/TPOT percentiles from the raw events;
  ``lifecycle_signature`` collapses burst ladders so fused and unfused
  runs of the same workload compare equal.

Env knobs: ``DS_TPU_EVENT_RING`` sizes the ring (default 65536),
``DS_TPU_EVENT_LOG`` enables the JSONL sink, ``DS_TPU_TELEMETRY=0``
disables emission entirely.
"""

import atexit
import json
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..analysis import knobs
from .registry import get_registry

# kinds that belong to a request's lifecycle state machine, in legal order
LIFECYCLE_KINDS = ("enqueue", "admit", "prefill_chunk", "first_token",
                   "decode", "finish")
_LIFECYCLE_ORDER = {k: i for i, k in enumerate(LIFECYCLE_KINDS)}

_SINK_SENTINEL = object()


class EventLog:
    """Bounded in-memory event ring with an optional JSONL drain thread.

    One process-wide instance via ``get_event_log()``; direct
    construction is for tests. Events are flat dicts
    ``{"ts", "kind", "uid", **attrs}`` — ``uid < 0`` marks global
    (non-request) records.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 sink_path: Optional[str] = None, sink_queue: int = 8192,
                 registry=None):
        self.enabled = enabled  # plain attribute: this IS the hot-path check
        self._ring = deque(maxlen=max(1, int(capacity)))
        reg = registry if registry is not None else get_registry()
        self._m_emitted = reg.counter("telemetry_events_total")
        self._m_dropped = reg.counter("telemetry_events_dropped_total")
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._sink_path: Optional[str] = None
        self._sink_queue = int(sink_queue)
        self._atexit_registered = False
        self._listeners: List[Callable] = []
        if sink_path:
            self.open_sink(sink_path)

    # ---------------------------------------------------------- emission
    def emit(self, kind: str, uid: int = -1, ts: Optional[float] = None,
             **attrs) -> None:
        """Record one event. ``ts`` defaults to ``time.perf_counter()``;
        pass it explicitly when the semantic time of the event (e.g. a
        scheduled arrival) differs from the emission time."""
        if not self.enabled:
            return
        if ts is None:
            ts = time.perf_counter()
        ev = {"ts": ts, "kind": kind, "uid": uid}
        if attrs:
            ev.update(attrs)
        ring = self._ring
        if len(ring) == ring.maxlen:
            self._m_dropped.inc()
        ring.append(ev)
        self._m_emitted.inc()
        q = self._queue
        if q is not None:
            try:
                q.put_nowait(ev)
            except queue.Full:
                self._m_dropped.inc()
        for fn in self._listeners:
            try:
                fn(ts, kind, uid, attrs)
            except Exception:
                pass  # telemetry must never take down the serving loop

    # --------------------------------------------------------- listeners
    def add_listener(self, fn: Callable) -> None:
        """Register ``fn(ts, kind, uid, attrs)``, called on every emit
        (synchronously: keep it cheap; the HealthMonitor uses this)."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    # -------------------------------------------------------- JSONL sink
    def open_sink(self, path: str) -> None:
        """Start draining events to ``path`` (JSONL, append) on a daemon
        thread. The emitter only ever does a non-blocking queue put."""
        self.close_sink()
        self._sink_path = str(path)
        self._queue = queue.Queue(maxsize=self._sink_queue)
        if not self._atexit_registered:
            # short-lived runs exit before the daemon drain thread empties
            # its queue: flush+join at interpreter shutdown so the last
            # events reach disk. close_sink is idempotent, so one
            # registration covers any number of open/close cycles.
            atexit.register(self.close_sink)
            self._atexit_registered = True
        self._thread = threading.Thread(
            target=self._drain, name="ds-tpu-event-log", daemon=True)
        self._thread.start()

    def close_sink(self, timeout: float = 5.0) -> None:
        """Flush and stop the drain thread (idempotent)."""
        q, t = self._queue, self._thread
        self._queue = None
        self._thread = None
        if q is not None:
            q.put(_SINK_SENTINEL)
        if t is not None:
            t.join(timeout)

    def _drain(self) -> None:
        q, path = self._queue, self._sink_path
        try:
            f = open(path, "a")
        except OSError:
            self._queue = None
            return
        with f:
            while True:
                item = q.get()
                if item is _SINK_SENTINEL:
                    f.flush()
                    return
                f.write(json.dumps(item) + "\n")
                if q.empty():
                    f.flush()

    # ---------------------------------------------------------- reading
    def events(self, uid: Optional[int] = None,
               kind: Optional[str] = None) -> List[Dict]:
        """Snapshot of the ring, oldest first, optionally filtered."""
        out = list(self._ring)
        if uid is not None:
            out = [e for e in out if e.get("uid") == uid]
        if kind is not None:
            out = [e for e in out if e.get("kind") == kind]
        return out

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()


_EVENT_LOG: Optional[EventLog] = None


def get_event_log() -> EventLog:
    """The process-wide event log. Env knobs: ``DS_TPU_EVENT_RING`` sizes
    the ring, ``DS_TPU_EVENT_LOG=<path>`` adds the JSONL sink,
    ``DS_TPU_TELEMETRY=0`` disables."""
    global _EVENT_LOG
    if _EVENT_LOG is None:
        path = knobs.get_str("DS_TPU_EVENT_LOG", "")
        _EVENT_LOG = EventLog(
            capacity=knobs.get_int("DS_TPU_EVENT_RING"),
            enabled=knobs.get_bool("DS_TPU_TELEMETRY"),
            sink_path=None if path in ("", "0") else path,
        )
    return _EVENT_LOG


# ------------------------------------------------------------ derivation

def request_timelines(events: List[Dict]) -> Dict[int, List[List[Dict]]]:
    """Group events into per-uid timelines. A new timeline opens at each
    ``enqueue`` (uids are reused across generate calls); events for a uid
    with no open timeline (ring partially overwritten) are dropped."""
    out: Dict[int, List[List[Dict]]] = {}
    open_tl: Dict[int, List[Dict]] = {}
    for e in events:
        uid = e.get("uid", -1)
        if uid is None or uid < 0:
            continue
        if e.get("kind") == "enqueue":
            tl: List[Dict] = []
            out.setdefault(uid, []).append(tl)
            open_tl[uid] = tl
        else:
            tl = open_tl.get(uid)
            if tl is None:
                continue
        tl.append(e)
    return out


def validate_timeline(timeline: List[Dict]) -> List[str]:
    """Lifecycle sanity check: returns a list of problems (empty == a
    complete, monotonically-timestamped enqueue->finish timeline)."""
    problems: List[str] = []
    if not timeline:
        return ["empty timeline"]
    if timeline[0].get("kind") != "enqueue":
        problems.append("does not start with enqueue")
    last_ts = None
    seen = set()
    for e in timeline:
        kind, ts = e.get("kind"), e.get("ts")
        if last_ts is not None and ts < last_ts:
            problems.append(f"timestamp regression at {kind!r}")
        last_ts = ts
        if kind not in _LIFECYCLE_ORDER:
            continue  # cow / custom records ride along without ordering
        if kind in ("enqueue", "admit", "first_token", "finish"):
            if kind in seen:
                problems.append(f"duplicate {kind!r}")
        if kind == "prefill_chunk" and "first_token" in seen:
            problems.append("prefill_chunk after first_token")
        if kind == "decode" and "first_token" not in seen:
            problems.append("decode before first_token")
        if kind != "enqueue" and "enqueue" not in seen:
            problems.append(f"{kind!r} before enqueue")
        seen.add(kind)
    for kind in ("enqueue", "admit", "first_token", "finish"):
        if kind not in seen:
            problems.append(f"missing {kind!r}")
    return problems


def lifecycle_signature(timeline: List[Dict]) -> tuple:
    """Burst-invariant event sequence: lifecycle kinds in order, with
    consecutive ``decode`` records merged into one ``("decode", total_k)``
    entry — a fused K-step burst and K unfused single steps collapse to
    the same signature, so fused vs unfused runs compare equal."""
    sig: List[tuple] = []
    for e in timeline:
        kind = e.get("kind")
        if kind not in _LIFECYCLE_ORDER:
            continue
        if kind == "decode":
            k = int(e.get("k", 1))
            if sig and sig[-1][0] == "decode":
                sig[-1] = ("decode", sig[-1][1] + k)
            else:
                sig.append(("decode", k))
        elif kind == "prefill_chunk":
            sig.append(("prefill_chunk", int(e.get("tokens", 0))))
        elif kind == "admit":
            sig.append(("admit", int(e.get("hit", 0))))
        else:
            sig.append((kind,))
    return tuple(sig)


def request_metrics(timeline: List[Dict]) -> Optional[Dict[str, float]]:
    """Per-request latency split derived from one timeline, or None if
    the timeline is incomplete. ``queue_s`` is enqueue->admit,
    ``prefill_s`` admit->first_token, ``decode_s`` first_token->finish;
    ``tpot_s`` uses the finish record's ``n_new``."""
    ts_by: Dict[str, float] = {}
    n_new = None
    accepted = proposed = 0
    spec_steps = 0
    for e in timeline:
        kind = e.get("kind")
        if kind in ("enqueue", "admit", "first_token", "finish") and kind not in ts_by:
            ts_by[kind] = e["ts"]
            if kind == "finish":
                n_new = e.get("n_new")
        elif kind == "decode" and "accepted" in e:
            # speculative decode events carry draft accounting
            accepted += int(e.get("accepted", 0))
            proposed += int(e.get("proposed", 0))
            spec_steps += 1
    if not {"enqueue", "first_token", "finish"} <= set(ts_by):
        return None
    enq = ts_by["enqueue"]
    admit = ts_by.get("admit", enq)
    first, done = ts_by["first_token"], ts_by["finish"]
    n_new = int(n_new) if n_new else 1
    out = {
        "queue_s": admit - enq,
        "prefill_s": first - admit,
        "decode_s": done - first,
        "ttft_s": first - enq,
        "tpot_s": (done - first) / (n_new - 1) if n_new > 1 else 0.0,
        "total_s": done - enq,
        "n_new": float(n_new),
    }
    if spec_steps:
        out["accepted_tokens"] = float(accepted)
        out["proposed_tokens"] = float(proposed)
    return out


def _percentile(values: List[float], q: float) -> float:
    """Linear-interpolated percentile (numpy's default), numpy-free."""
    if not values:
        return 0.0
    s = sorted(values)
    if len(s) == 1:
        return float(s[0])
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


def latency_summary(events: List[Dict]) -> Dict[str, float]:
    """True per-request TTFT/TPOT percentiles + queue-time fraction over
    every complete timeline in ``events``."""
    timelines = request_timelines(events)
    metrics = []
    for tls in timelines.values():
        for tl in tls:
            m = request_metrics(tl)
            if m is not None:
                metrics.append(m)
    ttfts = [m["ttft_s"] for m in metrics]
    tpots = [m["tpot_s"] for m in metrics if m["n_new"] > 1]
    total = sum(m["total_s"] for m in metrics)
    queued = sum(m["queue_s"] for m in metrics)
    return {
        "n_requests": float(len(timelines)),
        "n_complete": float(len(metrics)),
        "ttft_p50_s": _percentile(ttfts, 50.0),
        "ttft_p99_s": _percentile(ttfts, 99.0),
        "tpot_p50_s": _percentile(tpots, 50.0),
        "tpot_p99_s": _percentile(tpots, 99.0),
        "queue_time_fraction": (queued / total) if total > 0 else 0.0,
    }
