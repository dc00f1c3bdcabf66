"""Black-box serving journal: everything needed to re-run a session.

Port of ``deepspeed_tpu/telemetry/journal.py``: the same JSONL schema, so a
journal either package records reads the same here and replays on the port
(``inference/v2/replay.py``). A recording session is an append-only stream
of five record kinds:

``session``
    written at :meth:`Journal.begin_session`: engine fingerprint (model
    config, KV pool geometry, loop flags), the resolved knob registry
    (:func:`resolved_knobs`), the step-function signatures, the run
    arguments (``generate`` args or the SLA ``LoadSpec``), and any caller
    metadata (``Journal.meta``, e.g. a ``param_seed`` for synthetic
    workloads).
``request``
    one per admitted request: uid, prompt tokens, scheduled arrival
    (seconds since session start), the scheduler quantum id current at
    admission (``arrival_q``, the *logical* clock replay uses), and the
    request budget.
``quantum``
    one per scheduler quantum: the decode uids and
    ``(uid, start, len, final)`` prefill chunks that composed it, plus a
    composition digest: two runs scheduled identically produce identical
    quantum digest streams.
``commit``
    one per host-side token commit: uid, the quantum it committed
    under, the committed tokens, and a rolling per-request sha256
    digest, the replay oracle's token-exact equality witness.
``end``
    session close: per-request final digests/counts and a run summary
    (step counter, SLA percentiles when the SLA harness recorded them),
    the baseline side of a what-if comparison.

Recording is gated on ``DS_TPU_JOURNAL`` (files land under
``DS_TPU_JOURNAL_DIR``); a :class:`Journal` built with ``path=None``
keeps records in memory, so the determinism audit and tests record and
replay without touching disk.
"""

import contextlib
import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..analysis import knobs
from .registry import get_registry

JOURNAL_SCHEMA = 1
DEFAULT_TAIL = 256  # records kept in memory for flight captures and GET /journal


def resolved_knobs() -> Dict:
    """The declared knob registry with each knob's resolved value: exactly
    the configuration in effect (a copy of the reference's
    ``telemetry/flight.py`` helper over the port's knob registry)."""
    out: Dict[str, Dict] = {}
    for name, k in sorted(knobs.all_knobs().items()):
        out[name] = {"value": knobs.get_str(name), "default": k.default, "kind": k.kind,
                     "set": knobs.is_set(name), "owner": k.owner}
    return out


def _digest(payload) -> str:
    """Stable short digest of a JSON-able payload (composition digests)."""
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True, default=str).encode()).hexdigest()[:16]


def roll_digest(prev: str, tokens: List[int]) -> str:
    """Rolling per-request token digest: fold one commit's tokens into
    the previous digest. Token-exact: any substitution, reorder, or
    re-chunking that changes the committed stream changes the digest."""
    body = prev + ":" + ",".join(str(int(t)) for t in tokens)
    return hashlib.sha256(body.encode()).hexdigest()[:16]


class Journal:
    """Append-only session recorder.

    ``path=None`` records to memory only (``self.records``); with a path
    every record is also written as one JSONL line (buffered; flushed at
    ``end_session``/``close``). All ``record_*`` methods no-op unless a
    session is active, so production call sites stay one attribute check
    when recording is attached but idle.
    """

    def __init__(self, path: Optional[str] = None, tail: int = DEFAULT_TAIL, registry=None):
        self.path = str(path) if path else None
        self.meta: Dict = {}  # caller metadata merged into the next session record
        self.active = False
        self.records: List[Dict] = []  # memory mode only (path=None)
        self._tail = deque(maxlen=max(1, int(tail)))
        self._file = None
        self._lock = threading.Lock()
        self._session_seq = 0
        self._t0 = 0.0
        self._digests: Dict[int, str] = {}
        self._counts: Dict[int, int] = {}
        reg = registry if registry is not None else get_registry()
        self._m_records = reg.counter("journal_records_total")
        self._m_bytes = reg.counter("journal_bytes_total")
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._file = open(self.path, "a")

    # ----------------------------------------------------------- writing
    def _write(self, rec: Dict) -> None:
        line = json.dumps(rec, sort_keys=True, default=str)
        with self._lock:
            self._tail.append(rec)
            if self._file is not None:
                self._file.write(line + "\n")
            else:
                self.records.append(rec)
        self._m_records.inc()
        self._m_bytes.inc(len(line) + 1)

    def begin_session(self, fingerprint: Optional[Dict] = None, kind: str = "run",
                      run: Optional[Dict] = None, load: Optional[Dict] = None) -> int:
        """Open a new session (implicitly closing any prior one's state)."""
        self._session_seq += 1
        self.active = True
        self._t0 = time.perf_counter()
        self._digests = {}
        self._counts = {}
        rec = {"kind": "session", "schema": JOURNAL_SCHEMA, "seq": self._session_seq,
               "ts_unix": time.time(), "session_kind": kind}
        if run is not None:
            rec["run"] = run
        if load is not None:
            rec["load"] = load
        if self.meta:
            rec["meta"] = dict(self.meta)
        rec.update(fingerprint or {})
        self._write(rec)
        return self._session_seq

    def record_request(self, uid: int, prompt: List[int], arrival_s: float = 0.0,
                       arrival_q: int = 0, max_new_tokens: int = 0, **extra) -> None:
        if not self.active:
            return
        rec = {"kind": "request", "uid": int(uid), "prompt": [int(t) for t in prompt],
               "arrival_s": float(arrival_s), "arrival_q": int(arrival_q),
               "max_new_tokens": int(max_new_tokens)}
        if extra:
            rec.update(extra)
        self._write(rec)

    def record_quantum(self, q: int, decode_uids: List[int],
                       prefills: List, **extra) -> None:
        """One scheduler quantum's composition. ``prefills`` is a list of
        ``(uid, start, len, final)`` tuples."""
        if not self.active:
            return
        comp = {"decodes": [int(u) for u in decode_uids],
                "prefills": [[int(u), int(s), int(n), bool(f)] for u, s, n, f in prefills]}
        rec = {"kind": "quantum", "q": int(q), "digest": _digest(comp)}
        rec.update(comp)
        if extra:
            rec.update(extra)
        self._write(rec)

    def record_commit(self, uid: int, q: int, tokens: List[int]) -> Optional[str]:
        """Fold one committed token run into the request's rolling digest."""
        if not self.active:
            return None
        uid = int(uid)
        toks = [int(t) for t in tokens]
        d = roll_digest(self._digests.get(uid, ""), toks)
        self._digests[uid] = d
        self._counts[uid] = self._counts.get(uid, 0) + len(toks)
        self._write({"kind": "commit", "uid": uid, "q": int(q), "tokens": toks,
                     "n": self._counts[uid], "digest": d,
                     "ts": round(time.perf_counter() - self._t0, 6)})
        return d

    def end_session(self, summary: Optional[Dict] = None) -> None:
        if not self.active:
            return
        self.active = False
        rec = {"kind": "end", "seq": self._session_seq, "ts_unix": time.time(),
               "wall_s": round(time.perf_counter() - self._t0, 6),
               "digests": {str(u): d for u, d in sorted(self._digests.items())},
               "counts": {str(u): n for u, n in sorted(self._counts.items())}}
        if summary:
            rec["summary"] = summary
        self._write(rec)
        with self._lock:
            if self._file is not None:
                self._file.flush()

    def close(self) -> None:
        self.end_session()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    # ----------------------------------------------------------- queries
    def has_commits(self, uid: int) -> bool:
        return int(uid) in self._counts

    def digest(self, uid: int) -> Optional[str]:
        return self._digests.get(int(uid))

    def tail(self, n: int = 64) -> List[Dict]:
        with self._lock:
            return list(self._tail)[-max(0, int(n)):]

    def manifest_section(self, tail: int = 64) -> Dict:
        """Bounded summary for flight manifests and ``GET /journal``."""
        return {"enabled": True, "path": self.path, "active": self.active,
                "sessions_total": self._session_seq,
                "records_total": get_registry().peek("journal_records_total") or 0.0,
                "bytes_total": get_registry().peek("journal_bytes_total") or 0.0,
                "tail": self.tail(tail)}


# ------------------------------------------------------------- singleton

_JOURNAL: Optional[Journal] = None
_RESOLVED = False
_LOCK = threading.Lock()


def get_journal() -> Optional[Journal]:
    """The process-wide journal, or None when recording is off.

    Knob-gated on first call: ``DS_TPU_JOURNAL=1`` creates a per-process
    JSONL file under ``DS_TPU_JOURNAL_DIR``. ``set_journal`` overrides
    (tests, the replay harness)."""
    global _JOURNAL, _RESOLVED
    if _RESOLVED:
        return _JOURNAL
    with _LOCK:
        if not _RESOLVED:
            if knobs.get_bool("DS_TPU_JOURNAL"):
                jdir = knobs.get_str("DS_TPU_JOURNAL_DIR") or "journals"
                _JOURNAL = Journal(os.path.join(jdir, f"journal-{os.getpid()}.jsonl"))
            _RESOLVED = True
    return _JOURNAL


def set_journal(j: Optional[Journal]) -> None:
    """Install ``j`` as the process journal (None turns recording off).
    Explicit installation wins over the knob gate."""
    global _JOURNAL, _RESOLVED
    _JOURNAL = j
    _RESOLVED = True


@contextlib.contextmanager
def journal_override(j: Optional[Journal]):
    """Scoped ``set_journal``: the replay harness re-drives engines with
    recording muted (or redirected to a capture journal) and restores the
    previous journal on exit."""
    global _JOURNAL, _RESOLVED
    prev, prev_resolved = _JOURNAL, _RESOLVED
    set_journal(j)
    try:
        yield j
    finally:
        _JOURNAL, _RESOLVED = prev, prev_resolved


# --------------------------------------------------------------- reading

class Session:
    """One recorded session parsed out of a journal stream."""

    def __init__(self, header: Dict):
        self.header = header
        self.requests: Dict[int, Dict] = {}
        self.quanta: List[Dict] = []
        self.commits: List[Dict] = []
        self.end: Optional[Dict] = None

    @property
    def kind(self) -> str:
        return str(self.header.get("session_kind", "run"))

    def tokens_by_uid(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {int(u): [] for u in self.requests}
        for c in self.commits:
            out.setdefault(int(c["uid"]), []).extend(int(t) for t in c["tokens"])
        return out

    def digests(self) -> Dict[int, str]:
        """Final per-request digest: the end record when present, else
        recomputed from the commit stream."""
        if self.end and self.end.get("digests"):
            return {int(u): d for u, d in self.end["digests"].items()}
        out: Dict[int, str] = {}
        for c in self.commits:
            uid = int(c["uid"])
            out[uid] = roll_digest(out.get(uid, ""), c["tokens"])
        return out

    def quantum_of_commit(self, uid: int, pos: int) -> Optional[int]:
        """The quantum id of the commit that produced token ``pos`` of
        request ``uid`` (divergence pinpointing)."""
        seen = 0
        for c in self.commits:
            if int(c["uid"]) != int(uid):
                continue
            seen += len(c["tokens"])
            if pos < seen:
                return int(c.get("q", -1))
        return None


def sessions_from_records(records: List[Dict]) -> List[Session]:
    out: List[Session] = []
    cur: Optional[Session] = None
    for rec in records:
        kind = rec.get("kind")
        if kind == "session":
            cur = Session(rec)
            out.append(cur)
            continue
        if cur is None:
            continue  # torn head: records before the first session header
        if kind == "request":
            cur.requests[int(rec["uid"])] = rec
        elif kind == "quantum":
            cur.quanta.append(rec)
        elif kind == "commit":
            cur.commits.append(rec)
        elif kind == "end":
            cur.end = rec
    return out


def read_journal(path: str) -> List[Session]:
    """Parse a journal file into its sessions (malformed lines — a torn
    final write from a crashed recorder — are skipped, not fatal)."""
    records: List[Dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except ValueError:
                continue
    return sessions_from_records(records)
