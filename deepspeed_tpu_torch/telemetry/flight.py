"""Anomaly-triggered flight recorder: the serving/training black box.

Port of ``deepspeed_tpu/telemetry/flight.py``. A ``FlightRecorder``
registers as a :class:`~.health.HealthMonitor` sink: the moment any
detector fires (NaN loss, queue stall, SLO burn, HBM pressure, ...) it
snapshots everything an operator needs for a post-mortem into a bounded
on-disk capture ring under ``DS_TPU_FLIGHT_DIR``:

- the last-K request-lifecycle events and span-tracer tail,
- the full metrics snapshot (rank-stamped) and PerfAccountant snapshot
  (cost cards, roofline, goodput ledger, HBM pools),
- allocator / prefix-cache / host-tier residency and the step-cache view
  via engine-registered providers,
- the resolved knob registry: the exact configuration that produced the
  anomaly,
- optionally (``DS_TPU_FLIGHT_PROFILE_S>0``) a ``torch.profiler`` trace of
  the next few seconds (``profiler.start_trace``, the device profiler's
  seam: one session a process, so a window that cannot start is skipped),
  so the quanta *after* the anomaly are profiled; when the window closes
  the trace is parsed into a waterfall summary and linked from the
  manifest's ``profile`` section (relative ``dir``), with the raw directory
  size-bounded by ``DS_TPU_FLIGHT_PROFILE_MAX_MB`` (dropped-and-counted on
  overflow: the summary always survives).

Captures are directories ``capture-<seq>-<reason>/manifest.json``
(+ ``profile/``), written to a temp name and renamed so readers (the ops
plane's ``/flight`` endpoints) never see a half-written manifest. Manual
trigger: ``flight.capture(reason)`` in-process or ``POST /flight/capture``
on the ops plane. Every section is collected best-effort: a failing
provider records an error string instead of killing the capture, and the
sink contract already guarantees a broken recorder cannot take down
serving.
"""

import json
import os
import re
import shutil
import threading
import time
from typing import Callable, Dict, List, Optional

from ..analysis import knobs
from .journal import resolved_knobs

_REASON_RE = re.compile(r"[^a-z0-9_]+")
_CAPTURE_RE = re.compile(r"^capture-(\d{5})-([a-z0-9_]+)$")

MANIFEST_SCHEMA = 1
DEFAULT_EVENT_TAIL = 2048
DEFAULT_SPAN_TAIL = 512


def knob_provenance() -> Dict[str, str]:
    """Per-knob source of the resolved value ('env' | 'default'): how
    ``/varz`` attributes a knob."""
    return {name: knobs.provenance(name) for name in sorted(knobs.all_knobs())}


def tuned_profile_section() -> Dict:
    """The active tuned profile as captures and ``/varz`` report it. The
    port has no tuned-profile overlay (the reference's ``autotune/``), so
    this is always ``{"active": False}``."""
    return {"active": False}


def _safe(section: Callable[[], object]):
    try:
        return section()
    except Exception as e:  # capture must survive any broken source
        return {"error": f"{type(e).__name__}: {e}"}


class FlightRecorder:
    """Bounded on-disk capture ring; callable so it plugs straight into
    ``HealthMonitor.add_sink``. Direct construction is for tests —
    production wiring goes through ``maybe_attach_flight_recorder``."""

    def __init__(self, flight_dir: str, max_captures: Optional[int] = None,
                 profile_s: Optional[float] = None,
                 event_tail: int = DEFAULT_EVENT_TAIL,
                 span_tail: int = DEFAULT_SPAN_TAIL):
        self.flight_dir = str(flight_dir)
        self.max_captures = int(max_captures if max_captures is not None
                                else knobs.get_int("DS_TPU_FLIGHT_MAX"))
        self.profile_s = float(profile_s if profile_s is not None
                               else knobs.get_float("DS_TPU_FLIGHT_PROFILE_S"))
        self.event_tail = int(event_tail)
        self.span_tail = int(span_tail)
        self._providers: Dict[str, Callable[[], object]] = {}
        self._lock = threading.Lock()
        self._profiling = False
        os.makedirs(self.flight_dir, exist_ok=True)

    # ------------------------------------------------------------ wiring
    def register_provider(self, name: str, fn: Callable[[], object]) -> None:
        """Attach a manifest section source (engines register residency
        and step-cache summaries here). Last registration per name wins:
        a rebuilt engine replaces its predecessor's closures."""
        self._providers[name] = fn

    def __call__(self, alert) -> None:
        """HealthMonitor sink protocol."""
        self.capture(reason=getattr(alert, "detector", "alert"),
                     alert=_safe(alert.as_dict) if hasattr(alert, "as_dict") else None)

    # ----------------------------------------------------------- capture
    def capture(self, reason: str = "manual", alert: Optional[Dict] = None) -> str:
        """Snapshot the black box now; returns the capture directory."""
        reason = _REASON_RE.sub("_", str(reason).lower()).strip("_") or "manual"
        manifest = self._collect(reason, alert)
        with self._lock:
            seq = self._next_seq()
            name = f"capture-{seq:05d}-{reason}"
            final = os.path.join(self.flight_dir, name)
            tmp = os.path.join(self.flight_dir, f".tmp-{seq:05d}")
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True, default=str)
            os.replace(tmp, final)
            self._evict()
        if self.profile_s > 0:
            self._start_profile(final)
        return final

    def _collect(self, reason: str, alert: Optional[Dict]) -> Dict:
        from .agg import rank_stamp
        from .costs import get_perf_accountant
        from .events import get_event_log
        from .health import get_health_monitor
        from .registry import get_registry
        from .tracing import get_tracer
        manifest = {
            "schema": MANIFEST_SCHEMA,
            "reason": reason,
            "ts_unix": time.time(),
            "rank": _safe(rank_stamp),
            "alert": alert,
            "alerts_recent": _safe(lambda: [a.as_dict() for a in
                                            get_health_monitor().alerts()]),
            "events_tail": _safe(lambda: get_event_log().events()[-self.event_tail:]),
            "spans_tail": _safe(lambda: get_tracer().spans()[-self.span_tail:]),
            "metrics": _safe(lambda: get_registry().snapshot()),
            "perf": _safe(lambda: get_perf_accountant().snapshot()),
            "knobs": _safe(resolved_knobs),
            "knob_provenance": _safe(knob_provenance),
            "tuned_profile": _safe(tuned_profile_section),
            "journal": _safe(self._journal_section),
        }
        for name, fn in sorted(self._providers.items()):
            manifest[name] = _safe(fn)
        return manifest

    @staticmethod
    def _journal_section() -> Dict:
        """Journal tail in the capture: when recording is on, the black
        box carries the last records needed to replay the incident."""
        from .journal import get_journal
        journal = get_journal()
        if journal is None:
            return {"enabled": False}
        return journal.manifest_section()

    def _next_seq(self) -> int:
        seq = 0
        for entry in os.listdir(self.flight_dir):
            m = _CAPTURE_RE.match(entry)
            if m:
                seq = max(seq, int(m.group(1)) + 1)
        return seq

    def _evict(self) -> None:
        entries = sorted(e for e in os.listdir(self.flight_dir)
                         if _CAPTURE_RE.match(e))
        for stale in entries[:max(0, len(entries) - self.max_captures)]:
            shutil.rmtree(os.path.join(self.flight_dir, stale),
                          ignore_errors=True)

    # ----------------------------------------------------------- profile
    def _start_profile(self, capture_dir: str) -> None:
        """Opt-in post-anomaly trace window; at most one at a time. The
        device profiler's ``open_window`` starts it at the next quantum
        boundary and closes it at the first one ``profile_s`` later (a
        ``torch.profiler`` session lives on the thread that serves or
        trains); its waterfall summary and the raw trace, size-bounded by
        ``DS_TPU_FLIGHT_PROFILE_MAX_MB`` (drop-and-count on overflow), are
        linked from ``manifest.json`` by relative path: a capture is never
        left holding an unreferenced trace dir."""
        from .profiler import open_window

        with self._lock:
            if self._profiling:
                return
            self._profiling = True

        def done(summary: Dict) -> None:
            try:
                self._finish_profile(capture_dir, summary)
            finally:
                with self._lock:
                    self._profiling = False

        open_window(capture_dir, "profile", self.profile_s, done)

    def _finish_profile(self, capture_dir: str, summary: Dict) -> None:
        """Bound the landed trace and link it and its summary in the manifest."""
        from .profiler import dir_bytes
        profile_dir = os.path.join(capture_dir, "profile")
        max_bytes = int(knobs.get_float("DS_TPU_FLIGHT_PROFILE_MAX_MB") * (1 << 20))
        section: Dict = {"window_s": self.profile_s, "max_bytes": max_bytes, "summary": summary}
        nbytes = dir_bytes(profile_dir) if os.path.isdir(profile_dir) else 0
        if nbytes > max_bytes:
            # over budget: keep the parsed summary, drop the raw trace
            shutil.rmtree(profile_dir, ignore_errors=True)
            section.update(dir=None, bytes=nbytes, dropped=True)
        else:
            section.update(dir="profile" if nbytes else None, bytes=nbytes, dropped=False)
        path = os.path.join(capture_dir, "manifest.json")
        with self._lock:
            try:
                with open(path) as f:
                    manifest = json.load(f)
            except (OSError, ValueError):
                return  # capture already evicted
            manifest["profile"] = section
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True, default=str)
            os.replace(tmp, path)

    # ----------------------------------------------------------- reading
    def captures(self) -> List[Dict]:
        """Newest-first capture listing for ``GET /flight``."""
        out: List[Dict] = []
        for entry in sorted(os.listdir(self.flight_dir), reverse=True):
            m = _CAPTURE_RE.match(entry)
            if not m:
                continue
            info = {"name": entry, "seq": int(m.group(1)),
                    "reason": m.group(2),
                    "path": os.path.join(self.flight_dir, entry)}
            try:
                with open(os.path.join(info["path"], "manifest.json")) as f:
                    head = json.load(f)
                info["ts_unix"] = head.get("ts_unix")
            except Exception:
                info["ts_unix"] = None
            out.append(info)
        return out

    def read_manifest(self, name: str) -> Optional[Dict]:
        """Manifest of one capture by directory name (``GET /flight/<name>``);
        None for unknown/malformed names — never path traversal."""
        if not _CAPTURE_RE.match(name):
            return None
        path = os.path.join(self.flight_dir, name, "manifest.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_flight_recorder() -> Optional[FlightRecorder]:
    """The configured process-wide recorder, or None when
    ``DS_TPU_FLIGHT_DIR`` is unset (the feature is off by default)."""
    global _RECORDER
    if _RECORDER is None:
        flight_dir = knobs.get_str("DS_TPU_FLIGHT_DIR", "")
        if not flight_dir:
            return None
        with _RECORDER_LOCK:
            if _RECORDER is None:
                _RECORDER = FlightRecorder(flight_dir)
    return _RECORDER


def maybe_attach_flight_recorder(monitor=None) -> Optional[FlightRecorder]:
    """Wire the recorder (when configured) into the health monitor as an
    alert sink. Idempotent — ``add_sink`` dedupes — so every engine
    constructor can call it unconditionally."""
    rec = get_flight_recorder()
    if rec is None:
        return None
    if monitor is None:
        from .health import get_health_monitor
        monitor = get_health_monitor()
    monitor.add_sink(rec)
    return rec
