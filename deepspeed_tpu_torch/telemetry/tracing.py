"""Wall-time span tracer with a fixed-size ring buffer.

Port of ``deepspeed_tpu/telemetry/tracing.py``. ``span("train/forward",
**attrs)`` records a span at *dispatch* granularity: entry and exit stamp
``time.perf_counter()`` and never touch a device, so a span around CUDA
work measures how long the Python side took to *enqueue* it. ``blocking=True``
opts into a synchronisation of the current CUDA stream on exit, for honest
end-to-end timings (a device sync; never the default). It waits for that
stream only, never for every stream, so copies queued on other streams (the
host spill tier's d2h stream) keep running.

With ``DS_TPU_TRACE_XLA=1`` (the reference's name) spans are mirrored into
device profiles: a ``torch.profiler`` ``record_function`` range, which
``torch.profiler`` traces (and so the device profiler, ``profiler.py``)
show on the host lane, plus an NVTX range on a CUDA build, which Nsight
shows. Off by default, so profile-free runs pay nothing.

``dump_trace(path)`` exports the ring as Chrome trace-event JSON (load in
Perfetto / ``chrome://tracing``) or, for ``*.jsonl`` paths, one span per
line.
"""

import json
import os
import threading
import time
from collections import deque
from typing import Optional

from ..analysis import knobs

_TLS = threading.local()


class _NullSpan:
    """Singleton no-op context manager: the disabled path allocates nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False


_NULL_SPAN = _NullSpan()


def _block_current_stream() -> None:
    """Wait for the work queued on the current CUDA stream. A process that
    has not initialised CUDA has nothing queued, and is never made to."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class _ActiveSpan:
    __slots__ = ("_tracer", "name", "attrs", "blocking", "t0", "depth", "pushed")

    def __init__(self, tracer, name, blocking, attrs):
        self._tracer = tracer
        self.name = name
        self.blocking = blocking
        self.attrs = attrs

    def __enter__(self):
        tr = self._tracer
        # a span mirrored into the profile pops its range even if mirroring was switched off meanwhile
        self.pushed = tr.annotate_xla
        if self.pushed:
            tr._range_push(self.name)
        depth = getattr(_TLS, "depth", 0)
        self.depth = depth
        _TLS.depth = depth + 1
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self.blocking:
            _block_current_stream()
        t1 = time.perf_counter()
        _TLS.depth = self.depth
        tr = self._tracer
        ring = tr._ring
        if len(ring) == ring.maxlen:
            tr._m_dropped.inc()  # oldest span about to fall off the ring
        ring.append((self.name, self.t0, t1 - self.t0, threading.get_ident(), self.depth, self.attrs))
        if self.pushed:
            tr._range_pop()
        return False


class SpanTracer:
    """Ring-buffered span recorder. One process-wide instance via
    ``get_tracer()``; direct construction is for tests."""

    def __init__(self, capacity: int = 4096, enabled: bool = True, annotate_xla: bool = False, registry=None):
        self.enabled = enabled
        self.annotate_xla = annotate_xla
        self._ring = deque(maxlen=max(1, int(capacity)))
        if registry is None:
            from .registry import get_registry
            registry = get_registry()
        self._m_dropped = registry.counter("telemetry_spans_dropped_total")

    def span(self, name: str, blocking: bool = False, **attrs):
        if not self.enabled:
            return _NULL_SPAN
        return _ActiveSpan(self, name, blocking, attrs or None)

    # -------------------------------------------------- profile mirror
    def _range_push(self, name: str) -> None:
        """Open a ``record_function`` range (and an NVTX range on a CUDA
        build); ranges nest per thread."""
        import torch

        rf = torch.profiler.record_function(name)
        rf.__enter__()
        nvtx = torch.cuda.is_available()
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        stack = getattr(_TLS, "ranges", None)
        if stack is None:
            stack = _TLS.ranges = []
        stack.append((rf, nvtx))

    def _range_pop(self) -> None:
        stack = getattr(_TLS, "ranges", None)
        if not stack:
            return
        rf, nvtx = stack.pop()
        if nvtx:
            import torch

            torch.cuda.nvtx.range_pop()
        rf.__exit__(None, None, None)

    # ---------------------------------------------------------- reading
    def spans(self):
        """Completed spans, oldest first, as dicts."""
        return [{"name": name, "start_s": t0, "dur_s": dur, "tid": tid, "depth": depth, "attrs": attrs or {}}
                for (name, t0, dur, tid, depth, attrs) in self._ring]

    def clear(self) -> None:
        self._ring.clear()

    def dump_trace(self, path) -> str:
        """Write the ring to ``path``: Chrome trace-event JSON by default,
        one-record-per-line JSONL when the path ends in ``.jsonl``."""
        path = str(path)
        records = list(self._ring)
        if path.endswith(".jsonl"):
            with open(path, "w") as f:
                for (name, t0, dur, tid, depth, attrs) in records:
                    f.write(json.dumps({"name": name, "start_s": t0, "dur_s": dur, "tid": tid, "depth": depth,
                                        "attrs": attrs or {}}) + "\n")
            return path
        pid = os.getpid()
        events = [{"name": name, "ph": "X", "ts": t0 * 1e6, "dur": dur * 1e6, "pid": pid, "tid": tid,
                   "cat": name.split("/", 1)[0] if "/" in name else "span", "args": attrs or {}}
                  for (name, t0, dur, tid, depth, attrs) in records]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return path


_TRACER: Optional[SpanTracer] = None


def get_tracer() -> SpanTracer:
    """The process-wide tracer. Env knobs: ``DS_TPU_TELEMETRY=0`` disables,
    ``DS_TPU_TRACE_RING`` sizes the ring, ``DS_TPU_TRACE_XLA=1`` mirrors
    spans into device profiles."""
    global _TRACER
    if _TRACER is None:
        _TRACER = SpanTracer(capacity=knobs.get_int("DS_TPU_TRACE_RING"),
                             enabled=knobs.get_bool("DS_TPU_TELEMETRY"),
                             annotate_xla=knobs.get_bool("DS_TPU_TRACE_XLA"))
    return _TRACER


def span(name: str, blocking: bool = False, **attrs):
    """Module-level convenience over ``get_tracer().span(...)``."""
    tracer = _TRACER
    if tracer is None:
        tracer = get_tracer()
    if not tracer.enabled:
        return _NULL_SPAN
    return _ActiveSpan(tracer, name, blocking, attrs or None)


def dump_trace(path) -> str:
    return get_tracer().dump_trace(path)
