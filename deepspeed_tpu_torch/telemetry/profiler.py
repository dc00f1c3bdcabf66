"""Device-timeline profiler: per-quantum waterfall with collective exposure.

Port of ``deepspeed_tpu/telemetry/profiler.py`` onto ``torch.profiler``.
The perf accountant prices each dispatch as one opaque wall window; this
module says how much of a serving quantum was device compute, how much was
collective time *exposed* (not hidden under compute), how much was transfer
and how much was host gap (scheduling, commit closures, readbacks), with
bounded capture windows:

- ``DS_TPU_PROFILE=1`` arms a one-shot capture at engine construction (or
  ``POST /profile/capture`` re-arms at run time). The first quantum
  dispatched after arming starts a ``torch.profiler`` trace (CPU and, on a
  CUDA build, CUDA activities) under ``DS_TPU_PROFILE_DIR``; each later
  quantum marks its readback boundary (the same boundary the perf
  accountant's ``attribute()`` closes); after ``DS_TPU_PROFILE_QUANTA``
  markers the trace stops, is exported as Chrome-trace JSON and is parsed
  in-process.
- **A capture starts with the serving stream drained.** A kernel launched
  before a ``torch.profiler`` session starts is never traced, so device
  work still queued then would read as idle time in the window; the
  capture's first boundary waits for the current stream before it starts
  the session (once a capture; the quanta inside it are never synced).
- **The markers live in the trace.** Each is a zero-length
  ``record_function`` range (``ds_tpu_quantum/<i>/<program>``), between a
  begin and an end marker, so the quanta are cut on the trace's own clock,
  the clock of the device events, rather than by mapping ``perf_counter``
  onto it. A trace without them (a failed start, a stand-in trace in
  tests) falls back to the host stamps, as the reference cuts them.
- Events are classified into device compute / collective / transfer lanes
  and cut against the markers into a per-quantum waterfall: compute,
  collective split exposed-vs-overlapped (interval subtraction against the
  compute union), transfer, and host gap. While a capture runs, spans are
  mirrored into the trace (``tracing``'s ``record_function`` ranges), so
  the summary names the host time by span (``host_spans``: a graph
  capture's ``infer/graph_capture`` instead of an unexplained gap).

Lanes of a ``torch.profiler`` trace: ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events are the device; memcpy and memset are transfer,
``nccl*`` kernels collective, every other kernel compute; a kernel replayed
inside a CUDA graph is traced as a kernel like any other, so a graph replay
(one ``cudaGraphLaunch`` on the host) still counts as device time.
``gpu_user_annotation`` ranges (``record_function`` ranges mirrored onto the
device timeline) are bookkeeping, and ``cpu_op``, ``cuda_runtime``,
``python_function`` and the other host categories are host. Events of the
reference's own trace format (``/device:*`` pids, XLA executor threads)
keep the reference's classification, so both kinds of trace parse.

Only one ``torch.profiler`` session can run in a process (a second start
silently stops the first), so a start while one runs raises, and a capture
armed then (by the flight recorder or the ops plane) degrades to a
marker-only summary (``trace: "unavailable"``), as the reference's does.
A session records the ops of the thread that started it and must be
stopped by that thread, so every capture starts and stops at a quantum
boundary on the serving (or training) thread: the flight recorder's
post-anomaly window (``open_window``) is a time-bounded capture that
closes at the first boundary after its seconds, where the reference stops
its trace from a timer thread. The training engine marks each optimizer
step as a quantum (``train_step``).

Derived registry metrics: ``profile_collective_exposed_fraction``,
``profile_host_gap_fraction``, ``profile_device_busy_fraction`` and the
``profile_captures_total`` counter. Consumers: the ops plane
(``GET /profile``), the flight recorder (a post-anomaly window summarised
into the manifest) and ``chip_smoke.py``'s ``telemetry`` phase.
"""

import gzip
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis import knobs

SUMMARY_SCHEMA = 1
MAX_QUANTA_ROWS = 256     # summary rows kept per capture (ops-plane bound)
TOP_PROGRAMS = 8          # top-N device programs reported per capture

MARK_BEGIN = "ds_tpu_profile/begin"
MARK_END = "ds_tpu_profile/end"
MARK_QUANTUM = "ds_tpu_quantum/"

_COLLECTIVE_TOKENS = ("all-reduce", "allreduce", "all_reduce", "psum",
                      "reduce-scatter", "reduce_scatter", "all-gather",
                      "all_gather", "allgather", "all-to-all", "alltoall",
                      "collective-permute", "collective_permute",
                      "collective-broadcast", "ragged-all-to-all")
_TRANSFER_TOKENS = ("d2h", "h2d", "memcpy", "copy-start", "copy-done",
                    "copy.", "copystart", "copydone", "infeed", "outfeed",
                    "transferto", "transferfrom", "buffer_from", "to_host",
                    "from_host", "device_to_host", "host_to_device")
_INFRA_TOKENS = ("threadpoollistener", "thunkexecutor", "taskdispatcher")
# the reference's trace: XLA executes on these host threads (CPU backend) or /device:* pids
_DEVICE_THREAD_RE = re.compile(
    r"XLATfrtCpuClient|XLA.*Launch|StreamExecutor|TensorFlow Ops", re.I)

# torch.profiler (Kineto) event categories
_TORCH_DEVICE_CATS = {"kernel": "compute", "gpu_memcpy": "transfer", "gpu_memset": "transfer"}
_TORCH_INFRA_CATS = ("gpu_user_annotation",)
_TORCH_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation",
                    "cpu_instant_event", "overhead", "Trace")
_SPAN_NAME_RE = re.compile(r"^[a-z0-9_]+(/[a-z0-9_]+)+$")  # span names ("infer/prefill"); not the markers


# --------------------------------------------------------------- trace IO
def find_trace_files(root: str) -> List[str]:
    """Chrome-trace files under a profiler output directory."""
    out: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if fn.endswith(".trace.json.gz") or fn.endswith(".trace.json"):
                out.append(os.path.join(dirpath, fn))
    return sorted(out)


def load_trace(path: str) -> Dict:
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return json.loads(f.read().decode())
    with open(path) as f:
        return json.load(f)


def dir_bytes(path: str) -> int:
    """Total on-disk bytes below ``path`` (size-bound enforcement)."""
    total = 0
    for dirpath, _dirs, files in os.walk(path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                pass
    return total


# --------------------------------------------------------- torch.profiler
def start_trace(trace_dir: str):
    """Start a ``torch.profiler`` session (CPU, and CUDA on a CUDA build)
    whose trace ``stop_trace`` writes under ``trace_dir``; returns its
    handle. Raises RuntimeError while another session runs: a second start
    would silently stop the first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if torch.autograd._profiler_enabled():
        raise RuntimeError("a torch.profiler session is already running in this process")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_trace(handle, trace_dir: str) -> str:
    """Stop the session ``handle`` and export its Chrome trace into
    ``trace_dir``; returns the file's path."""
    handle.stop()
    path = os.path.join(trace_dir, "device.trace.json")
    handle.export_chrome_trace(path)
    return path


def mark(name: str) -> None:
    """A zero-length ``record_function`` range: an instant on the trace's
    clock (nothing is recorded when no session runs)."""
    import torch

    with torch.profiler.record_function(name):
        pass


# ---------------------------------------------------------------- parsing
def _classify(name: str) -> str:
    low = name.lower()
    if any(t in low for t in _INFRA_TOKENS):
        return "infra"
    if any(t in low for t in _COLLECTIVE_TOKENS):
        return "collective"
    if any(t in low for t in _TRANSFER_TOKENS):
        return "transfer"
    return "compute"


def _torch_category(cat: str, name: str) -> Optional[str]:
    """The lane of a ``torch.profiler`` event, or None for a category of
    the reference's format."""
    kind = _TORCH_DEVICE_CATS.get(cat)
    if kind is not None:
        return "collective" if kind == "compute" and "nccl" in name.lower() else kind
    if cat in _TORCH_INFRA_CATS:
        return "infra"
    if cat in _TORCH_HOST_CATS:
        return "host"
    return None


def parse_trace_events(doc: Dict) -> Dict:
    """Normalise a Chrome-trace document (``{"traceEvents": [...]}``) into
    categorised events with window-relative times in seconds.

    ``torch.profiler`` events are classified by their category (module
    docstring). Events of the reference's format: device lanes are
    ``/device:*`` pids plus host-pid threads matching ``_DEVICE_THREAD_RE``,
    split compute / collective / transfer by op-name tokens, with executor
    bookkeeping set aside as ``infra``; everything else is ``host``."""
    evs = doc.get("traceEvents") or []
    pid_names: Dict = {}
    tid_names: Dict = {}
    for e in evs:
        if e.get("ph") == "M":
            args = e.get("args") or {}
            if e.get("name") == "process_name":
                pid_names[e.get("pid")] = str(args.get("name", ""))
            elif e.get("name") == "thread_name":
                tid_names[(e.get("pid"), e.get("tid"))] = str(args.get("name", ""))
    xs = [e for e in evs if e.get("ph") == "X" and isinstance(e.get("ts"), (int, float))]
    if not xs:
        return {"t0_us": 0.0, "span_s": 0.0, "events": []}
    t0 = min(float(e["ts"]) for e in xs)
    out: List[Dict] = []
    span = 0.0
    for e in xs:
        pname = pid_names.get(e.get("pid"), "")
        tname = tid_names.get((e.get("pid"), e.get("tid")), "")
        name = str(e.get("name", ""))
        cat = _torch_category(str(e.get("cat", "")), name)
        if cat is None:
            device = pname.startswith("/device:") or bool(_DEVICE_THREAD_RE.search(tname))
            cat = _classify(name) if device else "host"
        start = (float(e["ts"]) - t0) / 1e6
        dur = max(0.0, float(e.get("dur") or 0.0) / 1e6)
        span = max(span, start + dur)
        out.append({"name": name, "cat": cat, "start_s": start, "dur_s": dur, "lane": tname or pname})
    return {"t0_us": t0, "span_s": span, "events": out}


def trace_markers(parsed: Dict) -> Optional[Tuple[float, float, List[float]]]:
    """(begin, end, quantum marker times) of a capture's in-trace markers,
    in the parsed trace's seconds; None when the trace lacks them."""
    begin = end = None
    quanta: List[Tuple[int, float]] = []
    for e in parsed.get("events") or []:
        name = e["name"]
        if name == MARK_BEGIN:
            begin = e["start_s"]
        elif name == MARK_END:
            end = e["start_s"]
        elif name.startswith(MARK_QUANTUM):
            quanta.append((int(name.split("/")[1]), e["start_s"]))
    if begin is None or end is None:
        return None
    return begin, end, [t for _, t in sorted(quanta)]


def rebase(parsed: Dict, origin_s: float, window_s: float) -> Dict:
    """The events of ``parsed`` moved to start at ``origin_s`` and clipped
    to ``[0, window_s]`` (the capture window between the begin and end
    markers); events wholly outside it are dropped."""
    out = []
    for e in parsed.get("events") or []:
        lo = e["start_s"] - origin_s
        hi = lo + e["dur_s"]
        if hi < 0.0 or lo > window_s:
            continue
        lo, hi = max(lo, 0.0), min(hi, window_s)
        out.append(dict(e, start_s=lo, dur_s=hi - lo))
    return {"t0_us": parsed.get("t0_us", 0.0) + origin_s * 1e6, "span_s": window_s, "events": out}


# ------------------------------------------------------- interval algebra
def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted union of [lo, hi) intervals."""
    merged: List[Tuple[float, float]] = []
    for lo, hi in sorted(i for i in intervals if i[1] > i[0]):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _total(merged: List[Tuple[float, float]]) -> float:
    return sum(hi - lo for lo, hi in merged)


def _clip(merged: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in merged if b > lo and a < hi]


def _subtract(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged intervals of ``a`` minus the union ``b`` (exposed time)."""
    out: List[Tuple[float, float]] = []
    for lo, hi in a:
        cur = lo
        for blo, bhi in b:
            if bhi <= cur or blo >= hi:
                continue
            if blo > cur:
                out.append((cur, blo))
            cur = max(cur, bhi)
            if cur >= hi:
                break
        if cur < hi:
            out.append((cur, hi))
    return out


def _frac(num: float, den: float) -> float:
    if den <= 0:
        return 0.0
    return max(0.0, min(1.0, num / den))


# -------------------------------------------------------------- waterfall
def build_waterfall(parsed: Optional[Dict], markers: List[Dict], window_s: Optional[float] = None,
                    ledger: Optional[Dict] = None, top_n: int = TOP_PROGRAMS) -> Dict:
    """Cut categorised trace events against quantum markers into the
    per-quantum waterfall model.

    ``markers`` are readback-boundary stamps (``rel_s`` relative to the
    window's start): quantum *k* covers ``(markers[k-1].rel_s,
    markers[k].rel_s]``, the interval between consecutive completions, so
    host gap between dispatches lands in the quantum that paid it. With no
    markers the whole window is one synthetic quantum."""
    parsed = parsed or {"span_s": 0.0, "events": []}
    events = parsed.get("events") or []
    span = max(float(window_s or 0.0), float(parsed.get("span_s") or 0.0))

    by_cat: Dict[str, List[Tuple[float, float]]] = {"compute": [], "collective": [], "transfer": []}
    prog_time: Dict[str, float] = {}
    span_time: Dict[str, float] = {}
    for e in events:
        cat = e["cat"]
        if cat in by_cat:
            by_cat[cat].append((e["start_s"], e["start_s"] + e["dur_s"]))
        if cat == "compute":
            prog_time[e["name"]] = prog_time.get(e["name"], 0.0) + e["dur_s"]
        elif cat == "host" and _SPAN_NAME_RE.match(e["name"]) and not e["name"].startswith("ds_tpu_"):
            span_time[e["name"]] = span_time.get(e["name"], 0.0) + e["dur_s"]
    comp_u = _merge(by_cat["compute"])
    coll_u = _merge(by_cat["collective"])
    tran_u = _merge(by_cat["transfer"])
    busy_u = _merge(comp_u + coll_u + tran_u)
    exposed_u = _subtract(coll_u, comp_u)

    marks = sorted((dict(m) for m in markers or []), key=lambda m: m["rel_s"])
    if marks:
        bounds = [0.0] + [float(m["rel_s"]) for m in marks]
    else:
        bounds = [0.0, span]
        marks = [{"program": "window", "attrs": {}}]
    quanta: List[Dict] = []
    for i, mark_ in enumerate(marks):
        lo, hi = bounds[i], bounds[i + 1] if i + 1 < len(bounds) else span
        hi = max(hi, lo)
        c = _clip(comp_u, lo, hi)
        k = _clip(coll_u, lo, hi)
        t = _clip(tran_u, lo, hi)
        b = _clip(busy_u, lo, hi)
        x = _clip(exposed_u, lo, hi)
        dur = hi - lo
        quanta.append({
            "index": i, "program": mark_.get("program", "?"),
            "start_s": round(lo, 6), "dur_s": round(dur, 6),
            "compute_s": round(_total(c), 6),
            "collective_s": round(_total(k), 6),
            "collective_exposed_s": round(_total(x), 6),
            "transfer_s": round(_total(t), 6),
            "device_busy_s": round(_total(b), 6),
            "host_gap_s": round(max(0.0, dur - _total(b)), 6),
            "attrs": mark_.get("attrs", {}),
        })

    busy_s = _total(busy_u)
    coll_s = _total(coll_u)
    exposed_s = _total(exposed_u)
    totals = {
        "wall_s": round(span, 6),
        "compute_s": round(_total(comp_u), 6),
        "collective_s": round(coll_s, 6),
        "collective_exposed_s": round(exposed_s, 6),
        "collective_overlapped_s": round(max(0.0, coll_s - exposed_s), 6),
        "transfer_s": round(_total(tran_u), 6),
        "device_busy_s": round(busy_s, 6),
        "host_gap_s": round(max(0.0, span - busy_s), 6),
    }
    fractions = {
        "device_busy": round(_frac(busy_s, span), 6),
        "host_gap": round(_frac(max(0.0, span - busy_s), span), 6),
        "collective_exposed": round(_frac(exposed_s, coll_s), 6),
    }
    programs = sorted(prog_time.items(), key=lambda kv: -kv[1])[:top_n]
    n_coll_events = sum(1 for e in events if e["cat"] == "collective")
    collectives = {
        "trace_ops": n_coll_events,
        "trace_s": totals["collective_s"],
        "exposed_s": totals["collective_exposed_s"],
        "overlapped_s": totals["collective_overlapped_s"],
        "exposed_fraction": fractions["collective_exposed"],
        "ledger": dict(ledger or {}),
    }
    return {
        "schema": SUMMARY_SCHEMA,
        "window_s": round(span, 6),
        "n_events": len(events),
        "n_quanta": len(quanta),
        "quanta": quanta[:MAX_QUANTA_ROWS],
        "quanta_truncated": max(0, len(quanta) - MAX_QUANTA_ROWS),
        "totals": totals,
        "fractions": fractions,
        "programs": [[name, round(sec, 6)] for name, sec in programs],
        "host_spans": [[name, round(sec, 6)] for name, sec in sorted(span_time.items(), key=lambda kv: -kv[1])],
        "collectives": collectives,
    }


def summarize_trace_dir(trace_dir: str, window_s: Optional[float] = None) -> Dict:
    """Parse a raw profiler output directory (e.g. a flight capture's
    ``profile/``) into a single-window waterfall summary."""
    files = find_trace_files(trace_dir)
    if not files:
        return {"schema": SUMMARY_SCHEMA, "trace": "unavailable", "error": f"no trace files under {trace_dir}"}
    try:
        summary = build_waterfall(parse_trace_events(load_trace(files[-1])), markers=[], window_s=window_s)
        summary["trace"] = "ok"
        summary["trace_file"] = os.path.basename(files[-1])
        return summary
    except Exception as e:  # a corrupt trace must not kill the caller
        return {"schema": SUMMARY_SCHEMA, "trace": "unavailable", "error": f"{type(e).__name__}: {e}"}


# ----------------------------------------------------------- the profiler
class DeviceProfiler:
    """One-shot bounded capture window over serving quanta.

    States: ``idle`` → ``arm()`` → ``armed`` → first ``note_quantum`` starts
    the trace (``tracing``) → after ``quanta_target`` markers (or, with
    ``window_s``, at the first marker that many seconds after the start)
    the trace stops, parses, lands gauges, hands the summary to
    ``on_done``, and the profiler returns to ``idle``. ``note_quantum`` in
    ``idle`` is one attribute compare. ``trace_name`` names the capture's
    directory under ``out_dir`` (default ``capture-<n>-<pid>``)."""

    def __init__(self, out_dir: Optional[str] = None, quanta: Optional[int] = None,
                 window_s: Optional[float] = None, trace_name: Optional[str] = None,
                 on_done: Optional[Callable[[Dict], None]] = None):
        self.out_dir = str(out_dir or knobs.get_str("DS_TPU_PROFILE_DIR", "") or "profile_captures")
        self.quanta_target = max(1, int(quanta if quanta is not None else knobs.get_int("DS_TPU_PROFILE_QUANTA")))
        self.window_s = window_s
        self.trace_name = trace_name
        self.on_done = on_done
        self.state = "idle"
        self.captures = 0
        self._lock = threading.Lock()
        self._markers: List[Dict] = []
        self._host_t0 = 0.0
        self._trace_dir: Optional[str] = None
        self._trace_ok = False
        self._handle = None
        self._annotate_was = False
        self._bytes_mark = 0.0
        self._summary: Optional[Dict] = None

    # ------------------------------------------------- torch.profiler seams
    # overridable so unit tests can drop a fixture trace instead of starting a live profiler (process-global)
    def _start_trace(self, trace_dir: str) -> None:
        self._handle = start_trace(trace_dir)

    def _stop_trace(self) -> None:
        handle, self._handle = self._handle, None
        stop_trace(handle, self._trace_dir)

    # ------------------------------------------------------------ control
    def arm(self, quanta: Optional[int] = None) -> bool:
        """Request one capture window; no-op (False) while tracing."""
        with self._lock:
            if self.state == "tracing":
                return False
            if quanta is not None:
                self.quanta_target = max(1, int(quanta))
            self._markers = []
            self.state = "armed"
        return True

    def note_quantum(self, program: str, **attrs) -> None:
        """Dispatch-site hook, called at each quantum's readback boundary
        (right after the perf accountant's ``attribute()``)."""
        if self.state not in ("armed", "tracing"):
            return
        finalize = False
        with self._lock:
            if self.state == "armed":
                self._begin_locked()
                return  # this quantum ran before the trace started
            if self.state != "tracing":
                return
            idx = len(self._markers)
            if self._trace_ok:
                mark(f"{MARK_QUANTUM}{idx}/{program}")
            self._markers.append({
                "index": idx, "program": str(program),
                "rel_s": time.perf_counter() - self._host_t0,
                "attrs": {k: v for k, v in attrs.items() if isinstance(v, (int, float, str, bool))},
            })
            if len(self._markers) >= self.quanta_target or (
                    self.window_s is not None and time.perf_counter() - self._host_t0 >= self.window_s):
                self.state = "stopping"
                finalize = True
        if finalize:
            self._finalize()

    def finish(self) -> Optional[Dict]:
        """Close an in-flight capture with however many quanta arrived (so a
        short run still lands a summary)."""
        with self._lock:
            if self.state == "armed":
                self.state = "idle"
                return None
            if self.state != "tracing":
                return self._summary
            self.state = "stopping"
        self._finalize()
        return self._summary

    def _begin_locked(self) -> None:
        trace_dir = os.path.join(self.out_dir, self.trace_name or f"capture-{self.captures:03d}-{os.getpid()}")
        try:
            os.makedirs(trace_dir, exist_ok=True)
        except OSError:
            trace_dir = None
        self._trace_dir = trace_dir
        self._trace_ok = False
        if trace_dir is not None:
            from .tracing import _block_current_stream
            _block_current_stream()  # a kernel launched before the session starts is never traced
            try:
                self._start_trace(trace_dir)
                self._trace_ok = True
            except Exception:
                # another session (the flight recorder's, a caller's) holds the profiler: degrade to a
                # marker-only window
                self._trace_ok = False
        if self._trace_ok:
            from .tracing import get_tracer
            tracer = get_tracer()
            self._annotate_was = tracer.annotate_xla
            tracer.annotate_xla = True  # name host time by span in this trace
            mark(MARK_BEGIN)
        from .registry import get_registry
        self._bytes_mark = get_registry().peek("infer_tp_allreduce_bytes_total") or 0.0
        self._host_t0 = time.perf_counter()
        self.state = "tracing"

    def _finalize(self) -> None:
        window_s = time.perf_counter() - self._host_t0
        trace_state = "ok" if self._trace_ok else "unavailable"
        if self._trace_ok:
            mark(MARK_END)
            from .tracing import get_tracer
            get_tracer().annotate_xla = self._annotate_was
            try:
                self._stop_trace()
            except Exception:
                trace_state = "unavailable"
        parsed = None
        markers = self._markers
        clock = "host"
        if trace_state == "ok" and self._trace_dir:
            files = find_trace_files(self._trace_dir)
            if files:
                try:
                    parsed = parse_trace_events(load_trace(files[-1]))
                except Exception:
                    trace_state = "unavailable"
            else:
                trace_state = "unavailable"
        if parsed is not None:
            found = trace_markers(parsed)
            if found is not None and len(found[2]) == len(markers):
                begin, end, times = found
                window_s = max(0.0, end - begin)
                parsed = rebase(parsed, begin, window_s)
                markers = [dict(m, rel_s=t - begin) for m, t in zip(markers, times)]
                clock = "trace"
        summary = build_waterfall(parsed, markers, window_s=window_s, ledger=self._ledger_delta())
        summary["trace"] = trace_state
        summary["trace_dir"] = self._trace_dir
        summary["quanta_target"] = self.quanta_target
        summary["marker_clock"] = clock
        self._land_metrics(summary)
        if self._trace_dir:
            try:
                with open(os.path.join(self._trace_dir, "summary.json"), "w") as f:
                    json.dump(summary, f, indent=2, sort_keys=True)
            except OSError:
                pass
        with self._lock:
            self._summary = summary
            self.captures += 1
            self.state = "idle"
        if self.on_done is not None:
            self.on_done(summary)

    def _ledger_delta(self) -> Dict:
        """Tensor-parallel allreduce traffic recorded during the window
        (the ``infer_tp_allreduce_bytes_total`` counter's delta; 0 until the
        port serves with tensor parallelism)."""
        from .registry import get_registry
        now = get_registry().peek("infer_tp_allreduce_bytes_total") or 0.0
        return {"source": "counter", "counter_bytes": int(now - self._bytes_mark)}

    def _land_metrics(self, summary: Dict) -> None:
        from .registry import get_registry
        reg = get_registry()
        fr = summary.get("fractions") or {}
        reg.gauge("profile_collective_exposed_fraction").set(float(fr.get("collective_exposed") or 0.0))
        reg.gauge("profile_host_gap_fraction").set(float(fr.get("host_gap") or 0.0))
        reg.gauge("profile_device_busy_fraction").set(float(fr.get("device_busy") or 0.0))
        reg.counter("profile_captures_total").inc()

    # ------------------------------------------------------------ reading
    def summary(self) -> Optional[Dict]:
        return self._summary

    def status(self) -> Dict:
        return {"state": self.state, "captures": self.captures, "quanta_target": self.quanta_target,
                "out_dir": self.out_dir, "n_markers": len(self._markers)}

    def write_rank_summary(self, out_dir: str) -> Optional[str]:
        """Drop this rank's last summary as ``profile-rank<k>.json``
        (parallel to the metric snapshots' ``telemetry-rank<k>.json``)."""
        if self._summary is None:
            return None
        from .agg import rank_stamp
        stamp = rank_stamp()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"profile-rank{stamp['process_index']}.json")
        with open(path, "w") as f:
            json.dump({"rank": stamp, "summary": self._summary}, f, indent=2, sort_keys=True)
        return path


# ----------------------------------------------------------- module state
_PROFILER: Optional[DeviceProfiler] = None
_PROFILER_LOCK = threading.Lock()


def get_device_profiler() -> Optional[DeviceProfiler]:
    return _PROFILER


def maybe_arm_profiler() -> Optional[DeviceProfiler]:
    """Engine-constructor hook: with ``DS_TPU_PROFILE`` unset this is one
    bool read; set, it creates the singleton and arms the one-shot capture
    (only if it has never fired: a finished capture is not re-armed by the
    next engine build; ``request_capture`` re-arms)."""
    global _PROFILER
    if not knobs.get_bool("DS_TPU_PROFILE"):
        return _PROFILER
    with _PROFILER_LOCK:
        if _PROFILER is None:
            _PROFILER = DeviceProfiler()
    if _PROFILER.captures == 0 and _PROFILER.state == "idle":
        _PROFILER.arm()
    return _PROFILER


def request_capture(quanta: Optional[int] = None) -> Tuple[DeviceProfiler, bool]:
    """Arm a capture on demand (ops plane, ``chip_smoke.py``): creates the
    singleton if needed; returns (profiler, armed), armed False while a
    capture is already tracing."""
    global _PROFILER
    with _PROFILER_LOCK:
        if _PROFILER is None:
            _PROFILER = DeviceProfiler(quanta=quanta)
    return _PROFILER, _PROFILER.arm(quanta)


_WINDOWS: List[DeviceProfiler] = []  # open time-bounded windows (the flight recorder's)


def open_window(out_dir: str, trace_name: str, window_s: float,
                on_done: Callable[[Dict], None]) -> DeviceProfiler:
    """A capture of the quanta of the next ``window_s`` seconds into
    ``out_dir/trace_name``, started at the next quantum boundary and closed
    at the first boundary ``window_s`` after it; ``on_done(summary)`` runs
    when it closes. While another capture holds the profiler it degrades to
    a marker-only summary."""

    def done(summary: Dict) -> None:
        if prof in _WINDOWS:
            _WINDOWS.remove(prof)
        on_done(summary)

    prof = DeviceProfiler(out_dir=out_dir, quanta=1 << 30, window_s=window_s, trace_name=trace_name, on_done=done)
    prof.arm()
    _WINDOWS.append(prof)
    return prof


def note_quantum(program: str, **attrs) -> None:
    """Module-level dispatch hook: a global read + None check and a list
    test when no profiler exists (the common case)."""
    p = _PROFILER
    if p is not None:
        p.note_quantum(program, **attrs)
    if _WINDOWS:
        for w in list(_WINDOWS):
            w.note_quantum(program, **attrs)


def _reset_for_tests() -> None:
    global _PROFILER
    _PROFILER = None
    _WINDOWS.clear()
