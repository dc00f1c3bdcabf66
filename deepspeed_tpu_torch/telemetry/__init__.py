"""Unified telemetry: metrics registry, span tracer, event log, health
monitor, perf accountant, device profiler, flight recorder, ops plane,
rank aggregation, monitor bridge and the serving journal.

Port of ``deepspeed_tpu/telemetry`` with the reference's exports and
metric, span, knob, endpoint and manifest names. ``DS_TPU_TELEMETRY=0``
starts the registry, the tracer and the event log disabled;
``set_enabled()`` flips them at run time. The journal is gated on
``DS_TPU_JOURNAL`` on its own.
"""

from .registry import DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, get_registry
from .tracing import SpanTracer, dump_trace, get_tracer, span
from .bridge import MonitorBridge
from .events import (EventLog, get_event_log, latency_summary, lifecycle_signature, request_metrics,
                     request_timelines, validate_timeline)
from .health import (Alert, CallbackAlertSink, Detector, GradNormSpikeDetector, HBMPressureDetector, HealthMonitor,
                     JsonlAlertSink, LoggerAlertSink, NonFiniteLossDetector, QueueStallDetector, SLOBurnRateDetector,
                     StragglerDetector, get_health_monitor)
from .costs import CostCard, PerfAccountant, get_perf_accountant, resolve_peaks
from .agg import (detect_stragglers, histogram_quantile, merge_snapshot_files, merge_snapshots, rank_stamp,
                  write_rank_snapshot)
from .flight import FlightRecorder, get_flight_recorder, maybe_attach_flight_recorder
from .journal import (Journal, Session, get_journal, journal_override, read_journal, resolved_knobs, roll_digest,
                      sessions_from_records, set_journal)
from .ops_plane import OpsServer, get_ops_server, maybe_start_ops_server
from .profiler import (DeviceProfiler, build_waterfall, get_device_profiler, maybe_arm_profiler, parse_trace_events,
                       request_capture, summarize_trace_dir)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS",
    "get_registry", "SpanTracer", "get_tracer", "span", "dump_trace",
    "MonitorBridge", "set_enabled",
    "EventLog", "get_event_log", "request_timelines", "request_metrics",
    "latency_summary", "lifecycle_signature", "validate_timeline",
    "Alert", "Detector", "HealthMonitor", "get_health_monitor",
    "NonFiniteLossDetector", "GradNormSpikeDetector", "QueueStallDetector",
    "SLOBurnRateDetector", "HBMPressureDetector", "StragglerDetector",
    "LoggerAlertSink", "JsonlAlertSink", "CallbackAlertSink",
    "CostCard", "PerfAccountant", "get_perf_accountant", "resolve_peaks",
    "rank_stamp", "write_rank_snapshot", "merge_snapshots",
    "merge_snapshot_files", "histogram_quantile", "detect_stragglers",
    "FlightRecorder", "get_flight_recorder", "maybe_attach_flight_recorder",
    "resolved_knobs", "OpsServer", "get_ops_server", "maybe_start_ops_server",
    "Journal", "Session", "get_journal", "set_journal", "journal_override",
    "read_journal", "roll_digest", "sessions_from_records",
    "DeviceProfiler", "get_device_profiler", "maybe_arm_profiler",
    "request_capture", "parse_trace_events", "build_waterfall",
    "summarize_trace_dir",
]


def set_enabled(flag: bool) -> None:
    """Enable or disable metric recording, span tracing and event emission
    process-wide."""
    get_registry().enabled = bool(flag)
    get_tracer().enabled = bool(flag)
    get_event_log().enabled = bool(flag)
