"""Serving telemetry: metrics registry, request-lifecycle event log, journal.

Port of the part of ``deepspeed_tpu/telemetry`` that the serving path feeds
(``registry``, ``events``, ``journal``). ``DS_TPU_TELEMETRY=0`` starts the
registry and the event log disabled; ``set_enabled()`` flips both at run
time. The journal is gated on ``DS_TPU_JOURNAL`` on its own.
"""

from .events import (EventLog, get_event_log, latency_summary, lifecycle_signature, request_metrics,
                     request_timelines, validate_timeline)
from .journal import (Journal, Session, get_journal, journal_override, read_journal, resolved_knobs, roll_digest,
                      sessions_from_records, set_journal)
from .registry import DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry, get_registry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "DEFAULT_BUCKETS", "get_registry", "set_enabled",
           "EventLog", "get_event_log", "request_timelines", "request_metrics", "latency_summary",
           "lifecycle_signature", "validate_timeline", "Journal", "Session", "get_journal", "set_journal",
           "journal_override", "read_journal", "resolved_knobs", "roll_digest", "sessions_from_records"]


def set_enabled(flag: bool) -> None:
    """Enable or disable metric recording and event emission process-wide."""
    get_registry().enabled = bool(flag)
    get_event_log().enabled = bool(flag)
