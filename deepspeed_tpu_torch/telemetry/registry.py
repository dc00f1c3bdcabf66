"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Port of ``deepspeed_tpu/telemetry/registry.py`` (framework-free, kept line
for line so the text exposition of the same operations is the same). The
serving engine, scheduler, state manager, prefix cache and SLA harness feed
it. Design constraints, in order:

- **hot-path cheap**: an enabled increment is one attribute check plus a
  float add on a pre-resolved handle (``registry.counter(...)`` is called
  once at wiring time, the handle is cached by the instrumented object);
  no metric ever reads a device value: each takes host numbers the
  serving loop already has;
- **disabled cheaper**: every mutator early-returns on one attribute
  check and allocates nothing;
- **lock-free-enough**: metric *creation* takes a lock; updates are plain
  float adds on per-metric slots.

Exports ``render_prometheus()`` (text exposition, stable series names
matching ``[a-z_][a-z0-9_]*``), ``series()`` (the flat pairs the monitor
bridge writes) and ``snapshot()`` (a JSON-able, rank-stamped dump for the
ops plane, the flight recorder and the rank merge).
"""

import bisect
import re
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

from ..analysis import knobs

_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

# generic latency buckets (seconds): span dispatch costs through tunnel RTTs
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote, and newline (in that order — backslash first so the others'
    escapes survive)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP-line escaping: only backslash and newline per the format."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: LabelKey, extra: Optional[Tuple[Tuple[str, str], ...]] = None) -> str:
    items = tuple(labels) + (extra or ())
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in items) + "}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter:
    """Monotonic float counter."""
    __slots__ = ("_reg", "name", "labels", "value")
    kind = "counter"

    def __init__(self, reg: "MetricsRegistry", name: str, labels: LabelKey):
        self._reg = reg
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if self._reg.enabled:
            self.value += amount


class Gauge:
    """Last-write-wins float value."""
    __slots__ = ("_reg", "name", "labels", "value")
    kind = "gauge"

    def __init__(self, reg: "MetricsRegistry", name: str, labels: LabelKey):
        self._reg = reg
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, value: float) -> None:
        if self._reg.enabled:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if self._reg.enabled:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._reg.enabled:
            self.value -= amount


class Histogram:
    """Fixed-bucket histogram (no dynamic resizing in the hot path)."""
    __slots__ = ("_reg", "name", "labels", "buckets", "counts", "sum", "count")
    kind = "histogram"

    def __init__(self, reg: "MetricsRegistry", name: str, labels: LabelKey,
                 buckets: Tuple[float, ...]):
        self._reg = reg
        self.name = name
        self.labels = labels
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"histogram {name!r}: buckets must be strictly increasing, got {buckets}")
        self.counts = [0] * (len(self.buckets) + 1)  # last slot = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not self._reg.enabled:
            return
        self.sum += value
        self.count += 1
        self.counts[bisect.bisect_left(self.buckets, value)] += 1

    def cumulative(self):
        """(le, cumulative_count) pairs, +Inf last — the Prometheus shape."""
        out, running = [], 0
        for b, c in zip(self.buckets, self.counts):
            running += c
            out.append((b, running))
        out.append((float("inf"), running + self.counts[-1]))
        return out


class MetricsRegistry:
    """Named-metric store. One process-wide instance via ``get_registry()``;
    direct construction is for tests."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled  # plain attribute: this IS the hot-path check
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        self._kinds: Dict[str, str] = {}
        self._buckets: Dict[str, Tuple[float, ...]] = {}
        self._help: Dict[str, str] = {}
        self._lock = threading.Lock()

    def describe(self, name: str, text: str) -> None:
        """Attach HELP text to a metric family (rendered on /metrics)."""
        self._help[name] = str(text)

    # ---------------------------------------------------------- creation
    def _get(self, cls, name: str, labels: LabelKey, buckets=None):
        key = (name, labels)
        m = self._metrics.get(key)
        if m is not None:
            if m.kind != cls.kind:
                raise ValueError(f"metric {name!r} already registered as a {m.kind}, not a {cls.kind}")
            if buckets is not None and tuple(buckets) != self._buckets.get(name):
                raise ValueError(f"histogram {name!r} already registered with buckets "
                                 f"{self._buckets.get(name)}, got {tuple(buckets)}")
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is not None:
                return m
            if not _NAME_RE.match(name):
                raise ValueError(f"metric name {name!r} must match [a-z_][a-z0-9_]*")
            for k, _ in labels:
                if not _NAME_RE.match(k):
                    raise ValueError(f"label name {k!r} must match [a-z_][a-z0-9_]*")
            prior_kind = self._kinds.get(name)
            if prior_kind is not None and prior_kind != cls.kind:
                raise ValueError(f"metric {name!r} already registered as a {prior_kind}, not a {cls.kind}")
            if cls is Histogram:
                buckets = tuple(buckets) if buckets is not None else self._buckets.get(name, DEFAULT_BUCKETS)
                prior = self._buckets.get(name)
                if prior is not None and prior != buckets:
                    raise ValueError(f"histogram {name!r} already registered with buckets {prior}, got {buckets}")
                m = Histogram(self, name, labels, buckets)
                self._buckets[name] = buckets
            else:
                m = cls(self, name, labels)
            self._kinds[name] = cls.kind
            self._metrics[key] = m
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, _label_key(labels))

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, _label_key(labels))

    def histogram(self, name: str, buckets: Optional[Tuple[float, ...]] = None, **labels) -> Histogram:
        return self._get(Histogram, name, _label_key(labels), buckets=buckets)

    # ---------------------------------------------------------- reading
    def peek(self, name: str, **labels) -> Optional[float]:
        """Current value of a counter/gauge (or a histogram's count), or
        None if the series does not exist. Never creates the series."""
        m = self._metrics.get((name, _label_key(labels)))
        if m is None:
            return None
        return float(m.count) if m.kind == "histogram" else float(m.value)

    def render_prometheus(self) -> str:
        """Prometheus text exposition. Families sorted by name; one # HELP
        and one # TYPE line per family (exposition-format order); label
        values escaped; series are unique by construction (dict-keyed)."""
        by_family: Dict[str, list] = {}
        for (name, labels), m in self._metrics.items():
            by_family.setdefault(name, []).append((labels, m))
        lines = []
        for name in sorted(by_family):
            kind = self._kinds[name]
            help_text = self._help.get(name, "see docs/OBSERVABILITY.md")
            lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, m in sorted(by_family[name], key=lambda x: x[0]):
                if kind == "histogram":
                    for le, c in m.cumulative():
                        le_s = "+Inf" if le == float("inf") else format(le, "g")
                        lines.append(f"{name}_bucket{_fmt_labels(labels, (('le', le_s),))} {c}")
                    lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(m.sum)}")
                    lines.append(f"{name}_count{_fmt_labels(labels)} {m.count}")
                else:
                    lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def series(self) -> Iterator[Tuple[str, float]]:
        """Flat (dotted_name, value) pairs for every series: the shape the
        MonitorBridge feeds to event writers (dots, not braces, so CSV
        filenames stay readable). Histograms flatten to _count/_sum."""
        for (name, labels), m in sorted(self._metrics.items()):
            suffix = "".join(f".{k}.{v}" for k, v in labels)
            if m.kind == "histogram":
                yield f"{name}_count{suffix}", float(m.count)
                yield f"{name}_sum{suffix}", float(m.sum)
            else:
                yield f"{name}{suffix}", float(m.value)

    def snapshot(self) -> Dict:
        """JSON-able dump of every series, stamped with this process's rank."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        histograms: Dict[str, Dict] = {}
        for (name, labels), m in sorted(self._metrics.items()):
            series = name + _fmt_labels(labels)
            if m.kind == "counter":
                counters[series] = m.value
            elif m.kind == "gauge":
                gauges[series] = m.value
            else:
                histograms[series] = {
                    "sum": m.sum, "count": m.count,
                    "buckets": {("+Inf" if le == float("inf") else format(le, "g")): c
                                for le, c in m.cumulative()},
                }
        from .agg import rank_stamp
        return {"ts_unix": time.time(), "enabled": self.enabled, "rank": rank_stamp(),
                "counters": counters, "gauges": gauges, "histograms": histograms}

    def reset(self) -> None:
        """Zero every series IN PLACE. Handles cached by long-lived objects
        (engines, schedulers, the event log) stay wired — only
        the values reset. Intended for tests and bench-rung boundaries."""
        with self._lock:
            for m in self._metrics.values():
                if m.kind == "histogram":
                    m.sum = 0.0
                    m.count = 0
                    m.counts = [0] * len(m.counts)
                else:
                    m.value = 0.0


_REGISTRY: Optional[MetricsRegistry] = None


def get_registry() -> MetricsRegistry:
    """The process-wide registry. ``DS_TPU_TELEMETRY=0`` starts it disabled."""
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = MetricsRegistry(enabled=knobs.get_bool("DS_TPU_TELEMETRY"))
    return _REGISTRY
