"""Health monitoring: pluggable anomaly detectors + structured alerts.

Port of ``deepspeed_tpu/telemetry/health.py`` (framework-free: the same
detectors, latching, cooldowns and sinks). A ``HealthMonitor`` owns a set of named detectors, feeds them from two
directions — push observations (training loss / grad norm, per-request
TTFT/TPOT) and the structured event stream (it registers as an
``EventLog`` listener) — and dispatches any resulting ``Alert`` through
configurable sinks (logger, JSONL file, callback). Every alert also
lands in the event log as a ``kind="alert"`` record and increments
``health_alerts_total{detector=...}``; the ``health_status`` gauge
(1 = healthy, 0 = alerting) rides the MonitorBridge like every other
registry series, so TensorBoard/CSV/WandB pick it up for free.

Detector semantics shared by all built-ins:

- **threshold**: the condition that opens an alert;
- **hysteresis**: once firing, a detector stays latched (no repeat
  alerts) until the condition *clears* (``_rearm``), so a NaN that
  persists for 500 steps raises exactly one alert;
- **cooldown**: after re-arming, a fresh alert is suppressed for
  ``cooldown_s`` so a value oscillating across the threshold can't
  spam the sinks.

Built-ins: ``NonFiniteLossDetector`` / ``GradNormSpikeDetector``
(training, wired into ``runtime/engine.py``'s host-sync points),
``QueueStallDetector`` / ``SLOBurnRateDetector`` / ``HBMPressureDetector``
(serving, fed by the event stream, the SLA harness and the engine's HBM
gauges, and polled from the generate and SLA loops) and
``StragglerDetector`` (cross-rank snapshots).
"""

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..analysis import knobs
from .registry import get_registry

_NEG_INF = float("-inf")


@dataclass
class Alert:
    """One structured health alert."""
    detector: str
    severity: str
    message: str
    ts_unix: float = field(default_factory=time.time)
    attrs: Dict = field(default_factory=dict)

    def as_dict(self) -> Dict:
        return {"detector": self.detector, "severity": self.severity,
                "message": self.message, "ts_unix": self.ts_unix,
                **self.attrs}


# ------------------------------------------------------------------ sinks

class LoggerAlertSink:
    """Routes alerts to the package logger (default sink)."""

    def __init__(self, logger=None):
        if logger is None:
            import logging
            logger = logging.getLogger("deepspeed_tpu_torch.health")
        self._logger = logger

    def __call__(self, alert: Alert) -> None:
        fn = self._logger.error if alert.severity == "error" else self._logger.warning
        fn("[health:%s] %s %s", alert.detector, alert.message,
           alert.attrs or "")


class JsonlAlertSink:
    """Appends one JSON record per alert to ``path``."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()

    def __call__(self, alert: Alert) -> None:
        import json
        line = json.dumps(alert.as_dict()) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)


class CallbackAlertSink:
    """Wraps a user callable ``fn(alert)``."""

    def __init__(self, fn: Callable[[Alert], None]):
        self._fn = fn

    def __call__(self, alert: Alert) -> None:
        self._fn(alert)


# -------------------------------------------------------------- detectors

class Detector:
    """Base class: latched-alert (hysteresis) + cooldown machinery.

    Subclasses implement ``observe(...)`` and/or ``on_event(...)`` /
    ``poll(now)`` and call ``_maybe_alert`` when their condition holds
    and ``_rearm`` when it clears.
    """

    name = "detector"
    severity = "error"

    def __init__(self, name: Optional[str] = None, cooldown_s: float = 60.0):
        if name is not None:
            self.name = name
        self.cooldown_s = float(cooldown_s)
        self.firing = False
        self._last_alert_ts = _NEG_INF

    def _maybe_alert(self, message: str, **attrs) -> Optional[Alert]:
        if self.firing:
            return None  # latched: condition has not cleared since the alert
        now = time.monotonic()
        if now - self._last_alert_ts < self.cooldown_s:
            return None
        self.firing = True
        self._last_alert_ts = now
        return Alert(detector=self.name, severity=self.severity,
                     message=message, attrs=attrs)

    def _rearm(self) -> None:
        self.firing = False

    def reset(self) -> None:
        self.firing = False
        self._last_alert_ts = _NEG_INF

    # hooks — default no-ops so the monitor can drive any detector mix
    def on_event(self, ts, kind, uid, attrs) -> None:
        pass

    def poll(self, now: Optional[float] = None) -> Optional[Alert]:
        return None


class NonFiniteLossDetector(Detector):
    """Alerts once per NaN/Inf-loss episode; a finite loss re-arms."""

    name = "nan_loss"

    def observe(self, loss: float) -> Optional[Alert]:
        if math.isfinite(loss):
            self._rearm()
            return None
        return self._maybe_alert(f"non-finite training loss: {loss}",
                                 loss=str(loss))


class GradNormSpikeDetector(Detector):
    """Alerts when the grad norm jumps ``spike_ratio``× over its EMA
    baseline (or goes non-finite). Spikes are excluded from the EMA so a
    single blow-up can't normalize itself; re-arms when the norm drops
    back under ``spike_ratio * hysteresis`` of baseline."""

    name = "grad_norm_spike"

    def __init__(self, spike_ratio: float = 10.0, warmup: int = 8,
                 ema_alpha: float = 0.1, hysteresis: float = 0.5,
                 floor: float = 1e-6, **kw):
        super().__init__(**kw)
        self.spike_ratio = float(spike_ratio)
        self.warmup = int(warmup)
        self.ema_alpha = float(ema_alpha)
        self.hysteresis = float(hysteresis)
        self.floor = float(floor)
        self._ema: Optional[float] = None
        self._n = 0

    def observe(self, gnorm: float) -> Optional[Alert]:
        if not math.isfinite(gnorm):
            return self._maybe_alert(f"non-finite grad norm: {gnorm}",
                                     grad_norm=str(gnorm))
        if self._ema is None:
            self._ema, self._n = float(gnorm), 1
            return None
        baseline = max(self._ema, self.floor)
        if self._n >= self.warmup and gnorm > self.spike_ratio * baseline:
            return self._maybe_alert(
                f"grad norm spike: {gnorm:.4g} vs EMA {self._ema:.4g}",
                grad_norm=float(gnorm), ema=float(self._ema),
                ratio=float(gnorm / baseline))
        self._ema += self.ema_alpha * (gnorm - self._ema)
        self._n += 1
        if gnorm <= self.spike_ratio * self.hysteresis * baseline:
            self._rearm()
        return None

    def reset(self) -> None:
        super().reset()
        self._ema, self._n = None, 0


class QueueStallDetector(Detector):
    """Serving liveness: requests are waiting but the scheduler has not
    admitted (or finished) anything for ``stall_s`` seconds. Fed by
    ``enqueue``/``admit``/``finish`` events; ``poll(now)`` checks the
    clock. Env: ``DS_TPU_STALL_S`` (default 30)."""

    name = "queue_stall"

    def __init__(self, stall_s: Optional[float] = None, **kw):
        super().__init__(**kw)
        if stall_s is None:
            stall_s = knobs.get_float("DS_TPU_STALL_S")
        self.stall_s = float(stall_s)
        self.waiting: set = set()
        self.last_progress: Optional[float] = None

    def on_event(self, ts, kind, uid, attrs) -> None:
        if kind == "enqueue":
            if not self.waiting:
                self.last_progress = ts
            self.waiting.add(uid)
        elif kind == "admit":
            self.waiting.discard(uid)
            self.last_progress = ts
            self._rearm()
        elif kind == "finish":
            self.waiting.discard(uid)
            self.last_progress = ts

    def stalled_for(self, now: Optional[float] = None) -> float:
        """Seconds since the queue last made progress (0 if idle)."""
        if not self.waiting or self.last_progress is None:
            return 0.0
        if now is None:
            now = time.perf_counter()
        return max(0.0, now - self.last_progress)

    def poll(self, now: Optional[float] = None) -> Optional[Alert]:
        stalled = self.stalled_for(now)
        if stalled <= self.stall_s:
            return None
        return self._maybe_alert(
            f"scheduler stalled: {len(self.waiting)} request(s) pending, "
            f"no admission for {stalled:.1f}s",
            pending=len(self.waiting), stalled_s=round(stalled, 3))

    def reset(self) -> None:
        super().reset()
        self.waiting.clear()
        self.last_progress = None


class SLOBurnRateDetector(Detector):
    """Alerts when the fraction of recent requests missing their
    TTFT/TPOT SLOs exceeds ``burn_threshold`` over a sliding window.
    Re-arms once the miss rate falls back under half the threshold."""

    name = "slo_burn"
    severity = "warning"

    def __init__(self, ttft_sla_s: float = 1.0, tpot_sla_s: float = 0.25,
                 window: int = 32, burn_threshold: float = 0.5,
                 min_count: int = 8, **kw):
        super().__init__(**kw)
        self.ttft_sla_s = float(ttft_sla_s)
        self.tpot_sla_s = float(tpot_sla_s)
        self.burn_threshold = float(burn_threshold)
        self.min_count = int(min_count)
        self._misses = deque(maxlen=int(window))

    def observe(self, ttft_s: float, tpot_s: float) -> Optional[Alert]:
        miss = ttft_s > self.ttft_sla_s or tpot_s > self.tpot_sla_s
        self._misses.append(bool(miss))
        n = len(self._misses)
        if n < self.min_count:
            return None
        rate = sum(self._misses) / n
        if rate >= self.burn_threshold:
            return self._maybe_alert(
                f"SLO burn: {rate:.0%} of last {n} requests missed "
                f"(ttft>{self.ttft_sla_s}s or tpot>{self.tpot_sla_s}s)",
                burn_rate=round(rate, 4), window=n)
        if rate <= self.burn_threshold / 2:
            self._rearm()
        return None

    def reset(self) -> None:
        super().reset()
        self._misses.clear()


class HBMPressureDetector(Detector):
    """Alerts when resident HBM (weights + paged KV + program temp peak,
    from the performance accountant's pool gauges) exceeds
    ``threshold`` of the device limit; re-arms below ``hysteresis``.
    Backends with no memory limit (CPU) report fraction 0 and never fire."""

    name = "hbm_pressure"
    severity = "warning"

    def __init__(self, threshold: float = 0.92, hysteresis: float = 0.85, **kw):
        super().__init__(**kw)
        self.threshold = float(threshold)
        self.hysteresis = float(hysteresis)

    def observe(self, fraction: float, **attrs) -> Optional[Alert]:
        if not math.isfinite(fraction):
            return None
        if fraction > self.threshold:
            return self._maybe_alert(
                f"HBM pressure: {fraction:.0%} of device memory resident "
                f"(threshold {self.threshold:.0%})",
                fraction=round(float(fraction), 4), **attrs)
        if fraction < self.hysteresis:
            self._rearm()
        return None


class StragglerDetector(Detector):
    """Cross-rank collective-wait skew (the TP-mesh hang precursor).

    Consumes per-rank metric snapshots — each carrying the existing
    ``comm_latency_seconds{op=...}`` histograms — pools each rank's
    collective-wait distribution (``agg.comm_wait_profile``) and alerts
    when any rank's p50 exceeds ``ratio`` × the cross-rank median p50
    (``DS_TPU_STRAGGLER_X``, default 4). Re-arms when no rank diverges.
    Driven from wherever per-rank snapshots meet: a merge tool or a
    controller process feeding ``HealthMonitor.observe_rank_snapshots``.
    """

    name = "comm_straggler"
    severity = "warning"

    def __init__(self, ratio: Optional[float] = None, min_count: int = 8, **kw):
        super().__init__(**kw)
        self.ratio = float(ratio if ratio is not None
                           else knobs.get_float("DS_TPU_STRAGGLER_X"))
        self.min_count = int(min_count)
        self.last_report: Dict = {}

    def observe_snapshots(self, snaps) -> Optional[Alert]:
        from .agg import detect_stragglers
        report = detect_stragglers(snaps, ratio=self.ratio,
                                   min_count=self.min_count)
        self.last_report = report
        stragglers = report["stragglers"]
        if not stragglers:
            self._rearm()
            return None
        worst = max(stragglers, key=lambda s: s["ratio"])
        return self._maybe_alert(
            f"rank {worst['rank']} collective-wait p50 "
            f"{worst['p50'] * 1e3:.1f}ms is {worst['ratio']:.1f}x the "
            f"cross-rank median ({report['median_p50'] * 1e3:.1f}ms, "
            f"threshold {self.ratio:g}x)",
            ranks=[s["rank"] for s in stragglers],
            p50_by_rank=report["p50_by_rank"],
            median_p50=report["median_p50"])


# ---------------------------------------------------------------- monitor

class HealthMonitor:
    """Detector host + alert dispatcher. One process-wide instance via
    ``get_health_monitor()``; direct construction is for tests."""

    def __init__(self, registry=None, sinks: Optional[List[Callable]] = None,
                 event_log=None, max_alerts: int = 256):
        reg = registry if registry is not None else get_registry()
        self._reg = reg
        self._g_status = reg.gauge("health_status")
        self._g_status.set(1.0)
        self._detectors: Dict[str, Detector] = {}
        self._sinks: List[Callable] = list(sinks or [])
        self._event_log = event_log
        self._external: set = set()  # one-shot alert names holding status at 0
        self._alerts = deque(maxlen=int(max_alerts))
        self._lock = threading.Lock()

    # -------------------------------------------------------------- wiring
    def add_sink(self, sink: Callable) -> None:
        if sink not in self._sinks:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable) -> None:
        if sink in self._sinks:
            self._sinks.remove(sink)

    def ensure_detector(self, detector: Detector) -> Detector:
        """Idempotent registration: the first detector wins per name (so
        repeated engine construction in one process keeps one state)."""
        with self._lock:
            existing = self._detectors.get(detector.name)
            if existing is not None:
                return existing
            self._detectors[detector.name] = detector
            return detector

    def detector(self, name: str) -> Optional[Detector]:
        return self._detectors.get(name)

    # ---------------------------------------------------------- observers
    def observe_loss(self, loss: float) -> None:
        d = self._detectors.get(NonFiniteLossDetector.name)
        if d is not None:
            self._dispatch(d.observe(float(loss)))

    def observe_grad_norm(self, gnorm: float) -> None:
        d = self._detectors.get(GradNormSpikeDetector.name)
        if d is not None:
            self._dispatch(d.observe(float(gnorm)))

    def observe_request(self, ttft_s: float, tpot_s: float) -> None:
        d = self._detectors.get(SLOBurnRateDetector.name)
        if d is not None:
            self._dispatch(d.observe(float(ttft_s), float(tpot_s)))

    def observe_hbm(self, fraction: float, **attrs) -> None:
        d = self._detectors.get(HBMPressureDetector.name)
        if d is not None:
            self._dispatch(d.observe(float(fraction), **attrs))

    def observe_rank_snapshots(self, snaps) -> None:
        """Feed merged-view inputs (a list of per-rank snapshot dicts)
        into the cross-rank detectors; registers the straggler detector
        on first use so callers need no wiring of their own."""
        d = self.ensure_detector(StragglerDetector())
        self._dispatch(d.observe_snapshots(snaps))

    def on_event(self, ts, kind, uid, attrs) -> None:
        """EventLog listener: streams lifecycle events into detectors.
        Never dispatches from here — alerting happens in ``poll``."""
        if kind == "alert":
            return
        for d in self._detectors.values():
            d.on_event(ts, kind, uid, attrs)

    def poll(self, now: Optional[float] = None) -> None:
        """Give clock-driven detectors (stall) a chance to fire; called
        from the serving loops."""
        for d in self._detectors.values():
            self._dispatch(d.poll(now))

    # ---------------------------------------------------------- alerting
    def raise_alert(self, name: str, message: str, severity: str = "error",
                    **attrs) -> Alert:
        """External one-shot structured alert (e.g. a watchdog timeout).
        Holds ``health_status`` at 0 until ``resolve(name)``/``reset``."""
        alert = Alert(detector=name, severity=severity, message=message,
                      attrs=attrs)
        self._external.add(name)
        self._deliver(alert)
        return alert

    def resolve(self, name: str) -> None:
        self._external.discard(name)
        self._refresh_status()

    def _dispatch(self, alert: Optional[Alert]) -> None:
        if alert is not None:
            self._deliver(alert)
        else:
            self._refresh_status()

    def _deliver(self, alert: Alert) -> None:
        self._alerts.append(alert)
        self._reg.counter("health_alerts_total", detector=alert.detector).inc()
        self._refresh_status()
        log = self._event_log
        if log is None:
            from .events import get_event_log
            log = get_event_log()
        log.emit("alert", -1, detector=alert.detector,
                 severity=alert.severity, message=alert.message,
                 **alert.attrs)
        for sink in self._sinks:
            try:
                sink(alert)
            except Exception:
                pass  # a broken sink must not take down the training loop

    def _refresh_status(self) -> None:
        firing = bool(self._external) or any(
            d.firing for d in self._detectors.values())
        self._g_status.set(0.0 if firing else 1.0)

    # ---------------------------------------------------------- reading
    def alerts(self) -> List[Alert]:
        return list(self._alerts)

    @property
    def healthy(self) -> bool:
        return self._g_status.value >= 1.0

    def reset(self) -> None:
        """Re-arm every detector and clear alert state (tests, bench
        rung boundaries). Wiring (detectors, sinks) stays."""
        for d in self._detectors.values():
            d.reset()
        self._external.clear()
        self._alerts.clear()
        self._refresh_status()


_MONITOR: Optional[HealthMonitor] = None


def get_health_monitor() -> HealthMonitor:
    """The process-wide monitor: logger sink by default, JSONL sink when
    ``DS_TPU_HEALTH_LOG=<path>``, subscribed to the global event log."""
    global _MONITOR
    if _MONITOR is None:
        _MONITOR = HealthMonitor()
        _MONITOR.add_sink(LoggerAlertSink())
        path = knobs.get_str("DS_TPU_HEALTH_LOG", "")
        if path not in ("", "0"):
            _MONITOR.add_sink(JsonlAlertSink(path))
        from .events import get_event_log
        get_event_log().add_listener(_MONITOR.on_event)
        from .flight import maybe_attach_flight_recorder
        maybe_attach_flight_recorder(_MONITOR)  # no-op without DS_TPU_FLIGHT_DIR
    return _MONITOR
