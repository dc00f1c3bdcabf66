"""Registry → MonitorMaster bridge.

Port of ``deepspeed_tpu/telemetry/bridge.py`` (framework-free). Every
flush it walks the whole registry and emits one ``("Telemetry/<series>",
value, step)`` event per series, so anything any layer records (KV
occupancy, host-tier spills, train_mfu) reaches TensorBoard, W&B or CSV
without per-metric plumbing. ``extra_events`` carries the legacy series
(``Train/Samples/lr`` etc.) verbatim so existing dashboards keep their
history even when the registry is disabled.
"""

from typing import Iterable, Optional, Tuple

Event = Tuple[str, float, int]


class MonitorBridge:
    """Flushes a ``MetricsRegistry`` into a monitor's ``write_events``.

    ``every_n_steps`` throttles full-registry flushes (the engine reads
    ``DS_TPU_TELEMETRY_FLUSH_STEPS``, default 1); ``extra_events`` always
    pass through unthrottled semantics aside — they ride whichever flush
    admits them.
    """

    def __init__(self, registry, monitor, every_n_steps: int = 1,
                 prefix: str = "Telemetry"):
        self.registry = registry
        self.monitor = monitor
        self.every_n_steps = max(1, int(every_n_steps))
        self.prefix = prefix

    def _monitor_on(self) -> bool:
        return self.monitor is not None and getattr(self.monitor, "enabled", False)

    def maybe_flush(self, step: int,
                    extra_events: Optional[Iterable[Event]] = None) -> None:
        """Flush on every Nth step. No-op (one attribute check deep) when
        no monitor writer is enabled."""
        if not self._monitor_on():
            return
        if step % self.every_n_steps != 0:
            return
        self.flush(step, extra_events=extra_events)

    def flush(self, step: int,
              extra_events: Optional[Iterable[Event]] = None) -> None:
        if not self._monitor_on():
            return
        events = list(extra_events or [])
        if self.registry.enabled:
            prefix = self.prefix
            events.extend((f"{prefix}/{name}", value, step)
                          for name, value in self.registry.series())
        if events:
            self.monitor.write_events(events)
