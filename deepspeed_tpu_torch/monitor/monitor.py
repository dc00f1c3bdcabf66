"""Metric event writers.

Port of ``deepspeed_tpu/monitor/monitor.py`` (reference DeepSpeed
``deepspeed/monitor/monitor.py`` ``MonitorMaster``): a fan-out over
TensorBoard, W&B and CSV writers. Events are ``(label, value, step)`` tuples
written only from process 0, which is rank 0 of ``torch.distributed`` when it
is initialised (the reference reads ``jax.process_index``). A writer whose
package is missing logs a warning and turns itself off.
"""

import csv
import logging
import os
from typing import List, Tuple

Event = Tuple[str, float, int]

logger = logging.getLogger(__name__)


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Monitor:
    def __init__(self, config):
        self.enabled = getattr(config, "enabled", False)

    def write_events(self, events: List[Event]):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if self.enabled and _process_index() == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter

                log_dir = os.path.join(config.output_path or "./runs", config.job_name)
                self.summary_writer = SummaryWriter(log_dir=log_dir)
            except Exception as e:
                logger.warning(f"tensorboard writer unavailable: {e}")
                self.enabled = False

    def write_events(self, events: List[Event]):
        if self.summary_writer is None:
            return
        for name, value, step in events:
            self.summary_writer.add_scalar(name, value, step)
        self.summary_writer.flush()


class WandbMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self._wandb = None
        if self.enabled and _process_index() == 0:
            try:
                import wandb

                wandb.init(project=config.project, group=config.group, entity=config.team)
                self._wandb = wandb
            except Exception as e:
                logger.warning(f"wandb unavailable: {e}")
                self.enabled = False

    def write_events(self, events: List[Event]):
        if self._wandb is None:
            return
        for name, value, step in events:
            self._wandb.log({name: value}, step=step)


class CsvMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.output_path = getattr(config, "output_path", "") or "./csv_monitor"
        self.job_name = getattr(config, "job_name", "job")
        if self.enabled and _process_index() == 0:
            os.makedirs(os.path.join(self.output_path, self.job_name), exist_ok=True)

    def write_events(self, events: List[Event]):
        if not self.enabled or _process_index() != 0:
            return
        for name, value, step in events:
            safe = name.replace("/", "_")
            path = os.path.join(self.output_path, self.job_name, f"{safe}.csv")
            new = not os.path.exists(path)
            with open(path, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["step", safe])
                w.writerow([step, value])


# reference spelling (deepspeed/monitor/csv_monitor.py); kept importable
csvMonitor = CsvMonitor


class MonitorMaster(Monitor):
    """The writers of a training config's ``tensorboard``, ``wandb`` and
    ``csv_monitor`` sections; enabled when any of them is."""

    def __init__(self, ds_config):
        self.tb_monitor = TensorBoardMonitor(ds_config.tensorboard)
        self.wandb_monitor = WandbMonitor(ds_config.wandb)
        self.csv_monitor = CsvMonitor(ds_config.csv_monitor)
        self.enabled = self.tb_monitor.enabled or self.wandb_monitor.enabled or self.csv_monitor.enabled

    def write_events(self, events: List[Event]):
        if not self.enabled or _process_index() != 0:
            return
        for m in (self.tb_monitor, self.wandb_monitor, self.csv_monitor):
            if m is not None and getattr(m, "enabled", False):
                m.write_events(events)
