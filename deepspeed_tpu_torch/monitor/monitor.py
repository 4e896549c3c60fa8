"""Experiment monitoring: TensorBoard and CSV fan-out.

Counterpart of ``deepspeed_tpu/monitor/monitor.py`` (``MonitorMaster``,
``TensorBoardMonitor``, ``csvMonitor``). Events are ``(tag, value, step)``
tuples, written by rank 0 only. TensorBoard goes through
``torch.utils.tensorboard``; W&B is not ported (its config block raises).
"""

import csv
import os
from typing import List

from .registry import Event, events_from_scalars  # noqa: F401


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


class Monitor:
    def __init__(self, config):
        self.config = config
        self.enabled = bool(getattr(config, "enabled", False))

    def write_events(self, event_list: List[Event]) -> None:
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    """Scalars into a ``SummaryWriter`` under ``output_path/job_name``
    (``./runs`` when no path is set). Raises ``ImportError`` when the
    ``tensorboard`` package is missing."""

    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if not self.enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "the tensorboard monitor needs the 'tensorboard' package "
                "(torch.utils.tensorboard imports it)") from e
        log_dir = os.path.join(config.output_path or "./runs",
                               config.job_name)
        self.summary_writer = SummaryWriter(log_dir=log_dir)

    def write_events(self, event_list: List[Event],
                     flush: bool = True) -> None:
        if not (self.enabled and self.summary_writer):
            return
        for name, value, step in event_list:
            self.summary_writer.add_scalar(name, value, step)
        if flush:
            self.summary_writer.flush()


class csvMonitor(Monitor):
    """One ``<tag with / as _>.csv`` a tag under ``output_path/job_name``
    (``./csv_logs`` when no path is set), rows ``step,value`` under a
    ``step,<tag>`` header (the JAX package's files)."""

    def __init__(self, config):
        super().__init__(config)
        if self.enabled:
            self.log_dir = os.path.join(config.output_path or "./csv_logs",
                                        config.job_name)
            os.makedirs(self.log_dir, exist_ok=True)

    def write_events(self, event_list: List[Event]) -> None:
        if not self.enabled:
            return
        for name, value, step in event_list:
            fname = os.path.join(self.log_dir,
                                 name.replace("/", "_") + ".csv")
            is_new = not os.path.exists(fname)
            with open(fname, "a", newline="") as f:
                w = csv.writer(f)
                if is_new:
                    w.writerow(["step", name])
                w.writerow([step, value])


class MonitorMaster(Monitor):
    """Fans events out to every enabled backend; only rank 0 writes."""

    def __init__(self, ds_config):
        self.tb_monitor = TensorBoardMonitor(ds_config.tensorboard)
        self.csv_monitor = csvMonitor(ds_config.csv_monitor)
        self.enabled = self.tb_monitor.enabled or self.csv_monitor.enabled

    def write_events(self, event_list: List[Event]) -> None:
        if _rank() != 0 or not event_list:
            return
        self.tb_monitor.write_events(event_list)
        self.csv_monitor.write_events(event_list)

    def write_registry(self, registry, step: int, prefix: str = "") -> None:
        """A :class:`~deepspeed_tpu_torch.monitor.registry.MetricsRegistry`
        snapshot to every enabled backend."""
        if not self.enabled:
            return
        self.write_events(registry.to_events(step, prefix=prefix))
