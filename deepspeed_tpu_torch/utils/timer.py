"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py``: a registry of named
timers that fence the device (``torch.cuda.synchronize``) at start and
stop, and a throughput timer that fences only at the edges of a reporting
window, so the steps in between stay queued on the card.
"""

import time
from collections import OrderedDict
from typing import List, Optional

import torch

from .logging import log_dist


def _synchronize() -> None:
    """Wait for the work queued on the current CUDA device, if any."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """One named timer with optional device synchronization."""

    def __init__(self, name: str, synchronize: bool = True):
        self.name = name
        self.synchronize = synchronize
        self.started = False
        self._start_time = 0.0
        self._elapsed = 0.0

    def start(self) -> None:
        if self.started:
            return
        if self.synchronize:
            _synchronize()
        self._start_time = time.perf_counter()
        self.started = True

    def stop(self) -> None:
        if not self.started:
            return
        if self.synchronize:
            _synchronize()
        self._elapsed += time.perf_counter() - self._start_time
        self.started = False

    def reset(self) -> None:
        self.started = False
        self._elapsed = 0.0

    def elapsed(self, reset: bool = True) -> float:
        """Total elapsed seconds (a running timer keeps running)."""
        was_started = self.started
        if was_started:
            self.stop()
        total = self._elapsed
        if reset:
            self.reset()
        if was_started:
            self.start()
        return total


class SynchronizedWallClockTimer:
    """Named timer registry."""

    def __init__(self):
        self.timers: "OrderedDict[str, Timer]" = OrderedDict()

    def __call__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def log(self, names: Optional[List[str]] = None, normalizer: float = 1.0,
            reset: bool = True, ranks=None) -> None:
        names = names if names is not None else list(self.timers)
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 \
                    / normalizer
                string += f" | {name}: {elapsed:.2f}"
        log_dist(string, ranks=ranks or [0])


class ThroughputTimer:
    """Samples per second over fenced windows: the first fence comes after
    ``start_step`` warm-up steps, and each report (every
    ``steps_per_output`` steps) or query closes a window with one more."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, logging_fn=None):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self._fenced_steps = 0
        self._window_steps = 0
        self._last_window_steps = 0
        self._window_t0 = None
        self.started = False

    def start(self) -> None:
        self.started = True
        if self.global_step_count == self.start_step and \
                self._window_t0 is None:
            _synchronize()
            self._window_t0 = time.perf_counter()
            self._window_steps = 0

    def stop(self, global_step: bool = True, report_speed: bool = True) -> None:
        if not self.started:
            return
        self.started = False
        if global_step:
            self.global_step_count += 1
        if self._window_t0 is None or \
                self.global_step_count <= self.start_step:
            return
        self._window_steps += 1
        if report_speed and self.steps_per_output and \
                self.global_step_count % self.steps_per_output == 0:
            self._settle()
            self.logging(
                f"step={self.global_step_count}, samples/sec (avg)="
                f"{self.avg_samples_per_sec():.2f}, samples/sec (recent)="
                f"{self.recent_samples_per_sec():.2f}")

    def _settle(self) -> None:
        """Fold the open window into the totals (one fence)."""
        if self._window_t0 is not None and self._window_steps > 0:
            _synchronize()
            duration = time.perf_counter() - self._window_t0
            self.total_elapsed_time += duration
            self.step_elapsed_time = duration
            self._fenced_steps += self._window_steps
            self._last_window_steps = self._window_steps
            self._window_t0 = time.perf_counter()
            self._window_steps = 0

    def avg_samples_per_sec(self) -> float:
        self._settle()
        if self._fenced_steps > 0 and self.total_elapsed_time > 0:
            return self.batch_size / (self.total_elapsed_time
                                      / self._fenced_steps)
        return 0.0

    def recent_samples_per_sec(self) -> float:
        self._settle()
        if self._last_window_steps > 0 and self.step_elapsed_time > 0:
            return self.batch_size * self._last_window_steps \
                / self.step_elapsed_time
        return 0.0
