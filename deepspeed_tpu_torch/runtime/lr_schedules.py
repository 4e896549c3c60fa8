"""LR schedules with the reference's names and semantics.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``: ``WarmupLR``,
``WarmupDecayLR``, ``OneCycle`` (with ``get_mom``) and ``LRRangeTest``,
each a ``step -> lr`` callable. The step is a 0-d integer tensor (the
optimizer's device count before the increment, as the JAX package passes
``state.count``) or a Python int; the lr is a 0-d fp32 tensor on the
step's device, computed with torch ops in fp32 as the ``jnp`` versions
are, so a schedule runs inside a captured training step and reads nothing
back. A client ``lr_scheduler`` handed to ``initialize`` is called the
same way and must accept such a tensor.
"""

import math
from typing import Any, Callable, Dict, Optional

import torch

VALID_LR_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR"]


def _step(step) -> torch.Tensor:
    """The step as a 0-d fp32 tensor (on its device when it is one)."""
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(float(step), dtype=torch.float32)


class WarmupLR:
    """Warm up from ``warmup_min_lr`` to ``warmup_max_lr`` (log or linear
    in the step), then hold."""

    def __init__(self, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                 warmup_type: str = "log", **_):
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in ("log", "linear"):
            raise ValueError(f"warmup_type {warmup_type} not in (log, linear)")
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def __call__(self, step) -> torch.Tensor:
        step = _step(step)
        if self.warmup_type == "log":
            gamma = self.inverse_log_warm_up * torch.log(step.clamp_min(1.0))
        else:
            gamma = step / self.warmup_num_steps
        gamma = gamma.clamp(0.0, 1.0)
        return self.warmup_min_lr + \
            (self.warmup_max_lr - self.warmup_min_lr) * gamma


class WarmupDecayLR(WarmupLR):
    """``WarmupLR``, then a linear decay to 0 at ``total_num_steps``."""

    def __init__(self, total_num_steps: int = 10000, **kwargs):
        super().__init__(**kwargs)
        self.total_num_steps = max(2, total_num_steps)

    def __call__(self, step) -> torch.Tensor:
        step = _step(step)
        warm = super().__call__(step)
        decay_frac = (self.total_num_steps - step) / max(
            1.0, self.total_num_steps - self.warmup_num_steps)
        decay = self.warmup_max_lr * decay_frac.clamp(0.0, 1.0)
        return torch.where(step < self.warmup_num_steps, warm, decay)


class OneCycle:
    """A triangular cycle then a decay; momentum cycles inversely."""

    def __init__(self, cycle_min_lr: float = 0.0, cycle_max_lr: float = 0.001,
                 decay_lr_rate: float = 0.0,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = True,
                 cycle_min_mom: float = 0.85, cycle_max_mom: float = 0.99,
                 decay_mom_rate: float = 0.0, last_batch_iteration: int = -1,
                 **_):
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = float(cycle_first_step_size)
        self.second = float(cycle_second_step_size
                            if cycle_second_step_size is not None
                            else cycle_first_step_size)
        self.decay_step_size = float(decay_step_size)
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate
        self.total_size = self.first + self.second

    def _cycle_phase(self, step):
        step = _step(step)
        up_frac = step / max(self.first, 1.0)
        down_frac = 1.0 - (step - self.first) / max(self.second, 1.0)
        frac = torch.where(step <= self.first, up_frac, down_frac)
        return frac.clamp(0.0, 1.0), step > self.total_size

    def __call__(self, step) -> torch.Tensor:
        frac, in_decay = self._cycle_phase(step)
        cyc = self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * frac
        if self.decay_step_size > 0:
            decay_steps = (_step(step) - self.total_size) \
                / self.decay_step_size
            dec = self.cycle_min_lr / \
                (1.0 + decay_steps.clamp_min(0.0) * self.decay_lr_rate)
        else:
            dec = torch.full_like(cyc, self.cycle_min_lr)
        return torch.where(in_decay, dec, cyc)

    def get_mom(self, step) -> Optional[torch.Tensor]:
        if not self.cycle_momentum:
            return None
        frac, in_decay = self._cycle_phase(step)
        cyc = self.cycle_max_mom - \
            (self.cycle_max_mom - self.cycle_min_mom) * frac
        return torch.where(in_decay, torch.full_like(cyc, self.cycle_max_mom),
                           cyc)


class LRRangeTest:
    """A rising LR sweep for finding the stable range."""

    def __init__(self, lr_range_test_min_lr: float = 1e-3,
                 lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0,
                 lr_range_test_staircase: bool = False, **_):
        self.min_lr = lr_range_test_min_lr
        self.step_size = max(1, lr_range_test_step_size)
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def __call__(self, step) -> torch.Tensor:
        interval = _step(step) / self.step_size
        if self.staircase:
            interval = torch.floor(interval)
        return self.min_lr * (1.0 + interval * self.step_rate)


SCHEDULE_REGISTRY: Dict[str, Any] = {
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "OneCycle": OneCycle,
    "LRRangeTest": LRRangeTest,
}


def get_lr_schedule(name: Optional[str],
                    params: Dict[str, Any]) -> Optional[Callable]:
    if name is None:
        return None
    if name not in SCHEDULE_REGISTRY:
        raise ValueError(f"Unknown lr schedule {name}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    return SCHEDULE_REGISTRY[name](**params)
