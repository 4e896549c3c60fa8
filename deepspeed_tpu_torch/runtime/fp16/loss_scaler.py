"""Static and dynamic loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``. As in the
JAX package, the automaton's state lives on the device (``cur_scale``
fp32, ``cur_iter`` and ``cur_hysteresis`` int32, 0-d tensors) and
``update_scale`` moves it with ``torch.where`` only, so the training step
never reads the overflow flag back and runs inside a CUDA graph; the
static settings stay Python values.
"""

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    cur_scale: torch.Tensor       # fp32 0-d
    cur_iter: torch.Tensor        # int32 0-d: steps since the last overflow
    cur_hysteresis: torch.Tensor  # int32 0-d
    static: bool = False
    scale_factor: float = 2.0
    scale_window: int = 1000
    min_scale: float = 1.0
    hysteresis: int = 2

    def replace(self, **kw) -> "LossScaleState":
        return dataclasses.replace(self, **kw)

    def copy_(self, other: "LossScaleState") -> "LossScaleState":
        """Write ``other``'s device values into this state's tensors in
        place (a captured step keeps reading the same memory)."""
        for name in ("cur_scale", "cur_iter", "cur_hysteresis"):
            getattr(self, name).copy_(getattr(other, name))
        return self


def create_loss_scaler(fp16_config=None,
                       static_scale: Optional[float] = None,
                       device=None) -> LossScaleState:
    """Scaler state from an ``FP16Config`` on ``device``: ``loss_scale ==
    0`` is dynamic, anything else static."""
    def state(scale, cur_hysteresis, **kw):
        return LossScaleState(
            cur_scale=torch.tensor(float(scale), dtype=torch.float32,
                                   device=device),
            cur_iter=torch.zeros((), dtype=torch.int32, device=device),
            cur_hysteresis=torch.tensor(int(cur_hysteresis),
                                        dtype=torch.int32, device=device),
            **kw)

    if fp16_config is not None and fp16_config.loss_scale:
        static_scale = fp16_config.loss_scale
    if static_scale is not None:
        return state(static_scale, 1, static=True)
    cfg = fp16_config
    return state(2.0 ** (cfg.initial_scale_power if cfg else 16),
                 cfg.hysteresis if cfg else 2,
                 scale_window=cfg.loss_scale_window if cfg else 1000,
                 min_scale=cfg.min_loss_scale if cfg else 1.0,
                 hysteresis=cfg.hysteresis if cfg else 2)


def update_scale(state: LossScaleState, overflow) -> LossScaleState:
    """One step of the dynamic automaton, as JAX ``update_scale``: on
    overflow (a device bool, or a Python bool), spend one unit of
    hysteresis, or halve the scale (not below ``min_scale``) once it is
    spent; after ``scale_window`` clean steps, double the scale and refill
    the hysteresis. A clean step between two overflows does not refill
    it. Returns a new state; the inputs are not changed."""
    if state.static:
        return state
    overflow = torch.as_tensor(overflow, dtype=torch.bool,
                               device=state.cur_scale.device)
    spent = state.cur_hysteresis <= 1
    scale_overflow = torch.where(
        spent, (state.cur_scale / state.scale_factor).clamp_min(
            state.min_scale), state.cur_scale)
    hyst_overflow = torch.where(spent, state.cur_hysteresis,
                                state.cur_hysteresis - 1)
    window_done = (state.cur_iter + 1) % state.scale_window == 0
    scale_clean = torch.where(window_done,
                              state.cur_scale * state.scale_factor,
                              state.cur_scale)
    hyst_clean = torch.where(window_done,
                             torch.full_like(state.cur_hysteresis,
                                             state.hysteresis),
                             state.cur_hysteresis)
    return state.replace(
        cur_scale=torch.where(overflow, scale_overflow, scale_clean),
        cur_hysteresis=torch.where(overflow, hyst_overflow, hyst_clean),
        cur_iter=torch.where(overflow, torch.zeros_like(state.cur_iter),
                             state.cur_iter + 1))
