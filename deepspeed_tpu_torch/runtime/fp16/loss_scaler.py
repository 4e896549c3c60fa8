"""Static and dynamic loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``. The JAX
package keeps the scaler as a pytree updated inside the compiled step; the
port reads the overflow flag back to the host once per fp16 step (as the
reference DeepSpeed does), so the scaler is plain Python state here.
"""

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    cur_scale: float
    cur_iter: int          # steps since the last overflow
    cur_hysteresis: int
    static: bool = False
    scale_factor: float = 2.0
    scale_window: int = 1000
    min_scale: float = 1.0
    hysteresis: int = 2

    def replace(self, **kw) -> "LossScaleState":
        return dataclasses.replace(self, **kw)


def create_loss_scaler(fp16_config=None,
                       static_scale: Optional[float] = None
                       ) -> LossScaleState:
    """Scaler state from an ``FP16Config``: ``loss_scale == 0`` is
    dynamic, anything else static."""
    if fp16_config is not None and fp16_config.loss_scale:
        static_scale = fp16_config.loss_scale
    if static_scale is not None:
        return LossScaleState(cur_scale=float(static_scale), cur_iter=0,
                              cur_hysteresis=1, static=True)
    cfg = fp16_config
    return LossScaleState(
        cur_scale=float(2.0 ** (cfg.initial_scale_power if cfg else 16)),
        cur_iter=0,
        cur_hysteresis=cfg.hysteresis if cfg else 2,
        scale_window=cfg.loss_scale_window if cfg else 1000,
        min_scale=cfg.min_loss_scale if cfg else 1.0,
        hysteresis=cfg.hysteresis if cfg else 2)


def update_scale(state: LossScaleState, overflow: bool) -> LossScaleState:
    """One step of the dynamic automaton: on overflow, spend one unit of
    hysteresis, or halve the scale (not below ``min_scale``) once it is
    spent; after ``scale_window`` clean steps, double the scale and refill
    the hysteresis. A clean step between two overflows does not refill
    it."""
    if state.static:
        return state
    if overflow:
        if state.cur_hysteresis <= 1:
            return state.replace(
                cur_scale=max(state.cur_scale / state.scale_factor,
                              state.min_scale), cur_iter=0)
        return state.replace(cur_hysteresis=state.cur_hysteresis - 1,
                             cur_iter=0)
    if (state.cur_iter + 1) % state.scale_window == 0:
        return state.replace(cur_scale=state.cur_scale * state.scale_factor,
                             cur_hysteresis=state.hysteresis,
                             cur_iter=state.cur_iter + 1)
    return state.replace(cur_iter=state.cur_iter + 1)
