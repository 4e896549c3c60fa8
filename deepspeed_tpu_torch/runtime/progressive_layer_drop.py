"""Progressive Layer Drop (PLD).

Counterpart of ``deepspeed_tpu/runtime/progressive_layer_drop.py``: a
keep-rate schedule theta(t) that anneals from 1 down to ``theta``. The
engine evaluates it on the device step count inside the (captured) step
and hands it to the model, which draws one keep decision per layer per
forward (layer l keeps with p_l = 1 - (l+1)/L * (1 - theta)) and applies
``x = x_in + keep/p_l * (block(x_in) - x_in)`` (``models/llama.py``).
"""

import torch


class ProgressiveLayerDrop:
    """theta(t) = (1 - theta_min) * exp(-gamma * t) + theta_min."""

    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = float(theta)
        self.gamma = float(gamma)

    def get_theta(self, global_step) -> torch.Tensor:
        """A 0-d fp32 tensor; ``global_step`` may be a device count, so
        nothing is read back."""
        step = torch.as_tensor(global_step).to(torch.float32)
        return (1.0 - self.theta) * torch.exp(-self.gamma * step) + \
            self.theta

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.theta}
