"""The user-facing MoE layer.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (reference
``deepspeed/moe/layer.py:15``): a ``TopKGate`` and an ``Experts`` bank
behind a ``MOELayer``, with Residual-MoE's learned 2-way blend
(arXiv:2201.05596) when ``use_residual``. The port has one device and no
expert axis: ``ep_size`` is kept for API parity, and a value above 1
raises naming the distributed slice.
"""

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.logging import log_dist
from .experts import Experts, reset_parameters
from .sharded_moe import MOELayer, TopKGate


class MoE(nn.Module):
    """Mixture-of-experts layer: ``forward(hidden_states, used_token=None,
    deterministic=False) -> (output, l_aux, exp_counts)``. ``expert`` is a
    template ``nn.Module``; the arguments are the reference's
    (``layer.py:16-49``)."""

    def __init__(self, hidden_size: int, expert: nn.Module,
                 num_experts: int = 1, ep_size: int = 1, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True,
                 enable_expert_tensor_parallelism: bool = False):
        super().__init__()
        assert noisy_gate_policy is None or noisy_gate_policy in (
            "None", "Jitter", "RSample"), \
            f"Unsupported noisy_gate_policy: {noisy_gate_policy}"
        if ep_size != 1:
            raise NotImplementedError(
                f"ep_size={ep_size} (expert parallelism) arrives with the "
                f"distributed slice of the port (ROADMAP.md Queue 1, item 9)")
        log_dist(f"Creating MoE layer with num_experts: {num_experts} | k: "
                 f"{k}", ranks=[0])
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.use_residual = use_residual
        self.deepspeed_moe = MOELayer(
            TopKGate(hidden_size, num_experts, k=k,
                     capacity_factor=capacity_factor,
                     eval_capacity_factor=eval_capacity_factor,
                     min_capacity=min_capacity,
                     noisy_gate_policy=noisy_gate_policy,
                     drop_tokens=drop_tokens, use_rts=use_rts),
            Experts(expert, num_experts))
        if use_residual:
            self.mlp = reset_parameters(copy.deepcopy(expert))
            self.coefficient = nn.Linear(hidden_size, 2)

    def forward(self, hidden_states, used_token=None,
                deterministic: bool = False):
        output, l_aux, exp_counts = self.deepspeed_moe(
            hidden_states, used_token, deterministic)
        if self.use_residual:
            mlp_out = self.mlp(hidden_states)
            if isinstance(mlp_out, tuple):
                mlp_out = mlp_out[0]
            w = self.coefficient.weight
            dt = torch.promote_types(hidden_states.dtype, w.dtype)
            coef = F.linear(hidden_states.to(dt), w.to(dt),
                            self.coefficient.bias.to(dt)).softmax(dim=-1)
            output = output * coef[..., 0:1] + mlp_out * coef[..., 1:2]
        return output, l_aux, exp_counts


def set_gating_generator(module: nn.Module,
                         generator: Optional[torch.Generator]) -> int:
    """Point every ``TopKGate`` in ``module`` at ``generator`` (the
    training engine's gating generator); returns how many there are."""
    gates = [m for m in module.modules() if isinstance(m, TopKGate)]
    for gate in gates:
        gate.generator = generator
    return len(gates)
