"""Stacked expert bank.

Counterpart of ``deepspeed_tpu/moe/experts.py``: ``num_experts``
independent copies of a template module whose parameters are stacked on a
leading ``[num_experts]`` dim, as the JAX package's ``nn.vmap``-lifted
``stacked`` child holds them. The bank runs every expert in one call
(``torch.func.functional_call`` under ``torch.vmap``: each expert's
matmuls become one batched matmul). The stacked parameters live under
``experts.stacked.<template name>``, so a JAX tree's
``.../experts/stacked/<module>/kernel [E, in, out]`` is the port's
``...experts.stacked.<module>.weight [E, out, in]`` transposed in its
last two dims, expert for expert.
"""

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call


def reset_parameters(module: nn.Module) -> nn.Module:
    """Draw ``module``'s parameters anew: each submodule's own
    ``reset_parameters`` where it has one."""
    for sub in module.modules():
        if sub is not module and hasattr(sub, "reset_parameters"):
            sub.reset_parameters()
    if hasattr(module, "reset_parameters"):
        module.reset_parameters()
    return module


class Experts(nn.Module):
    """Apply ``num_experts`` independent copies of ``expert`` to ``[E, C,
    M]``, expert ``e`` to ``[e]``. Each copy is drawn anew
    (:func:`reset_parameters`), so the experts start from independent
    weights, as the JAX bank's split ``params`` keys give them. If the
    expert returns a tuple, its first element is used (reference
    ``experts.py:29``)."""

    def __init__(self, expert: nn.Module, num_experts: int = 1):
        super().__init__()
        self.num_experts = num_experts
        self.stacked = copy.deepcopy(expert)
        slots = {name: p.new_empty((num_experts,) + tuple(p.shape))
                 for name, p in expert.named_parameters()}
        with torch.no_grad():
            for e in range(num_experts):     # one fresh copy at a time
                fresh = reset_parameters(copy.deepcopy(expert))
                for name, p in fresh.named_parameters():
                    slots[name][e].copy_(p)
        for name, t in slots.items():
            owner, _, attr = name.rpartition(".")
            self.stacked.get_submodule(owner)._parameters[attr] = \
                nn.Parameter(t)

    def forward(self, dispatched):
        if dispatched.shape[0] != self.num_experts:
            raise ValueError(f"expected leading expert dim "
                             f"{self.num_experts}, got "
                             f"{tuple(dispatched.shape)}")
        params = dict(self.stacked.named_parameters())

        def one(p, x):
            out = functional_call(self.stacked, p, (x,))
            return out[0] if isinstance(out, tuple) else out

        return torch.vmap(one)(params, dispatched)


class ExpertMLP(nn.Module):
    """The default expert: a two-layer GELU (tanh) MLP, ``fc1`` then
    ``fc2``, computed in ``dtype`` as the JAX ``ExpertMLP``'s flax Denses
    compute (lecun-normal kernels, zero biases)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 dtype: Optional[torch.dtype] = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.dtype = dtype
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        for fc in (self.fc1, self.fc2):
            fc.weight.normal_(0.0, 1.0 / math.sqrt(fc.in_features))
            fc.bias.zero_()

    def forward(self, x):
        dt = self.dtype or x.dtype
        h = F.linear(x.to(dt), self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        h = F.gelu(h, approximate="tanh")
        return F.linear(h, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
