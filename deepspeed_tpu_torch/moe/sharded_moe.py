"""Top-k gated mixture of experts (GShard gating).

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (reference
``deepspeed/moe/sharded_moe.py``: ``top1gating`` :177, ``top2gating``
:278, ``TopKGate`` :351, ``MOELayer`` :439). The gate math is the JAX
package's, in fp32: softmax gates, a static capacity per expert, the
load-balancing loss, random token selection (RTS), Gumbel top-2, and
dispatch / combine as einsums over ``[S, E, C]`` masks. On one device
there is no all-to-all: the dispatched ``[E, C, M]`` tensor goes straight
to the expert bank.

Every shape is static (no ``nonzero``, ``unique`` or read-back), so a
captured training step replays the gate. Random draws (Gumbel noise, RTS
priorities, multiplicative jitter) come from an explicit
``torch.Generator``: ``TopKGate.generator``, which the training engine
sets to its gating generator (as the JAX engine hands the gate the
``gating`` key ``fold_in(base, 1)``). Their values are torch's, not
``jax.random``'s. Top-2 in eval (``deterministic=True``) draws its Gumbel
noise from a generator seeded 0 on each call, where JAX draws it from
``PRNGKey(0)``.
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    """Static capacity per expert (reference ``_capacity``: ceil(S/E * cf),
    at least ``min_capacity``)."""
    capacity = int(math.ceil((num_tokens / num_experts) * capacity_factor))
    return max(capacity, min_capacity)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a row of zeros, as ``jax.nn.one_hot`` does (and
    nothing is read back, unlike ``F.one_hot``'s range check)."""
    return (idx.unsqueeze(-1) ==
            torch.arange(n, device=idx.device)).to(torch.float32)


def uniform_rsample(generator: torch.Generator, shape, device=None
                    ) -> torch.Tensor:
    """U[0, 1) noise, fp32, from ``generator``: RTS's priorities and the
    jitter's draws."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def multiplicative_jitter(x: torch.Tensor, generator: torch.Generator,
                          epsilon: float = 1e-2) -> torch.Tensor:
    """``x`` times U(1 - eps, 1 + eps) noise from ``generator`` (reference
    ``multiplicative_jitter`` :46)."""
    if epsilon == 0:
        return x
    u = uniform_rsample(generator, x.shape, x.device).to(x.dtype)
    return x * (1.0 - epsilon + 2.0 * epsilon * u)


def gumbel_rsample(generator: torch.Generator, shape, device=None
                   ) -> torch.Tensor:
    """Standard Gumbel noise, fp32: ``-log(-log(U))`` with ``U`` from
    ``generator`` in ``[tiny, 1)`` (the form ``jax.random.gumbel``
    draws)."""
    u = uniform_rsample(generator, shape, device).clamp_min(
        torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _keep_top_tokens(mask: torch.Tensor, priority: torch.Tensor,
                     capacity: int) -> torch.Tensor:
    """Keep at most ``capacity`` tokens per expert, highest ``priority``
    first (``mask`` and ``priority`` ``[S, E]``; returns the filtered
    mask). Among equal priorities the lowest token index wins, as
    ``jax.lax.top_k`` orders them: without RTS the priority is the 0/1
    mask itself, so ties are the rule, and ``torch.topk`` promises no
    order among equals. A stable descending sort keeps it."""
    s = mask.shape[0]
    if capacity >= s:
        return mask
    top_idx = torch.sort(priority.t(), dim=1, descending=True,
                         stable=True).indices[:, :capacity]   # [E, capacity]
    keep = torch.zeros_like(mask.t()).scatter_(1, top_idx, 1.0).t()
    return mask * keep


def top1gating(logits: torch.Tensor, capacity_factor: float,
               min_capacity: int, used_token: Optional[torch.Tensor] = None,
               noisy_gate_policy: Optional[str] = None,
               drop_tokens: bool = True, use_rts: bool = True,
               generator: Optional[torch.Generator] = None):
    """Top-1 gating over ``logits [S, E]``, in fp32. Returns ``(l_aux,
    combine_weights [S, E, C], dispatch_mask [S, E, C], exp_counts [E]
    int32)``. ``RSample`` adds Gumbel noise to the logits that choose the
    expert, and RTS ranks each expert's tokens by a uniform draw before
    the capacity cut: both draw from ``generator`` (in that order) and
    raise without one. Without ``drop_tokens`` the capacity is S."""
    logits = logits.float()
    s, e = logits.shape
    gates = logits.softmax(dim=1)
    capacity = _capacity(s, e, capacity_factor, min_capacity) \
        if drop_tokens else s

    if noisy_gate_policy == "RSample":
        if generator is None:
            raise ValueError("RSample noisy gating needs a generator")
        select = logits + gumbel_rsample(generator, logits.shape,
                                         logits.device)
    else:
        select = gates
    mask1 = _one_hot(select.argmax(dim=1), e)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None].float()
    exp_counts = mask1.sum(dim=0).detach().to(torch.int32)

    # load-balancing loss: E * sum(mean gate prob * dispatch fraction)
    l_aux = (gates.mean(dim=0) * mask1.mean(dim=0)).sum() * e

    if use_rts:
        if generator is None:
            raise ValueError("Random Token Selection needs a generator")
        priority = mask1 * uniform_rsample(generator, mask1.shape,
                                           mask1.device)
    else:
        priority = mask1
    mask1 = _keep_top_tokens(mask1, priority, capacity)

    # each surviving token's slot in its expert's capacity buffer
    locations1 = mask1.cumsum(dim=0) - mask1
    locations1_s = (locations1 * mask1).sum(dim=1).to(torch.int64)
    gates = gates * mask1
    combine_weights = torch.einsum("se,sc->sec", gates,
                                   _one_hot(locations1_s, capacity))
    return l_aux, combine_weights, combine_weights > 0, exp_counts


def top2gating(logits: torch.Tensor, capacity_factor: float,
               min_capacity: int,
               generator: Optional[torch.Generator] = None):
    """Top-2 gating (reference ``top2gating`` :278): the first expert by
    the gates, the second by the Gumbel-max trick over the other logits
    (noise from ``generator``, which is required); the two winners' gate
    probabilities renormalized. The capacity is twice top-1's."""
    if generator is None:
        raise ValueError("top-2 gating needs a generator (Gumbel sampling)")
    logits = logits.float()
    s, e = logits.shape
    gates = logits.softmax(dim=1)
    capacity = _capacity(s, e, capacity_factor * 2.0, min_capacity)

    mask1 = _one_hot(gates.argmax(dim=1), e)
    noisy = logits + gumbel_rsample(generator, logits.shape, logits.device)
    except1 = torch.where(mask1 > 0, torch.full_like(noisy, -math.inf),
                          noisy)
    mask2 = _one_hot(except1.argmax(dim=1), e)

    locations1 = mask1.cumsum(dim=0) - mask1
    locations2 = mask2.cumsum(dim=0) - mask2 + mask1.sum(dim=0,
                                                         keepdim=True)
    # an expert's load counts its first- and second-choice tokens
    exp_counts = (mask1 + mask2).sum(dim=0).detach().to(torch.int32)
    l_aux = (gates.mean(dim=0) * mask1.mean(dim=0)).mean() * e * e

    mask1 = mask1 * (locations1 < capacity)
    mask2 = mask2 * (locations2 < capacity)
    locations1_s = (locations1 * mask1).sum(dim=1).to(torch.int64)
    locations2_s = (locations2 * mask2).sum(dim=1).to(torch.int64)

    gates1_s = (gates * mask1).sum(dim=1)
    gates2_s = (gates * mask2).sum(dim=1)
    denom = (gates1_s + gates2_s).clamp_min(torch.finfo(torch.float32).eps)
    gates1 = (gates1_s / denom)[:, None] * mask1
    gates2 = (gates2_s / denom)[:, None] * mask2
    combine_weights = (
        torch.einsum("se,sc->sec", gates1, _one_hot(locations1_s, capacity))
        + torch.einsum("se,sc->sec", gates2,
                       _one_hot(locations2_s, capacity)))
    return l_aux, combine_weights, combine_weights > 0, exp_counts


class TopKGate(nn.Module):
    """The gate (reference ``TopKGate`` :351): a bias-free projection to
    the experts' logits and top-1 or top-2 gating, in fp32. Noise is drawn
    from ``self.generator`` (None until the training engine, or the
    caller, sets one); training-time RTS, ``RSample`` and top-2 raise
    without it, as JAX's raise without a ``gating`` key."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 8,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True):
        super().__init__()
        if k not in (1, 2):
            raise ValueError("Only top-1 and top-2 gatings are supported.")
        self.k = k
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts
        self.wg = nn.Linear(model_dim, num_experts, bias=False)
        #: the source of the gate's random draws in training
        self.generator: Optional[torch.Generator] = None

    def forward(self, x, used_token=None, deterministic: bool = False):
        x = x.float()
        gen = None if deterministic else self.generator
        if self.noisy_gate_policy == "Jitter" and gen is not None:
            x = multiplicative_jitter(x, gen)
        logits = F.linear(x, self.wg.weight.float())
        cf = self.eval_capacity_factor if deterministic \
            else self.capacity_factor
        if self.k == 1:
            return top1gating(
                logits, cf, self.min_capacity, used_token,
                None if deterministic else self.noisy_gate_policy,
                self.drop_tokens, self.use_rts and not deterministic, gen)
        if gen is None and not deterministic:
            # as top-1's RTS: training-time stochastic gating is seeded
            # explicitly, never silently fixed
            raise ValueError(
                "top-2 gating in training needs TopKGate.generator (the "
                "training engine sets it), or deterministic=True for eval")
        if gen is None:
            gen = torch.Generator(device=logits.device).manual_seed(0)
        return top2gating(logits, cf, self.min_capacity, gen)


class MOELayer(nn.Module):
    """GShard MoE layer (reference ``MOELayer`` :439): gate the tokens,
    dispatch them ``einsum('sec,sm->ecm')`` into the expert bank's
    ``[E, C, M]`` buffers, run the experts and combine
    ``einsum('sec,ecm->sm')``. Returns ``(output, l_aux, exp_counts)``."""

    def __init__(self, gate: TopKGate, experts: nn.Module):
        super().__init__()
        self.gate = gate
        self.experts = experts

    def forward(self, x, used_token=None, deterministic: bool = False):
        tokens = x.reshape(-1, x.shape[-1])
        l_aux, combine_weights, dispatch_mask, exp_counts = self.gate(
            tokens, used_token, deterministic)
        dispatched = torch.einsum("sec,sm->ecm", dispatch_mask.to(x.dtype),
                                  tokens)
        expert_output = self.experts(dispatched)
        combined = torch.einsum("sec,ecm->sm", combine_weights.to(x.dtype),
                                expert_output)
        return combined.reshape(x.shape), l_aux, exp_counts
