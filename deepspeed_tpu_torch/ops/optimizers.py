"""Optimizers and their registry.

Counterpart of ``deepspeed_tpu/ops/optimizers.py``. The Adam family
(``FusedAdam``, ``FusedLamb``) updates lists of fp32 tensors in place
through kernel K3 (``ops/fused_adam.py``): one launch over the whole list
on CUDA, the plain version on the CPU. The device decides, so the JAX
config's ``pallas=True`` is accepted and changes nothing. ``Adagrad`` (no
Pallas kernel in the JAX package) runs plain ``torch._foreach`` ops.
``step(grads, grad_scale, skip)`` takes the gradients, an
optional fp32 device scalar that multiplies them first (the engine's clip
factor, computed on the card) and an optional device bool that skips the
step (the fp16 overflow): params, moments and count then stay as they
were, as the JAX step's ``keep(new, old)``.

As ``FusedAdamState.count``, the step count is a device int32 tensor
that only a step advances, and the step's scalars (``alpha = [step_size,
lr, inv_bc2]``) are computed from it on the device in fp32: the schedule
sees the count before the increment, bias correction the count after it.
Nothing is read back to the host, so a captured training step replays
with the current count.
"""

from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..runtime.config_utils import unported
from .fused_adam import fused_adam

ScalarOrSchedule = Union[float, Callable]


class _AdamBase:
    def __init__(self, params: List[torch.Tensor], lr: ScalarOrSchedule,
                 betas, eps: float):
        self.params = list(params)
        self.lr = lr
        self.b1, self.b2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        device = self.params[0].device if self.params else None
        #: optimizer steps taken (skipped fp16 steps do not count): a
        #: device int32 scalar
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.exp_avg = [torch.zeros_like(p, dtype=torch.float32)
                        for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p, dtype=torch.float32)
                           for p in self.params]
        #: K3's table for the last gradient list (``fused_adam.AdamTable``;
        #: None on the CPU): built at the first step, reused while the
        #: gradient buffers stay the same, as a captured step requires
        self.table = None

    def lr_at(self, count) -> torch.Tensor:
        """The lr at ``count`` as an fp32 scalar on the count's device."""
        if callable(self.lr):
            return torch.as_tensor(self.lr(count), dtype=torch.float32,
                                   device=self.count.device)
        return torch.full((), float(self.lr), dtype=torch.float32,
                          device=self.count.device)

    def _alpha(self, lr: torch.Tensor) -> torch.Tensor:
        """``[step_size, lr, inv_bc2]`` for the next step, fp32 on the
        device, from the post-increment count (JAX ``update_fn``)."""
        t = (self.count + 1).to(torch.float32)
        step_size = lr / (1.0 - torch.pow(self.b1, t))
        inv_bc2 = 1.0 / torch.sqrt(1.0 - torch.pow(self.b2, t))
        return torch.stack([step_size, lr, inv_bc2])

    def _advance(self, skip: Optional[torch.Tensor]) -> None:
        """The count moves by one, or by none on a skipped step."""
        self.count.add_(1 if skip is None else (~skip).to(torch.int32))


class FusedAdam(_AdamBase):
    """Adam (``adam_w_mode=False``: L2 decay folded into the gradient) or
    AdamW (decoupled decay scaled by the uncorrected lr)."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True, amsgrad: bool = False,
                 pallas: bool = False, **_):
        if amsgrad:
            raise ValueError("FusedAdam does not support the AMSGrad variant "
                             "(reference parity)")
        super().__init__(params, lr, betas, eps)
        self.weight_decay = float(weight_decay)
        self.adam_w_mode = bool(adam_w_mode)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             grad_scale: Optional[torch.Tensor] = None,
             skip: Optional[torch.Tensor] = None) -> None:
        alpha = self._alpha(self.lr_at(self.count))
        self.table = fused_adam(
            self.params, grads, self.exp_avg, self.exp_avg_sq, b1=self.b1,
            b2=self.b2, eps=self.eps, weight_decay=self.weight_decay,
            adam_w_mode=self.adam_w_mode, alpha=alpha, skip=skip,
            grad_scale=grad_scale, table=self.table)
        self._advance(skip)


class FusedLamb(_AdamBase):
    """LAMB: the bias-corrected Adam direction from K3 (run with lr 1 and no
    decay, written into the gradient buffers, which then take the LAMB
    direction in place), plus the decay, scaled by
    the trust ratio ``|p| / |direction|`` clipped to ``[min_coeff,
    max_coeff]`` (1 where either norm is 0).

    ``groups`` lists the indices of tensors that share one ratio, whose
    norms span the whole group (``sqrt`` of the summed squared norms, on
    the device). The default makes every tensor its own group; the
    training engine groups a scanned model's per-layer copies of a weight,
    which is the JAX ``[L, ...]`` leaf."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, max_coeff: float = 10.0,
                 min_coeff: float = 0.01, pallas: bool = False,
                 groups: Optional[Sequence[Sequence[int]]] = None, **_):
        super().__init__(params, lr, betas, eps)
        self.weight_decay = float(weight_decay)
        self.min_coeff, self.max_coeff = float(min_coeff), float(max_coeff)
        n = len(self.params)
        self.groups = [[i] for i in range(n)] if groups is None else \
            [list(g) for g in groups]
        if sorted(i for g in self.groups for i in g) != list(range(n)):
            raise ValueError(f"groups must cover each of the {n} tensors "
                             f"exactly once")

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             grad_scale: Optional[torch.Tensor] = None,
             skip: Optional[torch.Tensor] = None) -> None:
        lr = self.lr_at(self.count)
        alpha = self._alpha(torch.ones_like(lr))
        # u = -adam_direction lands in the gradient buffers (nothing is
        # written on a skipped step)
        self.table = fused_adam(
            self.params, grads, self.exp_avg, self.exp_avg_sq, b1=self.b1,
            b2=self.b2, eps=self.eps, weight_decay=0.0, adam_w_mode=True,
            alpha=alpha, skip=skip, grad_scale=grad_scale,
            write_update=True, table=self.table)
        self._advance(skip)
        # the LAMB direction -u + decay * p, in place of u
        directions = list(grads)
        torch._foreach_neg_(directions)
        if self.weight_decay:
            torch._foreach_add_(directions, self.params,
                                alpha=self.weight_decay)
        p_norms = torch._foreach_norm(self.params)
        d_norms = torch._foreach_norm(directions)
        for group in self.groups:
            p_norm = torch.linalg.vector_norm(
                torch.stack([p_norms[i] for i in group]))
            d_norm = torch.linalg.vector_norm(
                torch.stack([d_norms[i] for i in group]))
            ratio = torch.where((p_norm > 0) & (d_norm > 0),
                                p_norm / d_norm.clamp_min(1e-12),
                                torch.ones_like(p_norm))
            ratio = ratio.clamp(self.min_coeff, self.max_coeff)
            for i in group:
                p = self.params[i]
                new = p + -lr * ratio * directions[i]
                # a skipped step adds nothing (its directions are the
                # non-finite gradients)
                p.copy_(new if skip is None else torch.where(skip, p, new))


class Adagrad:
    """Adagrad as the JAX package builds it (``ops/optimizers.py``
    ``Adagrad``: ``optax.adagrad`` after ``add_decayed_weights``): the
    decay added to the gradient, the sum of squares from 0.1 (optax's
    ``initial_accumulator_value``), the update ``g * rsqrt(sum + eps)``
    (0 where the sum is 0) scaled by the lr at the count before the step.
    The JAX package has no Pallas kernel for it: plain ``torch._foreach``
    ops on the device, captured with the rest of the step. The count moves
    as the Adam family's."""

    def __init__(self, params, lr: ScalarOrSchedule = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 initial_accumulator_value: float = 0.1, **_):
        self.params = list(params)
        self.lr = lr
        self.eps = float(eps)
        self.weight_decay = float(weight_decay)
        device = self.params[0].device if self.params else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.sum_of_squares = [
            torch.full_like(p, float(initial_accumulator_value),
                            dtype=torch.float32) for p in self.params]

    lr_at = _AdamBase.lr_at
    _advance = _AdamBase._advance

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             grad_scale: Optional[torch.Tensor] = None,
             skip: Optional[torch.Tensor] = None) -> None:
        lr = self.lr_at(self.count)
        g = [x.float() for x in grads]
        if grad_scale is not None:
            torch._foreach_mul_(g, grad_scale)
        if self.weight_decay:
            torch._foreach_add_(g, self.params, alpha=self.weight_decay)
        sums = torch._foreach_addcmul(self.sum_of_squares, g, g)
        for p, h, new_h, gi in zip(self.params, self.sum_of_squares, sums, g):
            inv = torch.where(new_h > 0, torch.rsqrt(new_h + self.eps),
                              torch.zeros_like(new_h))
            new_p = p - lr * (inv * gi)
            p.copy_(new_p if skip is None else torch.where(skip, p, new_p))
            h.copy_(new_h if skip is None else torch.where(skip, h, new_h))
        self._advance(skip)


ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
ADAGRAD_OPTIMIZER = "adagrad"
ONEBIT_OPTIMIZERS = ("onebitadam", "onebitlamb", "zerooneadam")


def get_optimizer(name: str, params: List[torch.Tensor],
                  opt_params: Dict, lr_schedule: Optional[Callable] = None,
                  groups: Optional[Sequence[Sequence[int]]] = None):
    """Engine dispatch by config name; ``lr_schedule`` replaces the scalar
    lr with a ``step -> lr`` callable; ``groups`` are LAMB's trust-ratio
    groups (``FusedLamb``), which the Adam family has no use for."""
    key = name.lower()
    p = dict(opt_params)
    lr = lr_schedule if lr_schedule is not None else p.pop("lr", 1e-3)
    p.pop("lr", None)
    if key == ADAM_OPTIMIZER:
        return FusedAdam(params, lr,
                         adam_w_mode=bool(p.pop("adam_w_mode", True)), **p)
    if key == ADAMW_OPTIMIZER:
        return FusedAdam(params, lr, adam_w_mode=True, **p)
    if key == LAMB_OPTIMIZER:
        return FusedLamb(params, lr, groups=groups, **p)
    if key == ADAGRAD_OPTIMIZER:
        return Adagrad(params, lr, **p)
    if key in ONEBIT_OPTIMIZERS:
        raise unported(f"the {name} optimizer", "the auxiliary subsystems "
                       "(item 11)")
    raise ValueError(f"Unknown optimizer: {name}")
