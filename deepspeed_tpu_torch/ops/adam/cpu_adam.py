"""Host-CPU Adam over flat fp32 partitions (the SIMD kernel of
``csrc/host/cpu_adam.cpp``).

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (``DeepSpeedCPUAdam``)
on the same C++ built with the same flags, so both packages step the same
bits. ZeRO-Offload keeps the fp32 masters and the moments in host memory
and steps them here while the card holds only compute-dtype weights; the
optional bf16 output is the fused fp32 -> bf16 copy that goes back to the
card. Buffers are contiguous CPU tensors (a writable numpy array is taken
as its memory), stepped in place through their data pointers.
"""

import ctypes
import itertools
import os
from typing import Iterable, List, Optional, Tuple

import torch

from .. import _build
from .._host import bf16_out_view, host_tensor, ptr

_ids = itertools.count()


class DeepSpeedCPUAdam:
    """Adam/AdamW over a list of flat fp32 tensors, in place.

    ``step(grads, lr=None, bf16_out=None)`` applies one update; the moments
    are owned by this object. Bias-corrected as optax's adam/adamw;
    ``adamw_mode`` decouples the weight decay."""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 num_threads: int = 0, fp32_optimizer_states: bool = True):
        self._lib = _build.load_host("cpu_adam")
        self._lib.ds_adam_step.restype = ctypes.c_int
        self._id = next(_ids)
        self.params: List[torch.Tensor] = [host_tensor(p).view(-1)
                                           for p in params]
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0
        self.num_threads = num_threads or max(1, os.cpu_count() or 1)
        rc = self._lib.ds_adam_create(
            ctypes.c_int(self._id), ctypes.c_float(lr),
            ctypes.c_float(betas[0]), ctypes.c_float(betas[1]),
            ctypes.c_float(eps), ctypes.c_float(weight_decay),
            ctypes.c_int(1 if adamw_mode else 0))
        if rc != 0:
            raise RuntimeError("ds_adam_create failed")

    def step(self, grads: List, lr: Optional[float] = None,
             bf16_out: Optional[List] = None) -> None:
        self.step_count += 1
        for i, g in enumerate(grads):
            self.step_leaf(self.params[i], g, self.exp_avg[i],
                           self.exp_avg_sq[i], self.step_count, lr,
                           None if bf16_out is None else bf16_out[i])

    def step_leaf(self, p: torch.Tensor, g, m: torch.Tensor,
                  v: torch.Tensor, step: int, lr: Optional[float] = None,
                  bf16_out=None) -> None:
        """One ``ds_adam_step`` on one flat leaf with its own moments and
        1-based ``step`` (the NVMe path steps a leaf at a time)."""
        g = host_tensor(g)
        out = None if bf16_out is None else bf16_out_view(bf16_out, p.numel())
        rc = self._lib.ds_adam_step(
            ctypes.c_int(self._id), ctypes.c_int64(step),
            ctypes.c_int64(p.numel()), ptr(p), ptr(g), ptr(m), ptr(v),
            ctypes.c_float(-1.0 if lr is None else lr),
            ptr(out, ctypes.c_uint16), ctypes.c_int(self.num_threads))
        if rc != 0:
            raise RuntimeError("ds_adam_step failed")

    def state_dict(self):
        return {"step": self.step_count, "exp_avg": self.exp_avg,
                "exp_avg_sq": self.exp_avg_sq}

    def load_state_dict(self, sd):
        self.step_count = int(sd["step"])
        self.exp_avg = [host_tensor(a).view(-1).clone() for a in sd["exp_avg"]]
        self.exp_avg_sq = [host_tensor(a).view(-1).clone()
                           for a in sd["exp_avg_sq"]]

    def __del__(self):
        try:
            self._lib.ds_adam_destroy(ctypes.c_int(self._id))
        except Exception:
            pass


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to fp32, as the kernels' fused
    multiply-adds round it (the product of two fp32 values is exact in
    fp64)."""
    return (torch.as_tensor(a).double() * torch.as_tensor(b).double()
            + torch.as_tensor(c).double()).float()


def cpu_adam_step_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                        v: torch.Tensor, step: int, lr: float,
                        betas=(0.9, 0.999), eps: float = 1e-8,
                        weight_decay: float = 0.0, adamw_mode: bool = True,
                        bf16_out: Optional[torch.Tensor] = None) -> None:
    """The plain version of one ``ds_adam_step`` on fp32 CPU tensors, in
    place: the same AdamW / L2 Adam math in torch ops, with the kernel's
    fp32 constants and its fused multiply-adds rounded once."""
    def f(x):
        return torch.tensor(x, dtype=torch.float32)

    one, b1, b2, wd = f(1.0), f(betas[0]), f(betas[1]), f(weight_decay)
    rbc1 = one / (one - torch.pow(b1, f(float(step))))
    rbc2 = one / (one - torch.pow(b2, f(float(step))))
    if not adamw_mode and weight_decay > 0:
        g = fma32(wd, p, g)
    m.copy_(fma32(b1, m, (one - b1) * g))
    v.copy_(fma32(b2, v, (one - b2) * (g * g)))
    update = (m * rbc1) / (torch.sqrt(v * rbc2) + f(eps))
    if adamw_mode and weight_decay > 0:
        update = fma32(wd, p, update)
    p.copy_(fma32(-f(lr), update, p))
    if bf16_out is not None:
        bf16_out.copy_(p.to(torch.bfloat16).view(bf16_out.dtype))
