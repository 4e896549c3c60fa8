"""Host-CPU Adagrad (the SIMD kernel of ``csrc/host/cpu_adagrad.cpp``).

Counterpart of ``deepspeed_tpu/ops/adagrad/cpu_adagrad.py`` on the same
C++; see ``ops/adam/cpu_adam.py`` for the offload design."""

import ctypes
import itertools
from typing import Iterable, List, Optional

import torch

from .. import _build
from .._host import bf16_out_view, host_tensor, ptr
from ..adam.cpu_adam import fma32

_ids = itertools.count()


class DeepSpeedCPUAdagrad:
    def __init__(self, params: Iterable, lr: float = 1e-2,
                 eps: float = 1e-10, weight_decay: float = 0.0,
                 num_threads: int = 0):
        self._lib = _build.load_host("cpu_adagrad")
        self._id = next(_ids)
        self.params: List[torch.Tensor] = [host_tensor(p).view(-1)
                                           for p in params]
        self.sum_sq = [torch.zeros_like(p) for p in self.params]
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay
        self.num_threads = num_threads or 1
        rc = self._lib.ds_adagrad_create(
            ctypes.c_int(self._id), ctypes.c_float(lr), ctypes.c_float(eps),
            ctypes.c_float(weight_decay))
        if rc != 0:
            raise RuntimeError("ds_adagrad_create failed")

    def step(self, grads: List, lr: Optional[float] = None,
             bf16_out: Optional[List] = None) -> None:
        for i, g in enumerate(grads):
            self.step_leaf(self.params[i], g, self.sum_sq[i], lr,
                           None if bf16_out is None else bf16_out[i])

    def step_leaf(self, p: torch.Tensor, g, h: torch.Tensor,
                  lr: Optional[float] = None, bf16_out=None) -> None:
        """One ``ds_adagrad_step`` on one flat leaf with its own sum of
        squares."""
        g = host_tensor(g)
        out = None if bf16_out is None else bf16_out_view(bf16_out, p.numel())
        rc = self._lib.ds_adagrad_step(
            ctypes.c_int(self._id), ctypes.c_int64(p.numel()), ptr(p),
            ptr(g), ptr(h), ctypes.c_float(-1.0 if lr is None else lr),
            ptr(out, ctypes.c_uint16), ctypes.c_int(self.num_threads))
        if rc != 0:
            raise RuntimeError("ds_adagrad_step failed")

    def state_dict(self):
        return {"sum_sq": self.sum_sq}

    def load_state_dict(self, sd):
        self.sum_sq = [host_tensor(a).view(-1).clone() for a in sd["sum_sq"]]

    def __del__(self):
        try:
            self._lib.ds_adagrad_destroy(ctypes.c_int(self._id))
        except Exception:
            pass


def cpu_adagrad_step_plain(p: torch.Tensor, g: torch.Tensor,
                           h: torch.Tensor, lr: float, eps: float = 1e-10,
                           weight_decay: float = 0.0,
                           bf16_out: Optional[torch.Tensor] = None) -> None:
    """The plain version of one ``ds_adagrad_step`` on fp32 CPU tensors,
    in place, with the kernel's fused multiply-adds rounded once (where
    the decayed gradient nearly cancels, two roundings move the update
    by its own size)."""
    def f(x):
        return torch.tensor(x, dtype=torch.float32)

    if weight_decay > 0:
        g = fma32(f(weight_decay), p, g)
    h.copy_(fma32(g, g, h))
    p.copy_(fma32(-f(lr), g / (torch.sqrt(h) + f(eps)), p))
    if bf16_out is not None:
        bf16_out.copy_(p.to(torch.bfloat16).view(bf16_out.dtype))
