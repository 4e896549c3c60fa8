"""Fused multi-tensor Adam / AdamW step (kernel K3).

``fused_adam(params, grads, exp_avgs, exp_avg_sqs, ...)`` updates lists of
fp32 tensors in place: on CUDA tensors one launch of the hand-written
Hopper kernel ``csrc/fused_adam.cu`` covers the whole list; on CPU tensors
``fused_adam_plain`` computes the same function tensor by tensor. Any
other placement raises: there is no fallback from the kernel to the plain
version.

The kernel replaces ``deepspeed_tpu/ops/pallas/fused_adam.py::
_adam_kernel``. Its bound on an H100 is bytes (28 per element); the design
note is at the top of the CUDA source. The scalars follow
``scale_by_fused_adam``: ``step_size = lr / (1 - b1^t)`` and
``inv_bc2 = 1 / sqrt(1 - b2^t)`` with ``t`` the post-increment count, eps
added after the bias-corrected square root, AdamW decay scaled by the
uncorrected ``lr``.
"""

import ctypes
import functools
from typing import List, Optional

import torch

from . import _build

#: elements per block of the kernel (a multiple of 4)
CHUNK = 32768


def fused_adam_plain(params, grads, exp_avgs, exp_avg_sqs, *, b1: float,
                     b2: float, eps: float, weight_decay: float,
                     adam_w_mode: bool, step_size: float, lr: float,
                     inv_bc2: float, grad_scale=None,
                     write_update: bool = False) -> None:
    """Plain PyTorch version, in place: each ``m``/``v`` moves one step and
    ``p += u`` (or ``g = u`` with ``write_update``). ``grad_scale``: an fp32
    scalar tensor that multiplies every gradient first, or None."""
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        gg = g * grad_scale if grad_scale is not None else g.clone()
        if not adam_w_mode and weight_decay:
            gg = gg + weight_decay * p
        m.mul_(b1).add_((1.0 - b1) * gg)
        v.mul_(b2).add_((1.0 - b2) * (gg * gg))
        u = -step_size * (m / (v.sqrt() * inv_bc2 + eps))
        if adam_w_mode and weight_decay:
            u = u - (lr * weight_decay) * p
        (g if write_update else p).copy_(u if write_update else p + u)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fused_adam").fused_adam
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, I, I, I, P] + [F] * 9 + [I, I, P]
    fn.restype = I
    return fn


_table_cache = {}


def _table(quads, device):
    """Check every tensor, then return the device table of ``(p, g, m, v,
    numel)`` rows and ``(tensor, start)`` chunk rows. The last table is
    kept and reused while the buffers stay the same (the engine's step
    after step)."""
    key = [device]
    for quad in quads:
        n = quad[0].numel()
        for t in quad:
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.numel() != n or t.data_ptr() % 16:
                raise ValueError("fused_adam: each param, grad and moment "
                                 "must be a contiguous, 16-byte aligned fp32 "
                                 "tensor of its param's size")
            key.append(t.data_ptr())
        key.append(n)
    key = tuple(key)
    hit = _table_cache.get(key)
    if hit is None:
        rows, chunks = [], []
        for i, quad in enumerate(quads):
            n = quad[0].numel()
            rows += [t.data_ptr() for t in quad] + [n]
            chunks += [x for s in range(0, n, CHUNK) for x in (i, s)]
        table = torch.tensor(rows + chunks, dtype=torch.int64).to(device)
        _table_cache.clear()
        hit = _table_cache[key] = (table, len(chunks) // 2)
    return hit


def fused_adam(params: List[torch.Tensor], grads: List[torch.Tensor],
               exp_avgs: List[torch.Tensor], exp_avg_sqs: List[torch.Tensor],
               *, b1: float, b2: float, eps: float, weight_decay: float,
               adam_w_mode: bool, step_size: float, lr: float, inv_bc2: float,
               grad_scale: Optional[torch.Tensor] = None,
               write_update: bool = False) -> None:
    """One Adam step over the lists (see ``fused_adam_plain``). CUDA tensors
    launch the kernel once for the whole list and add one to
    ``fused_adam.launches``; CPU tensors take the plain version; anything
    else raises."""
    quads = list(zip(params, grads, exp_avgs, exp_avg_sqs))
    if not (len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs)):
        raise ValueError("fused_adam: params, grads and both moment lists "
                         "must have the same length")
    tensors = [t for quad in quads for t in quad]
    if grad_scale is not None:
        tensors.append(grad_scale)
    devs = {t.device for t in tensors}
    if len(devs) > 1:
        raise ValueError(f"fused_adam: every tensor must be on one device, "
                         f"got {sorted(str(d) for d in devs)}")
    dev = devs.pop() if devs else torch.device("cpu")
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, step_size=step_size, lr=lr,
              inv_bc2=inv_bc2, grad_scale=grad_scale,
              write_update=write_update)
    if dev.type == "cpu":
        return fused_adam_plain(params, grads, exp_avgs, exp_avg_sqs, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_adam runs its kernel on cuda and its plain "
                         f"version on cpu, not on {dev.type}")
    if grad_scale is not None and (grad_scale.dtype != torch.float32
                                   or grad_scale.numel() != 1):
        raise ValueError("fused_adam: grad_scale must be an fp32 scalar")
    table, n_chunks = _table(quads, dev)
    with torch.cuda.device(dev):
        rc = _entry()(table.data_ptr(), len(quads), n_chunks, CHUNK,
                      None if grad_scale is None else grad_scale.data_ptr(),
                      b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
                      step_size, lr, inv_bc2, int(adam_w_mode),
                      int(write_update),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam: kernel launch failed with CUDA "
                           f"error {rc}")
    fused_adam.launches += 1


fused_adam.launches = 0
