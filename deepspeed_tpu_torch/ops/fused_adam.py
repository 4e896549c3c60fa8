"""Fused multi-tensor Adam / AdamW step (kernel K3).

``fused_adam(params, grads, exp_avgs, exp_avg_sqs, ...)`` updates lists of
fp32 tensors in place: on CUDA tensors one launch of the hand-written
Hopper kernel ``csrc/fused_adam.cu`` covers the whole list; on CPU tensors
``fused_adam_plain`` computes the same function tensor by tensor. Any
other placement raises: there is no fallback from the kernel to the plain
version.

The kernel replaces ``deepspeed_tpu/ops/pallas/fused_adam.py::
_adam_kernel``. Its bound on an H100 is bytes (28 per element); the design
note is at the top of the CUDA source. As the TPU kernel's ``alpha_ref``,
the step's scalars come from a device fp32 array ``alpha = [step_size, lr,
inv_bc2]`` (``step_size = lr / (1 - b1^t)`` and ``inv_bc2 = 1 / sqrt(1 -
b2^t)`` with ``t`` the post-increment count, computed on the device by
``ops/optimizers.py``), and a device bool ``skip`` (the fp16 overflow)
leaves every tensor as it was, as the JAX step's ``keep(new, old)``; eps
is added after the bias-corrected square root, AdamW decay scaled by the
uncorrected ``lr``. ``b1``, ``b2``, ``eps`` and the decay stay launch
arguments, static as in JAX.
"""

import ctypes
import functools
from typing import List, NamedTuple, Optional

import torch

from . import _build, _runs

#: elements per block of the kernel (a multiple of 4)
CHUNK = 32768


def fused_adam_plain(params, grads, exp_avgs, exp_avg_sqs, *, b1: float,
                     b2: float, eps: float, weight_decay: float,
                     adam_w_mode: bool, alpha: torch.Tensor, skip=None,
                     grad_scale=None, write_update: bool = False) -> None:
    """Plain PyTorch version, in place: each ``m``/``v`` moves one step and
    ``p += u`` (or ``g = u`` with ``write_update``). ``alpha``: fp32
    ``[step_size, lr, inv_bc2]``; ``skip``: a bool scalar tensor that,
    when set, keeps every tensor as it was (bit for bit), or None;
    ``grad_scale``: an fp32 scalar tensor that multiplies every gradient
    first, or None. Reads nothing back to the host."""
    step_size, lr, inv_bc2 = alpha[0], alpha[1], alpha[2]
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs):
        gg = g * grad_scale if grad_scale is not None else g.clone()
        if not adam_w_mode and weight_decay:
            gg = gg + weight_decay * p
        m_new = b1 * m + (1.0 - b1) * gg
        v_new = b2 * v + (1.0 - b2) * (gg * gg)
        u = -step_size * (m_new / (v_new.sqrt() * inv_bc2 + eps))
        if adam_w_mode and weight_decay:
            u = u - (lr * weight_decay) * p
        out, new = (g, u) if write_update else (p, p + u)
        for t, t_new in ((m, m_new), (v, v_new), (out, new)):
            t.copy_(t_new if skip is None else torch.where(skip, t, t_new))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("fused_adam").fused_adam
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, I, I, I, P, P, P, P] + [F] * 6 + [I, I, P]
    fn.restype = I
    return fn


class AdamTable(NamedTuple):
    """K3's device table of ``(p, g, m, v, numel)`` rows and ``(tensor,
    start)`` chunk rows for one set of lists, with the key (addresses and
    sizes) it was built for. A launch reads the table by address, and so
    does every replay of a graph that captured one: whoever keeps the lists
    keeps their table."""
    key: tuple
    rows: torch.Tensor
    n_chunks: int


def _table(quads, device, reuse: Optional[AdamTable]) -> AdamTable:
    """Check every tensor, then return ``reuse`` if it was built for these
    tensors, else a new table (a host-to-device copy, which a capture
    cannot hold: there the table must be built by an eager launch
    first)."""
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
    if reuse is not None and reuse.key == key:
        return reuse
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("fused_adam: no table for these tensors under "
                           "capture; launch once eagerly and pass the "
                           "returned table as table=")
    rows, chunks = [], []
    for i, quad in enumerate(quads):
        n = quad[0].numel()
        rows += [t.data_ptr() for t in quad] + [n]
        chunks += [x for s in range(0, n, CHUNK) for x in (i, s)]
    return AdamTable(key, torch.tensor(rows + chunks, dtype=torch.int64)
                     .to(device), len(chunks) // 2)


def fused_adam(params: List[torch.Tensor], grads: List[torch.Tensor],
               exp_avgs: List[torch.Tensor], exp_avg_sqs: List[torch.Tensor],
               *, b1: float, b2: float, eps: float, weight_decay: float,
               adam_w_mode: bool, alpha: torch.Tensor,
               skip: Optional[torch.Tensor] = None,
               grad_scale: Optional[torch.Tensor] = None,
               write_update: bool = False,
               table: Optional[AdamTable] = None) -> Optional[AdamTable]:
    """One Adam step over the lists (see ``fused_adam_plain``). CUDA tensors
    launch the kernel once for the whole list and add one to
    ``fused_adam.launches`` (and the kernel to its device run count,
    ``_runs.kernel_runs``, skipped steps too); CPU tensors take the plain
    version; anything else raises.

    Returns the table the kernel read (None on the CPU). Passed back as
    ``table`` while the lists hold the same tensors, it is used without a
    new host-to-device copy; a captured launch needs it, and the caller
    keeps it alive as long as the graph."""
    quads = list(zip(params, grads, exp_avgs, exp_avg_sqs))
    if not (len(params) == len(grads) == len(exp_avgs) == len(exp_avg_sqs)):
        raise ValueError("fused_adam: params, grads and both moment lists "
                         "must have the same length")
    scalars = [alpha] + [t for t in (skip, grad_scale) if t is not None]
    tensors = [t for quad in quads for t in quad] + scalars
    devs = {t.device for t in tensors}
    if len(devs) > 1:
        raise ValueError(f"fused_adam: every tensor must be on one device, "
                         f"got {sorted(str(d) for d in devs)}")
    dev = devs.pop()
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, alpha=alpha, skip=skip,
              grad_scale=grad_scale, write_update=write_update)
    if dev.type == "cpu":
        fused_adam_plain(params, grads, exp_avgs, exp_avg_sqs, **kw)
        return None
    if dev.type != "cuda":
        raise ValueError(f"fused_adam runs its kernel on cuda and its plain "
                         f"version on cpu, not on {dev.type}")
    if alpha.dtype != torch.float32 or alpha.numel() != 3 \
            or not alpha.is_contiguous():
        raise ValueError("fused_adam: alpha must be a contiguous fp32 "
                         "[step_size, lr, inv_bc2]")
    if skip is not None and (skip.dtype != torch.bool or skip.numel() != 1):
        raise ValueError("fused_adam: skip must be a bool scalar")
    if grad_scale is not None and (grad_scale.dtype != torch.float32
                                   or grad_scale.numel() != 1):
        raise ValueError("fused_adam: grad_scale must be an fp32 scalar")
    table = _table(quads, dev, table)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _entry()(table.rows.data_ptr(), len(quads), table.n_chunks,
                      CHUNK,
                      alpha.data_ptr(), ptr(skip), ptr(grad_scale),
                      _runs.counter("fused_adam", dev).data_ptr(),
                      b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
                      int(adam_w_mode), int(write_update),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_adam: kernel launch failed with CUDA "
                           f"error {rc}")
    fused_adam.launches += 1
    return table


fused_adam.launches = 0
