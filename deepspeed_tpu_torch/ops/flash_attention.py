"""Flash attention for training and the from-empty prefill (kernels K1
and K2).

``flash_attention(q, k, v, causal, sm_scale, window)`` is what the model
calls: a ``torch.autograd.Function`` over ``[B, T, H, D]`` tensors (kv heads
already repeated) whose forward saves ``(q, k, v, out, lse)`` and whose
backward recomputes the probabilities from the logsumexp. With
``key_mask=`` (``[B, Tk]``, 1 = real key) it is the forward-only, GQA-native
mode the serving and generate prefills use: k/v keep their ``Hkv`` heads
(query head ``h`` reads kv head ``h // (H // Hkv)``), padded keys are
masked in the kernel, and a gradient through it raises. On CUDA tensors
each pass launches the hand-written Hopper kernels of
``csrc/flash_attention.cu``; on CPU tensors the same passes run their plain
PyTorch versions. Any other placement raises: there is no fallback from a
kernel to a plain version.

The kernels replace ``deepspeed_tpu/ops/pallas/flash_attention.py``
(``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``). Their bound on
an H100 is operations; the design note is at the top of the CUDA source.

Causality is bottom-right aligned (row ``i`` sees column ``j`` iff
``i + Tk - Tq >= j``) and a window also needs ``i + Tk - Tq - j < window``.
A row that sees no key gets zeros and ``lse = -inf``.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import _build, _runs

#: head dims the kernels are compiled for (the JAX kernels take any; these
#: are the published models' 64, 80, 96, 128 and 256)
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)


def _mask(Tq: int, Tk: int, causal: bool, window: Optional[int], device):
    """``[Tq, Tk]`` bool: which keys each query row sees."""
    i = torch.arange(Tq, device=device)[:, None] + (Tk - Tq)
    j = torch.arange(Tk, device=device)[None, :]
    seen = torch.ones(Tq, Tk, dtype=torch.bool, device=device)
    if causal:
        seen = seen & (i >= j)
    if window is not None:
        seen = seen & (i - j < window)
    return seen


def _scores(q, k, sm_scale, causal, window, key_mask=None):
    """fp32 ``[B, H, Tq, Tk]`` scaled scores, -inf where masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    seen = _mask(q.shape[1], k.shape[1], causal, window, q.device)
    if key_mask is not None:
        seen = seen[None, None] & (key_mask > 0)[:, None, None, :]
    return s.masked_fill(~seen, float("-inf"))


def _repeat_heads(x, H: int):
    """``[B, T, Hkv, D] -> [B, T, H, D]``: head ``h`` reads kv head
    ``h // (H // Hkv)``."""
    Hkv = x.shape[2]
    return x if Hkv == H else x.repeat_interleave(H // Hkv, dim=2)


def flash_attention_plain(q, k, v, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          window: Optional[int] = None, key_mask=None):
    """Plain PyTorch attention, differentiable by autograd. ``k``/``v`` may
    keep ``Hkv < H`` heads (GQA), and ``key_mask [B, Tk]`` (1 = real key)
    hides padded keys. Returns ``(out [B, Tq, H, D] in q's dtype, lse
    [B, H, Tq] fp32)``; a row that sees no key gets zeros and ``-inf``."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    k, v = _repeat_heads(k, q.shape[2]), _repeat_heads(v, q.shape[2])
    s = _scores(q, k, sm_scale, causal, window, key_mask)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / torch.where(l == 0, torch.ones_like(l), l).transpose(1, 2)
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              window: Optional[int] = None):
    """Plain PyTorch backward from the saved logsumexp: ``(dq, dk, dv)``
    in the inputs' dtypes, computed in fp32."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    s = _scores(q, k, sm_scale, causal, window)
    p = torch.exp(s - lse[..., None]).masked_fill(torch.isinf(s), 0.0)
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)         # [B, H, Tq]
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * sm_scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("flash_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B H Tq Tk D causal window scale bf16 runs stream
    shape = [I] * 5 + [I, I, F, I, P, P]
    fwd = lib.flash_attention_fwd
    fwd.argtypes = [P] * 5 + shape
    dq = lib.flash_attention_bwd_dq
    dq.argtypes = [P] * 7 + shape
    dkv = lib.flash_attention_bwd_dkv
    dkv.argtypes = [P] * 8 + shape
    masked = lib.flash_attention_fwd_masked
    # q k v key_mask out lse | B H Hkv Tq Tk D | causal window scale bf16
    # runs stream
    masked.argtypes = [P] * 6 + [I] * 6 + [I, I, F, I, P, P]
    for fn in (fwd, dq, dkv, masked):
        fn.restype = I
    return fwd, dq, dkv, masked


def _check(name, tensors, window):
    """Raise on anything the kernels do not take."""
    q, k, v = tensors[:3]
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on {dev}, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs its kernel on cuda and its plain "
                         f"version on cpu, not on {dev.type}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"{name}: q [B, Tq, H, D] and k, v [B, Tk, H, D] "
                         f"with the same B, H, D (kv heads repeated), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window is not None and int(window) <= 0:
        raise ValueError("window must be a positive int or None")
    if dev.type == "cuda":
        _check_kernel_domain(name, q, k, v)
    return dev


def _check_kernel_domain(name, q, k, v):
    """Raise on the dtypes and head dims that the kernels do not take (CUDA
    tensors): q, k, v all bf16 or all fp32, a head dim of
    :data:`KERNEL_HEAD_DIMS`."""
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"{name}: the kernels take q, k, v all bf16 or "
                         f"all fp32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")


def _operand(t):
    """``t`` contiguous and 16-byte aligned: the bf16 kernels copy rows in
    16-byte pieces."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, name, ptrs, q, k, causal, window, sm_scale):
    B, Tq, H, D = q.shape
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, B, H, Tq, k.shape[1], D, int(causal),
                0 if window is None else int(window), float(sm_scale),
                int(q.dtype == torch.bfloat16),
                _runs.counter(name, q.device).data_ptr(),
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Forward pass (K1): ``(out, lse)``. CUDA tensors launch the kernel
    and add one to ``flash_attention_fwd.launches`` (the kernel adds one
    to its device run count, ``_runs.kernel_runs``); CPU tensors take
    ``flash_attention_plain``; anything else raises."""
    dev = _check("flash_attention_fwd", (q, k, v), window)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        with torch.no_grad():
            return flash_attention_plain(q, k, v, causal, sm_scale, window)
    q, k, v = (_operand(t) for t in (q, k, v))
    B, Tq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    if out.numel() == 0 or k.shape[1] == 0:
        return out.zero_(), lse.fill_(float("-inf"))
    _launch(_entries()[0], "flash_attention_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr()), q, k, causal, window, sm_scale)
    flash_attention_fwd.launches += 1
    return out, lse


def _delta(out, dout):
    """``rowsum(dO * O)`` as fp32 ``[B, H, Tq]`` (a plain reduction, as in
    the JAX package)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_dq(q, k, v, out, lse, dout, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None, delta=None):
    """dQ (K2, first kernel). CUDA tensors launch the kernel and add one to
    ``flash_attention_bwd_dq.launches`` (and the kernel to its device run
    count, ``_runs.kernel_runs``); CPU tensors take the plain
    backward; anything else raises. ``delta`` may pass ``rowsum(dO * O)``
    (fp32 ``[B, H, Tq]``) when the caller has it."""
    dev = _check("flash_attention_bwd_dq", (q, k, v, out, lse, dout), window)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         sm_scale, window)[0]
    q, k, v, dout = (_operand(t) for t in (q, k, v, dout))
    dq = torch.empty_like(q)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    if delta is None:
        delta = _delta(out, dout)
    _launch(_entries()[1], "flash_attention_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.contiguous().data_ptr(), delta.data_ptr(), dq.data_ptr()),
            q, k, causal, window, sm_scale)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, causal: bool = True,
                            sm_scale: Optional[float] = None,
                            window: Optional[int] = None, delta=None):
    """``(dk, dv)`` (K2, second kernel). CUDA tensors launch the kernel and
    add one to ``flash_attention_bwd_dkv.launches`` (and the kernel to its
    device run count, ``_runs.kernel_runs``); CPU tensors take the
    plain backward; anything else raises. ``delta`` may pass a
    ``rowsum(dO * O)`` already computed for the dQ kernel."""
    dev = _check("flash_attention_bwd_dkv", (q, k, v, out, lse, dout), window)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal,
                                         sm_scale, window)[1:]
    q, k, v, dout = (_operand(t) for t in (q, k, v, dout))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    if delta is None:
        delta = _delta(out, dout)
    _launch(_entries()[2], "flash_attention_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.contiguous().data_ptr(), delta.data_ptr(), dk.data_ptr(),
             dv.data_ptr()), q, k, causal, window, sm_scale)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_fwd_masked(q, k, v, key_mask, causal: bool = True,
                               sm_scale: Optional[float] = None,
                               window: Optional[int] = None):
    """The masked, GQA-native forward (K1's key-mask mode): ``q [B, Tq, H,
    D]``, un-repeated ``k``/``v [B, Tk, Hkv, D]``, ``key_mask [B, Tk]``
    (1 = real key). Returns ``(out, lse)``. CUDA tensors launch the kernel
    and add one to ``flash_attention_fwd_masked.launches`` (and the kernel
    to its device run count, ``_runs.kernel_runs``); CPU tensors
    take ``flash_attention_plain``; anything else raises. Forward only."""
    tensors = (q, k, v, key_mask)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"flash_attention_fwd_masked: every tensor must be "
                         f"on {dev}, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention_fwd_masked runs its kernel on "
                         f"cuda and its plain version on cpu, not on "
                         f"{dev.type}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention_fwd_masked: q [B, Tq, H, D] and "
                         f"k, v [B, Tk, Hkv, D] with H a multiple of Hkv, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if tuple(key_mask.shape) != (k.shape[0], k.shape[1]):
        raise ValueError(f"key_mask must be [B, Tk] = "
                         f"{(k.shape[0], k.shape[1])}, got "
                         f"{tuple(key_mask.shape)}")
    if window is not None and int(window) <= 0:
        raise ValueError("window must be a positive int or None")
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        with torch.no_grad():
            return flash_attention_plain(q, k, v, causal, sm_scale, window,
                                         key_mask=key_mask)
    _check_kernel_domain("flash_attention_fwd_masked", q, k, v)
    q, k, v = (_operand(t) for t in (q, k, v))
    key_mask = key_mask.to(torch.int32).contiguous()
    B, Tq, H, D = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=dev)
    if out.numel() == 0 or Tk == 0:
        return out.zero_(), lse.fill_(float("-inf"))
    with torch.cuda.device(dev):
        rc = _entries()[3](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, H, Hkv, Tq, Tk, D,
            int(causal), 0 if window is None else int(window),
            float(sm_scale), int(q.dtype == torch.bfloat16),
            _runs.counter("flash_attention_fwd_masked", dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd_masked: kernel launch "
                           f"failed with CUDA error {rc}")
    flash_attention_fwd_masked.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd_masked.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, window = ctx.args
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                   causal, sm_scale, window)
        else:
            dout = dout.contiguous()
            delta = _delta(out, dout)
            dq = flash_attention_bwd_dq(q, k, v, out, lse, dout, causal,
                                        sm_scale, window, delta=delta)
            dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, dout, causal,
                                             sm_scale, window, delta=delta)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None, key_mask=None):
    """Attention over ``[B, T, H, D]`` tensors: K1 forward, K2 backward on
    CUDA tensors, the plain versions on CPU tensors. Without ``key_mask``
    it is differentiable and takes kv heads already repeated. With
    ``key_mask [B, Tk]`` (1 = real key) it takes un-repeated kv heads
    ``[B, Tk, Hkv, D]`` and is forward-only: a gradient cannot be taken
    through the masked kernel, so inputs that require one raise (drop
    padding through the loss mask when training). Returns ``out`` in q's
    dtype. The kernels take bf16 and fp32: fp16 CUDA tensors (fp16
    training) widen exactly to fp32, run the fp32 kernels, and the result
    (and the gradients) round back to fp16."""
    if q.dtype == torch.float16 and q.device.type == "cuda":
        return flash_attention(q.float(), k.float(), v.float(), causal,
                               sm_scale, window, key_mask).half()
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if key_mask is not None:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError(
                "flash_attention(key_mask=...) is forward-only: the masked "
                "kernel has no backward; call it under torch.no_grad() or "
                "drop padding through the loss mask")
        return flash_attention_fwd_masked(q, k, v, key_mask, causal,
                                          float(sm_scale), window)[0]
    return _FlashAttention.apply(q, k, v, causal, float(sm_scale), window)
