"""One-position attention over the contiguous KV cache (kernel K4).

``decode_attention`` is the wrapper the model calls at every decode step
of ``InferenceEngine.generate``. On CUDA tensors it launches the
hand-written Hopper kernel ``csrc/decode_attention.cu``; on CPU tensors it
computes the same function with ``decode_attention_plain``. Any other
placement raises: there is no fallback from the kernel to the plain
version.

The kernel replaces ``deepspeed_tpu/ops/pallas/decode_attention.py
::_decode_kernel``. Its bound on an H100 is bytes: the filled prefix of
each row's K/V (and int8 scales) read once, against 3.35 TB/s. The design
note is at the top of the CUDA source.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import _build

#: head dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)
#: most query heads one kv head may serve (GQA group)
KERNEL_MAX_GROUP = 8


def _visible(cache_index, S: int, key_mask, window: Optional[int], device):
    """``[B or 1, S]`` bool: key ``j`` is visible iff ``j <= cache_index``,
    ``key_mask[b, j] > 0`` and, with a window, ``cache_index - j <
    window``. ``cache_index`` may be an int or a device scalar."""
    cidx = torch.as_tensor(cache_index, device=device).reshape(()).long()
    j = torch.arange(S, device=device)
    seen = j <= cidx
    if window is not None:
        seen = seen & (cidx - j < window)
    seen = seen[None]
    if key_mask is not None:
        seen = seen & (key_mask > 0)
    return seen


def decode_attention_plain(q, k_cache, v_cache, cache_index, key_mask=None,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None,
                           k_scale=None, v_scale=None):
    """Plain PyTorch version of the kernel.

    ``q``: ``[B, H, D]`` (the new token's query heads); ``k_cache``,
    ``v_cache``: head-major ``[B, Hkv, S, D]``; ``cache_index``: the new
    token's position (int or device scalar); ``key_mask``: ``[B, S]``,
    1 = real token; ``k_scale``/``v_scale``: fp32 ``[B, Hkv, S]`` for an
    int8 cache. Query head ``kvh * G + g`` reads kv head ``kvh``. Math in
    fp32; returns ``[B, H, D]`` in q's dtype, zeros for a row that sees no
    key. Masked keys' V never reaches the sum (zeroed, not only weighted
    by 0)."""
    B, H, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    G = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    k, v = k_cache.float(), v_cache.float()
    if k_scale is not None:
        k = k * k_scale.float()[..., None]
        v = v * v_scale.float()[..., None]
    seen = _visible(cache_index, S, key_mask, window, q.device)
    seen = seen.expand(B, S)[:, None]                          # [B, 1, S]
    s = torch.einsum("bhgd,bhsd->bhgs", q.float().reshape(B, Hkv, G, D),
                     k) * sm_scale
    s = s.masked_fill(~seen[:, :, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    v = v.masked_fill(~seen[..., None], 0.0)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v) \
        / torch.where(l == 0, torch.ones_like(l), l)
    return o.reshape(B, H, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("decode_attention").decode_attention
    P, I = ctypes.c_void_p, ctypes.c_int
    # q k v k_scale v_scale key_mask cache_index out | B H Hkv S D |
    # sm_scale window q_bf16 kv_int8 | stream
    fn.argtypes = [P] * 8 + [I] * 5 + [ctypes.c_float, I, I, I, P]
    fn.restype = I
    return fn


def _check_kernel_args(q, k_cache, v_cache, k_scale, v_scale, key_mask,
                       window):
    """Raise on anything the kernel does not take."""
    if q.dim() != 3 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be [B, H, D] bf16 or fp32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, H, D = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"k_cache and v_cache must both be [B, Hkv, S, D] "
                         f"for q {tuple(q.shape)}, got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    _, Hkv, S, _ = k_cache.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {D}")
    if H % Hkv or H // Hkv > KERNEL_MAX_GROUP:
        raise ValueError(f"query heads {H} over kv heads {Hkv}: the group "
                         f"must be whole and at most {KERNEL_MAX_GROUP}")
    int8 = k_scale is not None
    want = torch.int8 if int8 else q.dtype
    if k_cache.dtype != want or v_cache.dtype != want:
        raise ValueError(f"the cache must be {want} (q is {q.dtype}, int8 "
                         f"cache: {int8}), got {k_cache.dtype}/"
                         f"{v_cache.dtype}")
    if int8:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (B, Hkv, S) \
                    or not s.is_contiguous():
                raise ValueError("k_scale/v_scale must be contiguous fp32 "
                                 "[B, Hkv, S]")
    if tuple(key_mask.shape) != (B, S):
        raise ValueError(f"key_mask must be [B, S] = {(B, S)}, got "
                         f"{tuple(key_mask.shape)}")
    for t in (q, k_cache, v_cache):
        if not t.is_contiguous():
            raise ValueError("q and the caches must be contiguous")
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("the caches must be 16-byte aligned")
    if window is not None and int(window) <= 0:
        raise ValueError("window must be a positive int or None")


def decode_attention(q, k_cache, v_cache, cache_index, key_mask=None,
                     sm_scale: Optional[float] = None,
                     window: Optional[int] = None,
                     k_scale=None, v_scale=None):
    """Single-position cached attention (see the plain version for the
    arguments). CUDA tensors launch the kernel on the current stream and
    add one to ``decode_attention.launches``; CPU tensors take the plain
    version; anything else raises. ``cache_index`` may be an int or an
    int32 device scalar: the kernel reads it on the device, as the TPU
    kernel prefetches it."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale (int8 cache) or "
                         "neither")
    tensors = [q, k_cache, v_cache]
    tensors += [t for t in (k_scale, v_scale, key_mask) if t is not None]
    if torch.is_tensor(cache_index):
        tensors.append(cache_index)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("decode_attention: every tensor must be on "
                         f"{dev}, got {sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_index,
                                      key_mask=key_mask, sm_scale=sm_scale,
                                      window=window, k_scale=k_scale,
                                      v_scale=v_scale)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs its kernel on cuda and its "
                         f"plain version on cpu, not on {dev.type}")
    B, H, D = q.shape
    S = k_cache.shape[2]
    if key_mask is None:
        key_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
    key_mask = key_mask.to(torch.int32).contiguous()
    _check_kernel_args(q, k_cache, v_cache, k_scale, v_scale, key_mask,
                       window)
    cidx = torch.as_tensor(cache_index, dtype=torch.int32,
                           device=dev).reshape(1)
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if S == 0:
        return out.zero_()
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None \
        else (None, None)
    with torch.cuda.device(dev):
        rc = _entry()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
            key_mask.data_ptr(), cidx.data_ptr(), out.data_ptr(), B, H,
            k_cache.shape[1], S, D, float(sm_scale),
            0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), int(k_scale is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
