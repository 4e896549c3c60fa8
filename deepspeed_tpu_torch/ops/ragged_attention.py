"""Ragged paged attention for the packed serving step (kernel K6).

``ragged_paged_attention`` is the wrapper the model calls. On CUDA tensors
it launches the hand-written Hopper kernel ``csrc/ragged_attention.cu``;
on CPU tensors it computes the same function with
``ragged_paged_attention_plain``. Any other placement raises: there is no
fallback from the kernel to the plain version.

The kernel replaces ``deepspeed_tpu/ops/pallas/ragged_attention.py
::_ragged_kernel``. Its bound on an H100 is bytes: the live K/V pages of
every row (once per kv head) plus q and the output, against 3.35 TB/s.
The design note on what the kernel does about that bound is at the top of
the CUDA source.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import _build

#: pool page size the kernel is compiled for
KERNEL_BLOCK_SIZE = 16
#: head dims the kernel is compiled for
KERNEL_HEAD_DIMS = (64, 128)
#: query rows one kernel block holds (q_tile tokens x G heads)
KERNEL_TILE_ROWS = 32


def ragged_paged_attention_plain(q, k_pages, v_pages, block_tables,
                                 query_start, query_len, chunk_start,
                                 context_lens,
                                 sm_scale: Optional[float] = None,
                                 window: Optional[int] = None,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch version of the kernel, one row at a time.

    ``q``: ``[T, H, D]`` packed token batch (KV already appended);
    ``k_pages``/``v_pages``: ``[N, Hkv, bs, D]``; ``block_tables``: int32
    ``[R, nb]`` (entry ``N`` = unallocated); ``query_start``,
    ``query_len``, ``chunk_start``, ``context_lens``: int32 ``[R]``;
    ``k_scale``/``v_scale``: fp32 ``[N, Hkv, bs]`` for an int8 pool.
    Token ``t`` of row ``r`` sits at ``chunk_start[r] + t`` and sees kv
    positions ``p <= pos``, ``p < context_lens[r]`` and, with a window,
    ``pos - p < window``. Math in fp32; returns ``[T, H, D]`` in q's
    dtype, zeros where no row claims a token or a token sees no key
    (the kernel's ``l == 0`` rule)."""
    T, H, D = q.shape
    N, Hkv, bs, _ = k_pages.shape
    G = H // Hkv
    nb = block_tables.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    out = torch.zeros_like(q)
    tables = block_tables.long().clamp(0, N - 1)
    rows = torch.stack([query_start, query_len, chunk_start,
                        context_lens]).tolist()
    for r, (qs, ql, cs, cl) in enumerate(zip(*rows)):
        if ql <= 0 or cl <= 0:
            continue
        ids = tables[r, :min(-(-cl // bs), nb)]
        k = k_pages[ids].float()                      # [n, Hkv, bs, D]
        v = v_pages[ids].float()
        if k_scale is not None:
            k = k * k_scale[ids].float()[..., None]
            v = v * v_scale[ids].float()[..., None]
        S = ids.numel() * bs
        k = k.transpose(0, 1).reshape(Hkv, S, D)
        v = v.transpose(0, 1).reshape(Hkv, S, D)
        qr = q[qs:qs + ql].float().reshape(ql, Hkv, G, D)
        s = torch.einsum("thgd,hsd->thgs", qr, k) * sm_scale
        pos = cs + torch.arange(ql, device=q.device)[:, None]
        col = torch.arange(S, device=q.device)[None, :]
        valid = (col <= pos) & (col < cl)
        if window is not None:
            valid = valid & (pos - col < window)
        s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("thgs,hsd->thgd", p, v) \
            / torch.where(l == 0, torch.ones_like(l), l)
        out[qs:qs + ql] = o.reshape(ql, H, D).to(q.dtype)
    return out


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("ragged_attention").ragged_paged_attention
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 11 + [I] * 7 + [ctypes.c_float, I, I, I, P]
    fn.restype = I
    return fn


def _check_kernel_args(q, k_pages, v_pages, block_tables, descriptors,
                       k_scale, v_scale, window):
    """Raise on anything the kernel does not take."""
    if q.dim() != 3 or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be [T, H, D] bf16 or fp32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    T, H, D = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must both be [N, Hkv, bs, D]")
    N, Hkv, bs, Dk = k_pages.shape
    if Dk != D or D not in KERNEL_HEAD_DIMS or bs != KERNEL_BLOCK_SIZE:
        raise ValueError(f"the kernel takes head_dim in {KERNEL_HEAD_DIMS} "
                         f"and pages of {KERNEL_BLOCK_SIZE} tokens, got "
                         f"head_dim {D}/{Dk}, block_size {bs}")
    if H % Hkv or KERNEL_TILE_ROWS % (H // Hkv):
        raise ValueError(f"query heads {H} over kv heads {Hkv}: the group "
                         f"size must divide {KERNEL_TILE_ROWS}")
    int8 = k_scale is not None
    want = torch.int8 if int8 else q.dtype
    if k_pages.dtype != want or v_pages.dtype != want:
        raise ValueError(f"pages must be {want} (q is {q.dtype}, int8 pool: "
                         f"{int8}), got {k_pages.dtype}/{v_pages.dtype}")
    if int8:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (N, Hkv, bs) \
                    or not s.is_contiguous():
                raise ValueError("k_scale/v_scale must be contiguous fp32 "
                                 "[N, Hkv, bs]")
    if block_tables.dim() != 2 or block_tables.dtype != torch.int32:
        raise ValueError("block_tables must be int32 [R, nb]")
    R = block_tables.shape[0]
    for d in descriptors:
        if d.dtype != torch.int32 or tuple(d.shape) != (R,) \
                or not d.is_contiguous():
            raise ValueError("query_start/query_len/chunk_start/"
                             "context_lens must be contiguous int32 [R]")
    for t in (q, k_pages, v_pages, block_tables):
        if not t.is_contiguous():
            raise ValueError("q, pages and block_tables must be contiguous")
    for t in (k_pages, v_pages) + ((k_scale, v_scale) if int8 else ()):
        if t.data_ptr() % 16:
            raise ValueError("pages and scales must be 16-byte aligned")
    if window is not None and int(window) <= 0:
        raise ValueError("window must be a positive int or None")


def ragged_paged_attention(q, k_pages, v_pages, block_tables, query_start,
                           query_len, chunk_start, context_lens,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None,
                           k_scale=None, v_scale=None):
    """Unified ragged paged attention (see the plain version for the
    arguments). CUDA tensors launch the kernel on the current stream and
    add one to ``ragged_paged_attention.launches``; CPU tensors take the
    plain version; anything else raises."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale (int8 pool) or "
                         "neither")
    descriptors = (query_start, query_len, chunk_start, context_lens)
    tensors = (q, k_pages, v_pages, block_tables) + descriptors
    if k_scale is not None:
        tensors += (k_scale, v_scale)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("ragged_paged_attention: every tensor must be on "
                         f"{dev}, got {sorted({str(t.device) for t in tensors})}")
    if dev.type == "cpu":
        return ragged_paged_attention_plain(
            q, k_pages, v_pages, block_tables, query_start, query_len,
            chunk_start, context_lens, sm_scale=sm_scale, window=window,
            k_scale=k_scale, v_scale=v_scale)
    if dev.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs its kernel on cuda "
                         f"and its plain version on cpu, not on {dev.type}")
    _check_kernel_args(q, k_pages, v_pages, block_tables, descriptors,
                       k_scale, v_scale, window)
    T, H, D = q.shape
    N, Hkv = k_pages.shape[:2]
    R, nb = block_tables.shape
    out = torch.zeros_like(q)
    if T == 0 or R == 0:
        return out
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None \
        else (None, None)
    with torch.cuda.device(dev):
        rc = _entry()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            block_tables.data_ptr(), *(d.data_ptr() for d in descriptors),
            out.data_ptr(), T, H, Hkv, D, N, R, nb, float(sm_scale),
            0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), int(k_scale is not None),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention: kernel launch failed "
                           f"with CUDA error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
