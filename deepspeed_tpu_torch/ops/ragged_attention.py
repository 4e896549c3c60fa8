"""Ragged paged attention for the packed serving step (kernel K6).

``ragged_paged_attention`` is the wrapper the model calls. On CUDA tensors
it launches the hand-written Hopper kernel ``csrc/ragged_attention.cu``;
on CPU tensors it computes the same function with
``ragged_paged_attention_plain``. Any other placement raises: there is no
fallback from the kernel to the plain version.

The kernel replaces ``deepspeed_tpu/ops/pallas/ragged_attention.py
::_ragged_kernel``. Its bound on an H100 is bytes: the live K/V pages of
every row (once per kv head) plus q and the output, against 3.35 TB/s.
It is a split-key walk over the block table: work items (row, query tile,
kv head, split of whole 64-key tiles) laid out on the device from the
descriptors and taken from a queue by a persistent grid, fp32 partials
merged in split order in the same C call. Its launch (:func:`launch_params`) depends on
the shapes and the card's SM count only. The design note on what the
kernel does about its bound is at the top of the CUDA source; the walk is
``csrc/paged_common.cuh``, shared with K7a.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import _build, _runs
from .decode_attention import (KERNEL_HEAD_DIMS, KERNEL_TILE_ROWS,
                               _sm_count, head_chunks, paged_splits)

#: persistent blocks per SM that take the work items
BLOCKS_PER_SM = 2


def launch_params(T: int, R: int, nb: int, bs: int, Hkv: int,
                  sm_count: int):
    """The kernel's launch for a packed width ``T``, ``R`` table rows of
    ``nb`` pages of ``bs`` tokens and ``Hkv`` kv heads on a card of
    ``sm_count`` SMs: ``splits`` ranges of ``per`` 64-key tiles of a row's
    ``nb * bs`` keys (:func:`paged_splits`), and ``grid`` persistent blocks
    (at most :data:`BLOCKS_PER_SM` an SM, at most one per possible item).
    Shapes only: the descriptors' values never change it."""
    splits, per = paged_splits(R, Hkv, nb, bs, sm_count)
    grid = min(BLOCKS_PER_SM * sm_count, max(1, T * Hkv * splits))
    return dict(splits=splits, per=per, grid=grid)


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
    # q k v k_scale v_scale tables qs ql cs cl out iscratch fscratch runs
    # | T H Hkv D N R nb bs | sm_scale window q_bf16 kv_int8 splits per
    # grid | stream
    fn.argtypes = [P] * 14 + [I] * 8 + [ctypes.c_float] + [I] * 6 + [P]
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
    if Dk != D or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got head_dim {D}/{Dk} (no published model the "
                         f"JAX package serves has another; ROADMAP.md "
                         f"Queue 2)")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"query heads {H} over kv heads {Hkv}: the group "
                         f"must be whole")
    if bs < 1:
        raise ValueError("pages must hold at least one token")
    if Hkv * head_chunks(H // Hkv, KERNEL_TILE_ROWS[q.dtype])[0] > 65535:
        raise ValueError(f"{Hkv} kv heads x head chunks exceed the kernel's "
                         f"item count")
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
    arguments). CUDA tensors launch the kernel on the current stream (the
    item layout, the split walk and the merge, in one C call) and add one
    to ``ragged_paged_attention.launches`` (and, on the device, to the
    count :func:`kernel_runs` reads); CPU tensors take the plain
    version; anything else raises. The descriptors stay on the device: the
    launch depends on the shapes only (:func:`launch_params`), so a
    captured CUDA graph replays for new descriptor values. bf16 q runs on
    the tensor cores (P.V as bf16(P) + bf16(P - bf16(P))), over a bf16
    pool or an int8 one (its codes are exact in bf16, its scales stay
    fp32); fp32 q in exact fp32 on CUDA cores. Head dims
    :data:`KERNEL_HEAD_DIMS`, any whole GQA group, any page size."""
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
    N, Hkv, bs = k_pages.shape[:3]
    R, nb = block_tables.shape
    if T == 0 or R == 0 or N == 0 or nb == 0:
        return torch.zeros_like(q)
    out = torch.empty_like(q)          # the kernel writes every element
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None \
        else (None, None)
    lp = launch_params(T, R, nb, bs, Hkv, _sm_count(out.device.index))
    # the item layout (queue head, order, prefix, each token's splits),
    # then per (token, query head, split) D accumulators, m and l
    iscratch = torch.empty(2 * R + 2 + T, dtype=torch.int32, device=dev)
    fscratch = torch.empty(T * H * lp["splits"] * (D + 2),
                           dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _entry()(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            block_tables.data_ptr(), *(d.data_ptr() for d in descriptors),
            out.data_ptr(), iscratch.data_ptr(), fscratch.data_ptr(),
            _runs.counter("ragged_paged_attention", dev).data_ptr(), T, H,
            Hkv, D, N, R, nb, bs, float(sm_scale),
            0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), int(k_scale is not None),
            lp["splits"], lp["per"], lp["grid"],
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention: kernel launch failed "
                           f"with CUDA error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def kernel_runs(device="cuda") -> int:
    """The launches of the kernel that ran on ``device`` since
    :func:`reset_kernel_runs`: the kernel adds one itself, so replays of
    a captured CUDA graph count and captures do not (the Python counter
    ``ragged_paged_attention.launches`` ticks where the wrapper runs, at
    capture). Waits for the device."""
    return _runs.kernel_runs("ragged_paged_attention", device)


def reset_kernel_runs(device="cuda") -> None:
    """Set :func:`kernel_runs` to 0 on ``device``."""
    _runs.reset_kernel_runs("ragged_paged_attention", device)
