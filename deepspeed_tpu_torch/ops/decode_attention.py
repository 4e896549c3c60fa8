"""Decode-time attention: the contiguous cache (kernel K4) and the paged
pool (kernels K7a and K7b).

``decode_attention`` is the wrapper the model calls at every decode step
of ``InferenceEngine.generate``; ``paged_decode_attention`` and
``paged_prefill_attention`` are what the two-program serving engine's
decode step and chunked prefill call. On CUDA tensors each launches its
hand-written Hopper kernel (``csrc/decode_attention.cu``,
``csrc/paged_attention.cu``); on CPU tensors it computes the same function
with its ``*_plain`` version. Any other placement raises: there is no
fallback from a kernel to a plain version.

The kernels replace ``deepspeed_tpu/ops/pallas/decode_attention.py``
(``_decode_kernel``, ``_paged_decode_kernel``, ``_paged_prefill_kernel``).
Their bound on an H100 is bytes: the visible part of each row's K/V (and
int8 scales) read once, against 3.35 TB/s. K4 cuts the key axis into
:func:`decode_splits` ranges of whole tiles, one block each, and merges
their partials in the same call; K7a does the same over the block table's
capacity (:func:`decode_launch`), and K7b over the same capacity with its
query tiles counted in (:func:`prefill_launch`); both run the walk they
share with K6 (``csrc/paged_common.cuh``), for any page size, head dims
:data:`KERNEL_HEAD_DIMS` and any whole GQA group. The design notes are at
the top of the CUDA sources.
"""

import ctypes
import functools
from typing import Optional

import torch

from . import _build, _runs

#: head dims K4 and the paged kernels (K7a, K7b) are compiled for: those
#: of every published model the JAX package serves; each takes any whole
#: GQA group, the paged ones any page size
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)
#: query rows (tokens x heads) of the paged walk's chunk item, by q's
#: dtype: 64 on the tensor cores (bf16 q), 32 on the CUDA cores (fp32 q);
#: a chunk holds floor(rows / G) tokens, and a group over the rows is cut
#: into head chunks of one token (:func:`head_chunks`)
KERNEL_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 32}
#: most rows of the walk's narrow item (one K7a token of a group up to
#: this many heads), by q's dtype
KERNEL_NARROW_ROWS = {torch.bfloat16: 16, torch.float32: 8}
#: keys of one K4 tile: a split is a whole number of tiles
KERNEL_KEY_TILE = 64
#: K4's and the paged walks' (K6, K7a) blocks the split count aims for
#: per SM
BLOCKS_PER_SM = 2


def decode_splits(B: int, Hkv: int, S: int, sm_count: int) -> int:
    """K4's split count: ``S`` (the cache's capacity, not the filled
    length, so a launch never depends on ``cache_index``) cut into ranges
    of the same whole number of ``KERNEL_KEY_TILE``-key tiles. The count
    aims at ``B * Hkv * splits`` blocks giving every SM
    :data:`BLOCKS_PER_SM`, at most one range per tile; rounding the
    tiles a range holds up keeps more than half of that aim. Every range
    is non-empty."""
    return _split_tiles(B, Hkv, S, sm_count)[0]


def _split_tiles(B: int, Hkv: int, S: int, sm_count: int):
    """``(splits, per)``: :func:`decode_splits`' count and the tiles of
    each range."""
    tiles = -(-S // KERNEL_KEY_TILE)
    want = -(-BLOCKS_PER_SM * sm_count // max(1, B * Hkv))
    per = -(-tiles // max(1, min(want, tiles)))
    return -(-tiles // per), per


def paged_splits(rows: int, Hkv: int, nb: int, bs: int, sm_count: int):
    """``(splits, per)`` of the paged walks (K6, K7a): a block table of
    ``nb`` pages of ``bs`` tokens (``nb * bs`` keys, the capacity, never a
    context length) cut by :func:`decode_splits`' rule into ``splits``
    ranges of ``per`` whole ``KERNEL_KEY_TILE``-key tiles, for ``rows``
    table rows (rows times head chunks, where a group is cut)."""
    return _split_tiles(rows, Hkv, nb * bs, sm_count)


def head_chunks(G: int, rows: int):
    """``(chunks, heads)``: a chunk item of ``rows`` rows takes a group of
    ``G`` query heads whole where it fits (``(1, G)``), else in the fewest
    chunks of at most ``rows`` heads, ``heads`` each (the last may hold
    fewer), one token an item."""
    chunks = -(-G // rows)
    return chunks, -(-G // chunks)


def decode_launch(B: int, H: int, Hkv: int, nb: int, bs: int,
                  dtype: torch.dtype, sm_count: int):
    """K7a's launch for ``B`` sequences, ``H`` query heads over ``Hkv`` kv
    heads, a table of ``nb`` pages of ``bs`` tokens, q of ``dtype``:
    ``narrow`` (the group fits ``KERNEL_NARROW_ROWS[dtype]`` rows: one
    narrow item a (sequence, kv head, split), else a chunk item of one
    token a head chunk), ``chunks`` head chunks a kv head, and
    :func:`paged_splits`' ``splits`` and ``per`` for ``B * chunks`` rows of
    work. The grid is ``(B, Hkv * chunks, splits)``."""
    G = H // Hkv
    narrow = G <= KERNEL_NARROW_ROWS[dtype]
    chunks = 1 if narrow else head_chunks(G, KERNEL_TILE_ROWS[dtype])[0]
    splits, per = paged_splits(B * chunks, Hkv, nb, bs, sm_count)
    return dict(narrow=narrow, chunks=chunks, splits=splits, per=per)


def prefill_launch(B: int, T: int, H: int, Hkv: int, nb: int, bs: int,
                   dtype: torch.dtype, sm_count: int):
    """K7b's launch for ``B`` chunks of ``T`` tokens, ``H`` query heads
    over ``Hkv`` kv heads, a table of ``nb`` pages of ``bs`` tokens, q of
    ``dtype``: ``chunks`` head chunks a kv head (:func:`head_chunks`),
    ``tiles`` query tiles a chunk (``KERNEL_TILE_ROWS[dtype] // heads``
    tokens each), and :func:`paged_splits`' ``splits`` and ``per`` for
    ``B * tiles * chunks`` rows of work. The grid is ``(B * tiles, Hkv *
    chunks, splits)``. Shapes only: ``chunk_start`` and ``context_lens``
    never change it."""
    rows = KERNEL_TILE_ROWS[dtype]
    chunks, heads = head_chunks(H // Hkv, rows)
    tiles = -(-T // (rows // heads))
    splits, per = paged_splits(B * tiles * chunks, Hkv, nb, bs, sm_count)
    return dict(tiles=tiles, chunks=chunks, splits=splits, per=per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    # q k v k_scale v_scale key_mask cache_index out scratch | B H Hkv S D |
    # sm_scale window q_bf16 kv_int8 splits | stream
    fn.argtypes = [P] * 9 + [I] * 5 + [ctypes.c_float, I, I, I, I, P]
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
    if H % Hkv:
        raise ValueError(f"query heads {H} over kv heads {Hkv}: the group "
                         f"must be whole")
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
    arguments). CUDA tensors launch the kernel on the current stream (the
    split walk and its merge, in one C call) and add one to
    ``decode_attention.launches``; CPU tensors take the plain version;
    anything else raises. ``cache_index`` may be an int or an int32
    device scalar: the kernel reads it on the device, as the TPU kernel
    prefetches it, so the launch is the same for every value."""
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
    Hkv = k_cache.shape[1]
    splits = decode_splits(B, Hkv, S, _sm_count(out.device.index))
    # per (row, query head, split): D accumulators, then m and l
    scratch = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        rc = _entry()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales,
            key_mask.data_ptr(), cidx.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, H, Hkv, S, D, float(sm_scale),
            0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), int(k_scale is not None),
            splits, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention: kernel launch failed with "
                           f"CUDA error {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# the paged pool: K7a (one query per sequence) and K7b (a chunk per sequence)
# ---------------------------------------------------------------------------

def paged_prefill_attention_plain(q, k_pages, v_pages, block_tables,
                                  chunk_start, context_lens,
                                  sm_scale: Optional[float] = None,
                                  window: Optional[int] = None,
                                  k_scale=None, v_scale=None):
    """Plain PyTorch version of the paged chunked-prefill kernel.

    ``q``: ``[B, T, H, D]`` (one chunk per sequence, KV already appended);
    ``k_pages``/``v_pages``: ``[N, Hkv, bs, D]``; ``block_tables``: int32
    ``[B, nb]`` (an entry outside ``[0, N)`` is unallocated; it reads page
    ``N - 1``, which the length mask hides); ``chunk_start``,
    ``context_lens``: int32 ``[B]``; ``k_scale``/``v_scale``: fp32
    ``[N, Hkv, bs]`` for an int8 pool. Row ``t`` sits at ``chunk_start +
    t`` and sees keys ``p <= `` its position with ``p < context_len`` and,
    with a window, ``position - p < window``. Math in fp32; returns
    ``[B, T, H, D]`` in q's dtype, zeros for rows at or past
    ``context_len`` and rows that see no key. Masked keys' V never reaches
    the sum (zeroed, not only weighted by 0)."""
    B, T, H, D = q.shape
    N, Hkv, bs, _ = k_pages.shape
    G = H // Hkv
    nb = block_tables.shape[1]
    S = nb * bs
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    bt = block_tables.long()
    bt = torch.where((bt < 0) | (bt >= N), torch.full_like(bt, N - 1), bt)
    k, v = k_pages[bt].float(), v_pages[bt].float()    # [B, nb, Hkv, bs, D]
    if k_scale is not None:
        k = k * k_scale[bt].float()[..., None]
        v = v * v_scale[bt].float()[..., None]
    k = k.transpose(1, 2).reshape(B, Hkv, S, D)
    v = v.transpose(1, 2).reshape(B, Hkv, S, D)
    cs = chunk_start.long()[:, None, None]
    cl = context_lens.long()[:, None, None]
    pos = cs + torch.arange(T, device=q.device)[None, :, None]   # [B, T, 1]
    col = torch.arange(S, device=q.device)[None, None, :]
    seen = (col <= pos) & (col < cl) & (pos < cl)                # [B, T, S]
    if window is not None:
        seen = seen & (pos - col < window)
    s = torch.einsum("bthgd,bhsd->bhgts",
                     q.float().reshape(B, T, Hkv, G, D), k) * sm_scale
    s = s.masked_fill(~seen[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    v = v.masked_fill(~seen.any(dim=1)[:, None, :, None], 0.0)
    o = torch.einsum("bhgts,bhsd->bthgd", p / torch.where(
        l == 0, torch.ones_like(l), l), v)
    return o.reshape(B, T, H, D).to(q.dtype)


def paged_decode_attention_plain(q, k_pages, v_pages, block_tables,
                                 context_lens,
                                 sm_scale: Optional[float] = None,
                                 window: Optional[int] = None,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch version of the paged decode kernel: ``q [B, H, D]`` is
    one new token per sequence (already appended) at ``context_lens - 1``;
    key ``p`` is visible iff ``p < context_len`` and, with a window,
    ``context_len - 1 - p < window``. The other arguments are those of
    :func:`paged_prefill_attention_plain`, of which this is the chunk of
    one token. Returns ``[B, H, D]``, zeros for a row that sees no key."""
    return paged_prefill_attention_plain(
        q[:, None], k_pages, v_pages, block_tables, context_lens - 1,
        context_lens, sm_scale=sm_scale, window=window, k_scale=k_scale,
        v_scale=v_scale)[:, 0]


@functools.lru_cache(maxsize=None)
def _paged_entries():
    lib = _build.load("paged_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    dec = lib.paged_decode_attention
    # q k v k_scale v_scale tables context_lens out scratch | B H Hkv D N
    # nb bs | sm_scale window q_bf16 kv_int8 splits per | runs stream
    dec.argtypes = [P] * 9 + [I] * 7 + [ctypes.c_float, I, I, I, I, I, P, P]
    pre = lib.paged_prefill_attention
    # q k v k_scale v_scale tables chunk_start context_lens out scratch |
    # B T H Hkv D N nb bs | sm_scale window q_bf16 kv_int8 splits per |
    # runs stream
    pre.argtypes = [P] * 10 + [I] * 8 + [ctypes.c_float, I, I, I, I, I, P, P]
    dec.restype = pre.restype = I
    return dec, pre


def _check_paged_args(name, q, k_pages, v_pages, block_tables, descriptors,
                      k_scale, v_scale, window):
    """Raise on anything the paged kernels do not take; returns
    ``(B, H, D, N, Hkv, nb, bs)``."""
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: q must be bf16 or fp32, got {q.dtype}")
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: k_pages and v_pages must both be "
                         f"[N, Hkv, bs, D]")
    N, Hkv, bs, Dk = k_pages.shape
    if Dk != D or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got head_dim {D}/{Dk} (no "
                         f"published model the JAX package serves has "
                         f"another; ROADMAP.md Queue 2)")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: query heads {H} over kv heads {Hkv}: "
                         f"the group must be whole")
    if bs < 1:
        raise ValueError(f"{name}: pages must hold at least one token")
    rows = KERNEL_TILE_ROWS[q.dtype]
    if Hkv * head_chunks(H // Hkv, rows)[0] > 65535:
        raise ValueError(f"{name}: {Hkv} kv heads x head chunks exceed "
                         f"the grid")
    int8 = k_scale is not None
    want = torch.int8 if int8 else q.dtype
    if k_pages.dtype != want or v_pages.dtype != want:
        raise ValueError(f"{name}: pages must be {want} (q is {q.dtype}, "
                         f"int8 pool: {int8}), got {k_pages.dtype}/"
                         f"{v_pages.dtype}")
    if int8:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (N, Hkv, bs) \
                    or not s.is_contiguous():
                raise ValueError(f"{name}: k_scale/v_scale must be "
                                 f"contiguous fp32 [N, Hkv, bs]")
    if block_tables.dim() != 2 or block_tables.dtype != torch.int32 \
            or block_tables.shape[0] != B:
        raise ValueError(f"{name}: block_tables must be int32 [B, nb]")
    for d in descriptors:
        if d.dtype != torch.int32 or tuple(d.shape) != (B,) \
                or not d.is_contiguous():
            raise ValueError(f"{name}: chunk_start/context_lens must be "
                             f"contiguous int32 [B]")
    for t in (q, k_pages, v_pages, block_tables):
        if not t.is_contiguous():
            raise ValueError(f"{name}: q, pages and block_tables must be "
                             f"contiguous")
    for t in (k_pages, v_pages) + ((k_scale, v_scale) if int8 else ()):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: pages and scales must be 16-byte "
                             f"aligned")
    if window is not None and int(window) <= 0:
        raise ValueError("window must be a positive int or None")
    return B, H, D, N, Hkv, block_tables.shape[1], bs


def _paged_device(name, tensors, k_scale, v_scale):
    """The one device of a paged call's tensors ("cpu" or "cuda")."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale (int8 pool) or "
                         "neither")
    if k_scale is not None:
        tensors += (k_scale, v_scale)
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on {dev}, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs its kernel on cuda and its plain "
                         f"version on cpu, not on {dev.type}")
    return dev


def paged_decode_attention(q, k_pages, v_pages, block_tables, context_lens,
                           sm_scale: Optional[float] = None,
                           window: Optional[int] = None,
                           k_scale=None, v_scale=None):
    """One query per sequence over the paged pool (kernel K7a; see the
    plain version for the arguments). CUDA tensors launch the kernel on the
    current stream (the split walk over the block table and its merge, in
    one C call) and add one to ``paged_decode_attention.launches`` (and
    the kernel to its device run count, ``_runs.kernel_runs``); CPU
    tensors take the plain version; anything else raises. The launch comes
    from the table's width, the page size, the group and the card
    (:func:`decode_launch`), never from ``context_lens``, so it is the same
    for every value of the descriptors and a captured CUDA graph replays
    for new ones. bf16 q runs on the tensor cores (P.V as bf16(P) +
    bf16(P - bf16(P))), over a bf16 pool or an int8 one (its codes are
    exact in bf16, its scales stay fp32); fp32 q in exact fp32 on CUDA
    cores. Head dims :data:`KERNEL_HEAD_DIMS`, any whole group, any page
    size. The bound
    is bytes: the visible pages over 3.35 TB/s; the design notes are at
    the top of ``csrc/paged_attention.cu``."""
    dev = _paged_device("paged_decode_attention",
                        (q, k_pages, v_pages, block_tables, context_lens),
                        k_scale, v_scale)
    if dev.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pages, v_pages, block_tables, context_lens,
            sm_scale=sm_scale, window=window, k_scale=k_scale,
            v_scale=v_scale)
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], got {tuple(q.shape)}")
    B, H, D, N, Hkv, nb, bs = _check_paged_args(
        "paged_decode_attention", q, k_pages, v_pages, block_tables,
        (context_lens,), k_scale, v_scale, window)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if N == 0 or nb == 0:
        return out.zero_()
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None \
        else (None, None)
    lp = decode_launch(B, H, Hkv, nb, bs, q.dtype,
                       _sm_count(out.device.index))
    splits = lp["splits"]
    # per (sequence, query head, split): D accumulators, then m and l
    scratch = torch.empty(B * H * splits * (D + 2) if splits > 1 else 0,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _paged_entries()[0](
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if splits > 1 else None, B, H, Hkv, D, N, nb,
            bs, float(sm_scale), 0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), int(k_scale is not None),
            splits, lp["per"],
            _runs.counter("paged_decode_attention", dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention: kernel launch failed "
                           f"with CUDA error {rc}")
    paged_decode_attention.launches += 1
    return out


def paged_prefill_attention(q, k_pages, v_pages, block_tables, chunk_start,
                            context_lens, sm_scale: Optional[float] = None,
                            window: Optional[int] = None,
                            k_scale=None, v_scale=None):
    """One prefill chunk per sequence over the paged pool (kernel K7b; see
    the plain version for the arguments). CUDA tensors launch the kernel on
    the current stream (the split walk over the block table and its merge,
    in one C call) and add one to ``paged_prefill_attention.launches``
    (and the kernel to its device run count, ``_runs.kernel_runs``); CPU
    tensors take the plain version; anything else raises. The launch comes
    from the shapes and the card (:func:`prefill_launch`), never from
    ``chunk_start`` or ``context_lens``, so a captured CUDA graph replays
    for new descriptors. bf16 q runs on the tensor cores as K7a does, a
    query tile of floor(64 / G) tokens x G heads; fp32 q in exact fp32 on
    CUDA cores, floor(32 / G) tokens a tile; a larger group takes one token
    a tile in head chunks (:func:`head_chunks`). Every output element is
    written (zeros for rows at or past the context)."""
    dev = _paged_device("paged_prefill_attention",
                        (q, k_pages, v_pages, block_tables, chunk_start,
                         context_lens), k_scale, v_scale)
    if dev.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pages, v_pages, block_tables, chunk_start, context_lens,
            sm_scale=sm_scale, window=window, k_scale=k_scale,
            v_scale=v_scale)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    B, H, D, N, Hkv, nb, bs = _check_paged_args(
        "paged_prefill_attention", q, k_pages, v_pages, block_tables,
        (chunk_start, context_lens), k_scale, v_scale, window)
    T = q.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if N == 0 or nb == 0:
        return out.zero_()
    if sm_scale is None:
        sm_scale = 1.0 / D ** 0.5
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if k_scale is not None \
        else (None, None)
    lp = prefill_launch(B, T, H, Hkv, nb, bs, q.dtype,
                        _sm_count(out.device.index))
    splits = lp["splits"]
    # per (token, query head, split): D accumulators, then m and l
    scratch = torch.empty(B * T * H * splits * (D + 2) if splits > 1 else 0,
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _paged_entries()[1](
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            block_tables.data_ptr(), chunk_start.data_ptr(),
            context_lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if splits > 1 else None, B, T, H, Hkv, D, N,
            nb, bs, float(sm_scale), 0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), int(k_scale is not None),
            splits, lp["per"],
            _runs.counter("paged_prefill_attention", dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention: kernel launch failed "
                           f"with CUDA error {rc}")
    paged_prefill_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_prefill_attention.launches = 0
