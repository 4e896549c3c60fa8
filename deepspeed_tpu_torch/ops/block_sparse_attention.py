"""Block-sparse flash attention, forward and backward (kernel K9).

``sparse_attention(q, k, v, sparsity_config=..., causal=...)`` is the
public entry point (re-exported by ``ops.sparse_attention``): attention
over ``[B, T, H, D]`` tensors (kv heads already repeated) in which a
layout ``[H, nb, nb]`` of ``block x block`` tiles says which key blocks
each query block sees; with ``causal`` the layout is cut to its lower
triangle and each key must also lie at or before its query. It is a
``torch.autograd.Function`` whose forward saves ``(q, k, v, out, lse)``
and whose backward recomputes the probabilities from the logsumexp.

On CUDA tensors each pass launches a hand-written Hopper kernel that
walks the active blocks of the rows (forward, dQ) or columns (dK/dV)
only; on CPU tensors the same passes run their plain PyTorch versions,
which compute dense fp32 scores under the block mask. Any other placement
raises: there is no fallback from a kernel to a plain version. The
kernels take head dims 64, 80, 96, 128 and 256 and any block that is a
multiple of 16 (the tensor cores' m16n8k16 tiles need whole strips of 16
rows and 16 keys), by three routes (``kernel_route``): bf16 at blocks
that are a multiple of 64 runs ``csrc/block_sparse_attention.cu``'s
64-row slices, bf16 at the other blocks ``csrc/block_sparse_strips.cu``'s
16-row strips, fp32 the CUDA-core kernels of the first file. The bf16
kernels walk a work list (``_work_list``): each row's or column's list
cut into items of at most ``SPLIT_BLOCKS`` active blocks (64-row slices)
or ``SPLIT_KEYS`` keys (strips), longest first; the items of a walk that
was cut write fp32 partials that a second kernel of the same C call
merges, so each wrapper call is still one launch of its kernel.

The kernels replace ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``
(``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``). Their bounds on
an H100 and the design notes are at the top of the CUDA sources.

A row that sees no key gets zeros and ``lse = -inf``; ``layout_indices``
refuses a layout with an empty row, so only a direct call of a kernel
wrapper with such a layout makes one. The active lists of a layout and
their work lists are built on the host once and kept on the device in a
small cache. The layouts of a built-in ``SparsityConfig`` are made once
per sequence length and kept read-only, as are their causal cuts (a user
subclass is asked for its layout on every call); the lists of those
layouts are found by the array's identity, those of any other layout by
its bits, ``causal`` and the device either way.
"""

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import _delta

#: head dims the kernels are compiled for (those of K1/K2)
KERNEL_HEAD_DIMS = (64, 80, 96, 128, 256)
#: layout blocks the kernels take are whole multiples of this: mma's
#: m16n8k16 tiles need whole strips of 16 rows and of 16 keys
BLOCK_MULTIPLE = 16
#: how many layouts (and their device lists) the caches keep
CACHE_SIZE = 16
#: C, the most active blocks one work item of the 64-row slices walks: a
#: longer row (column for dK/dV) is cut into ceil(cnt / C) items whose
#: partials are merged (the design note of the CUDA source says why 16)
SPLIT_BLOCKS = 16
#: the most keys (queries for dK/dV) one work item of the 16-row strips
#: walks: 2048 // block active blocks (128 at a block of 16)
SPLIT_KEYS = 2048
#: rows the 64-row route gives one block: a block of 128 is walked as 2
SLICE = 64
#: rows (keys for dK/dV) the strip route gives one warp
STRIP = 16


def kernel_route(dtype, block: int) -> str:
    """The kernels a CUDA call takes: ``"tiles"`` (bf16, a block that is a
    multiple of 64: ``csrc/block_sparse_attention.cu``'s 64-row slices),
    ``"strips"`` (bf16, any other multiple of 16:
    ``csrc/block_sparse_strips.cu``) or ``"fp32"`` (the CUDA-core kernels
    of ``csrc/block_sparse_attention.cu``)."""
    if dtype == torch.float32:
        return "fp32"
    return "tiles" if block % SLICE == 0 else "strips"


def _split(block: int) -> int:
    """The most active blocks a work item holds at this block."""
    return SPLIT_BLOCKS if block % SLICE == 0 else max(1, SPLIT_KEYS // block)


def layout_indices(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[H, R, C] 0/1 layout → (idx [H, R, A], cnt [H, R]) active-column lists
    padded (by repetition) to the max row degree A."""
    layout = np.asarray(layout)
    H, R, C = layout.shape
    cnt = layout.sum(-1).astype(np.int32)
    if (cnt == 0).any():
        raise ValueError("sparsity layout has an empty row: every q block "
                         "must attend to at least one kv block")
    A = int(cnt.max())
    # the active columns of every row, in (head, row, column) order; entry
    # j of a row with n of them is its j-th (ascending), the rest repeat
    # its last
    seen = np.ascontiguousarray(layout != 0)
    c = (np.flatnonzero(seen) % C).astype(np.int32)
    n = np.count_nonzero(seen, axis=-1).ravel()
    idx = np.repeat(c[np.cumsum(n) - 1][:, None], A, axis=1)
    idx[np.arange(A) < n[:, None]] = c
    return idx.reshape(H, R, A), cnt


def _causal_layout(layout, causal: bool) -> np.ndarray:
    """The layout the kernels walk: cut to its lower triangle if causal."""
    layout = np.asarray(layout)
    if causal:
        nb = layout.shape[1]
        layout = layout * np.tril(np.ones((nb, nb), np.int64))
    return layout


def _scores(q, k, layout, block: int, causal: bool, sm_scale: float):
    """fp32 ``[B, H, T, T]`` scaled scores, -inf where the block mask (and
    causality) hides the key."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    seen = torch.as_tensor(np.asarray(layout) != 0, device=q.device)
    seen = seen.repeat_interleave(block, 1).repeat_interleave(block, 2)
    seen = seen[:, :T, :T][None]
    if causal:
        seen = seen & torch.ones(T, T, dtype=torch.bool,
                                 device=q.device).tril()
    return s.masked_fill(~seen, float("-inf"))


def block_sparse_attention_fwd_plain(q, k, v, layout, block: int,
                                     causal: bool = True,
                                     sm_scale: Optional[float] = None):
    """Plain PyTorch forward, differentiable by autograd: ``(out [B, T, H,
    D] in q's dtype, lse [B, H, T] fp32)``. A row that sees no key gets
    zeros and ``-inf``."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    s = _scores(q, k, layout, block, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / torch.where(l == 0, torch.ones_like(l), l).transpose(1, 2)
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, out, lse, dout, layout, block, causal,
                       sm_scale):
    """``(P, dS)`` of the backward, fp32 ``[B, H, T, T]``, with ``P``
    recomputed from ``lse`` and ``dS = P (dP - rowsum(dO * O))``."""
    s = _scores(q, k, layout, block, causal, sm_scale)
    p = torch.exp(s - lse[..., None]).masked_fill(torch.isinf(s), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - _delta(out, dout)[..., None])


def block_sparse_attention_bwd_dq_plain(q, k, v, out, lse, dout, layout,
                                        block: int, causal: bool = True,
                                        sm_scale: Optional[float] = None):
    """Plain PyTorch dQ from the saved logsumexp, in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    _, ds = _probs_and_dscores(q, k, v, out, lse, dout, layout, block,
                               causal, sm_scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
            * sm_scale).to(q.dtype)


def block_sparse_attention_bwd_dkv_plain(q, k, v, out, lse, dout, layout,
                                         block: int, causal: bool = True,
                                         sm_scale: Optional[float] = None):
    """Plain PyTorch ``(dk, dv)`` from the saved logsumexp, in k's and v's
    dtypes."""
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    p, ds = _probs_and_dscores(q, k, v, out, lse, dout, layout, block,
                               causal, sm_scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * sm_scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_indices_cache: "collections.OrderedDict" = collections.OrderedDict()
_layout_cache: "collections.OrderedDict" = collections.OrderedDict()
_cut_cache: "collections.OrderedDict" = collections.OrderedDict()


class _Same:
    """A cache key that holds an array and compares it by identity: the
    array stays alive while the entry does, so its id is never reused for
    another array under the same key."""
    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj


def _cached(cache, key, make):
    """``cache[key]``, made by ``make()`` on a miss; keeps the newest
    ``CACHE_SIZE`` entries."""
    if key in cache:
        cache.move_to_end(key)
        return cache[key]
    value = cache[key] = make()
    if len(cache) > CACHE_SIZE:
        cache.popitem(last=False)
    return value


def _work_list(cnt: np.ndarray, split: int = SPLIT_BLOCKS):
    """The bf16 kernels' work list of the lists with degrees ``cnt [H, R]``:
    ``(work [n, 5], merge [m, 4], slots)``.

    Each row ``r`` of head ``h`` becomes ``ceil(cnt / split)`` items
    ``(h, r, first entry, entries, slot)`` of at most ``split`` entries
    each, covering the row's entries once in order; an empty row keeps one
    item of none, which writes zeros. The items of a row cut into several
    get consecutive slots (else ``slot`` is -1) and the row a ``merge``
    entry ``(h, r, first slot, slots)``; ``slots`` counts them all. Items
    are ordered by their entries, most first (stable), so the longest
    start first on the card."""
    R = cnt.shape[1]
    n = np.asarray(cnt, np.int64).ravel()
    k = np.maximum(1, -(-n // split))            # items of each row
    cut = k > 1
    row = np.repeat(np.arange(n.size), k)
    c = np.arange(row.size) - np.repeat(np.cumsum(k) - k, k)
    start = c * split
    kept = np.where(cut, k, 0)
    slot0 = np.cumsum(kept) - kept               # each cut row's first slot
    work = np.stack([row // R, row % R, start,
                     np.minimum(split, n[row] - start),
                     np.where(cut[row], slot0[row] + c, -1)], axis=1)
    work = work[np.argsort(-work[:, 3], kind="stable")]
    rows = np.nonzero(cut)[0]
    merge = np.stack([rows // R, rows % R, slot0[rows], k[rows]], axis=1)
    return (work.astype(np.int32).reshape(-1, 5),
            merge.astype(np.int32).reshape(-1, 4), int(kept.sum()))


class _Walks(NamedTuple):
    """The lists one kernel walks, on the device: ``idx``/``cnt`` in the
    format of ``layout_indices`` and their ``_work_list`` (``longest`` is
    the most entries an item holds)."""
    idx: torch.Tensor
    cnt: torch.Tensor
    work: torch.Tensor
    merge: torch.Tensor
    slots: int
    longest: int


def _walks(layout: np.ndarray, device, split: int) -> _Walks:
    idx, cnt = layout_indices(layout)
    work, merge, slots = _work_list(cnt, split)
    return _Walks(*(torch.from_numpy(a).to(device)
                    for a in (idx, cnt, work, merge)),
                  slots, int(work[:, 3].max()))


def _own(layout) -> bool:
    """Is ``layout`` one of the read-only arrays the layout caches made
    (nothing else holds them writeable, so they never change)?"""
    return any(layout is a for cache in (_layout_cache, _cut_cache)
               for a in cache.values())


def _indices(layout, causal: bool, device, block: int):
    """``(rows, cols)``: the ``_Walks`` of the active key blocks of each
    query block (forward, dQ) and of the active query blocks of each key
    block (dK/dV) of the (causally cut) layout, with the work lists of
    ``block``'s route. Built once per layout, causality, device and split:
    a layout the caches made is looked up by identity, any other by its
    bits."""
    layout = np.asarray(layout)
    split = _split(block)
    what = _Same(layout) if _own(layout) else \
        (layout.shape, np.packbits(layout != 0).tobytes())
    key = (what, bool(causal), str(device), split)

    def make():
        cut = _causal_layout(layout, causal)
        return (_walks(cut, device, split),
                _walks(np.swapaxes(cut, 1, 2), device, split))

    return _cached(_indices_cache, key, make)


def _frozen(layout: np.ndarray) -> np.ndarray:
    layout.flags.writeable = False
    return layout


def _config_layout(sparsity_config, T: int) -> np.ndarray:
    """``sparsity_config.make_layout(T)``. A built-in config's layout is
    made once per config state and length (its fields, its seed included,
    determine it) and kept read-only; any other config is asked on every
    call, as the JAX package does, since a subclass may keep state outside
    its fields."""
    from .sparse_attention import sparsity_config as sc

    if type(sparsity_config) not in (
            sc.SparsityConfig, sc.DenseSparsityConfig, sc.FixedSparsityConfig,
            sc.VariableSparsityConfig, sc.BigBirdSparsityConfig,
            sc.BSLongformerSparsityConfig):
        return sparsity_config.make_layout(T)
    key = (type(sparsity_config), repr(sparsity_config), T)
    return _cached(_layout_cache, key,
                   lambda: _frozen(sparsity_config.make_layout(T)))


def _cut(layout, causal: bool) -> np.ndarray:
    """``_causal_layout``, kept (read-only) for a layout the caches made,
    so the lists of the cut are found by identity too."""
    if not _own(layout):
        return _causal_layout(layout, causal)
    if not causal:
        return layout
    return _cached(_cut_cache, (_Same(layout),),
                   lambda: _frozen(_causal_layout(layout, True)))


@functools.lru_cache(maxsize=None)
def _entries(route: str):
    """The C entries ``(fwd, dq, dkv)`` of a ``kernel_route``: the strips'
    library for ``"strips"``, ``block_sparse_attention``'s otherwise."""
    name = "block_sparse_strips" if route == "strips" \
        else "block_sparse_attention"
    lib = _build.load(name)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B H T D block A causal scale bf16 stream, then the work list:
    # work n_work merge n_merge max_blocks scratch
    shape = [I] * 7 + [F, I, P] + [P, I, P, I, I, P]
    fwd = getattr(lib, f"{name}_fwd")
    fwd.argtypes = [P] * 7 + shape          # q k v idx cnt out lse
    dq = getattr(lib, f"{name}_bwd_dq")
    dq.argtypes = [P] * 9 + shape           # q k v dout lse delta idx cnt dq
    dkv = getattr(lib, f"{name}_bwd_dkv")
    dkv.argtypes = [P] * 10 + shape         # ... dk dv
    for fn in (fwd, dq, dkv):
        fn.restype = I
    return fwd, dq, dkv


def _check(name, tensors, layout, block):
    """Raise on anything the kernels do not take; returns the device."""
    q, k, v = tensors[:3]
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on {dev}, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs its kernel on cuda and its plain "
                         f"version on cpu, not on {dev.type}")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must all be [B, T, H, D] (kv "
                         f"heads repeated), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    layout = np.asarray(layout)
    if layout.ndim != 3 or layout.shape[0] != H \
            or layout.shape[1] != layout.shape[2] \
            or layout.shape[1] * block != T:
        raise ValueError(f"{name}: layout {layout.shape} must be [H, nb, nb] "
                         f"with H {H} and nb * block ({block}) = T {T}")
    if dev.type == "cuda":
        _check_kernel_domain(name, q, k, v, block)
    return dev


def _check_kernel_domain(name, q, k, v, block):
    """Raise on the dtypes, head dims, blocks and grids that the kernels
    do not take (CUDA tensors)."""
    B, _, H, D = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or any(t.dtype != q.dtype for t in (k, v)):
        raise ValueError(f"{name}: the kernels take q, k, v all bf16 or "
                         f"all fp32, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if block <= 0 or block % BLOCK_MULTIPLE:
        raise ValueError(f"{name}: the kernels take a block that is a "
                         f"multiple of {BLOCK_MULTIPLE}, got {block} (the "
                         f"tensor cores' m16n8k16 tiles need whole strips "
                         f"of 16 rows and 16 keys)")
    if B * H > 65535:
        raise ValueError(f"{name}: B * H must be at most 65535, got "
                         f"{B * H}")


def _operand(t, dtype=None):
    """``t`` contiguous and 16-byte aligned, as the kernels read it."""
    t = t.contiguous() if dtype is None else t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(which, name, ptrs, q, block, walks, causal, sm_scale,
            part_row):
    """One call of the C entry ``which`` (0 fwd, 1 dq, 2 dkv) of the
    inputs' ``kernel_route``: its kernel and, for bf16 inputs with split
    walks, the merge of the split items' fp32 partials, ``part_row``
    values for each of their rows (forward: O, m and l, D + 2; dQ: D;
    dK/dV: 2 D), in a scratch of ``torch.empty``. Returns the route."""
    B, T, H, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    route = kernel_route(q.dtype, block)
    scratch = None
    if bf16 and walks.slots:
        scratch = torch.empty(walks.slots * block * B * part_row,
                              dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _entries(route)[which](
            *ptrs, B, H, T, D, block, walks.idx.shape[-1], int(causal),
            float(sm_scale), int(bf16),
            torch.cuda.current_stream(q.device).cuda_stream,
            walks.work.data_ptr(), walks.work.shape[0],
            walks.merge.data_ptr(), walks.merge.shape[0], walks.longest,
            None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    return route


def block_sparse_attention_fwd(q, k, v, layout, block: int,
                               causal: bool = True,
                               sm_scale: Optional[float] = None):
    """Forward pass (K9 fwd): ``(out, lse)``. CUDA tensors launch the
    kernel of their ``kernel_route`` and add one to
    ``block_sparse_attention_fwd.launches`` and to the route's entry of
    its ``route_launches`` (the merge of split rows runs inside the same
    call and is not counted apart); CPU tensors take ``block_sparse_attention_fwd_plain``;
    anything else raises."""
    dev = _check("block_sparse_attention_fwd", (q, k, v), layout, block)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        with torch.no_grad():
            return block_sparse_attention_fwd_plain(q, k, v, layout, block,
                                                    causal, sm_scale)
    rows, _ = _indices(layout, causal, dev, block)
    q, k, v = (_operand(t) for t in (q, k, v))
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    route = _launch(0, "block_sparse_attention_fwd",
                    (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     rows.idx.data_ptr(), rows.cnt.data_ptr(),
                     out.data_ptr(), lse.data_ptr()),
                    q, block, rows, causal, sm_scale, D + 2)
    block_sparse_attention_fwd.launches += 1
    block_sparse_attention_fwd.route_launches[route] += 1
    return out, lse


def _bwd_operands(q, k, v, out, lse, dout, delta):
    q, k, v = (_operand(t) for t in (q, k, v))
    dout = _operand(dout, q.dtype)     # the kernels read it as q's type
    if delta is None:
        delta = _delta(out, dout)
    return q, k, v, dout, _operand(lse, torch.float32), \
        _operand(delta, torch.float32)


def block_sparse_attention_bwd_dq(q, k, v, out, lse, dout, layout,
                                  block: int, causal: bool = True,
                                  sm_scale: Optional[float] = None,
                                  delta=None):
    """dQ (K9 dq). CUDA tensors launch the kernel and add one to
    ``block_sparse_attention_bwd_dq.launches`` (with the merge of split
    rows inside the same call); CPU tensors take the plain version;
    anything else raises. ``delta`` may pass ``rowsum(dO * O)``
    (fp32 ``[B, H, T]``) when the caller has it."""
    dev = _check("block_sparse_attention_bwd_dq", (q, k, v, out, lse, dout),
                 layout, block)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        return block_sparse_attention_bwd_dq_plain(
            q, k, v, out, lse, dout, layout, block, causal, sm_scale)
    rows, _ = _indices(layout, causal, dev, block)
    q, k, v, dout, lse, delta = _bwd_operands(q, k, v, out, lse, dout, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    route = _launch(1, "block_sparse_attention_bwd_dq",
                    (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     rows.idx.data_ptr(), rows.cnt.data_ptr(),
                     dq.data_ptr()),
                    q, block, rows, causal, sm_scale, q.shape[-1])
    block_sparse_attention_bwd_dq.launches += 1
    block_sparse_attention_bwd_dq.route_launches[route] += 1
    return dq


def block_sparse_attention_bwd_dkv(q, k, v, out, lse, dout, layout,
                                   block: int, causal: bool = True,
                                   sm_scale: Optional[float] = None,
                                   delta=None):
    """``(dk, dv)`` (K9 dkv), over the transposed active lists. CUDA
    tensors launch the kernel and add one to
    ``block_sparse_attention_bwd_dkv.launches``; CPU tensors take the plain
    version; anything else raises. The merge of split columns runs inside
    the same call. ``delta`` may pass a ``rowsum(dO * O)`` already computed
    for the dQ kernel."""
    dev = _check("block_sparse_attention_bwd_dkv", (q, k, v, out, lse, dout),
                 layout, block)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        return block_sparse_attention_bwd_dkv_plain(
            q, k, v, out, lse, dout, layout, block, causal, sm_scale)
    _, cols = _indices(layout, causal, dev, block)
    q, k, v, dout, lse, delta = _bwd_operands(q, k, v, out, lse, dout, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    route = _launch(2, "block_sparse_attention_bwd_dkv",
                    (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                     cols.idx.data_ptr(), cols.cnt.data_ptr(),
                     dk.data_ptr(), dv.data_ptr()),
                    q, block, cols, causal, sm_scale, 2 * q.shape[-1])
    block_sparse_attention_bwd_dkv.launches += 1
    block_sparse_attention_bwd_dkv.route_launches[route] += 1
    return dk, dv


for _fn in (block_sparse_attention_fwd, block_sparse_attention_bwd_dq,
            block_sparse_attention_bwd_dkv):
    _fn.launches = 0
    #: the launches of each ``kernel_route`` (they add up to ``launches``)
    _fn.route_launches = collections.Counter()
del _fn


class _SparseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, layout, block, causal, sm_scale):
        out, lse = block_sparse_attention_fwd(q, k, v, layout, block, causal,
                                              sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (layout, block, causal, sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        args = ctx.args
        delta = None if dout.device.type == "cpu" else _delta(out, dout)
        dq = block_sparse_attention_bwd_dq(q, k, v, out, lse, dout, *args,
                                           delta=delta)
        dk, dv = block_sparse_attention_bwd_dkv(q, k, v, out, lse, dout,
                                                *args, delta=delta)
        return dq, dk, dv, None, None, None, None


def sparse_attention(q, k, v, sparsity_config=None,
                     layout: Optional[np.ndarray] = None,
                     causal: bool = True, sm_scale: Optional[float] = None,
                     **unsupported):
    """Block-sparse attention over ``[B, T, H, D]`` tensors.

    Provide either a ``SparsityConfig`` (``ops.sparse_attention``) or a
    precomputed ``layout [H, nb, nb]``. Differentiable: K9 forward and
    backward kernels on CUDA tensors, the plain versions on CPU tensors.
    The JAX package's ``interpret`` and ``force_pallas`` choose between
    its TPU kernel and its reference; here the tensors' device decides,
    so they (and any other keyword) raise ``TypeError``."""
    if unsupported:
        raise TypeError(f"sparse_attention: unsupported options "
                        f"{sorted(unsupported)} (the tensors' device picks "
                        f"the kernel or the plain version)")
    B, T, H, D = q.shape
    if layout is None:
        if sparsity_config is None:
            raise ValueError("need sparsity_config or layout")
        layout = _config_layout(sparsity_config, T)
    layout = np.asarray(layout)
    nb = layout.shape[1]
    if T % nb or layout.shape[1] != layout.shape[2]:
        raise ValueError(f"layout [{layout.shape}] must be square and tile "
                         f"seq_len {T} exactly")
    block = T // nb
    if layout.shape[0] != H:
        raise ValueError(f"layout heads {layout.shape[0]} != {H}")
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(D))
    layout = _cut(layout, causal)
    # building the lists holds the JAX package's check (no empty row or
    # column) on every device; the kernels' wrappers find them cached
    _indices(layout, causal, q.device, block)
    return _SparseAttention.apply(q, k, v, layout, block, bool(causal),
                                  float(sm_scale))
