"""Block-sparse flash attention, forward and backward (kernel K9).

``sparse_attention(q, k, v, sparsity_config=..., causal=...)`` is the
public entry point (re-exported by ``ops.sparse_attention``): attention
over ``[B, T, H, D]`` tensors (kv heads already repeated) in which a
layout ``[H, nb, nb]`` of ``block x block`` tiles says which key blocks
each query block sees; with ``causal`` the layout is cut to its lower
triangle and each key must also lie at or before its query. It is a
``torch.autograd.Function`` whose forward saves ``(q, k, v, out, lse)``
and whose backward recomputes the probabilities from the logsumexp.

On CUDA tensors each pass launches a hand-written Hopper kernel of
``csrc/block_sparse_attention.cu`` that walks the active blocks of the
rows (forward, dQ) or columns (dK/dV) only; on CPU tensors the same
passes run their plain PyTorch versions, which compute dense fp32 scores
under the block mask. Any other placement raises: there is no fallback
from a kernel to a plain version. The bf16 kernels walk a work list
(``_work_list``): each row's or column's list cut into items of at most
``SPLIT_BLOCKS`` active blocks, longest first; the items of a walk that
was cut write fp32 partials that a second kernel of the same C call
merges, so each wrapper call is still one launch of its kernel.

The kernels replace ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``
(``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``). Their bounds on
an H100 and the design note are at the top of the CUDA source.

A row that sees no key gets zeros and ``lse = -inf``; ``layout_indices``
refuses a layout with an empty row, so only a direct call of a kernel
wrapper with such a layout makes one. The active lists of a layout and
their work lists are built on the host once and kept on the device in a
small cache keyed by the layout's bits, ``causal`` and the device, as are
the layouts of a built-in ``SparsityConfig`` per sequence length (a user
subclass is asked for its layout on every call).
"""

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build
from .flash_attention import _delta

#: head dims the kernels are compiled for; the rest of the JAX kernels'
#: domain is ROADMAP.md Queue 2, step 4
KERNEL_HEAD_DIMS = (64, 128)
#: layout block sizes the kernels take (multiples of their 64-row tiles)
KERNEL_BLOCKS = (64, 128)
#: how many layouts (and their device lists) the caches keep
CACHE_SIZE = 16
#: C, the most active blocks one work item of the bf16 kernels walks: a
#: longer row (column for dK/dV) is cut into ceil(cnt / C) items whose
#: partials are merged (the design note of the CUDA source says why 16)
SPLIT_BLOCKS = 16
#: rows the kernels give one block: a block of 128 is walked as 2 slices
SLICE = 64


def layout_indices(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[H, R, C] 0/1 layout → (idx [H, R, A], cnt [H, R]) active-column lists
    padded (by repetition) to the max row degree A."""
    H, R, C = layout.shape
    cnt = layout.sum(-1).astype(np.int32)
    if (cnt == 0).any():
        raise ValueError("sparsity layout has an empty row: every q block "
                         "must attend to at least one kv block")
    A = int(cnt.max())
    idx = np.zeros((H, R, A), np.int32)
    for h in range(H):
        for r in range(R):
            active = np.nonzero(layout[h, r])[0]
            idx[h, r, :len(active)] = active
            idx[h, r, len(active):] = active[-1]
    return idx, cnt


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
    items, merge, slots = [], [], 0
    for h, r in np.ndindex(*cnt.shape):
        n = int(cnt[h, r])
        if n <= split:
            items.append((h, r, 0, n, -1))
            continue
        k = -(-n // split)
        merge.append((h, r, slots, k))
        items += [(h, r, c * split, min(split, n - c * split), slots + c)
                  for c in range(k)]
        slots += k
    items.sort(key=lambda item: -item[3])
    return (np.asarray(items, np.int32).reshape(-1, 5),
            np.asarray(merge, np.int32).reshape(-1, 4), slots)


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


def _walks(layout: np.ndarray, device) -> _Walks:
    idx, cnt = layout_indices(layout)
    work, merge, slots = _work_list(cnt)
    return _Walks(*(torch.from_numpy(a).to(device)
                    for a in (idx, cnt, work, merge)),
                  slots, int(work[:, 3].max()))


def _indices(layout, causal: bool, device):
    """``(rows, cols)``: the ``_Walks`` of the active key blocks of each
    query block (forward, dQ) and of the active query blocks of each key
    block (dK/dV) of the (causally cut) layout. Built once per layout,
    causality and device."""
    layout = np.asarray(layout)
    key = (np.packbits(layout != 0).tobytes(), layout.shape, bool(causal),
           str(device))

    def make():
        cut = _causal_layout(layout, causal)
        return _walks(cut, device), _walks(np.swapaxes(cut, 1, 2), device)

    return _cached(_indices_cache, key, make)


def _config_layout(sparsity_config, T: int) -> np.ndarray:
    """``sparsity_config.make_layout(T)``. A built-in config's layout is
    made once per config state and length (its fields, its seed included,
    determine it); any other config is asked on every call, as the JAX
    package does, since a subclass may keep state outside its fields."""
    from .sparse_attention import sparsity_config as sc

    if type(sparsity_config) not in (
            sc.SparsityConfig, sc.DenseSparsityConfig, sc.FixedSparsityConfig,
            sc.VariableSparsityConfig, sc.BigBirdSparsityConfig,
            sc.BSLongformerSparsityConfig):
        return sparsity_config.make_layout(T)
    key = (type(sparsity_config), repr(sparsity_config), T)

    def make():
        layout = sparsity_config.make_layout(T)
        layout.flags.writeable = False
        return layout

    return _cached(_layout_cache, key, make)


@functools.lru_cache(maxsize=None)
def _entries():
    lib = _build.load("block_sparse_attention")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # B H T D block A causal scale bf16 stream, then the work list:
    # work n_work merge n_merge max_blocks scratch
    shape = [I] * 7 + [F, I, P] + [P, I, P, I, I, P]
    fwd = lib.block_sparse_attention_fwd
    fwd.argtypes = [P] * 7 + shape          # q k v idx cnt out lse
    dq = lib.block_sparse_attention_bwd_dq
    dq.argtypes = [P] * 9 + shape           # q k v dout lse delta idx cnt dq
    dkv = lib.block_sparse_attention_bwd_dkv
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
                         f"{KERNEL_HEAD_DIMS}, got {D} (the rest is "
                         f"ROADMAP.md Queue 2, step 4)")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"{name}: the kernels take block in "
                         f"{KERNEL_BLOCKS}, got {block} (the rest is "
                         f"ROADMAP.md Queue 2, step 4)")
    if B * H > 65535:
        raise ValueError(f"{name}: B * H must be at most 65535, got "
                         f"{B * H}")


def _operand(t, dtype=None):
    """``t`` contiguous and 16-byte aligned, as the kernels read it."""
    t = t.contiguous() if dtype is None else t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, name, ptrs, q, block, walks, causal, sm_scale, part_row):
    """One call of a C entry: its kernel and, for bf16 inputs with split
    walks, the merge of the split items' fp32 partials, ``part_row``
    values for each of their 64 rows (forward: O, m and l, D + 2; dQ: D;
    dK/dV: 2 D), in a scratch of ``torch.empty``."""
    B, T, H, D = q.shape
    bf16 = q.dtype == torch.bfloat16
    scratch = None
    if bf16 and walks.slots:
        scratch = torch.empty(walks.slots * (block // SLICE) * B * SLICE
                              * part_row, dtype=torch.float32,
                              device=q.device)
    with torch.cuda.device(q.device):
        rc = fn(*ptrs, B, H, T, D, block, walks.idx.shape[-1], int(causal),
                float(sm_scale), int(bf16),
                torch.cuda.current_stream(q.device).cuda_stream,
                walks.work.data_ptr(), walks.work.shape[0],
                walks.merge.data_ptr(), walks.merge.shape[0], walks.longest,
                None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")


def block_sparse_attention_fwd(q, k, v, layout, block: int,
                               causal: bool = True,
                               sm_scale: Optional[float] = None):
    """Forward pass (K9 fwd): ``(out, lse)``. CUDA tensors launch the
    kernel and add one to ``block_sparse_attention_fwd.launches`` (the
    merge of split rows runs inside the same call and is not counted
    apart); CPU tensors take ``block_sparse_attention_fwd_plain``;
    anything else raises."""
    dev = _check("block_sparse_attention_fwd", (q, k, v), layout, block)
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    if dev.type == "cpu":
        with torch.no_grad():
            return block_sparse_attention_fwd_plain(q, k, v, layout, block,
                                                    causal, sm_scale)
    rows, _ = _indices(layout, causal, dev)
    q, k, v = (_operand(t) for t in (q, k, v))
    B, T, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    _launch(_entries()[0], "block_sparse_attention_fwd",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), rows.idx.data_ptr(),
             rows.cnt.data_ptr(), out.data_ptr(), lse.data_ptr()),
            q, block, rows, causal, sm_scale, D + 2)
    block_sparse_attention_fwd.launches += 1
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
    rows, _ = _indices(layout, causal, dev)
    q, k, v, dout, lse, delta = _bwd_operands(q, k, v, out, lse, dout, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    _launch(_entries()[1], "block_sparse_attention_bwd_dq",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), rows.idx.data_ptr(),
             rows.cnt.data_ptr(), dq.data_ptr()),
            q, block, rows, causal, sm_scale, q.shape[-1])
    block_sparse_attention_bwd_dq.launches += 1
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
    _, cols = _indices(layout, causal, dev)
    q, k, v, dout, lse, delta = _bwd_operands(q, k, v, out, lse, dout, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    _launch(_entries()[2], "block_sparse_attention_bwd_dkv",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), cols.idx.data_ptr(),
             cols.cnt.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            q, block, cols, causal, sm_scale, 2 * q.shape[-1])
    block_sparse_attention_bwd_dkv.launches += 1
    return dk, dv


block_sparse_attention_fwd.launches = 0
block_sparse_attention_bwd_dq.launches = 0
block_sparse_attention_bwd_dkv.launches = 0


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
    layout = _causal_layout(layout, causal)
    # building the lists holds the JAX package's check (no empty row or
    # column) on every device; the kernels' wrappers find them cached
    _indices(layout, causal, q.device)
    return _SparseAttention.apply(q, k, v, layout, block, bool(causal),
                                  float(sm_scale))
