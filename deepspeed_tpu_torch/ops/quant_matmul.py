"""Quantized-weight matmuls (kernels K5 and K8).

``quant_matmul(x, codes, scale, mode)`` is what ``models.layers.QuantLinear``
calls: ``y = x @ dequant(codes, scale)`` with int8 codes ``[K, N]`` or
int4 codes packed two to a byte along K (uint8 ``[K//2, N]``: byte ``r``
holds K-row ``2r`` in its low nibble and ``2r + 1`` in its high nibble),
and fp32 scales ``[G, N]``, one per ``K / G`` contiguous rows of each
output column. ``int8_matmul(x, codes, scale)`` is the per-column case
with the scale ``[N]`` applied once to the fp32 sum. The layouts are the
JAX package's, so codes and scales carry across unchanged.

On CUDA tensors the wrappers launch the hand-written Hopper kernels of
``csrc/quant_matmul.cu``; on CPU tensors they compute the same function
with ``quant_matmul_plain`` / ``int8_matmul_plain``. Any other placement
raises: there is no fallback from a kernel to a plain version.

The kernels replace ``deepspeed_tpu/ops/pallas/quant_matmul.py::_kernel``
(K5) and ``deepspeed_tpu/ops/pallas/int8_matmul.py::_kernel`` (K8). A
decode step's product (a few rows) is bound by the bytes of the codes; a
prefill's (thousands of rows) by operations. Which kernel a call runs is
a function of its shape alone (:func:`kernel_route`): bf16 prefills whose
rows TMA can address run the ``wgmma`` kernel, bf16 decodes the one-launch
``gemv_tc`` kernel (K split over a thread-block cluster sized from the
card's SM count, :func:`gemv_tc_grid`), bf16 rows TMA cannot address
(``K % 8`` or ``N % 16`` not 0) the one-launch ``ragged`` kernel at any M
(row tile from M, column tile and cluster from the shape and the SM count,
:func:`ragged_grid`), fp32 prefills the tensor cores on x split in two
TF32 parts (:func:`fp32_grid`) and fp32 decodes the one-launch
``gemv_tf32`` kernel, the same arithmetic in gemv_tc's arrangement (K split
over the warps and a cluster sized from the SM count,
:func:`gemv_tf32_grid`). The design note is at the top of the CUDA
source.
"""

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .decode_attention import _sm_count

#: weight-quantization modes; int4 packs two codes per byte along K
MODES = ("int8", "int4")

#: int4 per-output-column scales are lossy (~7% max weight error on
#: gaussian weights against ~2.5% grouped at 64); int8 per-column is
#: already at its rounding floor, so grouping defaults off there
DEFAULT_INT4_GROUP = 64

#: rows of x up to which the kernel streams the weights as a GEMV
GEMV_MAX_ROWS = 8


def kernel_route(M: int, K: int, N: int, dtype: torch.dtype) -> str:
    """The kernel ``quant_matmul`` / ``int8_matmul`` launch for ``x [M, K]``
    of ``dtype`` and ``N`` output columns, chosen by shape before any
    launch (the C entry applies the same rule):

    - ``"gemv_tc"``: bf16 ``x``, ``M <= 8`` (decode), and rows TMA can
      address (16-byte strides: ``K % 8 == 0``, ``N % 16 == 0``): one
      launch, K split over a thread-block cluster (:func:`gemv_tc_grid`);
    - ``"wgmma"``: bf16 ``x``, ``M > 8``, and rows TMA can address;
    - ``"ragged"``: bf16 ``x`` whose rows TMA cannot address, any ``M``:
      one launch of the ragged kernel (:func:`ragged_grid`);
    - ``"gemv_tf32"``: fp32 ``x``, ``M <= 8``: one launch on the tensor
      cores, the codes exact in TF32 and x split in two TF32 parts, K
      split over the warps and a thread-block cluster
      (:func:`gemv_tf32_grid`);
    - ``"fp32"``: fp32 ``x``, ``M > 8``: tensor-core tiles on x split in
      two TF32 parts, K split over blocks (:func:`fp32_splits`)."""
    decode = M <= GEMV_MAX_ROWS
    if dtype != torch.bfloat16:
        return "gemv_tf32" if decode else "fp32"
    if K % 8 == 0 and N % 16 == 0:
        return "gemv_tc" if decode else "wgmma"
    return "ragged"


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"quantize mode must be one of {MODES}, got {mode!r}")


def pack_int4(vals: torch.Tensor) -> torch.Tensor:
    """Pack int4 codes (range [-8, 7]) ``[K, N]`` -> uint8 ``[K//2, N]``:
    byte ``r`` = K-row ``2r`` in the low nibble, ``2r + 1`` in the high
    nibble. K must be even."""
    if vals.shape[0] % 2:
        raise ValueError(f"int4 packing needs an even K, got {vals.shape[0]}")
    v = vals.to(torch.int32) & 0xF
    return (v[0::2] | (v[1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 ``[K//2, N]`` -> int8 ``[K, N]``
    (sign-extended nibbles)."""
    w = packed.to(torch.int32)
    lo = ((w & 0xF) ^ 8) - 8
    hi = ((w >> 4) ^ 8) - 8
    K2, N = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * K2, N).to(torch.int8)


def effective_group_size(k: int, mode: str, group_size: int,
                         shards: int = 1) -> int:
    """The scale-group length used for a ``[K, N]`` weight: ``group_size``
    (0 = per-column, except int4, which defaults to
    :data:`DEFAULT_INT4_GROUP`) resolved against the per-shard K. Shared by
    ``inference/quant.py`` (which writes the scales) and
    ``models/layers.QuantLinear`` (whose buffer shapes must agree)."""
    if group_size <= 0:
        group_size = DEFAULT_INT4_GROUP if mode == "int4" else 0
    align = k // shards if shards > 1 and k % shards == 0 else k
    return resolve_group_size(align, mode, group_size)


def resolve_group_size(k: int, mode: str, group_size: int) -> int:
    """Scale-group length along K: ``group_size`` shrunk to the largest
    divisor of ``k`` at most that big (0 = one group over all of K, i.e.
    per-column scales). int4 groups are even, so a nibble pair never
    straddles a scale boundary."""
    if mode == "int4" and k % 2:
        raise ValueError(f"int4 quantization needs an even K, got {k}")
    g = k if group_size <= 0 else min(group_size, k)
    while k % g:
        g -= 1
    if mode == "int4" and g % 2:
        # K is even (checked above), so an even divisor >= 2 exists
        g = 2 if g == 1 else g - 1
        while k % g or g % 2:
            g -= 1
    return g


def quantize_linear_weight(w: torch.Tensor, mode: str = "int8",
                           group_size: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absmax-quantize a linear weight ``[K, N]`` (K = input features).

    Returns ``(codes, scale)``: int8 ``[K, N]`` (int8) or packed uint8
    ``[K//2, N]`` (int4), and fp32 scales ``[G, N]``, one per ``group``
    contiguous K rows of each output column (``group_size <= 0`` = one
    group = per-column). Symmetric ranges: ±127 (int8), ±7 (int4). The
    arithmetic is the JAX package's op for op (fp32 division, round half
    to even), so the codes are bit-identical."""
    _check_mode(mode)
    k, n = w.shape
    if mode == "int4" and k % 2:
        raise ValueError(f"int4 quantization needs an even K, got {k}")
    g = resolve_group_size(k, mode, group_size)
    qmax = 127.0 if mode == "int8" else 7.0
    # contiguous: a transposed view (nn.Linear's weight.T) must not hand
    # its strides on to the codes
    wg = w.float().contiguous().reshape(k // g, g, n)
    amax = wg.abs().amax(dim=1)
    scale = (amax / qmax).clamp_min(1e-12)                 # [G, N]
    q = torch.round(wg / scale[:, None, :]).clamp(-qmax, qmax).reshape(k, n)
    if mode == "int4":
        return pack_int4(q), scale
    return q.to(torch.int8), scale


def dequantize_linear_weight(q: torch.Tensor, scale: torch.Tensor, mode: str,
                             dtype=torch.float32) -> torch.Tensor:
    """Rebuild the dense ``[K, N]`` weight: codes times their group's
    scale in fp32, then cast to ``dtype``."""
    _check_mode(mode)
    codes = unpack_int4(q) if mode == "int4" else q
    k, n = codes.shape
    gcount = scale.shape[0]
    wg = codes.float().reshape(gcount, k // gcount, n)
    return (wg * scale[:, None, :].float()).reshape(k, n).to(dtype)


def quant_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                       scale: torch.Tensor, mode: str = "int8"
                       ) -> torch.Tensor:
    """Plain version of K5: dequantize to ``x.dtype``, then matmul
    (``[M, K] @ [K, N] -> [M, N]`` in ``x.dtype``)."""
    return x @ dequantize_linear_weight(codes, scale, mode, x.dtype)


def quantize_weight_per_col(w: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[K, N]`` float -> (int8 ``[K, N]``, fp32 scale ``[N]``) with
    absmax/127 per output column (K8's layout; no clip, as in the JAX
    package: the absmax element maps to exactly ±127)."""
    w32 = w.float().contiguous()
    scale = (w32.abs().amax(dim=0) / 127.0).clamp_min(1e-12)
    return torch.round(w32 / scale[None, :]).to(torch.int8), scale


def int8_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: ``x @ codes`` with the codes cast to
    ``x.dtype`` (exact for ±127), summed in fp32, times the per-column
    scale once at the end, cast to ``x.dtype``."""
    acc = x.float() @ codes.to(x.dtype).float()
    return (acc * scale[None, :].float()).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("quant_matmul").quant_matmul
    P, I = ctypes.c_void_p, ctypes.c_int
    # x codes scale out workspace | M K N G mode x_bf16 splits wn | stream
    fn.argtypes = [P] * 5 + [I] * 8 + [P]
    fn.restype = I
    return fn


#: kernel modes of the C entry
_KERNEL_MODE = {"int8": 0, "int4": 1, "int8_col": 2}


#: ``gemv_tc`` blocks the split aims for per SM: int8 codes stream fastest
#: one block an SM; int4 has twice the dequantization work a byte, and two
#: blocks an SM hide more of it (measured on the H100, PERF.md)
GEMV_TC_BLOCKS_PER_SM = {"int8": 1, "int8_col": 1, "int4": 2}
#: W columns of a ``gemv_tc`` column tile, K rows of one of its stages
GEMV_TC_COLS = GEMV_TC_ROWS = 128
#: the largest portable thread-block cluster (the ragged kernel's too)
GEMV_TC_MAX_CLUSTER = 8


def gemv_tc_grid(K: int, N: int, mode: str,
                 sm_count: int) -> Tuple[int, int]:
    """``(column tiles, cluster size)`` of the ``gemv_tc`` kernel: one
    block per 128 W columns and cluster rank, the ranks of a cluster
    sharing the K tiles of 128 rows (rank ``r`` of ``C`` takes tiles
    ``r * nk // C`` to ``(r + 1) * nk // C``). The cluster size is the
    largest that keeps ``tiles * C`` within
    :data:`GEMV_TC_BLOCKS_PER_SM` blocks an SM of ``sm_count`` (one wave),
    at most 8 and at most one rank per K tile; at least 1."""
    tiles = -(-N // GEMV_TC_COLS)
    k_tiles = -(-K // GEMV_TC_ROWS)
    fit = GEMV_TC_BLOCKS_PER_SM[mode] * sm_count // tiles
    return tiles, max(1, min(GEMV_TC_MAX_CLUSTER, k_tiles, fit))


#: ragged blocks the cluster aims for per SM, by n8 tiles of x rows: the
#: decode tiles fit two an SM (shared memory, registers), wider ones one
RAGGED_BLOCKS_PER_SM = {1: 2, 2: 2, 4: 1, 8: 1, 16: 1}


def ragged_warp_cols(mt: int) -> int:
    """W columns of one warp of the ragged kernel: 64, or 32 with 128-row
    tiles (its 128 accumulators then meet each weight it dequantizes 16
    times, not 8)."""
    return 32 if mt == 16 else 64


def ragged_grid(M: int, K: int, N: int, sm_count: int
                ) -> Tuple[int, int, int, int, int]:
    """``(mt, wn, column tiles, row tiles, cluster size)`` of the ragged
    kernel (the C entry derives ``mt`` from M the same way). A block takes
    ``8 * mt`` rows of x (mt = 1, 2, 4, 8 or 16: the fewest n8 tiles that
    hold M, at most 16) and ``wn`` warps of :func:`ragged_warp_cols` W
    columns along N, its other warps along K (8 warps). Tiles of up to 32
    rows take wn 1. Tiles of 64 and 128 rows take the widest wn (4 or 8
    for 128 rows, 2 or 4 for 64) whose 256 columns still give every SM a
    block, so that wide prefills read x and the codes fewer times from
    L2, else the narrower one (a stage of 8 warps along K would not fit
    the kernel's shared memory). The kernel derives the k16 steps a warp
    takes in a stage (2 with 32 rows or more, else 1) from mt. The
    cluster splits the K axis's 16-row steps: the largest size that keeps
    ``tiles * C`` within :data:`RAGGED_BLOCKS_PER_SM` blocks an SM of
    ``sm_count`` (one wave), at most 8 and at most one rank per step; at
    least 1."""
    mt = next(t for t in (1, 2, 4, 8, 16) if 8 * t >= M or t == 16)
    row_tiles = -(-M // (8 * mt))
    wn = 1
    if mt >= 8:
        wide = 256 // ragged_warp_cols(mt)
        wn = wide if -(-N // 256) * row_tiles >= sm_count else wide // 2
    col_tiles = -(-N // (ragged_warp_cols(mt) * wn))
    fit = RAGGED_BLOCKS_PER_SM[mt] * sm_count // (col_tiles * row_tiles)
    cluster = max(1, min(GEMV_TC_MAX_CLUSTER, -(-K // 16), fit))
    return mt, wn, col_tiles, row_tiles, cluster


#: the fp32 route's output tile (rows of x, columns of W) and K chunk
FP32_TILE_M, FP32_TILE_N, FP32_CHUNK = 64, 128, 64
#: fp32-route blocks the split aims for per SM
FP32_BLOCKS_PER_SM = 2


def fp32_splits(M: int, K: int, N: int, sm_count: int) -> int:
    """K-splits of the ``fp32`` route: K's 64-row chunks cut into the same
    whole number per split, so that tiles x splits stay within
    :data:`FP32_BLOCKS_PER_SM` blocks an SM of ``sm_count`` (one wave),
    each split at least 256 rows; at least 1. The kernel cuts K the same
    way (``ceil(chunks / splits)`` chunks a split) and
    ``finalize_kernel`` sums the splits' fp32 partials in split order."""
    tiles = -(-M // FP32_TILE_M) * -(-N // FP32_TILE_N)
    chunks = -(-K // FP32_CHUNK)
    want = max(1, min(chunks, FP32_BLOCKS_PER_SM * sm_count // tiles,
                      K // 256))
    per = -(-chunks // want)
    return -(-chunks // per)


def fp32_grid(M: int, K: int, N: int, sm_count: int) -> Tuple[int, int, int]:
    """The ``fp32`` route's grid: (column tiles, row tiles, K splits)."""
    return (-(-N // FP32_TILE_N), -(-M // FP32_TILE_M),
            fp32_splits(M, K, N, sm_count))


#: W columns of a ``gemv_tf32`` block
GEMV_TF32_COLS = 128
#: ``gemv_tf32`` blocks the cluster aims for per SM (a block's 4 warps'
#: rings take 64-96 KB of shared memory; two blocks of 4 warps an SM ran
#: int4 28% faster than one of 8 on the H100, PERF.md)
GEMV_TF32_BLOCKS_PER_SM = 2


def gemv_tf32_grid(K: int, N: int, sm_count: int) -> Tuple[int, int]:
    """``(column tiles, cluster size)`` of the ``gemv_tf32`` kernel: one
    block per 128 W columns and cluster rank, the ranks sharing the K
    axis's 8-row steps (rank ``r`` of ``C`` takes steps ``r * n8 // C`` to
    ``(r + 1) * n8 // C``, its 4 warps contiguous quarters of those). The
    cluster size is the largest that keeps ``tiles * C`` within
    :data:`GEMV_TF32_BLOCKS_PER_SM` blocks an SM of ``sm_count`` (one
    wave), at most 8 and at most one rank per step; at least 1."""
    tiles = -(-N // GEMV_TF32_COLS)
    fit = GEMV_TF32_BLOCKS_PER_SM * sm_count // tiles
    return tiles, max(1, min(GEMV_TC_MAX_CLUSTER, -(-K // 8), fit))


def _launch(name, x, codes, scale, mode, N, G, route):
    x = x.contiguous()
    if x.data_ptr() % 16:       # a view at an odd offset: vector loads
        x = x.clone()
    M, K = x.shape
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    sms = _sm_count(x.device.index)
    wn, work = 1, out
    if route == "gemv_tc":
        splits = gemv_tc_grid(K, N, mode, sms)[1]
    elif route == "ragged":
        _, wn, _, _, splits = ragged_grid(M, K, N, sms)
    elif route == "fp32":
        splits = fp32_splits(M, K, N, sms)
        if splits > 1:
            work = torch.empty((splits, M, N), dtype=torch.float32,
                               device=x.device)
    else:
        splits = gemv_tf32_grid(K, N, sms)[1]
    with torch.cuda.device(x.device):
        rc = _entry()(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                      out.data_ptr(), work.data_ptr(), M, K, N, G,
                      _KERNEL_MODE[mode], int(x.dtype == torch.bfloat16),
                      splits, wn,
                      torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
    return out


def _check(name, x, codes, scale):
    tensors = (x, codes, scale)
    dev = x.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on {dev}, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs its kernel on cuda and its plain "
                         f"version on cpu, not on {dev.type}")
    if x.dim() != 2 or codes.dim() != 2:
        raise ValueError(f"{name}: x must be [M, K] and the codes 2-D, got "
                         f"{tuple(x.shape)} and {tuple(codes.shape)}")
    if dev.type == "cuda":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name}: the kernel takes bf16 or fp32 x, got "
                             f"{x.dtype}")
        # a weight is never copied per call: strided codes are a caller bug
        if not (codes.is_contiguous() and scale.is_contiguous()) \
                or codes.data_ptr() % 16 or scale.data_ptr() % 16:
            raise ValueError(f"{name}: codes and scales must be contiguous "
                             f"and 16-byte aligned")
    return dev


def quant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 mode: str = "int8") -> torch.Tensor:
    """``x [M, K] @ dequant(codes, scale)`` in ``x.dtype`` (kernel K5; see
    the plain version). CUDA tensors launch the kernel on the current
    stream and add one to ``quant_matmul.launches`` (and to
    ``quant_matmul.wgmma_launches`` on the ``wgmma`` route,
    ``quant_matmul.gemv_tc_launches`` on ``gemv_tc``,
    ``quant_matmul.ragged_launches`` on ``ragged``,
    ``quant_matmul.gemv_tf32_launches`` on ``gemv_tf32``); CPU tensors
    take :func:`quant_matmul_plain`; anything else raises."""
    _check_mode(mode)
    dev = _check("quant_matmul", x, codes, scale)
    M, K = x.shape
    want = (K // 2 if mode == "int4" else K, scale.shape[-1])
    want_dtype = torch.uint8 if mode == "int4" else torch.int8
    if tuple(codes.shape) != want or codes.dtype != want_dtype \
            or (mode == "int4" and K % 2):
        raise ValueError(f"quant_matmul: {mode} codes for x {tuple(x.shape)} "
                         f"must be {want_dtype} {want}, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    G = scale.shape[0]
    if scale.dim() != 2 or scale.dtype != torch.float32 or G == 0 or K % G \
            or (mode == "int4" and (K // G) % 2):
        raise ValueError(f"quant_matmul: scales must be fp32 [G, N] with G "
                         f"dividing K = {K} into groups (even for int4), "
                         f"got {scale.dtype} {tuple(scale.shape)}")
    if dev.type == "cpu":
        return quant_matmul_plain(x, codes, scale, mode)
    route = kernel_route(M, K, scale.shape[1], x.dtype)
    out = _launch("quant_matmul", x, codes, scale, mode, scale.shape[1], G,
                  route)
    quant_matmul.launches += 1
    if route == "wgmma":
        quant_matmul.wgmma_launches += 1
    elif route == "gemv_tc":
        quant_matmul.gemv_tc_launches += 1
    elif route == "ragged":
        quant_matmul.ragged_launches += 1
    elif route == "gemv_tf32":
        quant_matmul.gemv_tf32_launches += 1
    return out


def int8_matmul(x: torch.Tensor, codes: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``(x [M, K] @ codes [K, N]) * scale [N]`` in ``x.dtype`` (kernel K8;
    see the plain version). CUDA tensors launch the kernel and add one to
    ``int8_matmul.launches`` (and ``int8_matmul.gemv_tc_launches`` on the
    ``gemv_tc`` route, ``int8_matmul.ragged_launches`` on ``ragged``,
    ``int8_matmul.gemv_tf32_launches`` on ``gemv_tf32``);
    CPU tensors take :func:`int8_matmul_plain`; anything else
    raises."""
    dev = _check("int8_matmul", x, codes, scale)
    if codes.dtype != torch.int8 or codes.shape[0] != x.shape[1] \
            or scale.dtype != torch.float32 \
            or tuple(scale.shape) != (codes.shape[1],):
        raise ValueError(f"int8_matmul: codes must be int8 [K, N] and the "
                         f"scale fp32 [N], got {codes.dtype} "
                         f"{tuple(codes.shape)}, {scale.dtype} "
                         f"{tuple(scale.shape)} for x {tuple(x.shape)}")
    if dev.type == "cpu":
        return int8_matmul_plain(x, codes, scale)
    route = kernel_route(*x.shape, codes.shape[1], x.dtype)
    out = _launch("int8_matmul", x, codes, scale, "int8_col",
                  codes.shape[1], 1, route)
    int8_matmul.launches += 1
    if route == "gemv_tc":
        int8_matmul.gemv_tc_launches += 1
    elif route == "ragged":
        int8_matmul.ragged_launches += 1
    elif route == "gemv_tf32":
        int8_matmul.gemv_tf32_launches += 1
    return out


#: launches of each wrapper, and of those the ones on the wgmma prefill,
#: on the gemv_tc decode kernel, on the ragged kernel and on the fp32
#: decode kernel
quant_matmul.launches = quant_matmul.wgmma_launches = 0
quant_matmul.gemv_tc_launches = quant_matmul.ragged_launches = 0
quant_matmul.gemv_tf32_launches = 0
int8_matmul.launches = int8_matmul.gemv_tc_launches = 0
int8_matmul.ragged_launches = int8_matmul.gemv_tf32_launches = 0
