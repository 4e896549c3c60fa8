"""Quantized-weight matmuls (kernels K5 and K8) of the PyTorch port against
the JAX package.

Quantization must be bit-identical: the port's codes equal the JAX
``quantize_linear_weight`` / ``quantize_weight_per_col`` codes exactly and
its scales are the same fp32 values, for int8 and int4 and several group
lengths, and the int4 packing and the group resolution agree. The plain
versions (``quant_matmul_plain``, ``int8_matmul_plain``, which the
wrappers run for CPU tensors) are held against the JAX Pallas kernels run
as the JAX package's own tests run them (``interpret=True``, small blocks
so the K loop and the ragged edges are exercised).

Tolerance: fp32 throughout. Both sides dequantize the same codes with the
same scales in fp32 and sum the same products in another order, so they
agree to a few fp32 ulps of the sum's magnitude: 1e-5 relative and
absolute at these K (<= 264) and unit-scale inputs. The emulation of the
decode kernel in bf16 is held to the card's bound: one bf16 ulp of the
plain result plus 1e-5 of the products' magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import int8_matmul as jax_i8
from deepspeed_tpu.ops.pallas import quant_matmul as jax_qm
from deepspeed_tpu_torch.ops import quant_matmul as qm
from torch_threads import one_torch_thread  # noqa: F401


def _w(K, N, seed):
    return np.random.RandomState(seed).randn(K, N).astype(np.float32)


@pytest.mark.parametrize("mode,group", [
    ("int8", 0), ("int8", 32), ("int8", 7), ("int4", 0), ("int4", 32),
    ("int4", 6), ("int4", 5)])
def test_codes_are_bit_identical_to_jax(mode, group):
    w = _w(96, 40, seed=1)
    # a few exact half-way points and a zero column: round half to even
    w[0, :3] = [0.5, -2.5, 3.5]
    w[:, 7] = 0.0
    jq, js = jax_qm.quantize_linear_weight(jnp.asarray(w), mode, group)
    tq, ts = qm.quantize_linear_weight(torch.from_numpy(w), mode, group)
    assert tq.dtype == (torch.uint8 if mode == "int4" else torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        qm.dequantize_linear_weight(tq, ts, mode).numpy(),
        np.asarray(jax_qm.dequantize_linear_weight(jq, js, mode)))


def test_per_column_codes_are_bit_identical_to_jax():
    w = _w(64, 48, seed=2)
    jq, js = jax_i8.quantize_weight_per_col(jnp.asarray(w))
    tq, ts = qm.quantize_weight_per_col(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int4_packing_and_group_resolution_match_jax():
    v = np.random.RandomState(3).randint(-8, 8, size=(10, 6))
    packed = qm.pack_int4(torch.from_numpy(v))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_qm.pack_int4(jnp.asarray(v))))
    np.testing.assert_array_equal(qm.unpack_int4(packed).numpy(), v)
    with pytest.raises(ValueError, match="even K"):
        qm.pack_int4(torch.zeros(3, 2, dtype=torch.int32))

    def group(fn, *args):
        try:
            return fn(*args)
        except ValueError as e:         # int4 on an odd (per-shard) K
            return str(e)

    for k in (2, 12, 96, 100, 264, 4096, 14336):
        for mode in qm.MODES:
            for g in (0, 1, 5, 6, 32, 64, 128, 1000):
                for shards in (1, 2, 4):
                    args = (k, mode, g, shards)
                    assert group(qm.effective_group_size, *args) == \
                        group(jax_qm.effective_group_size, *args), args


@pytest.mark.parametrize("mode,group,M,K,N", [
    ("int8", 0, 5, 96, 72), ("int8", 32, 9, 128, 64), ("int4", 64, 3, 128, 80),
    ("int4", 6, 8, 96, 40), ("int4", 0, 17, 200, 33)])
def test_plain_matches_jax_pallas_kernel(mode, group, M, K, N):
    x = np.random.RandomState(4).randn(M, K).astype(np.float32)
    codes, scale = jax_qm.quantize_linear_weight(jnp.asarray(_w(K, N, 5)),
                                                 mode, group)
    want = jax_qm.quant_matmul(jnp.asarray(x), codes, scale, mode,
                               block_k=32, block_n=32, interpret=True)
    tc, ts = torch.from_numpy(np.array(codes)), torch.from_numpy(
        np.array(scale))
    before = qm.quant_matmul.launches
    got = qm.quant_matmul(torch.from_numpy(x), tc, ts, mode)
    assert qm.quant_matmul.launches == before, "CPU tensors run no kernel"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), qm.quant_matmul_plain(torch.from_numpy(x), tc, ts,
                                           mode).numpy())


@pytest.mark.parametrize("M,K,N", [(4, 64, 48), (9, 100, 70)])
def test_int8_matmul_plain_matches_jax_pallas_kernel(M, K, N):
    x = np.random.RandomState(6).randn(M, K).astype(np.float32)
    codes, scale = jax_i8.quantize_weight_per_col(jnp.asarray(_w(K, N, 7)))
    want = jax_i8.int8_matmul(jnp.asarray(x), codes, scale, block_k=32,
                              block_n=32, interpret=True)
    before = qm.int8_matmul.launches
    got = qm.int8_matmul(torch.from_numpy(x),
                         torch.from_numpy(np.array(codes)),
                         torch.from_numpy(np.array(scale)))
    assert qm.int8_matmul.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bf16_plain_rounds_the_dequantized_weight_to_bf16():
    """In bf16 both versions multiply by the dequantized weight rounded to
    bf16 (the TPU kernel's cast before the MXU), not by its fp32 value."""
    x = torch.from_numpy(np.random.RandomState(8).randn(4, 64)).bfloat16()
    codes, scale = qm.quantize_linear_weight(torch.from_numpy(_w(64, 32, 9)),
                                             "int4", 16)
    w16 = qm.dequantize_linear_weight(codes, scale, "int4", torch.bfloat16)
    want = (x.float() @ w16.float()).bfloat16()
    got = qm.quant_matmul_plain(x, codes, scale, "int4")
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-3)


def test_wrappers_raise_instead_of_falling_back():
    x = torch.zeros(2, 64)
    codes, scale = qm.quantize_linear_weight(torch.ones(64, 16), "int4", 32)
    with pytest.raises(ValueError, match="not on meta"):
        qm.quant_matmul(x.to("meta"), codes.to("meta"), scale.to("meta"),
                        "int4")
    with pytest.raises(ValueError, match="every tensor must be on"):
        qm.quant_matmul(x, codes.to("meta"), scale, "int4")
    with pytest.raises(ValueError, match="codes"):
        qm.quant_matmul(x, codes, scale, "int8")      # uint8 codes as int8
    with pytest.raises(ValueError, match="quantize mode"):
        qm.quant_matmul(x, codes, scale, "int2")
    with pytest.raises(ValueError, match="not on meta"):
        qm.int8_matmul(x.to("meta"), torch.zeros(64, 16, dtype=torch.int8,
                                                 device="meta"),
                       torch.zeros(16, device="meta"))


def test_codes_of_a_transposed_weight_are_contiguous():
    """nn.Linear keeps ``[N, K]``: quantizing its ``weight.T`` must still
    give contiguous codes and scales (the kernel streams them as laid out;
    the wrapper refuses strided ones rather than copying a weight per
    call)."""
    w = torch.from_numpy(_w(48, 64, seed=10)).T            # [K, N] view
    for mode, group in (("int8", 0), ("int4", 0), ("int4", 16)):
        codes, scale = qm.quantize_linear_weight(w, mode, group)
        assert codes.is_contiguous() and scale.is_contiguous()
    codes, scale = qm.quantize_weight_per_col(w)
    assert codes.is_contiguous() and scale.is_contiguous()


#: Llama-3-8B's projections, (K, N): q and o, k and v, gate and up, down
LLAMA3_8B_PROJECTIONS = ((4096, 4096), (4096, 1024), (4096, 14336),
                         (14336, 4096))


def test_prefill_route_is_chosen_by_shape():
    """The kernel a call runs is a function of its shape alone: every
    Llama-3-8B projection's bf16 prefill takes the wgmma kernel, rows that
    TMA cannot address (N % 16 or K % 8 not 0) take the ragged kernel,
    M <= 8 the tensor-core GEMV and fp32 x the fp32 route (tensor cores
    on x split in two TF32 parts)."""
    for K, N in LLAMA3_8B_PROJECTIONS:
        for M in (9, 129, 512, 4096, 4097):
            assert qm.kernel_route(M, K, N, torch.bfloat16) == "wgmma"
            assert qm.kernel_route(M, K, N, torch.float32) == "fp32"
        for M in (1, 8):
            assert qm.kernel_route(M, K, N, torch.bfloat16) == "gemv_tc"
    assert qm.kernel_route(4096, 4096, 1000, torch.bfloat16) == "ragged"
    assert qm.kernel_route(37, 264, 1000, torch.bfloat16) == "ragged"
    assert qm.kernel_route(300, 260, 1024, torch.bfloat16) == "ragged"
    assert qm.kernel_route(129, 264, 1024, torch.bfloat16) == "wgmma"


def _kernel_dequantized_weight(codes, scale, mode, K):
    """The wgmma kernel's dequantization, emulated: K tiles of 64 rows;
    lane l of a warp takes a column pair (n, n + 1) and, in every tile,
    the K rows 2 q + 16 j + 8 h (+ 1) for q = l % 4, j < 4, h < 2, in that
    order, so all threads with the same q walk the same rows (emulated
    together over the columns). A thread reloads its two scales only when
    a row leaves the group it holds (int4: once per row pair), and rounds
    code x scale (fp32) to bf16; rows past K hold zero codes."""
    N = codes.shape[1]
    int4 = mode == "int4"
    vals = qm.unpack_int4(codes) if int4 else codes
    col = mode == "int8_col"
    g = K // (1 if col else scale.shape[0])
    tiles = -(-K // 64)
    out = torch.empty(tiles * 64, N, dtype=torch.bfloat16)
    for q in range(4):
        sc, sc_end = torch.zeros(N), 0
        for kt in range(tiles):
            for j in range(4):
                for h in range(2):
                    k = kt * 64 + 2 * q + 16 * j + 8 * h
                    for kk in (k, k + 1):
                        if not col and kk < K and kk >= sc_end \
                                and (kk == k or not int4):
                            sc, sc_end = scale[kk // g], (kk // g + 1) * g
                        code = vals[kk].float() if kk < K else torch.zeros(N)
                        out[kk] = (code if col else code * sc).bfloat16()
    return out[:K]


@pytest.mark.parametrize("mode,group,K,N", [
    ("int8", 64, 264, 320),      # groups of 44 cut the 64-row tiles
    ("int4", 8, 264, 144),       # 33 groups of 8; K ends 8 rows into a tile
    ("int4", 64, 256, 256),
    ("int8", 0, 200, 160),       # per-column scales
    ("int8_col", 0, 136, 144)])  # K8: codes only, the scale in the epilogue
def test_dequantized_tiles_match_dequantize_linear_weight(mode, group, K, N):
    """The kernel's per-K-tile dequantization is bit-identical to
    ``dequantize_linear_weight`` in bf16, which the plain version
    multiplies by, for groups that cut a tile and per-column scales."""
    w = torch.from_numpy(_w(K, N, seed=12))
    if mode == "int8_col":
        codes, col_scale = qm.quantize_weight_per_col(w)
        want = codes.to(torch.bfloat16)
        got = _kernel_dequantized_weight(codes, col_scale, mode, K)
    else:
        codes, scale = qm.quantize_linear_weight(w, mode, group)
        want = qm.dequantize_linear_weight(codes, scale, mode,
                                           torch.bfloat16)
        got = _kernel_dequantized_weight(codes, scale, mode, K)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the gemv_tc decode kernel (M <= 8, bf16 x), emulated
# ---------------------------------------------------------------------------

def _gt_chunk(g, int4):
    """The 16-column chunk of a 128-column tile that lane group g reads
    (the kernel's gt_chunk: int4 pairs chunks 0 and 4, 1 and 5, ...)."""
    return (g >> 1) | ((g & 1) << 2) if int4 else g


def _emulate_gemv_tc(x, codes, scale, mode, cluster, bf16=True):
    """``gemv_tc_kernel`` in torch, for ``x [M <= 8, K]``. Returns the
    product ``[M, N]`` and the weight ``[K, N]`` as the lanes assemble it.

    Tiles of 128 W columns; K tiles of 128 rows, rank r of ``cluster``
    taking tiles ``r * nk // cluster`` to ``(r + 1) * nk // cluster``;
    codes and x past K (and columns past N) are TMA's zero fill. A code
    tile lands in shared memory 128B-swizzled (16-byte chunk c of row r at
    c ^ (r & 7)) and lane (g, q) of warp w reads its chunk back with the
    kernel's address: K rows 16 w + 2 q (+ 1, + 8, + 9) of the stage (int4:
    byte rows 8 w + q and 8 w + q + 4, low nibble first). Each weight is
    code x scale in fp32, rounded to bf16 (``bf16=False``: kept in fp32),
    with the scale of the step's group (per K row where groups cut a k16
    step). Warp w's products accumulate in fp32 over the rank's stages;
    the block adds its warps in order 0..7, the cluster its ranks in order
    0..C-1; K8's column scale and the rounding to x's type come last."""
    M, K = x.shape
    int4, col = mode == "int4", mode == "int8_col"
    N = codes.shape[1]
    gl = K if col else K // scale.shape[0]
    uniform = col or gl == K or gl % 16 == 0
    tiles, nk = -(-N // 128), -(-K // 128)
    crow = 64 if int4 else 128
    raw = torch.zeros(nk * crow, tiles * 128, dtype=torch.uint8)
    raw[:codes.shape[0], :N] = codes.view(torch.uint8)
    xp = torch.zeros(8, nk * 128, dtype=torch.float64)
    xp[:M, :K] = x.double()
    wdt = torch.bfloat16 if bf16 else torch.float32
    lane = torch.arange(32)
    g, q = lane // 4, lane % 4
    chunk = _gt_chunk(g, int4)
    cols = 16 * chunk[:, None] + torch.arange(16)                # [32, 16]
    y = torch.zeros(8, tiles * 128, dtype=torch.float32)
    weight = torch.full((nk * 128, tiles * 128), float("nan"))
    for t in range(tiles):
        n_glob = (t * 128 + cols).clamp(max=N - 1)
        ranks = []
        for r in range(cluster):
            acc = torch.zeros(8, 128, 8, dtype=torch.float32)  # warp, n, m
            for kt in range(r * nk // cluster, (r + 1) * nk // cluster):
                tile = raw[kt * crow:(kt + 1) * crow, t * 128:(t + 1) * 128]
                rr = torch.arange(crow)[:, None]
                smem = torch.empty(crow, 8, 16, dtype=torch.uint8)
                smem[rr, torch.arange(8)[None, :] ^ (rr & 7)] = \
                    tile.reshape(crow, 8, 16)
                for w in range(8):
                    k0 = kt * 128 + 16 * w
                    if int4:
                        br = torch.stack([8 * w + q, 8 * w + q + 4], 1)
                        b = smem[br, chunk[:, None] ^ (br & 7)].int()
                        # rows k, k + 1 (byte row 0), k + 8, k + 9 (row 1)
                        u = torch.stack([b[:, 0] & 15, b[:, 0] >> 4,
                                         b[:, 1] & 15, b[:, 1] >> 4], 1)
                        code = (u ^ 8) - 8
                    else:
                        rows = 16 * w + 2 * q[:, None] + \
                            torch.tensor([0, 1, 8, 9])
                        b = smem[rows, chunk[:, None] ^ (rows & 7)].int()
                        code = (b ^ 128) - 128
                    k = k0 + 2 * q[:, None] + torch.tensor([0, 1, 8, 9])
                    if col:
                        wv = code.float()
                    else:
                        grp = (k if not uniform else
                               torch.full_like(k, k0)).clamp(max=K - 1) // gl
                        sc = scale[grp[:, :, None], n_glob[:, None, :]]
                        wv = code.float() * sc
                    wv = wv.to(wdt)                               # [32, 4, 16]
                    step = torch.full((16, 128), float("nan"), dtype=wdt)
                    step[(k - k0)[:, :, None], cols[:, None, :]] = wv
                    assert not step.float().isnan().any(), "a hole"
                    weight[k0:k0 + 16, t * 128:(t + 1) * 128] = step.float()
                    acc[w] += (step.double().T @ xp[:, k0:k0 + 16].T).float()
            block = acc[0]
            for w in range(1, 8):
                block = block + acc[w]
            ranks.append(block)
        total = ranks[0]
        for r in range(1, cluster):
            total = total + ranks[r]
        y[:, t * 128:(t + 1) * 128] = total.T
    y = y[:M, :N]
    if col:
        y = y * scale[None, :]
    return y.to(x.dtype), weight[:K, :N]


#: (mode, group, M, K, N, cluster): K 264 ends 8 rows into a tile; int8
#: group 64 resolves to 44 at K 264 (groups cut the k16 steps); N 144 is
#: a tile and a ninth of one
GEMV_TC_CASES = [("int8", 0, 8, 264, 144, 3), ("int8", 64, 5, 264, 144, 2),
                 ("int4", 8, 1, 264, 144, 3), ("int4", 64, 8, 256, 256, 2),
                 ("int8_col", 0, 8, 136, 144, 2)]


def _quantized(mode, group, K, N, seed):
    w = torch.from_numpy(_w(K, N, seed))
    if mode == "int8_col":
        return qm.quantize_weight_per_col(w)
    return qm.quantize_linear_weight(w, mode, group)


def _plain(x, codes, scale, mode):
    if mode == "int8_col":
        return qm.int8_matmul_plain(x, codes, scale)
    return qm.quant_matmul_plain(x, codes, scale, mode)


@pytest.mark.parametrize("mode,group,M,K,N,cluster", GEMV_TC_CASES)
def test_gemv_tc_emulation_matches_plain_and_jax(mode, group, M, K, N,
                                                 cluster):
    """The decode kernel's arithmetic (which lane holds which column and K
    row, the K tiles of each cluster rank, the warp and rank sums in
    order) against the plain version and the JAX Pallas kernel
    (interpret mode): fp32 to 1e-5; in bf16 its lanes assemble exactly
    ``dequantize_linear_weight``'s bf16 weight, and the product lies
    within one bf16 ulp of the plain version plus 1e-5 of |x| @ |W|."""
    codes, scale = _quantized(mode, group, K, N, seed=13)
    x = np.random.RandomState(14).randn(M, K).astype(np.float32)
    got, _ = _emulate_gemv_tc(torch.from_numpy(x), codes, scale, mode,
                              cluster, bf16=False)
    plain = _plain(torch.from_numpy(x), codes, scale, mode)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)
    jc, js = jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy())
    if mode == "int8_col":
        want = jax_i8.int8_matmul(jnp.asarray(x), jc, js, block_k=32,
                                  block_n=32, interpret=True)
    else:
        want = jax_qm.quant_matmul(jnp.asarray(x), jc, js, mode, block_k=32,
                                   block_n=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    xb = torch.from_numpy(x).bfloat16()
    got, weight = _emulate_gemv_tc(xb, codes, scale, mode, cluster)
    wd = codes.to(torch.bfloat16) if mode == "int8_col" else \
        qm.dequantize_linear_weight(codes, scale, mode, torch.bfloat16)
    assert torch.equal(weight.bfloat16(), wd)
    plain = _plain(xb, codes, scale, mode).float()
    if mode == "int8_col":
        wd = (codes.float() * scale).bfloat16()
    bound = 2 ** -7 * plain.abs() + 1e-5 * (xb.float().abs() @
                                            wd.float().abs())
    assert bool(((got.float() - plain).abs() <= bound).all())


def _order_case(split):
    """Inputs whose fp32 sum depends on its order: three products 2**24,
    1, -2**24 in column 0, in K rows 0, 128, 256 (three K tiles: one per
    cluster rank, or one per stage of one rank) or, ``split=False``, in
    rows 0, 16, 32 (warps 0, 1, 2 of one stage). Added in that order the
    1 is lost (2**24 + 1 rounds to 2**24): the result is 0; in any other
    order it is 1 or -1."""
    rows = (0, 128, 256) if split else (0, 16, 32)
    K, N = 384 if split else 128, 128
    codes = torch.zeros(K, N, dtype=torch.int8)
    scale = torch.full((1, N), 2.0)
    x = torch.zeros(1, K)
    for r, c, v in zip(rows, (64, 1, -64), (2.0 ** 17, 0.5, 2.0 ** 17)):
        codes[r, 0], x[0, r] = c, v
    return x.bfloat16(), codes, scale


@pytest.mark.parametrize("split,cluster", [(True, 3), (True, 1),
                                           (False, 1)])
def test_gemv_tc_sums_ranks_warps_and_stages_in_order(split, cluster):
    """The kernel's sums run in a fixed order (ranks 0..C-1, warps 0..7,
    stages in K order): on inputs whose fp32 sum depends on the order, the
    emulation gives exactly the in-order result, 0, where a reordered or
    incomplete reduction gives 1, -1 or 2**24. (The card test
    ``test_gemv_tc_sums_in_a_fixed_order`` holds the kernel to the same
    inputs.)"""
    x, codes, scale = _order_case(split)
    got, _ = _emulate_gemv_tc(x, codes, scale, "int8", cluster)
    assert got[0, 0].item() == 0.0
    assert not got[0, 1:].any()


#: Llama-3-8B's projections, (K, N), and the expected gemv_tc grid
#: (column tiles, cluster size) for int8 / int4 codes on 132 and 114 SMs
GEMV_TC_GRIDS = {
    (4096, 4096): {132: ((32, 4), (32, 8)), 114: ((32, 3), (32, 7))},
    (4096, 1024): {132: ((8, 8), (8, 8)), 114: ((8, 8), (8, 8))},
    (4096, 14336): {132: ((112, 1), (112, 2)), 114: ((112, 1), (112, 2))},
    (14336, 4096): {132: ((32, 4), (32, 8)), 114: ((32, 3), (32, 7))},
}


def test_gemv_tc_route_and_split_for_every_llama3_8b_projection():
    """Every Llama-3-8B decode projection (M 1 and 8, bf16 x) takes the
    gemv_tc kernel; its cluster size comes from the card's SM count: at
    most 8, at most one rank per K tile of 128 rows, and the blocks of a
    launch within one wave (int8 one an SM, int4 two). fp32 x takes the
    fp32 decode kernel (gemv_tf32)."""
    assert set(GEMV_TC_GRIDS) == set(LLAMA3_8B_PROJECTIONS)
    for (K, N), by_sms in GEMV_TC_GRIDS.items():
        for M in (1, 8):
            assert qm.kernel_route(M, K, N, torch.bfloat16) == "gemv_tc"
            assert qm.kernel_route(M, K, N, torch.float32) == "gemv_tf32"
        for sms, (int8, int4) in by_sms.items():
            for mode, want in (("int8", int8), ("int8_col", int8),
                               ("int4", int4)):
                tiles, c = qm.gemv_tc_grid(K, N, mode, sms)
                assert (tiles, c) == want, (K, N, mode, sms)
                assert 1 <= c <= 8 and c <= -(-K // 128)
                assert tiles * c <= qm.GEMV_TC_BLOCKS_PER_SM[mode] * sms
    # ragged rows that TMA cannot address take the ragged kernel
    assert qm.kernel_route(8, 264, 1000, torch.bfloat16) == "ragged"
    assert qm.kernel_route(8, 264, 1024, torch.bfloat16) == "gemv_tc"
    assert qm.kernel_route(8, 260, 1024, torch.bfloat16) == "ragged"
    assert qm.gemv_tc_grid(256, 128, "int8", 132) == (1, 2)


# ---------------------------------------------------------------------------
# the ragged kernel (bf16 x whose rows TMA cannot address, any M), emulated
# ---------------------------------------------------------------------------

def _stage_windows(buf, starts, ends, width, unit):
    """The kernel's cp.async staging of rows: row i is copied as the
    ``width`` units from ``starts[i]`` rounded down to a 16-byte boundary
    (``unit`` units), in whole 16-byte copies that read only below
    ``ends[i]`` (zeros from there on). ``buf`` is a flat array of units."""
    a0 = starts - starts % unit
    idx = a0[:, None] + np.arange(width)[None, :]
    ok = idx < ends[:, None]
    out = np.zeros((len(starts), width), buf.dtype)
    out[ok] = buf[idx[ok]]
    return out


def _funnel_bytes(row, off, n):
    """The ``n`` code bytes (4 or 8) a lane reads at byte ``off`` of a
    staged row, as the kernel reads an unaligned window: the n / 4 + 1
    32-bit words from ``off`` rounded down to 4, one funnel shift by
    8 (off % 4) bits a word."""
    words = row.view(np.uint32).astype(np.uint64)
    w = words[off // 4:off // 4 + n // 4 + 1]
    bits = np.uint64(8 * (off % 4))
    out = [(((w[i + 1] << np.uint64(32)) | w[i]) >> bits)
           & np.uint64(0xFFFFFFFF) for i in range(n // 4)]
    return np.array(out, np.uint32).view(np.uint8)


def _emulate_ragged(x, codes, scale, mode, grid=None, sm_count=132,
                    bf16=True, reverse=()):
    """``ragged_kernel`` in torch, for any ``x [M, K]``. Returns the
    product ``[M, N]`` and the weight ``[K, N]`` as the lanes assemble it.

    ``grid`` (default ``ragged_grid`` at ``sm_count``) gives the row tile
    of ``8 mt`` rows, ``wn`` warps of ``ragged_warp_cols(mt)`` W columns
    along N (lane group g reading a ``2 * mi`` column chunk, mi = the
    warp's m16 tiles) and ``8 / wn`` along K, and the cluster size C: rank
    r takes the K axis's k16 steps
    ``r * n16 // C`` to ``(r + 1) * n16 // C`` in stages of ``8 / wn * ks``
    steps (ks = 2 for rows tiles of 32 and 64, else 1, as the kernel's
    ``rg_steps``), warp (wn, wk) steps ``wk * ks`` .. ``wk * ks + ks - 1``
    of each. A stage's code rows, x rows and scale rows (those of the
    rank's steps) are staged as the cp.async ring copies them (16-byte
    aligned windows read only up to each row's end: ``_stage_windows``)
    and read back at the row's offset in its window, ``(row * N) % 16``
    bytes for codes (three words and two funnel shifts), ``(m * K) % 8``
    elements for x, ``(group * N) % 4`` floats for staged scales. Each
    weight is code x scale in fp32, rounded to bf16 (``bf16=False``: kept
    in fp32); per-column scales and even groups of 8 rows or more come
    from the stage's staged rows (the pair's group), other groups per K
    row from the scale array. A warp's k16 products accumulate in fp32 in
    step order; the block adds its warps along K that had a step in order,
    the cluster its ranks in order 0..C-1 (``reverse`` may hold "warps"
    or "ranks" to add them backwards); K8's column scale and the rounding
    to x's type come last."""
    M, K = x.shape
    N = codes.shape[1]
    int4, col = mode == "int4", mode == "int8_col"
    mt, wn_count, col_tiles, row_tiles, C = grid or qm.ragged_grid(
        M, K, N, sm_count)
    wk_count = 8 // wn_count
    ks = 2 if mt >= 4 else 1
    per = wk_count * ks
    wc = qm.ragged_warp_cols(mt)
    lc = wc // 8                       # W columns of a lane
    bn, bk = wc * wn_count, 16 * per
    KR = codes.shape[0]
    G = 1 if col else scale.shape[0]
    gl = K // G
    staged = not col and (G == 1 or (gl % 2 == 0 and gl >= 8))
    cb = codes.contiguous().view(torch.uint8).numpy().reshape(-1)
    sv = scale.contiguous().float().numpy().reshape(-1)
    xv = x.double().numpy().reshape(-1)
    wdt = torch.bfloat16 if bf16 else torch.float32
    n16 = -(-K // 16)
    y = torch.zeros(row_tiles * 8 * mt, col_tiles * bn)
    weight = torch.full((n16 * 16, col_tiles * bn), float("nan"))
    kk = np.arange(16)
    for rt in range(row_tiles):
        m0 = rt * 8 * mt
        xr = m0 + np.arange(8 * mt)
        for ct in range(col_tiles):
            n0 = ct * bn
            ranks = []
            for r in range(C):
                st0, st1 = r * n16 // C, (r + 1) * n16 // C
                nwk = min(wk_count, -(-(st1 - st0) // ks))
                acc = torch.zeros(wk_count, 8 * mt, bn)
                for i in range(-(-(st1 - st0) // per)):
                    f = st0 + i * per
                    k0 = 16 * f
                    steps = min(per, st1 - f)
                    kr = (8 * f if int4 else k0) + np.arange(
                        8 * steps if int4 else 16 * steps)
                    cs = _stage_windows(cb, kr * N + n0,
                                        np.where(kr < KR, (kr + 1) * N, 0),
                                        bn + 16, 16)
                    xs = _stage_windows(xv, xr * K + k0,
                                        np.where(xr < M, (xr + 1) * K, 0),
                                        16 * steps + 8, 8)
                    if staged:
                        g0 = k0 // gl
                        last = (min(16 * (f + steps), K) - 1) // gl
                        assert last - g0 < bk // 8 + 2
                        gr = np.arange(g0, last + 1)
                        ss = _stage_windows(sv, gr * N + n0, (gr + 1) * N,
                                            bn + 4, 4)
                    for w, s_ in ((w, s_) for w in range(8)
                                  for s_ in range(ks)):
                        wn, wk = w % wn_count, w // wn_count
                        sl = wk * ks + s_          # the step's place
                        step = f + sl
                        if step >= st1:
                            continue
                        k = 16 * step + kk                   # K rows
                        # codes [16 K rows, wc columns], as the lanes read
                        code = np.zeros((16, wc), np.int64)
                        for j in range(16):
                            if int4:
                                rel = 8 * sl + j // 2
                            else:
                                rel = 16 * sl + j
                            krow = kr[rel]
                            sh = ((krow & 15) * (N & 15)) & 15
                            for lg in range(8):
                                b = _funnel_bytes(
                                    cs[rel], sh + wc * wn + lc * lg,
                                    lc).astype(np.int64)
                                if int4:
                                    b = (b >> (4 * (j % 2))) & 15
                                    b = (b ^ 8) - 8
                                else:
                                    b = (b ^ 128) - 128
                                code[j, lc * lg:lc * lg + lc] = b
                        code = torch.from_numpy(code).float()
                        cols = n0 + wc * wn + np.arange(wc)
                        if col:
                            sc = torch.ones(16, wc)
                        elif staged:
                            pair = np.minimum(k - k % 2, K - 1) // gl
                            rows = pair - g0
                            assert (rows < len(gr)).all()
                            off = ((pair & 3) * (N & 3)) & 3
                            sc = torch.from_numpy(ss[
                                rows[:, None],
                                off[:, None] + wc * wn + np.arange(wc)])
                        else:
                            grp = np.minimum(k, K - 1) // gl
                            sc = torch.from_numpy(sv[
                                grp[:, None] * N
                                + np.minimum(cols, N - 1)[None, :]])
                        wv = (code * sc.float()).to(wdt)     # [16, wc]
                        if rt == 0:
                            weight[k[0]:k[0] + 16, cols] = wv.float()
                        # x [8 mt rows, 16], at each row's window offset
                        sx = ((xr & 7) * (K & 7)) & 7
                        xt = torch.from_numpy(xs[
                            np.arange(8 * mt)[:, None],
                            (sx + 16 * sl)[:, None] + kk[None, :]])
                        if bf16:
                            xt = xt.float().bfloat16().double()
                        acc[wk, :, wc * wn:wc * wn + wc] += (
                            xt @ wv.double()).float()
                order = range(nwk)
                if "warps" in reverse:
                    order = reversed(order)
                block = None
                for wk in order:
                    block = acc[wk] if block is None else block + acc[wk]
                ranks.append(block)
            if "ranks" in reverse:
                ranks.reverse()
            total = ranks[0]
            for part in ranks[1:]:
                total = total + part
            y[m0:m0 + 8 * mt, n0:n0 + bn] = total
    y = y[:M, :N]
    if col:
        y = y * scale[None, :]
    return y.to(x.dtype), weight[:K, :N]


#: (mode, group, M, K, N): M from 1 to 130 (row tiles of 8, 64 and 3 x 64);
#: K 264 (17 k16 steps, 8 rows into the last) and odd K 131 (x rows on
#: 2-byte boundaries); N 1000 and N = 330 and 1002 (= 2 mod 4: every other
#: code row on a 2-byte boundary); int4 groups of 8, int8 groups of 44 (64
#: resolved at K 264) and per-column scales, K8's per-column mode
RAGGED_CASES = [("int8", 0, 1, 264, 1000), ("int4", 8, 5, 264, 1000),
                ("int8_col", 0, 8, 264, 1002), ("int8", 0, 37, 131, 1000),
                ("int4", 8, 37, 264, 330), ("int8", 64, 8, 264, 330),
                ("int8_col", 0, 130, 264, 1000), ("int4", 0, 130, 264, 1002),
                ("int8", 64, 16, 131, 330), ("int4", 8, 24, 264, 1000)]


@pytest.mark.parametrize("mode,group,M,K,N", RAGGED_CASES)
def test_ragged_emulation_matches_plain_and_jax(mode, group, M, K, N):
    """The ragged kernel's arithmetic (the staging windows and each row's
    shift, which lane holds which column and K row, the row tile, the
    stages of each warp and the K steps of each cluster rank, the warp and
    rank sums in order) against the plain version and the JAX Pallas
    kernel (interpret mode): in fp32 within 1e-5 of |x| @ |W| (the card's
    rule; sums of up to 264 products of magnitude ~1 differ by that in
    another order); in bf16 its lanes assemble exactly
    ``dequantize_linear_weight``'s bf16 weight, and the product lies
    within one bf16 ulp of the plain version plus 1e-5 of |x| @ |W|."""
    codes, scale = _quantized(mode, group, K, N, seed=23)
    x = np.random.RandomState(24).randn(M, K).astype(np.float32)
    xt = torch.from_numpy(x)
    got, _ = _emulate_ragged(xt, codes, scale, mode, bf16=False)
    bound = 1e-5 * (xt.abs() @ _dense(codes, scale, mode).abs())
    assert bool(((got - _plain(xt, codes, scale, mode)).abs()
                 <= bound).all())
    jc, js = jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy())
    if mode == "int8_col":
        want = jax_i8.int8_matmul(jnp.asarray(x), jc, js, block_k=128,
                                  block_n=256, interpret=True)
    else:
        want = jax_qm.quant_matmul(jnp.asarray(x), jc, js, mode,
                                   block_k=128, block_n=256, interpret=True)
    assert bool(((got - torch.from_numpy(np.array(want))).abs()
                 <= bound).all())

    xb = torch.from_numpy(x).bfloat16()
    got, weight = _emulate_ragged(xb, codes, scale, mode)
    wd = codes.to(torch.bfloat16) if mode == "int8_col" else \
        qm.dequantize_linear_weight(codes, scale, mode, torch.bfloat16)
    assert torch.equal(weight.bfloat16(), wd)
    plain = _plain(xb, codes, scale, mode).float()
    if mode == "int8_col":
        wd = (codes.float() * scale).bfloat16()
    bound = 2 ** -7 * plain.abs() + 1e-5 * (xb.float().abs() @
                                            wd.float().abs())
    assert bool(((got.float() - plain).abs() <= bound).all())


def ragged_order_case(rows, K, N=1000):
    """Inputs whose fp32 sum depends on its order: three products 2**24,
    1, -2**24 in column 0, at K ``rows``, int8 codes with per-column
    scales of 2. Added in that order the 1 is lost (2**24 + 1 rounds to
    2**24): the result is 0; in any other order it is 1 or -1."""
    codes = torch.zeros(K, N, dtype=torch.int8)
    scale = torch.full((1, N), 2.0)
    x = torch.zeros(1, K)
    for r, c, v in zip(rows, (64, 1, -64), (2.0 ** 17, 0.5, 2.0 ** 17)):
        codes[r, 0], x[0, r] = c, v
    return x.bfloat16(), codes, scale


#: (K rows of the three products, K, the grid (mt, wn, column tiles, row
#: tiles, cluster), the order that a mutation reverses): the first steps
#: of cluster ranks 0, 1, 2 (K 264, a cluster of 8: 17 steps cut 2, 2, 2,
#: ..., 3); warps 0, 1, 2 of one stage; the same with 64-row tiles, whose
#: warps take two steps each (steps 0, 2, 4); stages 0, 1, 2 of warp 0
RAGGED_ORDERS = {
    "ranks": ((0, 32, 64), 264, (1, 1, 16, 1, 8), "ranks"),
    "warps": ((0, 16, 32), 264, (1, 1, 16, 1, 1), "warps"),
    "warps_two_steps": ((0, 32, 64), 264, (8, 2, 8, 1, 1), "warps"),
    "stages": ((0, 128, 256), 384, (1, 1, 16, 1, 1), None),
}


@pytest.mark.parametrize("case", sorted(RAGGED_ORDERS))
def test_ragged_sums_ranks_warps_and_stages_in_order(case):
    """The ragged kernel's sums run in a fixed order (ranks 0..C-1, warps
    along K in order, each warp's stages in K order): on inputs whose fp32
    sum depends on the order, the emulation gives exactly the in-order
    result, 0, and the same inputs summed with the ranks or the warps
    reversed give 1 (the card test ``test_ragged_sums_in_a_fixed_order``
    holds the kernel to the same inputs)."""
    rows, K, grid, mutation = RAGGED_ORDERS[case]
    x, codes, scale = ragged_order_case(rows, K)
    got, _ = _emulate_ragged(x, codes, scale, "int8", grid=grid)
    assert got[0, 0].item() == 0.0
    assert not got[0, 1:].any()
    if mutation is not None:
        bad, _ = _emulate_ragged(x, codes, scale, "int8", grid=grid,
                                 reverse=(mutation,))
        assert bad[0, 0].item() != 0.0


def test_ragged_routes_and_grids_come_from_the_shapes():
    """bf16 rows that TMA cannot address take the ragged kernel at any M
    (fp32 x takes ``gemv_tf32`` at M <= 8 and ``fp32`` above); its grid is
    a function of the shape and the SM count: the row tile holds M in the
    fewest n8 tiles (at most 16), 64- and 128-row tiles are 256 W columns
    wide where such tiles still cover the SMs, else 128, and the cluster
    is the largest that keeps tiles x cluster within a wave (two blocks an
    SM up to 16 rows, one above), at most 8 and one rank per k16 step."""
    for M, K, N in ((8, 264, 1000), (1, 4100, 14330), (5, 263, 1024)):
        assert qm.kernel_route(M, K, N, torch.bfloat16) == "ragged"
        assert qm.kernel_route(M, K, N, torch.float32) == "gemv_tf32"
    for M, K, N in ((37, 264, 1000), (512, 4100, 14330), (9, 4096, 1000)):
        assert qm.kernel_route(M, K, N, torch.bfloat16) == "ragged"
        assert qm.kernel_route(M, K, N, torch.float32) == "fp32"
    assert qm.kernel_route(8, 264, 1000, torch.float32) == "gemv_tf32"
    grids = {
        # (M, K, N, SMs): (mt, wn, column tiles, row tiles, cluster)
        (8, 264, 1000, 132): (1, 1, 16, 1, 8),     # 128 blocks, not 8
        (37, 264, 1000, 132): (8, 2, 8, 1, 8),     # 64 rows, not 128
        (8, 4100, 14330, 132): (1, 1, 224, 1, 1),
        (512, 4100, 14330, 132): (16, 8, 56, 4, 1),
        (16, 264, 1000, 114): (2, 1, 16, 1, 8),
        (32, 264, 1000, 114): (4, 1, 16, 1, 7),
        (64, 4096, 1000, 132): (8, 2, 8, 1, 8),
        (300, 1024, 520, 132): (16, 4, 5, 3, 8),
        (4096, 4096, 1000, 132): (16, 4, 8, 32, 1),
        (8192, 4096, 1000, 132): (16, 8, 4, 64, 1),
        (1088, 4096, 1000, 132): (16, 4, 8, 9, 1),
        (1, 20, 1000, 132): (1, 1, 16, 1, 2),      # one rank per step
    }
    for (M, K, N, sms), want in grids.items():
        got = qm.ragged_grid(M, K, N, sms)
        assert got == want, (M, K, N, sms, got)
        mt, wn, ct, rt, c = got
        assert 8 * mt >= min(M, 128) and rt * 8 * mt >= M
        assert ct * qm.ragged_warp_cols(mt) * wn >= N
        assert 1 <= c <= min(8, -(-K // 16))
        assert c == 1 or ct * rt * c <= qm.RAGGED_BLOCKS_PER_SM[mt] * sms


# ---------------------------------------------------------------------------
# the fp32 route (fp32 x, M > 8): tensor cores on x split in two TF32 parts
# ---------------------------------------------------------------------------

def _tf32(x):
    """``cvt.rna.tf32.f32`` by bit masks: half a TF32 ulp added to the
    magnitude bits, the 13 low mantissa bits cleared (round to nearest,
    ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulate_fp32_tc(x, codes, scale, mode, splits, passes=2, order=None):
    """The fp32 route's arithmetic: x = hi + lo, both TF32; the codes
    exact; K cut into 64-row chunks, ``ceil(chunks / splits)`` a split; in
    a split, each scale group's fp32 sum of the products (hi, then lo)
    times the group's scales, added in K order; the splits' partials
    added in split order (``order`` permutes it), K8's column scale on the
    total. ``passes=1`` drops lo: one TF32 pass."""
    M, K = x.shape
    w = (qm.unpack_int4(codes) if mode == "int4" else codes).float()
    G = 1 if mode == "int8_col" else scale.shape[0]
    g = K // G
    hi = _tf32(x)
    lo = _tf32(x.float() - hi)
    chunks = -(-K // qm.FP32_CHUNK)
    per = -(-chunks // splits)
    parts = []
    for s in range(splits):
        k, k1 = s * per * qm.FP32_CHUNK, min(K, (s + 1) * per * qm.FP32_CHUNK)
        acc = torch.zeros(M, w.shape[1])
        while k < k1:
            gi = k // g
            ke = min(k1, (gi + 1) * g)
            gacc = hi[:, k:ke] @ w[k:ke]
            if passes == 2:
                gacc = gacc + lo[:, k:ke] @ w[k:ke]
            acc = acc + (gacc if mode == "int8_col" else gacc * scale[gi])
            k = ke
        parts.append(acc)
    if order is not None:
        parts = [parts[i] for i in order]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total * scale if mode == "int8_col" else total


def _dense(codes, scale, mode):
    if mode == "int8_col":
        return codes.float() * scale
    return qm.dequantize_linear_weight(codes, scale, mode)


FP32_CASES = [("int8", 128, 37, 512, 96), ("int4", 64, 20, 384, 72),
              ("int8_col", 0, 37, 264, 100), ("int8", 44, 9, 264, 50),
              ("int4", 6, 12, 96, 33)]


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("mode,group,M,K,N", FP32_CASES)
def test_fp32_route_emulation_meets_the_matmul_tolerance(mode, group, M, K,
                                                         N, splits):
    """The fp32 route's arithmetic (x split by TF32 rounding, exact codes,
    per-group scaling of the fp32 partials, splits summed in order)
    against the plain version and the JAX Pallas kernel (interpret mode)
    under the card's rule |kernel - plain| <= 1e-5 (|x| @ |W|): int8 in
    groups of 128, int4 in groups of 64, K8's per-column mode, groups of
    44 and 6 that straddle the kernel's 8-row steps, K not a multiple of
    the 64-row chunk and N not of the 128-column tile."""
    codes, scale = _quantized(mode, group, K, N, seed=17)
    x = torch.from_numpy(np.random.RandomState(18).randn(M, K)
                         .astype(np.float32))
    got = _emulate_fp32_tc(x, codes, scale, mode, splits)
    bound = 1e-5 * (x.abs() @ _dense(codes, scale, mode).abs())
    assert bool(((got - _plain(x, codes, scale, mode)).abs() <= bound).all())
    jc, js = jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy())
    if mode == "int8_col":
        want = jax_i8.int8_matmul(jnp.asarray(x.numpy()), jc, js, block_k=32,
                                  block_n=32, interpret=True)
    else:
        want = jax_qm.quant_matmul(jnp.asarray(x.numpy()), jc, js, mode,
                                   block_k=32, block_n=32, interpret=True)
    assert bool(((got - torch.from_numpy(np.array(want))).abs()
                 <= bound).all())


@pytest.mark.parametrize("mode,group,M,K,N", FP32_CASES[:3])
def test_one_tf32_pass_fails_the_matmul_tolerance(mode, group, M, K, N):
    """With x's lo part dropped (a single TF32 pass, about 11 bits of x)
    the same inputs break the 1e-5 rule that the two-part split meets: the
    lo term stays."""
    codes, scale = _quantized(mode, group, K, N, seed=17)
    x = torch.from_numpy(np.random.RandomState(18).randn(M, K)
                         .astype(np.float32))
    bound = 1e-5 * (x.abs() @ _dense(codes, scale, mode).abs())
    err = (_emulate_fp32_tc(x, codes, scale, mode, 1, passes=1)
           - _plain(x, codes, scale, mode)).abs()
    assert not bool((err <= bound).all())


def fp32_order_case(M, K, N, splits):
    """Inputs whose fp32 sum depends on the split order: int8 codes of 1,
    per-column scales of 1, and row 0 of x zero but for 2**25, -2**25 and
    1 at the first K row of splits 0, 1 and 2 (the route's cut: ``ceil(
    chunks / splits)`` 64-row chunks a split). Every split's sum is exact;
    summed in split order row 0 is exactly 1, in the reverse order 0
    (1 - 2**25 rounds to -2**25)."""
    per = -(-(-(-K // qm.FP32_CHUNK)) // splits) * qm.FP32_CHUNK
    x = torch.zeros(M, K)
    for s, v in enumerate((2.0 ** 25, -2.0 ** 25, 1.0)):
        x[0, s * per] = v
    return x, torch.ones(K, N, dtype=torch.int8), torch.ones(1, N)


def test_fp32_route_sums_splits_in_order():
    """On ``fp32_order_case`` (three splits of one chunk each) the route
    gives exactly 1 in row 0 and 0 elsewhere; the reversed split order
    gives 0 and fails. The card test
    ``test_fp32_route_sums_splits_in_order`` holds the kernel to the same
    inputs at its own split count."""
    x, codes, scale = fp32_order_case(9, 192, 8, 3)
    got = _emulate_fp32_tc(x, codes, scale, "int8", 3)
    assert torch.equal(got[0], torch.ones(8)) and not got[1:].any()
    rev = _emulate_fp32_tc(x, codes, scale, "int8", 3, order=[2, 1, 0])
    assert not torch.equal(rev[0], torch.ones(8))


def test_fp32_route_grid_comes_from_the_shapes():
    """The fp32 route's grid (column tiles, row tiles, K splits) at the
    card cases' shapes on 132 and 114 SMs: within two blocks an SM, each
    split at least 256 K rows, every split non-empty."""
    assert qm.kernel_route(300, 4096, 1024, torch.float32) == "fp32"
    assert qm.kernel_route(37, 264, 1000, torch.float32) == "fp32"
    assert qm.fp32_grid(300, 4096, 1024, 132) == (8, 5, 6)
    assert qm.fp32_grid(300, 4096, 1024, 114) == (8, 5, 5)
    assert qm.fp32_grid(37, 264, 1000, 132) == (8, 1, 1)
    assert qm.fp32_grid(16, 4096, 128, 132) == (1, 1, 16)
    for M, K, N, sm in ((300, 4096, 1024, 132), (37, 264, 1000, 114),
                        (4096, 4096, 4096, 132), (9, 14336, 4096, 132)):
        nt, mt, splits = qm.fp32_grid(M, K, N, sm)
        chunks = -(-K // qm.FP32_CHUNK)
        per = -(-chunks // splits)
        assert (splits - 1) * per < chunks <= splits * per
        assert splits == 1 or (nt * mt * splits <= 2 * sm
                               and per * qm.FP32_CHUNK >= 256)


# ---------------------------------------------------------------------------
# the fp32 decode kernel (fp32 x, M <= 8): gemv_tf32, emulated
# ---------------------------------------------------------------------------

def _gf_columns(int4):
    """``[8 tiles, 16 A rows]``: the W column (of a 128-column block) that
    n8 tile j's A row r holds. Lane group g's load L reads 8 columns at
    byte ``8 (g & 1)`` of 16-byte chunk ``gf_chunk(g, L)``; its column j
    is A row g (L = 0) or g + 8 (L = 1) of tile j."""
    g = torch.arange(8)
    if int4:
        chunk = [((((g >> 1) & 1) << 2) | (g >> 2)) + 2 * L for L in (0, 1)]
    else:
        chunk = [(g >> 1) + 4 * L for L in (0, 1)]
    base = [16 * c + 8 * (g & 1) for c in chunk]
    return torch.stack([torch.cat([base[0] + j, base[1] + j])
                        for j in range(8)])


#: warps of a gemv_tf32 block
GF_WARPS = 4


def gf_ranges(K, cluster):
    """``[[(first step, steps)] * GF_WARPS] * cluster``: the kernel's cut
    of the K axis's 8-row steps, rank r taking ``r * n8 // C`` to ``(r + 1)
    * n8 // C`` and its warp w the contiguous share ``w * n // W`` to
    ``(w + 1) * n // W`` of those."""
    n8 = -(-K // 8)
    out = []
    for r in range(cluster):
        s0, n = r * n8 // cluster, (r + 1) * n8 // cluster - r * n8 // cluster
        out.append([(s0 + w * n // GF_WARPS,
                     (w + 1) * n // GF_WARPS - w * n // GF_WARPS)
                    for w in range(GF_WARPS)])
    return out


def _emulate_gemv_tf32(x, codes, scale, mode, cluster, warp_order=None,
                       rank_order=None):
    """``gemv_tf32_kernel`` in torch for fp32 ``x [M <= 8, K]``.

    Blocks of 128 W columns; the K axis cut as :func:`gf_ranges`. In a
    step at K row k, lane (g, q) puts K rows k + 2q and k + 2q + 1 (int4:
    the low and high nibble of byte row k / 2 + q) of its columns into A
    columns q and q + 4 of each n8 tile (A rows from :func:`_gf_columns`),
    and x's rows g at those K rows, split x = hi + lo (both TF32 by
    ``cvt.rna``), into B; each tile runs ``A @ hi`` then ``A @ lo`` into
    its group sum (rounded to fp32 after each product). A group sum is
    multiplied by its scales and added to the warp's total when the next
    group opens (a step that a group boundary cuts runs once per group,
    other rows' codes zeroed). Warps are added in order 0..3 (or
    ``warp_order``), ranks 0..C-1 (or ``rank_order``); K8's column scale
    and nothing else follows. Returns ``[M, N]`` fp32."""
    M, K = x.shape
    int4, col = mode == "int4", mode == "int8_col"
    N = codes.shape[1]
    gl = K if col else K // scale.shape[0]
    tiles = -(-N // 128)
    n8 = -(-K // 8)
    # codes as the lanes read them, padded to whole steps and tiles
    if int4:
        b = torch.zeros(4 * n8, tiles * 128, dtype=torch.int32)
        b[:codes.shape[0], :N] = codes.int()
        w = torch.stack([((b & 15) ^ 8) - 8, ((b >> 4) ^ 8) - 8],
                        1).reshape(8 * n8, tiles * 128)
    else:
        w = torch.zeros(8 * n8, tiles * 128, dtype=torch.int32)
        w[:K, :N] = codes.int()
    w = w.double()
    xp = torch.zeros(8, 8 * n8)
    xp[:M, :K] = x.float()
    hi = _tf32(xp)
    lo = _tf32(xp - hi)
    sc = torch.ones(-(-K // gl), tiles * 128)
    if not col:
        sc[:, :N] = scale
    cols = _gf_columns(int4)                                  # [8, 16]
    assert sorted(cols.reshape(-1).tolist()) == list(range(128)), "a hole"
    q = torch.arange(4)
    y = torch.zeros(8, tiles * 128)
    for t in range(tiles):
        ct = t * 128 + cols                                   # [8, 16]
        ranks = []
        for rng in gf_ranges(K, cluster):
            warps = []
            for s0, n in rng:
                acc = torch.zeros(8, 16, 8)
                gacc = torch.zeros(8, 16, 8)
                cur, gend = -1, 0
                for step in range(s0, s0 + n):
                    k = 8 * step
                    kmap = torch.cat([k + 2 * q, k + 2 * q + 1])  # A columns
                    A = w[kmap][:, ct].permute(1, 2, 0)           # [8, 16, 8]
                    Bh, Bl = hi[:, kmap].T.double(), lo[:, kmap].T.double()
                    groups = sorted({int(min(r, K - 1)) // gl for r in
                                     kmap.tolist() if r < K} or {cur})
                    for gg in groups:
                        if gg != cur:
                            if cur >= 0:
                                acc = acc + gacc * sc[cur][ct][:, :, None]
                                gacc = torch.zeros_like(gacc)
                            cur, gend = gg, (gg + 1) * gl
                        keep = ((kmap.clamp(max=K - 1) // gl) == gg).double()
                        Am = A * keep
                        gacc = (gacc.double() + Am @ Bh).float()
                        gacc = (gacc.double() + Am @ Bl).float()
                if cur >= 0:
                    acc = acc + gacc * sc[cur][ct][:, :, None]
                warps.append(acc)
            order = warp_order or range(GF_WARPS)
            block = torch.zeros(8, 16, 8)
            for i in order:
                block = block + warps[i]
            ranks.append(block)
        total = torch.zeros(8, 16, 8)
        for i in rank_order or range(cluster):
            total = total + ranks[i]
        y[:, ct.reshape(-1)] = total.reshape(128, 8).T
    y = y[:M, :N]
    return y * scale[None, :] if col else y


#: (mode, group, M, K, N, cluster): aligned N (144: a tile and a ninth;
#: 256) and odd N (1001, 33), groups of 44 and 6 rows that a k8 step
#: straddles, K 263 off the steps, M 1 to 8
GEMV_TF32_CASES = [("int8", 0, 8, 264, 144, 3), ("int8", 44, 5, 264, 1001, 2),
                   ("int4", 64, 1, 256, 256, 2), ("int4", 6, 8, 96, 33, 1),
                   ("int8_col", 0, 3, 263, 144, 2),
                   ("int8_col", 0, 8, 264, 1001, 8),
                   ("int4", 8, 7, 264, 1001, 4)]


@pytest.mark.parametrize("mode,group,M,K,N,cluster", GEMV_TF32_CASES)
def test_gemv_tf32_emulation_matches_plain_and_jax(mode, group, M, K, N,
                                                   cluster):
    """The fp32 decode kernel's arithmetic (the lanes' column and K-row
    maps, x split in two TF32 parts, per-group scaling, warp and rank
    sums in order) against the plain version and the JAX Pallas kernel
    (interpret mode) under the card's rule |kernel - plain| <= 1e-5
    (|x| @ |W|), for int8, int4 and K8's per-column mode."""
    codes, scale = _quantized(mode, group, K, N, seed=23)
    x = torch.from_numpy(np.random.RandomState(24).randn(M, K)
                         .astype(np.float32))
    got = _emulate_gemv_tf32(x, codes, scale, mode, cluster)
    bound = 1e-5 * (x.abs() @ _dense(codes, scale, mode).abs())
    assert bool(((got - _plain(x, codes, scale, mode)).abs() <= bound).all())
    jc, js = jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy())
    if mode == "int8_col":
        want = jax_i8.int8_matmul(jnp.asarray(x.numpy()), jc, js, block_k=32,
                                  block_n=32, interpret=True)
    else:
        want = jax_qm.quant_matmul(jnp.asarray(x.numpy()), jc, js, mode,
                                   block_k=32, block_n=32, interpret=True)
    assert bool(((got - torch.from_numpy(np.array(want))).abs()
                 <= bound).all())


def gemv_tf32_order_case(K, cluster, across_ranks):
    """Inputs whose fp32 sum depends on the kernel's reduction order:
    int8 codes and per-column scales of 1, x zero but for 2**25, -2**25
    and 1 in row 0 at the first K row of ranks 0, 1, 2 (``across_ranks``)
    or of warps 0, 1, 2 of rank 0. Every warp's sum is exact; added in
    order row 0 is exactly 1, in the reverse order 0 (1 - 2**25 rounds to
    -2**25)."""
    ranges = gf_ranges(K, cluster)
    firsts = [ranges[i][0][0] for i in range(3)] if across_ranks else \
        [ranges[0][i][0] for i in range(3)]
    x = torch.zeros(2, K)
    for s, v in zip(firsts, (2.0 ** 25, -2.0 ** 25, 1.0)):
        x[0, 8 * s] = v
    return x, torch.ones(K, 128, dtype=torch.int8), torch.ones(1, 128)


@pytest.mark.parametrize("across_ranks,K,cluster", [(True, 384, 8),
                                                    (False, 1024, 8)])
def test_gemv_tf32_sums_warps_and_ranks_in_order(across_ranks, K, cluster):
    """On :func:`gemv_tf32_order_case` the emulation gives exactly 1 in
    row 0 and 0 elsewhere; with the ranks (or warps) added in reverse it
    gives 0, so a reordered reduction fails. The card test
    ``test_gemv_tf32_sums_in_a_fixed_order`` holds the kernel to the same
    inputs at its own cluster size (8 at N 128 and K 384, where the ranks
    take 6 steps each, or K 1024, where each warp of a rank takes 4)."""
    x, codes, scale = gemv_tf32_order_case(K, cluster, across_ranks)
    got = _emulate_gemv_tf32(x, codes, scale, "int8", cluster)
    assert torch.equal(got[0], torch.ones(128)) and not got[1].any()
    if across_ranks:
        rev = _emulate_gemv_tf32(x, codes, scale, "int8", cluster,
                                 rank_order=list(range(cluster))[::-1])
    else:
        rev = _emulate_gemv_tf32(x, codes, scale, "int8", cluster,
                                 warp_order=list(range(GF_WARPS))[::-1])
    assert not torch.equal(rev[0], torch.ones(128))


def test_gemv_tf32_grid_comes_from_the_shapes():
    """fp32 decodes (M <= 8) take ``gemv_tf32`` at any N; its cluster
    fills one wave of two blocks an SM, at most 8, at most one rank per
    8-row step: 8 at chip_smoke's 4096 -> 4096."""
    for M, K, N in ((8, 4096, 4096), (1, 264, 1001), (8, 263, 33)):
        assert qm.kernel_route(M, K, N, torch.float32) == "gemv_tf32"
    assert qm.gemv_tf32_grid(4096, 4096, 132) == (32, 8)
    assert qm.gemv_tf32_grid(4096, 14336, 132) == (112, 2)
    assert qm.gemv_tf32_grid(384, 128, 132) == (1, 8)
    assert qm.gemv_tf32_grid(16, 128, 132) == (1, 2)
    for K, N, sms in ((4096, 4096, 114), (264, 1001, 132)):
        tiles, c = qm.gemv_tf32_grid(K, N, sms)
        assert tiles * 128 >= N and 1 <= c <= min(8, -(-K // 8))
        assert c == 1 or tiles * c <= qm.GEMV_TF32_BLOCKS_PER_SM * sms
