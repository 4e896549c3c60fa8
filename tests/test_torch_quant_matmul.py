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
absolute at these K (<= 200) and unit-scale inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import int8_matmul as jax_i8
from deepspeed_tpu.ops.pallas import quant_matmul as jax_qm
from deepspeed_tpu_torch.ops import quant_matmul as qm


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
    TMA cannot address (N % 16 or K % 8 not 0) take the mma.sync kernel,
    M <= 8 the GEMV and fp32 x the CUDA-core tiles."""
    for K, N in LLAMA3_8B_PROJECTIONS:
        for M in (9, 129, 512, 4096, 4097):
            assert qm.kernel_route(M, K, N, torch.bfloat16) == "wgmma"
            assert qm.kernel_route(M, K, N, torch.float32) == "fp32"
        for M in (1, 8):
            assert qm.kernel_route(M, K, N, torch.bfloat16) == "gemv"
    assert qm.kernel_route(4096, 4096, 1000, torch.bfloat16) == "mma"
    assert qm.kernel_route(37, 264, 1000, torch.bfloat16) == "mma"
    assert qm.kernel_route(300, 260, 1024, torch.bfloat16) == "mma"
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
