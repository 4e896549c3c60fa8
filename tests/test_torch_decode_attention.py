"""Decode attention (kernel K4) of the PyTorch port against the JAX package.

The port's plain version (``decode_attention_plain``, which the wrapper
runs for CPU tensors) is held against the JAX Pallas kernel run as the
JAX package's own tests run it (``interpret=True``), on numpy-seeded
inputs: GQA groups, left-padding holes in the key mask, a cache index in
the middle of a block, a cache length that is no multiple of the block, a
sliding window, an int8 cache with its scales, and a row that sees no
key.

Tolerance: fp32 throughout; the Pallas kernel runs an online softmax
block by block, the port a direct softmax, so the two differ by summation
order only: a few fp32 ulps of values of order one, inside 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.layers import _quantize_kv as jax_quantize_kv
from deepspeed_tpu.ops.pallas.decode_attention import \
    decode_attention as jax_decode
from deepspeed_tpu_torch.ops.decode_attention import (_check_kernel_args,
                                                      decode_attention,
                                                      decode_attention_plain,
                                                      decode_splits)
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    # name: (B, H, Hkv, S, D, cache_index, window, int8, block_k)
    "mha": (2, 4, 4, 64, 16, 40, None, False, 16),
    "gqa4_mid_block": (2, 8, 2, 64, 16, 37, None, False, 16),
    "gqa8_uneven_s": (3, 8, 1, 50, 32, 49, None, False, 16),
    "first_position": (2, 4, 2, 40, 16, 0, None, False, 16),
    "window": (2, 8, 2, 96, 16, 80, 24, False, 32),
    "window_past_start": (2, 4, 2, 48, 16, 10, 24, False, 16),
    "int8_cache": (2, 8, 2, 64, 16, 45, None, True, 16),
    "int8_window_uneven": (2, 4, 1, 70, 16, 66, 20, True, 32),
    # Phi-2's, GPT-NeoX-20B's and GPT-J-6B's / Gemma's head dims
    "d80": (2, 2, 1, 64, 80, 40, None, False, 16),
    "d96_window": (2, 4, 2, 96, 96, 80, 24, False, 32),
    "d256": (1, 2, 2, 70, 256, 66, None, False, 16),
    "d256_int8_gqa8": (1, 8, 1, 64, 256, 37, None, True, 16),
    # groups of 16 and 71 (Falcon-7B) on one kv head
    "g16_one_kv_head": (2, 16, 1, 64, 64, 45, None, False, 16),
    "g71_one_kv_head": (1, 71, 1, 50, 64, 49, None, False, 16),
    "g71_one_kv_head_int8": (1, 71, 1, 64, 64, 30, 24, True, 32),
}


def _inputs(B, H, Hkv, S, D, int8, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, D).astype(np.float32)
    k = rs.randn(B, Hkv, S, D).astype(np.float32)
    v = rs.randn(B, Hkv, S, D).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    for b in range(B):
        mask[b, :rs.randint(0, 6)] = 0       # left padding
    mask[0, 3] = 0                           # a hole inside the prompt
    scales = {}
    if int8:
        kq, ks = jax_quantize_kv(jnp.asarray(k))
        vq, vs = jax_quantize_kv(jnp.asarray(v))
        k, v = np.array(kq), np.array(vq)
        scales = {"k_scale": np.array(ks), "v_scale": np.array(vs)}
    return q, k, v, mask, scales


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_kernel(case):
    B, H, Hkv, S, D, cidx, window, int8, bk = CASES[case]
    q, k, v, mask, scales = _inputs(B, H, Hkv, S, D, int8, seed=len(case))
    if cidx == 0:
        mask[0, 0] = 0      # row 0 sees no key at all: zeros
    want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), cidx,
                      key_mask=jnp.asarray(mask), block_k=bk,
                      interpret=True, window=window,
                      **{n: jnp.asarray(s) for n, s in scales.items()})
    t = {n: torch.from_numpy(s) for n, s in scales.items()}
    before = decode_attention.launches
    got = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), cidx,
                           key_mask=torch.from_numpy(mask), window=window,
                           **t)
    assert decode_attention.launches == before, "CPU tensors run no kernel"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(cidx, dtype=torch.int32),
        key_mask=torch.from_numpy(mask), window=window, **t)
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    if cidx == 0:
        assert not got[0].abs().sum(), "a row that sees no key is zeros"


def test_masked_values_never_reach_the_output():
    """Non-finite K/V under the mask or past the filled prefix leave the
    output unchanged (masked V is skipped, not weighted by 0)."""
    q, k, v, mask, _ = _inputs(2, 4, 2, 32, 16, False, seed=3)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    clean = decode_attention_plain(*args, 20, key_mask=torch.from_numpy(mask))
    k2, v2 = args[1].clone(), args[2].clone()
    for t in (k2, v2):
        t[:, :, 21:] = float("nan")
        t[0, :, 3] = float("inf")            # mask[0, 3] == 0
    got = decode_attention_plain(args[0], k2, v2, 20,
                                 key_mask=torch.from_numpy(mask))
    torch.testing.assert_close(got, clean, rtol=0, atol=0)


def test_bf16_rounds_like_the_fp32_result():
    q, k, v, mask, _ = _inputs(2, 8, 2, 40, 32, False, seed=4)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    ref = decode_attention_plain(*args, 33, key_mask=torch.from_numpy(mask))
    got = decode_attention_plain(*(a.bfloat16() for a in args), 33,
                                 key_mask=torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    # bf16 inputs (rel. error 2**-9 each) through a softmax of order-one
    # logits: a few bf16 ulps
    torch.testing.assert_close(got.float(), ref, rtol=3e-2, atol=3e-2)


def test_wrapper_raises_instead_of_falling_back():
    q, k, v, _, _ = _inputs(1, 4, 2, 16, 16, False, seed=5)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="not on meta"):
        decode_attention(*(a.to("meta") for a in args), 3)
    with pytest.raises(ValueError, match="every tensor must be on"):
        decode_attention(args[0], args[1].to("meta"), args[2], 3)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        decode_attention(*args, 3, k_scale=torch.zeros(1, 2, 16))
    # what a CUDA tensor may hand K4 (the device check bypassed): head
    # dims 64, 80, 96, 128 and 256, any whole group, bf16, fp32, int8
    mask = torch.ones(1, 8, dtype=torch.int32)
    for D in (64, 80, 96, 128, 256):
        for H, Hkv in ((2, 2), (8, 1), (16, 1), (71, 1), (142, 2)):
            for dtype in (torch.bfloat16, torch.float32):
                qq = torch.zeros(1, H, D, dtype=dtype)
                kv = torch.zeros(1, Hkv, 8, D, dtype=dtype)
                _check_kernel_args(qq, kv, kv, None, None, mask, None)
                sc = torch.ones(1, Hkv, 8)
                kv8 = kv.to(torch.int8)
                _check_kernel_args(qq, kv8, kv8, sc, sc, mask, None)
    kv = torch.zeros(1, 2, 8, 80)
    with pytest.raises(ValueError, match="must be whole"):
        _check_kernel_args(torch.zeros(1, 3, 80), kv, kv, None, None, mask,
                           None)
    for D in (32, 72, 112, 192):
        kv = torch.zeros(1, 1, 8, D)
        with pytest.raises(ValueError, match="head_dim"):
            _check_kernel_args(torch.zeros(1, 2, D), kv, kv, None, None,
                               mask, None)


def test_paged_and_sparse_kernels_name_their_queue_step():
    """K9 takes its JAX kernels' domain as far as the tensor cores' tiles
    allow (head dims 64, 80, 96, 128, 256; every block that is a multiple
    of 16): outside it, it refuses before any kernel runs (the device
    check bypassed) with a message that says why and names no queue step,
    since none is left. K6 and K7 take their JAX kernels' whole domain
    (``tests/test_torch_paged_attention.py``)."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    x = torch.zeros(1, 128, 2, 256, dtype=torch.bfloat16)
    bsa._check_kernel_domain("block_sparse_attention_fwd", x, x, x, 16)
    x = torch.zeros(1, 128, 2, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim in") as err:
        bsa._check_kernel_domain("block_sparse_attention_fwd", x, x, x, 64)
    assert "Queue" not in str(err.value)
    x = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="m16n8k16") as err:
        bsa._check_kernel_domain("block_sparse_attention_fwd", x, x, x, 8)
    assert "Queue" not in str(err.value)


# ---------------------------------------------------------------------------
# the split-key walk of the CUDA kernel, emulated
# ---------------------------------------------------------------------------

TILE = 64               # keys of one kernel tile; a split is whole tiles
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.bfloat16().float()


def _emulate_split_decode(q, k, v, cidx, mask, window, per, slice_keys,
                          k_scale=None, v_scale=None, split_p=False):
    """The kernel's algorithm in fp32: the key axis cut into splits of
    ``per`` tiles; inside a split, state slices of ``slice_keys`` keys of
    every tile (64: the CUDA-core kernel's one running state, and the
    multi-tile tensor-core kernel's, whose warps each take one m16 tile of
    a group of more than 16 heads over all 64 keys; 16: the single-tile
    tensor-core kernel's four warps) walk the split's visible tiles with a
    running max (log2 units), sum and accumulator; the slices merge at
    the end of the split, then the splits merge through their lse in
    order. ``split_p``: P.V takes bf16(P) + bf16(P - bf16(P)), as the
    tensor-core kernel does."""
    B, H, D = q.shape
    _, Hkv, S, _ = k.shape
    G = H // Hkv
    sl2 = D ** -0.5 * LOG2E
    tiles = -(-S // TILE)
    splits = -(-tiles // per)
    hi = min(cidx, S - 1)
    lo = max(0, cidx - window + 1) if window else 0
    kf, vf = k.float(), v.float()
    out = torch.zeros(B, H, D)

    for b in range(B):
        for kvh in range(Hkv):
            qg = q[b, kvh * G:(kvh + 1) * G].float()
            split_parts = []
            for s in range(splits):
                t0 = max(s * per, lo // TILE)
                t1 = min((s + 1) * per, hi // TILE + 1) if hi >= lo else 0
                if t0 >= t1:
                    continue                       # an empty partial
                slices = []
                for w0 in range(0, TILE, slice_keys):
                    m = torch.full((G,), -np.inf)
                    l, acc = torch.zeros(G), torch.zeros(G, D)
                    for t in range(t0, t1):
                        keys = torch.arange(t * TILE + w0,
                                            min(t * TILE + w0 + slice_keys,
                                                S))
                        if not len(keys):
                            continue
                        ok = (keys >= lo) & (keys <= hi) & (mask[b, keys] > 0)
                        if not ok.any():
                            continue               # the slice skips the tile
                        kk, vv = kf[b, kvh, keys], vf[b, kvh, keys]
                        sc = (qg @ kk.T)
                        if k_scale is not None:
                            sc = sc * k_scale[b, kvh, keys][None]
                            vv = vv * v_scale[b, kvh, keys][:, None]
                        sc = torch.where(ok[None], sc * sl2,
                                         torch.full_like(sc, -np.inf))
                        vv = torch.where(ok[:, None], vv, torch.zeros_like(vv))
                        m_new = torch.maximum(m, sc.amax(dim=1))
                        base = torch.where(torch.isinf(m_new),
                                           torch.zeros_like(m_new), m_new)
                        alpha = torch.exp2(m - base)
                        p = torch.exp2(sc - base[:, None])
                        l = l * alpha + p.sum(dim=1)
                        if split_p:
                            ph = _bf16(p)
                            pv = ph @ vv + _bf16(p - ph) @ vv
                        else:
                            pv = p @ vv
                        acc = acc * alpha[:, None] + pv
                        m = m_new
                    slices.append((m, l, acc))
                # the block's merge of its slices, row by row
                pm = torch.stack([sm for sm, _, _ in slices]).amax(dim=0)
                pl, pa = torch.zeros(G), torch.zeros(G, D)
                for sm, sl, sa in slices:
                    w = torch.where(torch.isinf(sm), torch.zeros_like(sm),
                                    torch.exp2(sm - torch.where(
                                        torch.isinf(pm), torch.zeros_like(pm),
                                        pm)))
                    pl, pa = pl + sl * w, pa + sa * w[:, None]
                split_parts.append((pm, pl, pa))
            # the merge kernel, split by split in order
            if split_parts:
                pm = torch.stack([sm for sm, _, _ in split_parts]).amax(dim=0)
                base = torch.where(torch.isinf(pm), torch.zeros_like(pm), pm)
                L, A = torch.zeros(G), torch.zeros(G, D)
                for sm, sl, sa in split_parts:
                    w = torch.where(torch.isinf(sm), torch.zeros_like(sm),
                                    torch.exp2(sm - base))
                    L, A = L + sl * w, A + sa * w[:, None]
                inv = torch.where(L == 0, torch.zeros_like(L), 1 / L)
                out[b, kvh * G:(kvh + 1) * G] = A * inv[:, None]
    return out


SPLIT_CASES = {
    # name: (cache_index, window, mask edit, int8[, (B, H, Hkv, D)])
    "cache_index_empties_splits": (100, None, None, False),
    "window_empties_splits": (300, 70, None, False),
    "masked_range_empties_splits": (300, None, (64, 192), False),
    "row_sees_no_key": (250, None, "row0", False),
    "int8_cache": (290, 100, (130, 140), True),
    # the new tile plans: D 256 (Q read from shared memory, one fp32
    # stage), D 80 and 96, and groups of more than 16 (the multi-tile
    # tensor-core kernel; the CUDA-core kernel's blocks of 8 heads)
    "d256_window": (300, 70, None, False, (2, 2, 1, 256)),
    "g71_d64_masked_range": (290, None, (130, 200), False, (1, 71, 1, 64)),
    "g24_d96_row_sees_no_key": (250, None, "row0", False, (2, 24, 1, 96)),
    "g16_d80_int8": (250, 100, (64, 80), True, (1, 16, 1, 80)),
}
SPLIT_PARAMS = [(case, per, kernel) for case in sorted(SPLIT_CASES)
                for per in ((1, 2, 3) if len(SPLIT_CASES[case]) == 4
                            else (2,))
                for kernel in ("cuda_core", "tensor_core")
                if not (SPLIT_CASES[case][3] and kernel == "tensor_core")]


@pytest.mark.parametrize("case,per,kernel", SPLIT_PARAMS)
def test_split_decode_merges_to_the_plain_version(case, per, kernel):
    """The split walk and its lse merge (splits of 1, 2 and 3 tiles of a
    5-tile cache) against the plain version and the JAX Pallas kernel
    (interpret mode), fp32 at 1e-5: splits emptied by the cache index, a
    window or an all-masked key range, a row that sees no key, an int8
    cache; and at head dims 80, 96 and 256 and groups of 16, 24 and 71 on
    one kv head. The tensor-core kernels' rounding points (bf16 inputs,
    P.V as bf16(P) + bf16(P - bf16(P))) stay inside K4's bf16 tolerance,
    2**-7 |plain| + 1e-3, with the single-tile kernel's four 16-key
    slices for a group of at most 16 and the multi-tile kernel's one
    64-key state for a larger one."""
    cidx, window, edit, int8 = SPLIT_CASES[case][:4]
    B, H, Hkv, D = (SPLIT_CASES[case] + ((2, 8, 2, 16),))[4]
    S = 5 * TILE - 7
    q, k, v, mask, scales = _inputs(B, H, Hkv, S, D, int8, seed=41)
    if edit == "row0":
        mask[0] = 0
    elif edit is not None:
        mask[:, edit[0]:edit[1]] = 0
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    t = {n: torch.from_numpy(s) for n, s in scales.items()}
    tmask = torch.from_numpy(mask)
    tc = kernel == "tensor_core"
    if tc:      # the kernel reads bf16 q, K and V
        tq, tk, tv = _bf16(tq), _bf16(tk), _bf16(tv)
    slice_keys = 16 if tc and H // Hkv <= 16 else TILE
    got = _emulate_split_decode(tq, tk, tv, cidx, tmask, window, per,
                                slice_keys, split_p=tc, **t)
    plain = decode_attention_plain(tq, tk, tv, cidx, key_mask=tmask,
                                   window=window, **t)
    if tc:
        torch.testing.assert_close(_bf16(got), _bf16(plain), rtol=2 ** -7,
                                   atol=1e-3)
    else:
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        want = jax_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          cidx, key_mask=jnp.asarray(mask), block_k=16,
                          interpret=True, window=window,
                          **{n: jnp.asarray(s) for n, s in scales.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    if edit == "row0":
        assert not got[0].abs().sum(), "a row that sees no key is zeros"


def test_split_count_comes_from_the_cache_capacity():
    """K4's split count depends on B, Hkv, S and the card's SM count only
    (never on cache_index): whole tiles per split, no split without a
    tile, and more than half the splits that two blocks an SM want."""
    assert decode_splits(8, 8, 576, 132) == 5      # 9 tiles, 2 a split
    assert decode_splits(8, 8, 8192, 132) == 5     # 128 tiles, 26 a split
    assert decode_splits(3, 2, 2048, 132) == 32    # a tile a split
    assert decode_splits(1, 1, 10, 132) == 1
    assert decode_splits(64, 8, 576, 132) == 1     # 512 blocks already
    for B, Hkv, S in ((8, 8, 576), (3, 3, 2048), (2, 2, 1000), (1, 8, 300)):
        splits = decode_splits(B, Hkv, S, 132)
        tiles = -(-S // TILE)
        per = -(-tiles // splits)
        assert (splits - 1) * per < tiles <= splits * per
        want = -(-2 * 132 // (B * Hkv))
        assert 2 * splits > min(want, tiles)
