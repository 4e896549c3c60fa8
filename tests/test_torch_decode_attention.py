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
from deepspeed_tpu_torch.ops.decode_attention import (decode_attention,
                                                      decode_attention_plain)

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
