"""Building blocks of the PyTorch port against their JAX counterparts.

Same numpy-seeded inputs through ``deepspeed_tpu.models.layers`` and
``deepspeed_tpu_torch.models.layers``: the packed paged append (pads and
sentinel targets dropped, never written; bf16 and int8 pools), RMSNorm,
rotary embeddings, int8 KV quantization, the multi-position logit
harvest, and the engine's sampling helpers. fp32 results agree to a few
ulps (``1e-6``); the int8 codes and every dropped/kept decision agree
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.engine import (_sample_logits as jax_sample,
                                            next_pow2 as jax_next_pow2)
from deepspeed_tpu.models import layers as jl
from deepspeed_tpu_torch.inference.engine import _sample_logits, next_pow2
from deepspeed_tpu_torch.models import layers as tl


def _packed_append_inputs(seed, int8):
    """A pool with random content and a packed batch whose tokens include
    padding (append_pos / token_rows -1), a row whose table ends in
    sentinel entries (its last tokens map to an unallocated page) and a
    position past the table width."""
    rs = np.random.RandomState(seed)
    N, Hkv, bs, D, R, nb, T = 12, 2, 4, 8, 3, 3, 11
    bt = np.full((R, nb), N, np.int32)
    bt[0] = [3, 7, 1]
    bt[1, :1] = [5]                      # pages 1.. are the sentinel
    bt[2] = [0, 9, 2]
    pos = np.array([[9, 10, 11, -1, 2, 3, 4, 5, 12, 0, -1]], np.int32)
    rows = np.array([[0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2]], np.int32)
    k = rs.randn(1, T, Hkv, D).astype(np.float32)
    v = rs.randn(1, T, Hkv, D).astype(np.float32)
    if int8:
        pool = {"k": rs.randint(-127, 128, (N, Hkv, bs, D)).astype(np.int8),
                "v": rs.randint(-127, 128, (N, Hkv, bs, D)).astype(np.int8),
                "k_scale": rs.rand(N, Hkv, bs).astype(np.float32),
                "v_scale": rs.rand(N, Hkv, bs).astype(np.float32)}
    else:
        pool = {"k": rs.randn(N, Hkv, bs, D).astype(np.float32),
                "v": rs.randn(N, Hkv, bs, D).astype(np.float32)}
    desc = dict(block_tables=bt, append_pos=pos,
                context_len=np.array([12, 6, 13], np.int32),
                chunk_start=np.array([9, 2, 12], np.int32),
                token_rows=rows, query_start=np.array([0, 4, 8], np.int32),
                query_len=np.array([3, 4, 1], np.int32))
    return pool, k, v, desc


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_packed_append_matches_jax_and_drops_pads_and_sentinels(int8):
    pool, k, v, desc = _packed_append_inputs(3, int8)
    jidx = jl.paged_cache_index(**desc)
    want = jax.device_get(jl.update_paged_kv_cache(
        {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(k),
        jnp.asarray(v), jidx))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tidx = tl.paged_cache_index(**desc)
    out = tl.update_paged_kv_cache(tpool, torch.from_numpy(k),
                                   torch.from_numpy(v), tidx)
    assert out is tpool, "the pool is updated in place"
    for name in pool:
        np.testing.assert_allclose(tpool[name].numpy(), want[name],
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # exactly the 6 real targets changed: pads, row 1's tokens on its
    # sentinel page and row 2's position past its table land nowhere
    changed = (tpool["k"].numpy() != pool["k"]).any(axis=(1, 3))
    written = {(int(b), int(o)) for b, o in zip(*np.nonzero(changed))}
    assert written == {(1, 1), (1, 2), (1, 3), (5, 2), (5, 3), (0, 0)}


def test_rmsnorm_matches_flax():
    from deepspeed_tpu.models.layers import RMSNorm as JRMSNorm

    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 32).astype(np.float32) * 3
    scale = rs.rand(32).astype(np.float32) + 0.5
    for dtype, tdtype, tol in ((jnp.float32, torch.float32, 1e-6),
                               (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = JRMSNorm(eps=1e-5).apply({"params": {"scale": scale}},
                                        jnp.asarray(x, dtype))
        norm = tl.RMSNorm(32, eps=1e-5).requires_grad_(False)
        norm.weight.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(tdtype))
        assert got.dtype == tdtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)


def test_rotary_matches_jax():
    rs = np.random.RandomState(1)
    pos = rs.randint(0, 2048, (1, 9)).astype(np.int32)
    x = rs.randn(1, 9, 4, 16).astype(np.float32)
    jc, js = jl.rotary_embedding(jnp.asarray(pos), 16, 500000.0)
    tc, ts = tl.rotary_embedding(torch.from_numpy(pos), 16, 500000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    want = jl.apply_rotary(jnp.asarray(x), jc, js)
    got = tl.apply_rotary(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                          torch.from_numpy(np.array(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # cos/sin are cast to the activation dtype, as the JAX model does
    assert tl.rotary_embedding(torch.from_numpy(pos), 16,
                               dtype=torch.bfloat16)[0].dtype == torch.bfloat16


def test_kv_quantization_matches_jax():
    x = np.random.RandomState(2).randn(3, 2, 5, 16).astype(np.float32)
    jq, js = jl._quantize_kv(jnp.asarray(x))
    tq, ts = tl._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(tl.dequantize_kv(tq, ts).numpy(),
                               np.asarray(jl.dequantize_kv(jq, js)),
                               rtol=1e-7)


def test_init_paged_kv_cache_layout():
    jp = jl.init_paged_kv_cache(6, 4, 2, 8, n_layers=3, dtype=jnp.int8)
    tp = tl.init_paged_kv_cache(6, 4, 2, 8, n_layers=3, dtype=torch.int8)
    assert {n: tuple(a.shape) for n, a in tp.items()} == \
        {n: a.shape for n, a in jp.items()}
    assert tp["k"].dtype == torch.int8 and tp["k_scale"].dtype == torch.float32
    assert tl.is_paged_index(tl.paged_cache_index(np.zeros((1, 2)),
                                                  np.zeros((1, 1)), [1]))
    assert not tl.is_paged_index(0)


def test_harvest_packed_logits_matches_jax():
    rs = np.random.RandomState(4)
    logits = rs.randn(1, 7, 11).astype(np.float32)
    logits[0, 2, 5] = np.nan               # row 1's token
    logits[0, 6, 0] = np.inf               # a padding position: ignored
    rows = np.array([[0, 1, 1, 2, -1, 0, -1]], np.int32)
    jlg, jbad = jl.harvest_packed_logits(jnp.asarray(logits), rows, 4)
    tlg, tbad = tl.harvest_packed_logits(torch.from_numpy(logits),
                                         torch.from_numpy(rows), 4)
    np.testing.assert_array_equal(tlg.numpy(), np.asarray(jlg))
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    assert tbad.tolist() == [False, True, False, False]


def test_sampling_helpers():
    logits = np.random.RandomState(5).randn(6, 50).astype(np.float32)
    greedy = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0), False,
                        1.0, 0, 1.0)
    np.testing.assert_array_equal(
        _sample_logits(torch.from_numpy(logits), None, False, 1.0, 0,
                       1.0).numpy(), np.asarray(greedy))
    g = torch.Generator().manual_seed(0)
    t = torch.from_numpy(logits)
    # top_k=1 and a tiny top_p both leave only the argmax to draw
    for k, p in ((1, 1.0), (0, 1e-6)):
        np.testing.assert_array_equal(
            _sample_logits(t, g, True, 0.7, k, p).numpy(), np.asarray(greedy))
    # top_k=3: every draw is one of the 3 largest logits
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    for _ in range(5):
        s = _sample_logits(t, g, True, 1.0, 3, 1.0).numpy()
        assert all(s[i] in top3[i] for i in range(6))
    assert [next_pow2(n) for n in (1, 2, 3, 64, 65)] == \
        [jax_next_pow2(n) for n in (1, 2, 3, 64, 65)]
