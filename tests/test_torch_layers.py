"""Building blocks of the PyTorch port against their JAX counterparts.

Same numpy-seeded inputs through ``deepspeed_tpu.models.layers`` and
``deepspeed_tpu_torch.models.layers``: the packed and the per-row paged
append (pads and sentinel targets dropped, never written; bf16 and int8
pools), the page copy of copy-on-write, the from-empty prefill attention,
RMSNorm,
rotary embeddings, int8 KV quantization, the multi-position logit
harvest, the contiguous cache's append, bias and cached attention, and
the engine's sampling helpers. fp32 results agree to a few
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
from torch_threads import one_torch_thread  # noqa: F401


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


def _compacting_append(pool, k, v, idx):
    """The append the fixed-shape one replaced: the tokens that land are
    compacted with ``nonzero`` (a host sync, a data-dependent shape) and
    only they are written."""
    N, Hkv, bs, D = pool["k"].shape
    pos = idx["append_pos"].reshape(-1).long()
    rows = idx["token_rows"].reshape(-1).long()
    tables = idx["block_tables"]
    R, nb = tables.shape
    blk, off = pos.clamp_min(0) // bs, pos.clamp_min(0) % bs
    bids = tables[rows.clamp(0, R - 1), blk.clamp_max(nb - 1)].long()
    valid = (pos >= 0) & (rows >= 0) & (blk < nb) & (bids >= 0) & (bids < N)
    tok = valid.nonzero().squeeze(1)
    k, v = k.reshape(-1, Hkv, D)[tok], v.reshape(-1, Hkv, D)[tok]
    if "k_scale" in pool:
        kq, ks = tl._quantize_kv(k)
        vq, vs = tl._quantize_kv(v)
        vals = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        vals = {"k": k, "v": v}
    for name, val in vals.items():
        pool[name][bids[tok], :, off[tok]] = val.to(pool[name].dtype)
    return pool


@pytest.mark.parametrize("case", ["mixed", "none_lands", "one_lands"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_fixed_shape_append_is_bit_identical_to_the_compacting_one(int8,
                                                                  case):
    """The fixed-shape append (every packed token written; those that must
    not land repeat the first landing token's write) leaves the pool bit
    for bit as the compacting append did, int8 codes and scales included:
    on the mixed batch (pads, sentinel table entries, a position past the
    table width), on a batch where no token lands (every entry then writes
    page 0, offset 0's own value back) and on one where only the last
    token lands."""
    pool, k, v, desc = _packed_append_inputs(5, int8)
    if case == "none_lands":
        desc["append_pos"] = np.where(desc["append_pos"] == 12, 13, -1)
    elif case == "one_lands":
        desc["append_pos"] = np.where(np.arange(11) == 9, 0, -1)[None]
    want = _compacting_append({n: torch.from_numpy(a.copy())
                               for n, a in pool.items()},
                              torch.from_numpy(k), torch.from_numpy(v),
                              tl.paged_cache_index(**desc))
    got = tl.update_paged_kv_cache({n: torch.from_numpy(a.copy())
                                    for n, a in pool.items()},
                                   torch.from_numpy(k), torch.from_numpy(v),
                                   tl.paged_cache_index(**desc))
    for name in pool:
        assert torch.equal(got[name], want[name]), name
    if case == "none_lands":
        for name in pool:
            assert np.array_equal(got[name].numpy(), pool[name]), name


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



def test_harvest_packed_logits_corrupt_flags_match_jax():
    """The corrupt_logits chaos flags: a flagged packed row is ``bad`` as
    in the JAX harvest (which NaNs the row's logits; the port leaves its
    logits as they are and flags the row)."""
    rs = np.random.RandomState(6)
    logits = rs.randn(1, 7, 11).astype(np.float32)
    logits[0, 2, 5] = np.nan               # row 1's token
    rows = np.array([[0, 1, 1, 2, -1, 0, -1]], np.int32)
    corrupt = np.array([0, 0, 1, 0], np.int32)
    jlg, jbad = jl.harvest_packed_logits(jnp.asarray(logits), rows, 4,
                                         corrupt=jnp.asarray(corrupt))
    tlg, tbad = tl.harvest_packed_logits(torch.from_numpy(logits.copy()),
                                         torch.from_numpy(rows), 4,
                                         corrupt=torch.from_numpy(corrupt))
    np.testing.assert_array_equal(tbad.numpy(), np.asarray(jbad))
    assert tbad.tolist() == [False, True, True, False]
    np.testing.assert_array_equal(tlg.numpy(), logits[0])

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


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("int8", [False, True])
def test_contiguous_cache_append_bias_and_attention_match_jax(window, int8):
    """The contiguous cache of dense generation: an append at a cache
    index (int8 quantized at append), the additive -1e9 cache bias with a
    left-padded key mask (a pad row that sees no key stays finite), and
    the plain cached attention of a prefill, against the JAX functions."""
    rs = np.random.RandomState(11)
    B, T, H, Hkv, S, D, start = 2, 5, 4, 2, 12, 8, 3
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, T, Hkv, D).astype(np.float32)
    v = rs.randn(B, T, Hkv, D).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[0, :start + 2] = 0              # row 0: the first two new tokens pad
    dtype = jnp.int8 if int8 else jnp.float32
    jcache = jl.update_kv_cache(
        jl.init_kv_cache(B, S, Hkv, D, dtype=dtype), jnp.asarray(k),
        jnp.asarray(v), start)
    tcache = tl.init_kv_cache(B, S, Hkv, D,
                              dtype=torch.int8 if int8 else torch.float32)
    tl.update_kv_cache(tcache, torch.from_numpy(k), torch.from_numpy(v),
                       torch.tensor(start, dtype=torch.int32))
    for name in tcache:
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    want_bias = jl.cache_attention_bias(T, S, start,
                                        key_mask=jnp.asarray(mask),
                                        window=window)
    got_bias = tl.cache_attention_bias(T, S, start, torch.from_numpy(mask),
                                       window)
    np.testing.assert_array_equal(got_bias.numpy(), np.asarray(want_bias))
    np.testing.assert_array_equal(
        tl.key_mask_to_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jl.key_mask_to_bias(jnp.asarray(mask))))
    want = jl.cached_attention_xla(jnp.asarray(q), jcache, start,
                                   key_mask=jnp.asarray(mask), window=window)
    got = tl.cached_attention(torch.from_numpy(q), tcache, start,
                              key_mask=torch.from_numpy(mask), window=window)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_per_row_append_matches_jax_and_drops_pads_and_sentinels(int8):
    """The two-program engine's append (no ``token_rows``: a token's row
    is its batch row): a prefill with right padding, a row whose table
    ends in sentinels, a position past the table width, an idle slot
    (sentinel row, position 0). int8 codes and scales are bit-identical
    to the JAX append's; exactly the real targets change."""
    rs = np.random.RandomState(4)
    N, Hkv, bs, D, B, nb, T = 12, 2, 4, 8, 4, 3, 6
    bt = np.full((B, nb), N, np.int32)
    bt[0] = [3, 7, 1]
    bt[1, :1] = [5]                      # pages 1.. are the sentinel
    bt[2] = [0, 9, 2]                    # row 3: an idle slot, all sentinel
    pos = np.array([[2, 3, 4, 5, -1, -1], [1, 2, 3, 4, 5, -1],
                    [10, 11, 12, -1, -1, -1], [0, -1, -1, -1, -1, -1]],
                   np.int32)
    k = rs.randn(B, T, Hkv, D).astype(np.float32)
    v = rs.randn(B, T, Hkv, D).astype(np.float32)
    if int8:
        pool = {"k": rs.randint(-127, 128, (N, Hkv, bs, D)).astype(np.int8),
                "v": rs.randint(-127, 128, (N, Hkv, bs, D)).astype(np.int8),
                "k_scale": rs.rand(N, Hkv, bs).astype(np.float32),
                "v_scale": rs.rand(N, Hkv, bs).astype(np.float32)}
    else:
        pool = {"k": rs.randn(N, Hkv, bs, D).astype(np.float32),
                "v": rs.randn(N, Hkv, bs, D).astype(np.float32)}
    desc = dict(block_tables=bt, append_pos=pos,
                context_len=np.array([6, 6, 13, 1], np.int32))
    want = jax.device_get(jl.update_paged_kv_cache(
        {n: jnp.asarray(a) for n, a in pool.items()}, jnp.asarray(k),
        jnp.asarray(v), jl.paged_cache_index(**desc)))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tidx = tl.paged_cache_index(**desc)
    assert tl.update_paged_kv_cache(tpool, torch.from_numpy(k),
                                    torch.from_numpy(v), tidx) is tpool
    assert "token_rows" not in tidx, "the caller's bundle is not rewritten"
    for name in pool:
        if int8:
            np.testing.assert_array_equal(tpool[name].numpy(), want[name],
                                          err_msg=name)
        else:
            np.testing.assert_allclose(tpool[name].numpy(), want[name],
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    changed = (tpool["k"].numpy() != pool["k"]).any(axis=(1, 3))
    written = {(int(b), int(o)) for b, o in zip(*np.nonzero(changed))}
    assert written == {(3, 2), (3, 3), (7, 0), (7, 1),      # row 0
                       (5, 1), (5, 2), (5, 3),              # row 1's page 0
                       (2, 2), (2, 3)}                      # row 2: 10, 11


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_copy_paged_blocks_matches_jax(int8):
    """``pool[:, dst] = pool[:, src]`` over every pool tensor with a layer
    axis, in place; every other page keeps its content."""
    rs = np.random.RandomState(6)
    L, N, Hkv, bs, D = 2, 6, 2, 4, 8
    if int8:
        pool = {"k": rs.randint(-127, 128, (L, N, Hkv, bs, D)).astype(np.int8),
                "v": rs.randint(-127, 128, (L, N, Hkv, bs, D)).astype(np.int8),
                "k_scale": rs.rand(L, N, Hkv, bs).astype(np.float32),
                "v_scale": rs.rand(L, N, Hkv, bs).astype(np.float32)}
    else:
        pool = {"k": rs.randn(L, N, Hkv, bs, D).astype(np.float32),
                "v": rs.randn(L, N, Hkv, bs, D).astype(np.float32)}
    want = jax.device_get(jl.copy_paged_blocks(
        {n: jnp.asarray(a) for n, a in pool.items()}, [4, 1], [0, 5]))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    assert tl.copy_paged_blocks(tpool, [4, 1], [0, 5]) is tpool
    for name in pool:
        np.testing.assert_array_equal(tpool[name].numpy(), want[name])
        np.testing.assert_array_equal(tpool[name][:, 0].numpy(),
                                      pool[name][:, 4])
        np.testing.assert_array_equal(tpool[name][:, [1, 2, 3, 4]].numpy(),
                                      pool[name][:, [1, 2, 3, 4]])


@pytest.mark.parametrize("window", [None, 5])
def test_from_empty_prefill_attention_matches_jax(window):
    """Both from-empty prefill attentions over fresh, un-repeated K/V with
    right padding (the serving prefill's key mask) against the JAX ones,
    at the real positions, 1e-5; the flash route also with the left
    padding of generate, where pad rows come back zero."""
    rs = np.random.RandomState(8)
    B, T, H, Hkv, D = 2, 16, 4, 2, 16
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, T, Hkv, D).astype(np.float32)
    v = rs.randn(B, T, Hkv, D).astype(np.float32)
    for mask in (np.array([[1] * 11 + [0] * 5, [1] * 16], np.int32),
                 np.array([[0] * 6 + [1] * 10, [1] * 16], np.int32)):
        real = mask.astype(bool)
        tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
        want = np.asarray(jl.flash_prefill_from_empty(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            key_mask=jnp.asarray(mask), window=window))
        got = tl.flash_prefill_from_empty(tq, tk, tv, key_mask=tm,
                                          window=window).numpy()
        np.testing.assert_allclose(got[real], want[real], rtol=1e-5,
                                   atol=1e-5)
        left = ~real & (np.cumsum(mask, axis=1) == 0)
        assert not got[left].any(), "a row that sees no key returns zeros"
        want = np.asarray(jl.dot_product_attention(
            jnp.asarray(q), jl.repeat_kv(jnp.asarray(k), H // Hkv),
            jl.repeat_kv(jnp.asarray(v), H // Hkv),
            bias=jl.key_mask_to_bias(jnp.asarray(mask)), causal=True,
            window=window))
        got = tl.masked_prefill_attention(tq, tk, tv, tm,
                                          window=window).numpy()
        np.testing.assert_allclose(got[real], want[real], rtol=1e-5,
                                   atol=1e-5)
    # no mask: every key is real
    np.testing.assert_allclose(
        tl.flash_prefill_from_empty(tq, tk, tv, window=window).numpy(),
        np.asarray(jl.flash_prefill_from_empty(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window)),
        rtol=1e-5, atol=1e-5)
