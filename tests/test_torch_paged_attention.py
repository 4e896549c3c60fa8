"""Paged decode and paged chunked-prefill attention of the PyTorch port
against the JAX package.

The port's plain versions (``paged_decode_attention_plain`` and
``paged_prefill_attention_plain``, which the wrappers run for CPU tensors)
are held against the JAX Pallas kernels run as the JAX package's own tests
run them (``interpret=True``), against the JAX XLA references, and against
the port's ``ragged_paged_attention_plain`` (the unified kernel's function,
which both split kernels must agree with row for row). Pools are built
through the JAX per-row append from numpy-seeded inputs: GQA and MHA,
ragged contexts with a partial last page, an idle sentinel row, a window,
an int8 pool, a padded chunk tail, and the chunk of one token.

Tolerance: everything is fp32. The Pallas kernels run an online softmax
page by page, the port a direct softmax per row; the results differ only
by summation order, i.e. a few fp32 ulps of values of order one, so
``atol = rtol = 1e-5`` holds with a wide margin. Where the JAX XLA
reference gives finite junk (padding rows see a uniform softmax) the
kernels and the port give zeros: those rows are compared with the Pallas
kernel only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.layers import (init_paged_kv_cache,
                                         paged_attention_reference,
                                         paged_cache_index,
                                         paged_prefill_attention_reference,
                                         update_paged_kv_cache)
from deepspeed_tpu.ops.pallas.decode_attention import (
    paged_decode_attention as jax_paged_decode,
    paged_prefill_attention as jax_paged_prefill)
from deepspeed_tpu_torch.ops.decode_attention import (
    paged_decode_attention, paged_decode_attention_plain,
    paged_prefill_attention, paged_prefill_attention_plain)
from deepspeed_tpu_torch.ops.ragged_attention import \
    ragged_paged_attention_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def build_pool(seed, lens, Hkv, D, bs=8, n_pool=24, nb=6, int8=False,
               idle=()):
    """A JAX pool holding ``lens[b]`` tokens for each sequence, written
    through the JAX per-row append. Rows listed in ``idle`` keep an
    all-sentinel table row (the two-program engine's idle slots). Pages a
    sequence does not own, and the tail of its last page, hold stale
    values from an earlier owner."""
    rs = np.random.RandomState(seed)
    B = len(lens)
    pool = init_paged_kv_cache(n_pool, bs, Hkv, D,
                               dtype=jnp.int8 if int8 else jnp.float32)
    # stale content everywhere first: one long "earlier" sequence per page
    every = np.arange(n_pool, dtype=np.int32)[None]
    stale = paged_cache_index(every, np.arange(n_pool * bs)[None],
                              np.asarray([n_pool * bs]))
    pool = update_paged_kv_cache(
        pool, jnp.asarray(rs.randn(1, n_pool * bs, Hkv, D), jnp.float32),
        jnp.asarray(rs.randn(1, n_pool * bs, Hkv, D), jnp.float32), stale)
    bt = np.full((B, nb), n_pool, np.int32)
    free = iter(rs.permutation(n_pool))
    for b, L in enumerate(lens):
        if b in idle or not L:
            continue
        need = -(-L // bs)
        bt[b, :need] = [next(free) for _ in range(need)]
        idx = paged_cache_index(bt[b:b + 1], np.arange(L)[None],
                                np.asarray([L]))
        pool = update_paged_kv_cache(
            pool, jnp.asarray(rs.randn(1, L, Hkv, D), jnp.float32),
            jnp.asarray(rs.randn(1, L, Hkv, D), jnp.float32), idx)
    return {n: np.array(a) for n, a in pool.items()}, bt, rs


def _scales(pool, conv):
    if "k_scale" not in pool:
        return {}
    return {"k_scale": conv(pool["k_scale"]), "v_scale": conv(pool["v_scale"])}


CASES = {
    # name: (H, Hkv, window, int8)
    "gqa": (8, 2, None, False),
    "mha": (4, 4, None, False),
    "window5": (8, 2, 5, False),
    "window_wide": (8, 2, 19, False),
    "int8_pool": (8, 2, None, True),
    "int8_window": (4, 2, 6, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_decode_plain_matches_jax(case):
    """K7a's plain version against the Pallas kernel (interpret mode) and
    the XLA reference: context lengths 1, a partial last page, a full
    page boundary, the whole table, and an idle sentinel row (context 1,
    no page: it reads the clamped last page in all three)."""
    H, Hkv, window, int8 = CASES[case]
    D, lens = 16, [1, 13, 16, 48, 1, 29]
    pool, bt, rs = build_pool(3, lens, Hkv, D, int8=int8, idle=(4,))
    q = rs.randn(len(lens), H, D).astype(np.float32)
    clen = np.asarray(lens, np.int32)
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    kern = np.asarray(jax_paged_decode(
        jnp.asarray(q), jpool["k"], jpool["v"], jnp.asarray(bt),
        jnp.asarray(clen), interpret=True, window=window,
        **_scales(pool, jnp.asarray)))
    ref = np.asarray(paged_attention_reference(
        jnp.asarray(q), jpool, jnp.asarray(bt), jnp.asarray(clen),
        window=window))
    got = paged_decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(pool["k"]),
        torch.from_numpy(pool["v"]), torch.from_numpy(bt),
        torch.from_numpy(clen), window=window,
        **_scales(pool, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


def _prefill_inputs(case_seed, H, Hkv, int8, T=8):
    """Chunks at 0, mid-prompt behind a cached prefix, with a padded tail
    (3 of T rows valid), of one valid row, and an empty sequence."""
    D = 16
    starts = np.asarray([0, 10, 21, 16, 0], np.int32)
    valid = np.asarray([T, T, 3, 1, 0], np.int32)
    clen = (starts + valid).astype(np.int32)
    pool, bt, rs = build_pool(case_seed, list(clen), Hkv, D, int8=int8)
    q = rs.randn(len(starts), T, H, D).astype(np.float32)
    return pool, bt, q, starts, valid, clen


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_prefill_plain_matches_jax(case):
    """K7b's plain version against the Pallas kernel (interpret mode) on
    every row (the padded tail and the empty sequence return zeros in
    both) and against the XLA reference on the valid rows."""
    H, Hkv, window, int8 = CASES[case]
    pool, bt, q, starts, valid, clen = _prefill_inputs(5, H, Hkv, int8)
    T = q.shape[1]
    jpool = {n: jnp.asarray(a) for n, a in pool.items()}
    kern = np.asarray(jax_paged_prefill(
        jnp.asarray(q), jpool["k"], jpool["v"], jnp.asarray(bt),
        jnp.asarray(starts), jnp.asarray(clen), force_pallas=True,
        interpret=True, window=window, **_scales(pool, jnp.asarray)))
    pos = starts[:, None] + np.arange(T)[None]
    live = np.arange(T)[None] < valid[:, None]
    ref = np.asarray(paged_prefill_attention_reference(
        jnp.asarray(q), jpool, jnp.asarray(bt),
        jnp.asarray(np.where(live, pos, -1).astype(np.int32)),
        jnp.asarray(clen), window=window))
    got = paged_prefill_attention_plain(
        torch.from_numpy(q), torch.from_numpy(pool["k"]),
        torch.from_numpy(pool["v"]), torch.from_numpy(bt),
        torch.from_numpy(starts), torch.from_numpy(clen), window=window,
        **_scales(pool, torch.from_numpy)).numpy()
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got[live], ref[live], **TOL)
    assert not got[~live].any() and not kern[~live].any(), \
        "rows at or past context_len return zeros"


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_versions_agree_with_the_unified_one(case):
    """Row for row, both plain versions compute what the unified ragged
    version computes on the same pool: a decode row is a segment of one
    token at context_len - 1, a chunk a segment of its valid rows."""
    H, Hkv, window, int8 = CASES[case]
    pool, bt, q, starts, valid, clen = _prefill_inputs(7, H, Hkv, int8)
    B, T = q.shape[:2]
    tp = {n: torch.from_numpy(a) for n, a in pool.items()}
    sc = _scales(pool, torch.from_numpy)
    tbt, tcl = torch.from_numpy(bt), torch.from_numpy(clen)
    chunk = paged_prefill_attention_plain(
        torch.from_numpy(q), tp["k"], tp["v"], tbt, torch.from_numpy(starts),
        tcl, window=window, **sc)
    unified = ragged_paged_attention_plain(
        torch.from_numpy(q.reshape(B * T, H, -1)), tp["k"], tp["v"], tbt,
        torch.arange(B, dtype=torch.int32) * T, torch.from_numpy(valid),
        torch.from_numpy(starts), tcl, window=window, **sc)
    torch.testing.assert_close(chunk.reshape(B * T, H, -1), unified, **TOL)
    # decode: the last valid row of each chunk, as a T = 1 call
    rows = [b for b in range(B) if valid[b]]
    qd = torch.from_numpy(np.stack([q[b, valid[b] - 1] for b in rows]))
    dec = paged_decode_attention_plain(qd, tp["k"], tp["v"], tbt[rows],
                                       tcl[rows], window=window, **sc)
    want = torch.stack([chunk[b, valid[b] - 1] for b in rows])
    torch.testing.assert_close(dec, want, **TOL)


@pytest.mark.parametrize("case", ["gqa", "int8_pool", "window5"])
def test_chunk_of_one_token_is_a_decode_step(case):
    """``paged_prefill_attention`` at chunk length 1 equals
    ``paged_decode_attention`` on the same pool, in the port and against
    the JAX decode kernel."""
    H, Hkv, window, int8 = CASES[case]
    D, lens = 16, [9, 16, 33]
    pool, bt, rs = build_pool(9, lens, Hkv, D, int8=int8)
    q = rs.randn(len(lens), H, D).astype(np.float32)
    clen = np.asarray(lens, np.int32)
    args = (torch.from_numpy(pool["k"]), torch.from_numpy(pool["v"]),
            torch.from_numpy(bt))
    sc = _scales(pool, torch.from_numpy)
    dec = paged_decode_attention_plain(torch.from_numpy(q), *args,
                                       torch.from_numpy(clen), window=window,
                                       **sc)
    one = paged_prefill_attention_plain(
        torch.from_numpy(q)[:, None], *args, torch.from_numpy(clen - 1),
        torch.from_numpy(clen), window=window, **sc)[:, 0]
    torch.testing.assert_close(dec, one, rtol=0, atol=0)
    kern = np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(bt), jnp.asarray(clen), interpret=True, window=window,
        **_scales(pool, jnp.asarray)))
    np.testing.assert_allclose(dec.numpy(), kern, **TOL)


def test_wrappers_on_cpu_are_the_plain_versions():
    """A CPU call of either wrapper computes its plain version and
    launches nothing."""
    pool, bt, q, starts, valid, clen = _prefill_inputs(11, 8, 2, False)
    tk, tv = torch.from_numpy(pool["k"]), torch.from_numpy(pool["v"])
    tbt, tcs, tcl = (torch.from_numpy(a) for a in (bt, starts, clen))
    before = (paged_decode_attention.launches,
              paged_prefill_attention.launches)
    torch.testing.assert_close(
        paged_prefill_attention(torch.from_numpy(q), tk, tv, tbt, tcs, tcl),
        paged_prefill_attention_plain(torch.from_numpy(q), tk, tv, tbt, tcs,
                                      tcl), rtol=0, atol=0)
    qd = torch.from_numpy(q[:, 0])
    torch.testing.assert_close(
        paged_decode_attention(qd, tk, tv, tbt, tcl),
        paged_decode_attention_plain(qd, tk, tv, tbt, tcl), rtol=0, atol=0)
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == before
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_decode_attention(qd, tk, tv, tbt, tcl,
                               k_scale=torch.ones(1))


def test_rows_that_see_no_key_return_zeros_not_nan():
    """An empty sequence (context 0) and a window that excludes nothing
    but stale keys: zeros, never NaN, and a NaN in a page the sequence
    does not own (or past its context in its last page) cannot leak."""
    pool, bt, q, starts, valid, clen = _prefill_inputs(13, 8, 2, False)
    k, v = torch.from_numpy(pool["k"]), torch.from_numpy(pool["v"])
    owned = torch.zeros(k.shape[0], dtype=torch.bool)
    owned[torch.from_numpy(bt[bt < k.shape[0]]).long()] = True
    owned[-1] = True                       # sentinel entries clamp here
    k[~owned] = float("nan")
    v[~owned] = float("nan")
    bs = k.shape[2]
    for b in range(len(clen)):             # the stale tail of each last page
        if clen[b] % bs:
            v[bt[b, clen[b] // bs], :, clen[b] % bs:] = float("nan")
    tbt, tcs, tcl = (torch.from_numpy(a) for a in (bt, starts, clen))
    out = paged_prefill_attention_plain(torch.from_numpy(q), k, v, tbt, tcs,
                                        tcl)
    assert torch.isfinite(out).all()
    assert not out[4].any(), "the empty sequence returns zeros"
    dec = paged_decode_attention_plain(torch.from_numpy(q[:, 0]), k, v, tbt,
                                       tcl)
    assert torch.isfinite(dec).all() and not dec[4].any()
