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

import functools

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
    paged_prefill_attention, paged_prefill_attention_plain, paged_splits)
from deepspeed_tpu_torch.ops.ragged_attention import \
    ragged_paged_attention_plain
from torch_threads import one_torch_thread  # noqa: F401

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
    # name: (H, Hkv, window, int8[, shape]); shape: D (default 16) and the
    # page size bs (default 8)
    "gqa": (8, 2, None, False),
    "mha": (4, 4, None, False),
    "window5": (8, 2, 5, False),
    "window_wide": (8, 2, 19, False),
    "int8_pool": (8, 2, None, True),
    "int8_window": (4, 2, 6, True),
    # Gemma's head dim, Qwen2's groups of 7 and 6, pages of 24 and 32
    "d256": (4, 2, None, False, dict(D=256)),
    "d256_int8_window": (4, 2, 6, True, dict(D=256)),
    "g7_bs24": (14, 2, None, False, dict(bs=24)),
    "g6_bs32_int8": (12, 2, None, True, dict(bs=32)),
}


def _case(case):
    """``(H, Hkv, window, int8, D, bs)`` of a CASES entry."""
    H, Hkv, window, int8, *shape = CASES[case]
    shape = shape[0] if shape else {}
    return H, Hkv, window, int8, shape.get("D", 16), shape.get("bs", 8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_decode_plain_matches_jax(case):
    """K7a's plain version against the Pallas kernel (interpret mode) and
    the XLA reference: context lengths 1, a partial last page, a full
    page boundary, the whole table, and an idle sentinel row (context 1,
    no page: it reads the clamped last page in all three)."""
    H, Hkv, window, int8, D, bs = _case(case)
    lens = [1, 13, 16, 48, 1, 29]
    pool, bt, rs = build_pool(3, lens, Hkv, D, bs=bs, int8=int8, idle=(4,))
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


def _prefill_inputs(case_seed, H, Hkv, int8, T=8, D=16, bs=8):
    """Chunks at 0, mid-prompt behind a cached prefix, with a padded tail
    (3 of T rows valid), of one valid row, and an empty sequence."""
    starts = np.asarray([0, 10, 21, 16, 0], np.int32)
    valid = np.asarray([T, T, 3, 1, 0], np.int32)
    clen = (starts + valid).astype(np.int32)
    pool, bt, rs = build_pool(case_seed, list(clen), Hkv, D, bs=bs,
                              int8=int8)
    q = rs.randn(len(starts), T, H, D).astype(np.float32)
    return pool, bt, q, starts, valid, clen


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_prefill_plain_matches_jax(case):
    """K7b's plain version against the Pallas kernel (interpret mode) on
    every row (the padded tail and the empty sequence return zeros in
    both) and against the XLA reference on the valid rows."""
    H, Hkv, window, int8, D, bs = _case(case)
    pool, bt, q, starts, valid, clen = _prefill_inputs(5, H, Hkv, int8, D=D,
                                                       bs=bs)
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
    H, Hkv, window, int8, D, bs = _case(case)
    pool, bt, q, starts, valid, clen = _prefill_inputs(7, H, Hkv, int8, D=D,
                                                       bs=bs)
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
    H, Hkv, window, int8, D, bs = _case(case)
    lens = [9, 16, 33]
    pool, bt, rs = build_pool(9, lens, Hkv, D, bs=bs, int8=int8)
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


# ---------------------------------------------------------------------------
# K7a's split-key walk, emulated with the walk of
# test_torch_ragged_attention.py
# ---------------------------------------------------------------------------

from test_torch_ragged_attention import (CHUNK_ROWS, NARROW_ROWS,  # noqa: E402
                                         PAGE, TILE, _bf16, finish,
                                         head_chunks, key_range,
                                         merge_states, order_sensitive_pool,
                                         walk_item)


def emulate_paged_decode(q, k_pages, v_pages, bt, clen, per, window=None,
                         route="cuda_core", rounding=False, k_scale=None,
                         v_scale=None):
    """K7a's kernel in fp32: grid (B, Hkv x head chunks, splits) over the
    table's capacity (nb * bs keys) cut into splits of ``per`` 64-key
    tiles; a split past the context or outside the window writes an empty
    partial; the others walk their visible tiles (the ragged walk's item
    of one token at context_len - 1: a narrow item where the group fits the
    route's narrow rows, else a chunk item of each head chunk); the merge
    combines every split in order (with one split the block writes the
    output)."""
    B, H, D = q.shape
    Hkv, bs = k_pages.shape[1:3]
    G = H // Hkv
    nb = bt.shape[1]
    narrow = G <= NARROW_ROWS[route]
    chunks = [(0, G)] if narrow else [
        (c * gc, min(gc, G - c * gc))
        for nch, gc in [head_chunks(G, CHUNK_ROWS[route])]
        for c in range(nch)]
    splits = -(-(-(-nb * bs // TILE)) // per)
    out = torch.zeros(B, H, D)
    for b in range(B):
        cl = int(clen[b])
        lo, hi = key_range(cl - 1, 1, cl, nb, window, bs)
        for kvh in range(Hkv):
            for g0, gn in chunks:
                parts = []
                for s in range(splits):
                    t0 = max(s * per, lo // TILE)
                    t1 = min((s + 1) * per, hi // TILE + 1) if hi >= lo \
                        else 0
                    if t0 >= t1:
                        parts.append((torch.full((gn,), -np.inf),
                                      torch.zeros(gn), torch.zeros(gn, D)))
                        continue
                    it = dict(row=b, kvh=kvh, g0=g0, gn=gn, tok0=b, ntok=1,
                              pos0=cl - 1, clen=cl, lo=lo, hi=hi, t0=t0,
                              t1=t1, narrow=narrow)
                    parts.append(walk_item(q, k_pages, v_pages, bt, it, G,
                                           window, route, rounding, k_scale,
                                           v_scale))
                _, l, acc = merge_states(parts)
                h0 = kvh * G + g0
                out[b, h0:h0 + gn] = finish(l, acc)
    return out


# contexts across a 320-key table (5 tiles): one key, a partial page, a
# tile boundary, several splits, an idle sentinel row, an empty row, the
# whole table
DECODE_LENS = [1, 13, 64, 200, 1, 0, 320]
DECODE_SPLIT_CASES = {
    # name: (window, int8[, shape]); shape: H, Hkv and the page size bs
    # (default 8 query heads over 2 kv heads, pages of 16)
    "contexts_empty_splits": (None, False),
    "window_empties_splits": (70, False),
    "int8_pool": (None, True),
    "int8_window": (33, True),
    # a group of 7 on pages of 8; a group of 64 (head chunks of 32 on the
    # CUDA cores, one chunk item of 64 rows on the tensor cores) on pages
    # of 24; a group of 71 (chunks of 24 and 36) on an int8 pool of 12
    "g7_bs8": (None, False, dict(H=14, bs=8)),
    "g64_bs24_window": (70, False, dict(H=64, Hkv=1, bs=24)),
    "g71_bs12_int8": (None, True, dict(H=71, Hkv=1, bs=12)),
}
DECODE_SPLIT_PARAMS = [(case, per, route)
                       for case in sorted(DECODE_SPLIT_CASES)
                       for per in (1, 2, 3)
                       for route in ("cuda_core", "tensor_core")]


def _decode_split_setup(case, seed=31):
    window, int8, *shape = DECODE_SPLIT_CASES[case]
    shape = shape[0] if shape else {}
    H, Hkv, bs = shape.get("H", 8), shape.get("Hkv", 2), \
        shape.get("bs", PAGE)
    pool, bt, rs = build_pool(seed, DECODE_LENS, Hkv, 16, bs=bs,
                              n_pool=768 // bs, nb=-(-320 // bs), int8=int8,
                              idle=(4,))
    q = rs.randn(len(DECODE_LENS), H, 16).astype(np.float32)
    return q, pool, bt, np.asarray(DECODE_LENS, np.int32), window


@functools.lru_cache(maxsize=None)
def _decode_split_kernel(case):
    """The JAX Pallas kernel (interpret mode) on a case's inputs, once a
    case: it depends on neither the split nor the route."""
    q, pool, bt, clen, window = _decode_split_setup(case)
    return np.asarray(jax_paged_decode(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(bt), jnp.asarray(clen), interpret=True, window=window,
        **_scales(pool, jnp.asarray)))


@pytest.mark.parametrize("case,per,route", DECODE_SPLIT_PARAMS)
def test_split_paged_decode_merges_to_the_plain_version(case, per, route):
    """K7a's split walk and its lse merge (splits of 1, 2 and 3 tiles of a
    5-tile table) against the plain version and the JAX Pallas kernel
    (interpret mode), fp32 at 1e-5: splits emptied by the context or by a
    window, an idle sentinel row, a row that sees no key (context 0), an
    int8 pool."""
    q, pool, bt, clen, window = _decode_split_setup(case)
    scales = _scales(pool, torch.from_numpy)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, pool["k"], pool["v"]))
    got = emulate_paged_decode(tq, tk, tv, bt, clen, per, window, route,
                               **scales)
    plain = paged_decode_attention_plain(tq, tk, tv, torch.from_numpy(bt),
                                         torch.from_numpy(clen),
                                         window=window, **scales)
    torch.testing.assert_close(got, plain, **TOL)
    assert not got[5].any(), "a row that sees no key is zeros"
    np.testing.assert_allclose(got.numpy(), _decode_split_kernel(case),
                               **TOL)


@pytest.mark.parametrize("case", sorted(DECODE_SPLIT_CASES))
@pytest.mark.parametrize("per", [1, 3])
def test_paged_decode_rounding_points_stay_inside_the_bf16_tolerance(case,
                                                                      per):
    """K7a's tensor-core rounding points (bf16 q, K and V; an int8 pool's
    codes exact in bf16 with fp32 scales; P.V as bf16(P) + bf16(P -
    bf16(P)); a bf16 output) against the plain version on the same bf16
    inputs, within 2**-7 |plain| + 1e-3."""
    q, pool, bt, clen, window = _decode_split_setup(case, seed=37)
    scales = _scales(pool, torch.from_numpy)
    tq = torch.from_numpy(q).bfloat16()
    tk, tv = (torch.from_numpy(pool[n]) for n in ("k", "v"))
    if not scales:
        tk, tv = tk.bfloat16(), tv.bfloat16()
    got = _bf16(emulate_paged_decode(tq, tk, tv, bt, clen, per, window,
                                     "tensor_core", rounding=True, **scales))
    plain = paged_decode_attention_plain(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(clen),
        window=window, **scales).float()
    torch.testing.assert_close(got, plain, rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("route", ["cuda_core", "tensor_core"])
def test_paged_decode_merges_splits_in_order(route):
    """One tile a split: the sequence's partials merge in split order and
    the output is exactly 1 / 192 (fp32); any other order loses the 1
    (see ``order_sensitive_pool``)."""
    q, k, v, desc = order_sensitive_pool()
    got = emulate_paged_decode(q, k, v, desc[0], desc[4], per=1, route=route)
    assert torch.equal(got, torch.full_like(got, np.float32(1 / 192)))


def test_paged_splits_come_from_the_table_width():
    """K7a's split count and tiles a split at the two-program decode's
    shapes (B 8, Hkv 8, a 128-page table of 16-token pages) on 132 and 114
    SMs, and for other page sizes (the keys are nb * bs); whole tiles,
    every split non-empty, from shapes only. ``decode_launch`` cuts a
    group over the narrow item's rows into head chunks, each a row of
    work."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_launch

    assert paged_splits(8, 8, 128, 16, 132) == (5, 7)
    assert paged_splits(8, 8, 128, 16, 114) == (4, 8)
    assert paged_splits(1, 1, 128, 16, 132) == (32, 1)
    assert paged_splits(8, 8, 256, 8, 132) == (5, 7)
    assert paged_splits(8, 8, 64, 32, 132) == (5, 7)
    for B, Hkv, nb, bs, sm in ((8, 8, 128, 16, 132), (3, 2, 10, 16, 114),
                               (1, 1, 1, 16, 132), (8, 4, 86, 24, 132),
                               (8, 4, 171, 12, 114), (2, 1, 300, 1, 132),
                               (8, 16, 16, 128, 132)):
        splits, per = paged_splits(B, Hkv, nb, bs, sm)
        tiles = -(-nb * bs // TILE)
        assert (splits - 1) * per < tiles <= splits * per
    bf16, fp32 = torch.bfloat16, torch.float32
    assert decode_launch(8, 32, 8, 128, 16, bf16, 132) == \
        dict(narrow=True, chunks=1, splits=5, per=7)
    # Qwen2-7B's group of 7 and Gemma-2B's of 8 stay narrow on the tensor
    # cores; 8 is the CUDA cores' last narrow group
    assert decode_launch(8, 28, 4, 128, 16, bf16, 132)["narrow"]
    assert decode_launch(8, 8, 1, 256, 8, fp32, 132)["narrow"]
    # Falcon-7B's 71 heads on one kv head: chunks of 36 and 35 (tensor
    # cores), of 24, 24 and 23 (CUDA cores)
    assert decode_launch(8, 71, 1, 128, 16, bf16, 132) == \
        dict(narrow=False, chunks=2, splits=16, per=2)
    assert decode_launch(8, 71, 1, 128, 16, fp32, 132)["chunks"] == 3


# ---------------------------------------------------------------------------
# K7b's grid (B x query tiles, Hkv, splits) over the same walk
# ---------------------------------------------------------------------------

def emulate_paged_prefill(q, k_pages, v_pages, bt, cs, clen, per,
                          window=None, route="cuda_core", rounding=False,
                          k_scale=None, v_scale=None, order=None):
    """K7b's kernel in fp32: block (b * tiles + i, kvh * chunks + c, s)
    takes tokens ``[i * qt, i * qt + qt)`` of chunk b (``qt`` = the route's
    chunk rows // heads, one token where the group is cut into head
    chunks) and head chunk c, clipped to the context, as one chunk item of
    split s (the ragged walk's item); tokens at or past the context, and
    splits that see no tile of the item, give empty partials; the merge
    combines every split of a token in split order (``order`` permutes it,
    to show that it matters). With one split the block writes the output
    itself, which is the merge of one state."""
    B, T, H, D = q.shape
    Hkv, bs = k_pages.shape[1:3]
    G = H // Hkv
    nb = bt.shape[1]
    nch, gc = head_chunks(G, CHUNK_ROWS[route])
    qt = CHUNK_ROWS[route] // gc
    tiles = -(-T // qt)
    splits = -(-(-(-nb * bs // TILE)) // per)
    flat = q.reshape(B * T, H, D)
    out = torch.zeros(B * T, H, D)
    for b in range(B):
        cl, start = int(clen[b]), int(cs[b])
        valid = max(0, min(T, cl - start))
        for i in range(tiles):
            first = i * qt
            ntok = max(0, min(qt, valid - first))
            width = min(qt, T - first)
            lo, hi = key_range(start + first, ntok, cl, nb, window, bs)
            for kvh in range(Hkv):
                for c in range(nch):
                    g0 = c * gc
                    gn = min(gc, G - g0)
                    parts = []
                    for s in range(splits):
                        m = torch.full((width * gn,), -np.inf)
                        l = torch.zeros(width * gn)
                        acc = torch.zeros(width * gn, D)
                        t0 = max(s * per, lo // TILE)
                        t1 = min((s + 1) * per, hi // TILE + 1)
                        if ntok and hi >= lo and t0 < t1:
                            it = dict(row=b, kvh=kvh, g0=g0, gn=gn,
                                      tok0=b * T + first, ntok=ntok,
                                      pos0=start + first, clen=cl, lo=lo,
                                      hi=hi, t0=t0, t1=t1, narrow=False)
                            wm, wl, wacc = walk_item(
                                flat, k_pages, v_pages, bt, it, G, window,
                                route, rounding, k_scale, v_scale)
                            m[:ntok * gn], l[:ntok * gn] = wm, wl
                            acc[:ntok * gn] = wacc
                        parts.append((m, l, acc))
                    if order is not None:
                        parts = [parts[s] for s in order]
                    _, l, acc = merge_states(parts)
                    rows = slice(b * T + first, b * T + first + width)
                    h0 = kvh * G + g0
                    out[rows, h0:h0 + gn] = \
                        finish(l, acc).reshape(width, gn, D)
    return out.reshape(B, T, H, D)


# (chunk_start, context_len) over a 320-key table (5 tiles): a chunk at 0,
# one that starts mid-page behind a prefix, a padded tail that starts
# mid-page, an idle sentinel row (context 1, no page), an empty row, a
# chunk that ends at the table's end
PREFILL_T = 40
PREFILL_ROWS = [(0, 40), (150, 190), (270, 293), (0, 1), (0, 0), (290, 320)]
PREFILL_SPLIT_CASES = {
    # name: (window, int8[, shape]) as DECODE_SPLIT_CASES: 9 tokens x 7
    # heads (4 x 7 on the CUDA cores) a query tile on pages of 8; a group of
    # 64 (one token a tile, head chunks of 32 on the CUDA cores) on pages
    # of 24; a group of 6 on an int8 pool of 32-token pages
    "mid_page_and_tails": (None, False),
    "window_empties_splits": (70, False),
    "int8_pool": (None, True),
    "int8_window": (33, True),
    "g7_bs8": (None, False, dict(H=14, bs=8)),
    "g64_bs24_window": (70, False, dict(H=64, Hkv=1, bs=24)),
    "g6_bs32_int8": (None, True, dict(H=12, bs=32)),
}
PREFILL_SPLIT_PARAMS = [(case, per, route)
                        for case in sorted(PREFILL_SPLIT_CASES)
                        for per in (1, 2)
                        for route in ("cuda_core", "tensor_core")]


def _prefill_split_setup(case, seed=41):
    window, int8, *shape = PREFILL_SPLIT_CASES[case]
    shape = shape[0] if shape else {}
    H, Hkv, bs = shape.get("H", 8), shape.get("Hkv", 2), \
        shape.get("bs", PAGE)
    cs, cl = (np.asarray([r[i] for r in PREFILL_ROWS], np.int32)
              for i in (0, 1))
    pool, bt, rs = build_pool(seed, list(cl), Hkv, 16, bs=bs,
                              n_pool=1024 // bs, nb=-(-320 // bs),
                              int8=int8, idle=(3,))
    q = rs.randn(len(cl), PREFILL_T, H, 16).astype(np.float32)
    return q, pool, bt, cs, cl, window


@functools.lru_cache(maxsize=None)
def _prefill_split_kernel(case):
    """The JAX Pallas kernel (interpret mode) on a case's inputs, once a
    case."""
    q, pool, bt, cs, cl, window = _prefill_split_setup(case)
    return np.asarray(jax_paged_prefill(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        jnp.asarray(bt), jnp.asarray(cs), jnp.asarray(cl), force_pallas=True,
        interpret=True, window=window, **_scales(pool, jnp.asarray)))


@pytest.mark.parametrize("case,per,route", PREFILL_SPLIT_PARAMS)
def test_split_paged_prefill_merges_to_the_plain_version(case, per, route):
    """K7b's grid over the split walk (query tiles of 8 tokens on the CUDA
    cores and 16 on the tensor cores, the last one partial; splits of 1
    and 2 tiles of a 5-tile table) and its merge in split order, against
    the plain version and the JAX Pallas kernel (interpret mode), fp32 at
    1e-5: chunks that start mid-page, padded tails (zeros), windows that
    empty splits, an int8 pool, an idle sentinel row and an empty one."""
    q, pool, bt, cs, cl, window = _prefill_split_setup(case)
    scales = _scales(pool, torch.from_numpy)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, pool["k"], pool["v"]))
    got = emulate_paged_prefill(tq, tk, tv, bt, cs, cl, per, window, route,
                                **scales)
    plain = paged_prefill_attention_plain(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(cs),
        torch.from_numpy(cl), window=window, **scales)
    torch.testing.assert_close(got, plain, **TOL)
    live = np.arange(PREFILL_T)[None] < (cl - cs)[:, None]
    assert not got.numpy()[~live].any(), "rows past the context are zeros"
    np.testing.assert_allclose(got.numpy(), _prefill_split_kernel(case),
                               **TOL)


@pytest.mark.parametrize("case", sorted(PREFILL_SPLIT_CASES))
@pytest.mark.parametrize("per", [1, 3])
def test_paged_prefill_rounding_points_stay_inside_the_bf16_tolerance(case,
                                                                       per):
    """K7b's tensor-core rounding points (bf16 q, K and V; an int8 pool's
    codes exact in bf16 with fp32 scales; P.V as bf16(P) + bf16(P -
    bf16(P)); a bf16 output) against the plain version on the same bf16
    inputs, within 2**-7 |plain| + 1e-3."""
    q, pool, bt, cs, cl, window = _prefill_split_setup(case, seed=43)
    scales = _scales(pool, torch.from_numpy)
    tq = torch.from_numpy(q).bfloat16()
    tk, tv = (torch.from_numpy(pool[n]) for n in ("k", "v"))
    if not scales:
        tk, tv = tk.bfloat16(), tv.bfloat16()
    got = _bf16(emulate_paged_prefill(tq, tk, tv, bt, cs, cl, per, window,
                                      "tensor_core", rounding=True,
                                      **scales))
    plain = paged_prefill_attention_plain(
        tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(cs),
        torch.from_numpy(cl), window=window, **scales).float()
    torch.testing.assert_close(got, plain, rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("route", ["cuda_core", "tensor_core"])
def test_paged_prefill_merges_splits_in_order(route):
    """A chunk of 4 tokens at positions 188..191 over
    ``order_sensitive_pool``'s 192 keys, one tile a split: every token's
    three partials merge in split order to exactly 1 / (position + 1)
    (fp32); the reversed order loses the 1 and fails. The card test
    ``test_paged_walks_merge_splits_in_order`` holds K7b to the same
    inputs."""
    _, k, v, desc = order_sensitive_pool()
    keys = int(desc[4][0])
    q = torch.zeros(1, 4, 4, k.shape[-1])
    cs = np.asarray([keys - 4], np.int32)
    want = torch.from_numpy(
        (1 / np.arange(keys - 3, keys + 1)).astype(np.float32))
    want = want[None, :, None, None].expand_as(q)
    got = emulate_paged_prefill(q, k, v, desc[0], cs, desc[4], per=1,
                                route=route)
    assert torch.equal(got, want)
    rev = emulate_paged_prefill(q, k, v, desc[0], cs, desc[4], per=1,
                                route=route, order=[2, 1, 0])
    assert not torch.equal(rev, want)


def test_paged_prefill_launch_comes_from_the_shapes_alone():
    """K7b's launch (head chunks, query tiles, splits, tiles a split) at the
    two-program prefill's shapes (B 1, T 64, H 32 over Hkv 8, a 128-page
    table of 16-token pages) on 132 and 114 SMs, bf16 and fp32, and at
    other groups and page sizes: a function of the shapes and the SM count,
    with no descriptor among its arguments."""
    import inspect

    from deepspeed_tpu_torch.ops.decode_attention import prefill_launch

    assert list(inspect.signature(prefill_launch).parameters) == \
        ["B", "T", "H", "Hkv", "nb", "bs", "dtype", "sm_count"]
    bf16, fp32 = torch.bfloat16, torch.float32
    assert prefill_launch(1, 64, 32, 8, 128, 16, bf16, 132) == \
        dict(tiles=4, chunks=1, splits=8, per=4)
    assert prefill_launch(1, 64, 32, 8, 128, 16, bf16, 114) == \
        dict(tiles=4, chunks=1, splits=8, per=4)
    assert prefill_launch(1, 64, 32, 8, 128, 16, fp32, 132) == \
        dict(tiles=8, chunks=1, splits=5, per=7)
    assert prefill_launch(3, 40, 8, 4, 128, 16, fp32, 132) == \
        dict(tiles=3, chunks=1, splits=8, per=4)
    # Qwen2-7B's group of 7: 9 tokens a tile (63 of 64 rows); Gemma-7B's
    # pages of 16 at 16 heads; a group of 64 on the CUDA cores: 2 head
    # chunks of one token; pages of 8 halve the keys of a 128-page table
    assert prefill_launch(1, 64, 28, 4, 128, 16, bf16, 132)["tiles"] == 8
    assert prefill_launch(1, 64, 64, 1, 128, 16, fp32, 132)["chunks"] == 2
    assert prefill_launch(1, 64, 64, 1, 128, 16, bf16, 132)["tiles"] == 64
    assert prefill_launch(1, 64, 32, 8, 128, 8, bf16, 132) == \
        dict(tiles=4, chunks=1, splits=8, per=2)
    for B, T, H, Hkv, nb, bs, dt, sm in (
            (1, 64, 32, 8, 128, 16, bf16, 132),
            (8, 512, 32, 8, 512, 16, bf16, 132),
            (1, 1, 8, 8, 1, 16, fp32, 114),
            (2, 37, 8, 1, 10, 16, fp32, 132),
            (1, 64, 28, 4, 86, 24, bf16, 132),
            (2, 33, 71, 1, 171, 12, fp32, 114),
            (1, 64, 16, 16, 256, 8, bf16, 132)):
        lp = prefill_launch(B, T, H, Hkv, nb, bs, dt, sm)
        rows = {bf16: 64, fp32: 32}[dt]
        chunks = -(-(H // Hkv) // rows)
        tokens = rows // -(-(H // Hkv) // chunks)
        assert lp["chunks"] == chunks
        assert (lp["tiles"] - 1) * tokens < T <= lp["tiles"] * tokens
        tiles = -(-nb * bs // TILE)
        assert (lp["splits"] - 1) * lp["per"] < tiles <= \
            lp["splits"] * lp["per"]


def test_paged_kernels_accept_the_whole_domain_and_refuse_the_rest():
    """What a CUDA tensor may hand K6, K7a and K7b (the device check
    bypassed): head dims 64, 80, 96, 128 and 256, any whole group up to 71
    and beyond, pages of 1 to 128 tokens (12 and 24 too), bf16 and fp32
    q, bf16/fp32 and int8 pools. A group that is not whole, head dims 32,
    72, 112 and 192, and fp16 are refused, the head dims naming ROADMAP.md
    Queue 2."""
    from deepspeed_tpu_torch.ops import ragged_attention as ra
    from deepspeed_tpu_torch.ops.decode_attention import _check_paged_args

    lens = torch.zeros(2, dtype=torch.int32)

    def check(H, Hkv, D, bs, dtype, int8=False):
        q = torch.zeros(2, H, D, dtype=dtype)
        pages = torch.zeros(3, Hkv, bs, D,
                            dtype=torch.int8 if int8 else dtype)
        sc = torch.ones(3, Hkv, bs) if int8 else None
        tables = torch.zeros(2, 4, dtype=torch.int32)
        _check_paged_args("paged_decode_attention", q, pages, pages, tables,
                          (lens,), sc, sc, None)
        _check_paged_args("paged_prefill_attention", q[:, None], pages,
                          pages, tables, (lens, lens), sc, sc, None)
        ra._check_kernel_args(q, pages, pages, tables, (lens,) * 4, sc, sc,
                              None)

    for D in (64, 80, 96, 128, 256):
        for H, Hkv in ((16, 16), (28, 4), (12, 2), (8, 1), (64, 1),
                       (71, 1), (142, 2)):
            for bs in (1, 8, 12, 16, 24, 32, 64, 128):
                for dtype in (torch.bfloat16, torch.float32):
                    check(H, Hkv, D, bs, dtype, int8=(bs + D) % 3 == 0)
    with pytest.raises(ValueError, match="must be whole"):
        check(7, 2, 128, 16, torch.bfloat16)
    for D in (32, 72, 112, 192):
        with pytest.raises(ValueError, match="ROADMAP.md Queue 2"):
            check(8, 2, D, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        check(8, 2, 128, 16, torch.float16)
