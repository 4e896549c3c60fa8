"""Ragged paged attention of the PyTorch port against the JAX package.

The port's plain version (``ragged_paged_attention_plain``, which the
wrapper runs for CPU tensors) is held against the JAX Pallas kernel run as
the JAX package's own tests run it (``interpret=True, force_pallas=True``)
and against its XLA reference, on pools and packed batches built with
numpy-seeded inputs: decode rows, mid-prompt chunks, idle rows, sentinel
table entries, GQA with 4 query heads per kv head, an int8 pool and a
sliding window.

Tolerance: everything is fp32. The Pallas kernel runs an online softmax
page by page, the port a direct softmax per row; the results differ only
by summation order, i.e. a few fp32 ulps of values of order one, so
``atol = rtol = 1e-5`` holds with a wide margin.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.layers import (init_paged_kv_cache,
                                         paged_cache_index,
                                         update_paged_kv_cache)
from deepspeed_tpu.ops.pallas.ragged_attention import (
    _reference_ragged, ragged_paged_attention as jax_ragged)
from deepspeed_tpu_torch.ops.ragged_attention import (
    launch_params, ragged_paged_attention, ragged_paged_attention_plain)
from torch_threads import one_torch_thread  # noqa: F401

# (kind, start, qlen): decode rows sit at position ``start`` (context
# start + 1), chunks span [start, start + qlen), idle rows hold nothing
ROWS = [("decode", 13, 1), ("chunk", 8, 5), ("idle", 0, 0),
        ("chunk", 0, 7), ("decode", 0, 1), ("chunk", 19, 3)]


def mixed_setup(seed, rows, Hkv=2, H=8, D=16, bs=8, n_pool=64, nb=6,
                int8=False):
    """A JAX pool holding each row's cached prefix plus the packed batch's
    appended KV (through the JAX packed append, as the engine does), and
    the packed descriptors. Table entries past each row's pages are the
    sentinel ``n_pool``; the packed axis ends in 2 unclaimed tokens."""
    rs = np.random.RandomState(seed)
    R = len(rows)
    pool = init_paged_kv_cache(n_pool, bs, Hkv, D,
                               dtype=jnp.int8 if int8 else jnp.float32)
    bt = np.full((R, nb), n_pool, np.int32)
    free = iter(range(1, n_pool))
    qs, ql, cs, cl = (np.zeros((R,), np.int32) for _ in range(4))
    segs, cursor = [], 0
    for r, (kind, start, qlen) in enumerate(rows):
        if kind == "idle":
            continue
        n = 1 if kind == "decode" else qlen
        need = -(-(start + n) // bs)
        bt[r, :need] = [next(free) for _ in range(need)]
        if start:
            pk = rs.randn(1, start, Hkv, D).astype(np.float32)
            pv = rs.randn(1, start, Hkv, D).astype(np.float32)
            idx = paged_cache_index(bt[r:r + 1], np.arange(start)[None],
                                    np.asarray([start]))
            pool = update_paged_kv_cache(pool, jnp.asarray(pk),
                                         jnp.asarray(pv), idx)
        qs[r], ql[r], cs[r], cl[r] = cursor, n, start, start + n
        segs.append((cursor, n))
        cursor += n
    T = cursor + 2
    q = rs.randn(T, H, D).astype(np.float32)
    k = rs.randn(1, T, Hkv, D).astype(np.float32)
    v = rs.randn(1, T, Hkv, D).astype(np.float32)
    pos = np.full((1, T), -1, np.int32)
    trow = np.full((1, T), -1, np.int32)
    for r in range(R):
        if ql[r]:
            pos[0, qs[r]:qs[r] + ql[r]] = cs[r] + np.arange(ql[r])
            trow[0, qs[r]:qs[r] + ql[r]] = r
    idx = paged_cache_index(bt, pos, cl, chunk_start=cs, token_rows=trow,
                            query_start=qs, query_len=ql)
    pool = update_paged_kv_cache(pool, jnp.asarray(k), jnp.asarray(v), idx)
    pool = {name: np.array(a) for name, a in pool.items()}
    return q, pool, (bt, qs, ql, cs, cl), segs


def _claimed(T, segs):
    mask = np.zeros(T, bool)
    for c, n in segs:
        mask[c:c + n] = True
    return mask


def _torch_args(q, pool, desc):
    return ((torch.from_numpy(q), torch.from_numpy(pool["k"]),
             torch.from_numpy(pool["v"]))
            + tuple(torch.from_numpy(d) for d in desc))


CASES = {
    "gqa4_fp32": dict(setup={}, window=None),
    "int8_pool": dict(setup={"int8": True}, window=None),
    "window6": dict(setup={}, window=6),
    # Gemma's head dim, Qwen2's groups of 7 and 6, pages of 24 and 32
    "d256": dict(setup={"D": 256, "H": 4}, window=None),
    "d256_int8_window5": dict(setup={"D": 256, "int8": True}, window=5),
    "g7_bs24": dict(setup={"H": 14, "bs": 24, "nb": 2}, window=None),
    "g6_bs32_int8": dict(setup={"H": 12, "bs": 32, "nb": 1, "int8": True},
                         window=None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_kernel_and_reference(case):
    spec = CASES[case]
    q, pool, desc, segs = mixed_setup(11, ROWS, **spec["setup"])
    scales = {}
    if "k_scale" in pool:
        scales = {"k_scale": pool["k_scale"], "v_scale": pool["v_scale"]}
    jargs = (jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"])) \
        + tuple(jnp.asarray(d) for d in desc)
    jscales = {n: jnp.asarray(s) for n, s in scales.items()}
    kern = np.asarray(jax_ragged(*jargs, interpret=True, force_pallas=True,
                                 window=spec["window"], **jscales))
    ref = np.asarray(_reference_ragged(
        *jargs, None, spec["window"], jscales.get("k_scale"),
        jscales.get("v_scale")))
    got = ragged_paged_attention_plain(
        *_torch_args(q, pool, desc), window=spec["window"],
        **{n: torch.from_numpy(s) for n, s in scales.items()}).numpy()
    claimed = _claimed(q.shape[0], segs)
    np.testing.assert_allclose(got[claimed], kern[claimed], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got[claimed], ref[claimed], rtol=1e-5,
                               atol=1e-5)
    # unclaimed packed positions come back zero, as from the kernel
    assert not np.any(got[~claimed]) and not np.any(kern[~claimed])


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU call of the wrapper computes the plain version and launches
    nothing."""
    q, pool, desc, _ = mixed_setup(13, ROWS)
    args = _torch_args(q, pool, desc)
    before = ragged_paged_attention.launches
    torch.testing.assert_close(ragged_paged_attention(*args),
                               ragged_paged_attention_plain(*args),
                               rtol=0, atol=0)
    assert ragged_paged_attention.launches == before


def test_rows_without_query_or_context_return_zeros():
    """A row with query_len 0 or context_lens 0 contributes nothing, even
    when its segment descriptors point at packed tokens."""
    q, pool, (bt, qs, ql, cs, cl), segs = mixed_setup(17, ROWS)
    full = ragged_paged_attention_plain(*_torch_args(q, pool,
                                                     (bt, qs, ql, cs, cl)))
    cl0 = cl.copy()
    cl0[0] = 0                    # decode row 0 loses its context
    out = ragged_paged_attention_plain(*_torch_args(q, pool,
                                                    (bt, qs, ql, cs, cl0)))
    c, n = segs[0]
    assert not out[c:c + n].any()
    torch.testing.assert_close(out[n:], full[n:], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the split-key walk of the CUDA kernels (K6 here, K7a in
# test_torch_paged_attention.py), emulated
# ---------------------------------------------------------------------------

PAGE, TILE = 16, 64        # the default page size; csrc/paged_common.cuh
CHUNK_ROWS = {"tensor_core": 64, "cuda_core": 32}
NARROW_ROWS = {"tensor_core": 16, "cuda_core": 8}
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.bfloat16().float()


def key_range(pos0, ntok, clen, nb, window, bs=PAGE):
    """Keys [lo, hi] some token at pos0 .. pos0 + ntok - 1 sees in a table
    of ``nb`` pages of ``bs`` tokens."""
    hi = min(pos0 + ntok, clen, nb * bs) - 1
    lo = max(0, pos0 - window + 1) if window else 0
    return lo, hi


def head_chunks(G, rows):
    """A chunk item's head chunks of a group and the heads of each: the
    whole group where it fits ``rows``, else the fewest equal chunks."""
    chunks = -(-G // rows)
    return chunks, -(-G // chunks)


def plan_items(desc, T, G, Hkv, nb, per, window, route, bs=PAGE):
    """ragged_plan_kernel: the work items (chunk rows first, then the
    narrow rows, whose tokens x G heads fit one narrow item; within a row
    query tile, split, kv head, head chunk) and each claimed token's split
    range ``(s_lo, n)``. A chunk row's tiles hold floor(rows / heads)
    tokens; a group over the route's chunk rows is cut into head chunks of
    one token a tile."""
    bt, qs, ql, cs, cl = (np.asarray(d).tolist() for d in desc)
    chunk, narrow, info = [], [], {}
    nch, gc = head_chunks(G, CHUNK_ROWS[route])
    for r in range(len(qs)):
        nq = 0 if ql[r] <= 0 or cl[r] <= 0 or not 0 <= qs[r] < T \
            else min(ql[r], T - qs[r])
        one = nq * G <= NARROW_ROWS[route]
        qt = max(nq, 1) if one else CHUNK_ROWS[route] // gc
        chunks = [(0, G)] if one else \
            [(c * gc, min(gc, G - c * gc)) for c in range(nch)]
        for tok in range(0, nq, qt):
            ntok = min(qt, nq - tok)
            lo, hi = key_range(cs[r] + tok, ntok, cl[r], nb, window, bs)
            s_lo = lo // TILE // per
            n = hi // TILE // per - s_lo + 1 if hi >= lo else 0
            for j in range(ntok):
                info[qs[r] + tok + j] = (s_lo, n)
            for s in range(s_lo, s_lo + n):
                for kvh in range(Hkv):
                    for g0, gn in chunks:
                        (narrow if one else chunk).append(dict(
                            row=r, kvh=kvh, g0=g0, gn=gn, tok0=qs[r] + tok,
                            ntok=ntok, pos0=cs[r] + tok, clen=cl[r], lo=lo,
                            hi=hi, t0=max(s * per, lo // TILE),
                            t1=min((s + 1) * per, hi // TILE + 1),
                            slot=-1 if n == 1 else s, narrow=one))
    return chunk + narrow, info


def item_heads(it, G):
    """The query heads of an item's rows' head index ``g0 .. g0 + gn``
    (the whole group where the item carries no chunk)."""
    g0, gn = it.get("g0", 0), it.get("gn", G)
    return it["kvh"] * G + g0, gn


def walk_item(q, k_pages, v_pages, bt, it, G, window, route, rounding,
              k_scale=None, v_scale=None):
    """One block's item in fp32: its split's 64-key tiles gathered key by
    key through the table (key k in table entry k // bs, row k % bs; keys
    outside [lo, hi] read as zeros; entries clamped to page N - 1), an
    online softmax in log2 units per state slice (tensor-core narrow items:
    the four warps' 16-key slices, merged in warp order at the end;
    otherwise the whole tile), P.V over those V rows (an int8 pool: P times
    the V scale, selected to 0 outside [lo, hi]). ``rounding``: the tensor
    cores' bf16 rounding points, P.V as bf16(P) + bf16(P - bf16(P)).
    Returns the rows' ``(m, l, acc)``, row g = token g // gn, head
    kvh * G + g0 + g % gn."""
    N, _, bs, D = k_pages.shape
    nb = bt.shape[1]
    sl2 = D ** -0.5 * LOG2E
    h0, gn = item_heads(it, G)
    Q = q[it["tok0"]:it["tok0"] + it["ntok"], h0:h0 + gn].float() \
        .reshape(-1, D)
    pos = it["pos0"] + torch.arange(Q.shape[0]) // gn
    width = 16 if route == "tensor_core" and it["narrow"] else TILE
    states = [(torch.full((Q.shape[0],), -np.inf), torch.zeros(Q.shape[0]),
               torch.zeros(Q.shape[0], D)) for _ in range(TILE // width)]
    for t in range(it["t0"], it["t1"]):
        keys = t * TILE + torch.arange(TILE)
        Kt, Vt = torch.zeros(TILE, D), torch.zeros(TILE, D)
        ks, vs = torch.zeros(TILE), torch.zeros(TILE)
        inr = (keys >= it["lo"]) & (keys <= it["hi"])
        read = keys[inr]                            # the rest zero-filled
        page = read // bs
        pid = torch.from_numpy(np.asarray(bt)[it["row"]]).long()[
            page.clamp(max=nb - 1)]
        pid = torch.where((page < nb) & (pid >= 0) & (pid < N), pid,
                          torch.full_like(pid, N - 1))
        Kt[inr] = k_pages[pid, it["kvh"], read % bs].float()
        Vt[inr] = v_pages[pid, it["kvh"], read % bs].float()
        if k_scale is not None:
            ks[inr] = k_scale[pid, it["kvh"], read % bs].float()
            vs[inr] = v_scale[pid, it["kvh"], read % bs].float()
        seen = (keys[None] <= pos[:, None]) & (keys[None] < it["clen"]) \
            & (keys[None] < nb * bs) & inr[None]
        if window:
            seen &= pos[:, None] - keys[None] < window
        for w, (m, l, acc) in enumerate(states):
            sl = slice(w * width, (w + 1) * width)
            s = Q @ Kt[sl].T
            if k_scale is not None:
                s = s * ks[sl][None]
            s = torch.where(seen[:, sl], s * sl2, torch.full_like(s, -np.inf))
            m_new = torch.maximum(m, s.amax(dim=1))
            base = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                               m_new)
            alpha = torch.exp2(m - base[:, None].squeeze(1))
            p = torch.exp2(s - base[:, None])
            l = l * alpha + p.sum(dim=1)
            v = torch.where(inr[sl][:, None], Vt[sl], torch.zeros_like(Vt[sl]))
            if v_scale is not None:
                p = torch.where(inr[sl][None], p * vs[sl][None],
                                torch.zeros_like(p))
            if rounding:
                hi = _bf16(p)
                pv = hi @ v + _bf16(p - hi) @ v
            else:
                pv = p @ v
            states[w] = (m_new, l, acc * alpha[:, None] + pv)
    return merge_states(states)


def merge_states(states):
    """Combine ``(m, l, acc)`` states (log2 units) in their order."""
    M = torch.stack([m for m, _, _ in states]).amax(dim=0)
    base = torch.where(torch.isinf(M), torch.zeros_like(M), M)
    L, A = torch.zeros_like(M), torch.zeros_like(states[0][2])
    for m, l, acc in states:
        w = torch.where(torch.isinf(m), torch.zeros_like(m),
                        torch.exp2(m - base))
        L, A = L + l * w, A + acc * w[:, None]
    return M, L, A


def finish(l, acc):
    """The output rows: acc / l, zeros where l == 0."""
    return torch.where(l[:, None] == 0, torch.zeros_like(acc),
                       acc / torch.where(l == 0, torch.ones_like(l), l)[:, None])


def emulate_ragged(q, k_pages, v_pages, desc, per, window=None,
                   route="cuda_core", rounding=False, k_scale=None,
                   v_scale=None):
    """K6's kernel in fp32: the plan, every item's walk, the merge of the
    tokens whose tile spans n >= 2 splits in split order; tokens no row
    claims (or whose tile sees no key) stay zeros."""
    T, H, D = q.shape
    Hkv, bs = k_pages.shape[1:3]
    G = H // Hkv
    bt = np.asarray(desc[0])
    items, info = plan_items(desc, T, G, Hkv, bt.shape[1], per, window,
                             route, bs)
    out = torch.zeros(T, H, D)
    parts = {}
    for it in items:
        m, l, acc = walk_item(q, k_pages, v_pages, bt, it, G, window, route,
                              rounding, k_scale, v_scale)
        h0, gn = item_heads(it, G)
        for g in range(it["ntok"] * gn):
            tok, head = it["tok0"] + g // gn, h0 + g % gn
            if it["slot"] < 0:
                out[tok, head] = finish(l[g:g + 1], acc[g:g + 1])[0]
            else:
                parts[tok, head, it["slot"]] = (m[g:g + 1], l[g:g + 1],
                                                acc[g:g + 1])
    for tok, (s_lo, n) in info.items():
        if n < 2:
            continue
        for head in range(H):
            _, l, acc = merge_states([parts[tok, head, s]
                                      for s in range(s_lo, s_lo + n)])
            out[tok, head] = finish(l, acc)[0]
    return out


# rows (kind, start, qlen) long enough for several 64-key tiles and splits
SPLIT_ROWS = [("decode", 300, 1), ("chunk", 150, 40), ("idle", 0, 0),
              ("decode", 0, 1), ("chunk", 0, 70), ("decode", 470, 1),
              ("chunk", 200, 3), ("chunk", 90, 2)]
SPLIT_CASES = {
    # name: (rows, window, int8, edit[, shape]); shape: H, Hkv, D and the
    # page size (default 8 query heads over 2 kv heads of 16, pages of 16)
    "mixed": (SPLIT_ROWS, None, False, None),
    "decode_rows": ([("decode", c, 1) for c in (63, 64, 255, 256, 400, 511)],
                    None, False, None),
    "window_empties_splits": (SPLIT_ROWS, 70, False, None),
    "row_sees_no_key": (SPLIT_ROWS, 20, False, "no_key"),
    "int8_pool": (SPLIT_ROWS, None, True, None),
    # a group of 7 (9 tokens a 64-row tile, 4 a 32-row one) on pages of 8;
    # a group of 6 on pages of 24, which neither divide 64 nor are
    # multiples of it; a group of 64 and one of 71 (head chunks of 32 and
    # 36) on pages of 32 and 12; D 256 on an int8 pool
    "g7_bs8": (SPLIT_ROWS[:4], None, False, None, dict(H=14, bs=8)),
    "g6_bs24_window": (SPLIT_ROWS[:4], 70, False, None, dict(H=12, bs=24)),
    "g64_bs32": (SPLIT_ROWS[:4], None, False, None,
                 dict(H=64, Hkv=1, bs=32)),
    "g71_bs12_int8": (SPLIT_ROWS[:4], None, True, None,
                      dict(H=71, Hkv=1, bs=12)),
    "d256_int8": (SPLIT_ROWS[:2], None, True, None,
                  dict(H=2, Hkv=1, D=256)),
}
SPLIT_PARAMS = [(case, per, route) for case in sorted(SPLIT_CASES)
                for per in (1, 2) for route in ("cuda_core", "tensor_core")]


def _split_setup(case, seed=23):
    rows, window, int8, edit, *shape = SPLIT_CASES[case]
    shape = dict(shape[0]) if shape else {}
    bs = shape.pop("bs", PAGE)
    q, pool, desc, segs = mixed_setup(seed, rows, bs=bs, n_pool=2048 // bs,
                                      nb=-(-512 // bs), int8=int8, **shape)
    if edit == "no_key":
        desc[4][0] = 10     # decode row 0 at 300 keeps 10 keys: outside
        #                     its 20-key window, it sees none
    return q, pool, desc, segs, window


@functools.lru_cache(maxsize=None)
def _split_kernel(case):
    """The JAX Pallas kernel (interpret mode) on a case's inputs, once a
    case: it depends on neither the split nor the route."""
    q, pool, desc, _, window = _split_setup(case)
    return np.asarray(jax_ragged(
        jnp.asarray(q), jnp.asarray(pool["k"]), jnp.asarray(pool["v"]),
        *(jnp.asarray(d) for d in desc), interpret=True, force_pallas=True,
        window=window, **{n: jnp.asarray(pool[n]) for n in
                          ("k_scale", "v_scale") if n in pool}))


@pytest.mark.parametrize("case,per,route", SPLIT_PARAMS)
def test_split_walk_merges_to_the_plain_version(case, per, route):
    """The kernel's algorithm (the plan's items, splits of 1 and 2 tiles
    of a 512-key table, each item's walk over pages gathered through the
    table, the lse merge in split order) against the plain version and
    the JAX Pallas kernel (interpret mode), fp32 at 1e-5: decode rows,
    narrow rows of 2 and 3 tokens, chunk rows, the mixed shape, idle rows
    and sentinel table entries, windows, a row that sees no key, an int8
    pool."""
    q, pool, desc, segs, window = _split_setup(case)
    scales = {n: torch.from_numpy(pool[n]) for n in ("k_scale", "v_scale")
              if n in pool}
    tq, tk, tv = (torch.from_numpy(a) for a in (q, pool["k"], pool["v"]))
    got = emulate_ragged(tq, tk, tv, desc, per, window, route, **scales)
    plain = ragged_paged_attention_plain(
        tq, tk, tv, *(torch.from_numpy(d) for d in desc), window=window,
        **scales)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    claimed = _claimed(q.shape[0], segs)
    assert not got[~claimed].any(), "unclaimed tokens stay zeros"
    if SPLIT_CASES[case][3] == "no_key":
        assert not got[segs[0][0]].any(), "a row that sees no key is zeros"
        return
    np.testing.assert_allclose(got.numpy()[claimed],
                               _split_kernel(case)[claimed], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["mixed", "window_empties_splits",
                                  "int8_pool"])
@pytest.mark.parametrize("per", [1, 2])
def test_tensor_core_rounding_points_stay_inside_the_bf16_tolerance(case,
                                                                    per):
    """The tensor-core route's rounding points (bf16 q, K and V; an int8
    pool's codes exact in bf16; P.V as bf16(P) + bf16(P - bf16(P)); the
    output rounded to bf16) against the plain version on the same bf16
    inputs, within the card tests' bf16 tolerance 2**-7 |plain| + 1e-3."""
    q, pool, desc, _, window = _split_setup(case, seed=29)
    scales = {n: torch.from_numpy(pool[n]) for n in ("k_scale", "v_scale")
              if n in pool}
    tq = torch.from_numpy(q).bfloat16()
    tk, tv = (torch.from_numpy(pool[n]) for n in ("k", "v"))
    if not scales:
        tk, tv = tk.bfloat16(), tv.bfloat16()
    got = _bf16(emulate_ragged(tq, tk, tv, desc, per, window, "tensor_core",
                               rounding=True, **scales))
    plain = ragged_paged_attention_plain(
        tq, tk, tv, *(torch.from_numpy(d) for d in desc), window=window,
        **scales).float()
    torch.testing.assert_close(got, plain, rtol=2 ** -7, atol=1e-3)


def order_sensitive_pool():
    """q = 0 (every visible key weighs exactly 1) over a pool whose V rows
    are zero but for 2**25, -2**25 and 1 at the first key of tiles 0, 1
    and 2 of a 192-key context (one token, 4 heads over 1 kv head): every
    in-split sum is exact, and only the split order 0, 1, 2 gives
    ((2**25 - 2**25) + 1) / 192; any other order loses the 1."""
    keys, H, D = 3 * TILE, 4, 16
    n_pages = keys // PAGE
    k = torch.zeros(n_pages + 1, 1, PAGE, D)
    v = torch.zeros(n_pages + 1, 1, PAGE, D)
    for tile, x in enumerate((2.0 ** 25, -2.0 ** 25, 1.0)):
        v[tile * TILE // PAGE, :, 0] = x
    bt = np.arange(n_pages, dtype=np.int32)[None]
    desc = (bt, np.zeros(1, np.int32), np.ones(1, np.int32),
            np.asarray([keys - 1], np.int32), np.asarray([keys], np.int32))
    return torch.zeros(1, H, D), k, v, desc


@pytest.mark.parametrize("route", ["cuda_core", "tensor_core"])
def test_walk_merges_splits_in_order(route):
    """With one tile a split the token's three partials merge in split
    order: the output is exactly 1 / 192 (fp32). The card test
    ``test_paged_walks_merge_splits_in_order`` holds both kernels to the
    same inputs."""
    q, k, v, desc = order_sensitive_pool()
    got = emulate_ragged(q, k, v, desc, per=1, route=route)
    assert torch.equal(got, torch.full_like(got, np.float32(1 / 192)))


def test_launch_comes_from_the_shapes_alone():
    """K6's launch (splits, tiles a split, persistent blocks) at the
    serving shapes (T 263, R 8, nb 128, Hkv 8) on 132 and 114 SMs: a
    function of the shapes and the SM count, with no descriptor among its
    arguments, so one captured launch fits every step."""
    import inspect

    assert list(inspect.signature(launch_params).parameters) == \
        ["T", "R", "nb", "bs", "Hkv", "sm_count"]
    assert launch_params(263, 8, 128, 16, 8, 132) == \
        dict(splits=5, per=7, grid=264)
    assert launch_params(263, 8, 128, 16, 8, 114) == \
        dict(splits=4, per=8, grid=228)
    # the keys are nb * bs: pages of 8 halve them, of 32 double them
    assert launch_params(263, 8, 128, 8, 8, 132) == \
        dict(splits=4, per=4, grid=264)
    assert launch_params(263, 8, 64, 32, 8, 132) == \
        dict(splits=5, per=7, grid=264)
    for T, R, nb, bs, Hkv, sm in ((263, 8, 128, 16, 8, 132),
                                  (7, 3, 10, 16, 2, 114),
                                  (1, 1, 1, 16, 1, 132),
                                  (4096, 64, 512, 16, 8, 132),
                                  (1, 1, 1024, 16, 1, 132),
                                  (263, 8, 86, 24, 4, 132),
                                  (263, 8, 171, 12, 4, 114),
                                  (9, 2, 300, 1, 1, 132)):
        lp = launch_params(T, R, nb, bs, Hkv, sm)
        tiles = -(-nb * bs // TILE)
        assert (lp["splits"] - 1) * lp["per"] < tiles <= \
            lp["splits"] * lp["per"]
        assert 1 <= lp["grid"] <= 2 * sm
    # the plan's items depend on the descriptors; the launch does not
    q, pool, desc, _, _ = _split_setup("mixed")
    a, _ = plan_items(desc, q.shape[0], 4, 2, 32, 2, None, "tensor_core")
    desc2 = tuple(d.copy() for d in desc)
    desc2[4][:] = 1
    b, _ = plan_items(desc2, q.shape[0], 4, 2, 32, 2, None, "tensor_core")
    assert len(a) != len(b)
