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
    ragged_paged_attention, ragged_paged_attention_plain)

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
