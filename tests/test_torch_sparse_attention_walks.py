"""The bf16 tensor-core kernels of K9 (the 64-row slices of
``csrc/block_sparse_attention.cu``) emulated on the CPU: work lists cut
into items of at most C blocks, each item's online softmax over its
64-key tiles, the split rows and columns merged in the items' order, P
and dS rounded to bf16 before their products. The emulation is held to
the plain versions and to the JAX ``sparse_attention`` (its Pallas
kernels in interpret mode) within the card's bf16 tolerance.

The emulations run on one torch thread (``torch_threads.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import sparse_attention as psa
from test_torch_sparse_attention import BLOCK, _config
from torch_threads import one_torch_thread  # noqa: F401


LOG2E = 1.4426950408889634
TILE = 64   # keys (forward, dQ) or queries (dK/dV at D 64) of a tile


def _tiles(layout, h, r, start, n, block, rows):
    """Index tensors of the tiles an item walks: ``rows`` rows of each of
    its ``n`` active blocks from entry ``start``, in the list's order."""
    blocks = np.nonzero(layout[h, r])[0][start:start + n]
    return [torch.arange(b * block + t, b * block + t + rows)
            for b in blocks for t in range(0, block, rows)]


def _emulate_tc_sparse_forward(q, k, v, layout, block, causal, sm_scale,
                               split):
    """The bf16 tensor-core forward's algorithm on the CPU, item by item of
    ``_work_list(cnt, split)``: fp32 scores in log2 units from bf16
    inputs, an online softmax over the item's 64-key tiles in the list's
    order, the row sum from the unrounded P, P rounded to bf16 before
    P.V. An item of a row that is not split normalizes its rows; the items
    of a split row keep (O, m, l) and are merged through their maxima in
    the items' order; a row no item saw keeps zeros and -inf."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    B, H, T, D = qf.shape
    out = torch.zeros(B, H, T, D)
    lse = torch.full((B, H, T), float("-inf"))
    work, merge, _ = bsa._work_list(layout.sum(-1).astype(np.int32), split)

    def finish(h, rows, o, m, l):
        out[:, h, rows] = o / torch.where(l == 0, torch.ones_like(l),
                                          l)[..., None]
        lse[:, h, rows] = torch.where(l == 0, torch.full_like(l, -math.inf),
                                      m * math.log(2.0) + torch.log(l))

    parts = {}
    for h, r, start, n, slot in work:
        rows = torch.arange(r * block, (r + 1) * block)
        m = torch.full((B, block), float("-inf"))
        l = torch.zeros(B, block)
        o = torch.zeros(B, block, D)
        for cols in _tiles(layout, h, r, start, n, block, TILE):
            s = qf[:, h, rows] @ kf[:, h, cols].transpose(-1, -2) \
                * (sm_scale * LOG2E)
            if causal:
                s = s.masked_fill(cols[None] > rows[:, None], float("-inf"))
            mx = torch.maximum(m, s.amax(-1))
            base = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.bfloat16().float() @ vf[:, h, cols]
            m = mx
        if slot < 0:
            finish(h, rows, o, m, l)
        else:
            parts[slot] = (o, m, l)
    for h, r, slot0, k_items in merge:
        items = [parts[slot0 + c] for c in range(k_items)]
        mx = torch.stack([m for _, m, _ in items]).amax(0)
        o, l = torch.zeros_like(items[0][0]), torch.zeros_like(mx)
        for oc, mc, lc in items:
            a = torch.where(torch.isinf(mx), torch.zeros_like(mx),
                            torch.exp2(mc - mx))
            o, l = o + a[..., None] * oc, l + a * lc
        finish(h, torch.arange(r * block, (r + 1) * block), o, mx, l)
    return out.transpose(1, 2).to(q.dtype), lse


def _emulate_tc_sparse_backward(q, k, v, out, lse, do, layout, block, causal,
                                sm_scale, split):
    """The bf16 dQ and dK/dV kernels' algorithm: P (from lse; -inf gives
    zeros) and dS in fp32 from bf16 inputs, each rounded to bf16 before its
    product; dQ summed over an item's key tiles, dK and dV over its query
    tiles (of the transposed lists), in the lists' order; the partials of
    a split row or column summed in the items' order, then scaled."""
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    B, H, T, D = qf.shape
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    seen = torch.as_tensor(layout != 0).repeat_interleave(block, 1) \
        .repeat_interleave(block, 2)
    if causal:
        seen = seen & torch.ones(T, T, dtype=torch.bool).tril()
    lse2 = torch.where(torch.isinf(lse), torch.full_like(lse, math.inf),
                       lse) * LOG2E
    s = (qf @ kf.transpose(-1, -2)) * (sm_scale * LOG2E)
    p = torch.exp2(s - lse2[..., None]).masked_fill(~seen[None], 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    grads = [torch.zeros(B, H, T, D) for _ in range(3)]   # dq, dk, dv

    def walk(lists, tile, item_sums, outputs):
        work, merge, _ = bsa._work_list(lists.sum(-1).astype(np.int32),
                                        split)
        parts = {}
        for h, r, start, n, slot in work:
            own = torch.arange(r * block, (r + 1) * block)
            sums = [torch.zeros(B, block, D) for _ in outputs]
            for other in _tiles(lists, h, r, start, n, block, tile):
                for acc, x in zip(sums, item_sums(h, own, other)):
                    acc += x
            if slot < 0:
                for g, acc, c in zip(outputs, sums, (sm_scale, 1.0)):
                    grads[g][:, h, own] = acc * c
            else:
                parts[slot] = sums
        for h, r, slot0, k_items in merge:
            own = torch.arange(r * block, (r + 1) * block)
            for i, (g, c) in enumerate(zip(outputs, (sm_scale, 1.0))):
                acc = torch.zeros(B, block, D)
                for j in range(k_items):
                    acc += parts[slot0 + j][i]
                grads[g][:, h, own] = acc * c

    walk(layout, TILE, lambda h, rows, cols: (
        dsb[:, h][:, rows][..., cols] @ kf[:, h, cols],), (0,))
    walk(np.swapaxes(layout, 1, 2), TILE if D == 64 else 32,
         lambda h, keys, rows: (
             dsb[:, h][:, rows][..., keys].transpose(-1, -2) @ qf[:, h, rows],
             pb[:, h][:, rows][..., keys].transpose(-1, -2)
             @ dof[:, h, rows]), (1, 2))
    return tuple(g.transpose(1, 2).to(q.dtype) for g in grads)


def _within_bf16_tolerance(got, want, name):
    """chip_smoke.check_block_sparse_attention's bf16 tolerance:
    |got - want| <= 2**-7 |want| + 2e-2."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= 2 ** -7 * np.abs(want) + 2e-2).all(), \
        f"{name}: max |err| {err.max():.3e}"


def _bf16_inputs(T, seed, H=2, D=64):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(1, T, H, D).astype(
        np.float32)).bfloat16() for _ in range(4))


@pytest.mark.parametrize("name,causal", [("bigbird", False),
                                         ("bigbird", True),
                                         ("bslongformer", True)],
                         ids=["bigbird_full", "bigbird_causal",
                              "bslongformer_causal"])
def test_tensor_core_split_walks_stay_inside_the_bf16_tolerance(name,
                                                                causal):
    """The bf16 kernels' algorithm, with walks longer than C = 8 cut into
    items and merged (BigBird's global row and column, BSLongformer's
    global column: degree 32 at T 2048, block 64), keeps the forward, lse
    and the three gradients inside the card's bf16 tolerance, against the
    plain versions and against the JAX ``sparse_attention`` (its Pallas
    kernels in interpret mode) on the same inputs (B 1, H 2, D 64)."""
    T, split, sm = 2048, 8, 1.0 / 8.0
    layout = bsa._causal_layout(_config(psa, name).make_layout(T), causal)
    q, k, v, do = _bf16_inputs(T, seed=21)
    rows = bsa._work_list(bsa.layout_indices(layout)[1], split)
    cols = bsa._work_list(
        bsa.layout_indices(np.swapaxes(layout, 1, 2))[1], split)
    assert cols[2] > 0 and (rows[2] > 0 or name == "bslongformer")

    out, lse = _emulate_tc_sparse_forward(q, k, v, layout, BLOCK, causal,
                                          sm, split)
    grads = _emulate_tc_sparse_backward(q, k, v, out, lse, do, layout, BLOCK,
                                        causal, sm, split)
    ref_out, ref_lse = bsa.block_sparse_attention_fwd_plain(
        q, k, v, layout, BLOCK, causal, sm)
    args = (q, k, v, out, lse, do, layout, BLOCK, causal, sm)
    ref_grads = (bsa.block_sparse_attention_bwd_dq_plain(*args),
                 *bsa.block_sparse_attention_bwd_dkv_plain(*args))
    _within_bf16_tolerance(out.float(), ref_out.float(), "out vs plain")
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for label, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _within_bf16_tolerance(g.float(), r.float(), f"{label} vs plain")

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, do))

    def jax_loss(q, k, v):
        o = jsa.sparse_attention(q, k, v, sparsity_config=_config(jsa, name),
                                 causal=causal, sm_scale=sm,
                                 force_pallas=True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32)), o

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    _within_bf16_tolerance(out.float(), jout.astype(jnp.float32),
                           "out vs JAX")
    for label, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        _within_bf16_tolerance(g.float(), r.astype(jnp.float32),
                               f"{label} vs JAX")


def test_split_walks_keep_zeros_and_minus_inf_for_rows_that_see_no_key():
    """The cases of ``test_rows_that_see_no_key_get_zeros`` through the
    emulated bf16 algorithm with C = 1: the empty row is one item of no
    entries (zeros, lse = -inf, zero dQ), the full row is split into two
    items whose merge matches the plain version."""
    q, k, v, do = _bf16_inputs(2 * BLOCK, seed=22, H=1)
    layout = np.asarray([[[0, 0], [1, 1]]])
    work, merge, slots = bsa._work_list(layout.sum(-1), 1)
    assert work.tolist() == [[0, 1, 0, 1, 0], [0, 1, 1, 1, 1],
                             [0, 0, 0, 0, -1]]
    assert merge.tolist() == [[0, 1, 0, 2]] and slots == 2
    out, lse = _emulate_tc_sparse_forward(q, k, v, layout, BLOCK, False,
                                          0.125, 1)
    assert not out[0, :BLOCK].any() and torch.isinf(lse[0, 0, :BLOCK]).all()
    assert (lse[0, 0, :BLOCK] < 0).all()
    ref_out, ref_lse = bsa.block_sparse_attention_fwd_plain(
        q, k, v, layout, BLOCK, False, 0.125)
    _within_bf16_tolerance(out.float(), ref_out.float(), "out vs plain")
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    dq, dk, dv = _emulate_tc_sparse_backward(q, k, v, out, lse, do, layout,
                                             BLOCK, False, 0.125, 1)
    assert not dq[0, :BLOCK].any()
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    ref_dq = bsa.block_sparse_attention_bwd_dq_plain(
        q, k, v, out, lse, do, layout, BLOCK, False, 0.125)
    _within_bf16_tolerance(dq.float(), ref_dq.float(), "dq vs plain")
