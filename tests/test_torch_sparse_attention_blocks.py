"""K9's whole domain on the CPU: blocks of every multiple of 16 (the
16-row strips of ``csrc/block_sparse_strips.cu``), block 256 and head dims
80, 96 and 256, against the JAX package; the strip route's algorithm
emulated; the host-side lists built without per-row loops.

The same numpy-seeded inputs (B 2, H 2, T <= 512) go through the JAX
package and the port's plain versions on CPU tensors. Tolerances as in
``tests/test_torch_sparse_attention.py``: the forward 3e-5 against JAX
``sparse_attention(..., force_pallas=True)`` (the Pallas kernel in
interpret mode), ``lse`` and the backward passes 1e-5 against its
``_fwd`` / ``_bwd`` (interpret mode), the gradients 1e-4 against
``jax.grad`` of its reference: the two differ only in summation order.
The strip emulation is held to the card's bf16 tolerance
(``2**-7 |want| + 2e-2``) against the plain versions and the JAX
reference.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import sparse_attention as psa

from test_torch_sparse_attention import CONFIGS, _config
from torch_threads import one_torch_thread  # noqa: F401

LOG2E = 1.4426950408889634

# (block, head dim): the strips' blocks at D 64, a strip block at D 256,
# and the slices at the new head dims
SHAPES = [(16, 64), (32, 64), (48, 64), (64, 80), (64, 96), (64, 256),
          (16, 256)]


def _ids(shapes):
    return [f"block{b}_d{d}" for b, d in shapes]


def _inputs(T, D, B=2, H=2, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))


def _length(block):
    """T for a block: 8 blocks, at most 512 tokens."""
    return min(8 * block, 512)


def _bhtd(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))


def _jax_lists(layout):
    return [jnp.asarray(a) for a in jbsa.layout_indices(layout)
            + jbsa.layout_indices(np.swapaxes(layout, 1, 2))]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block,D", SHAPES, ids=_ids(SHAPES))
def test_forward_matches_the_pallas_kernel(block, D, causal):
    T = _length(block)
    q, k, v, _ = _inputs(T, D)
    want = jsa.sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                sparsity_config=_config(jsa, "bigbird",
                                                        block=block),
                                causal=causal, force_pallas=True)
    got = psa.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               sparsity_config=_config(psa, "bigbird",
                                                       block=block),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block,D", SHAPES[:6], ids=_ids(SHAPES[:6]))
def test_lse_and_backward_passes_match_the_pallas_kernels(block, D, causal):
    """The plain forward's ``lse`` and the plain dQ and dK/dV, given the
    same ``out``, ``lse`` and ``dout``, against the Pallas kernels."""
    T = _length(block)
    q, k, v, do = _inputs(T, D, seed=1)
    layout = bsa._causal_layout(
        _config(psa, "fixed_per_head", block=block).make_layout(T), causal)
    sm = 1.0 / math.sqrt(D)
    kv_idx, kv_cnt, q_idx, q_cnt = _jax_lists(layout)
    jq, jk, jv, jdo = (_bhtd(a) for a in (q, k, v, do))
    jout, jlse = jbsa._fwd(jq, jk, jv, kv_idx, kv_cnt, sm, causal, block,
                           block, True)
    jdq, jdk, jdv = jbsa._bwd((jq, jk, jv, jout, jlse), jdo, kv_idx, kv_cnt,
                              q_idx, q_cnt, sm, causal, block, block, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    _, lse = bsa.block_sparse_attention_fwd(tq, tk, tv, layout, block,
                                            causal, sm)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    out = torch.from_numpy(np.array(jnp.transpose(jout, (0, 2, 1, 3))))
    lse = torch.from_numpy(np.array(jlse))
    dq = bsa.block_sparse_attention_bwd_dq(tq, tk, tv, out, lse, tdo, layout,
                                           block, causal, sm)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(tq, tk, tv, out, lse, tdo,
                                                layout, block, causal, sm)
    for got, want, label in ((dq, jdq, "dq"), (dk, jdk, "dk"),
                             (dv, jdv, "dv")):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jnp.transpose(want, (0, 2, 1, 3))),
            rtol=1e-5, atol=1e-5, err_msg=label)


GRAD_SHAPES = [(16, 64), (48, 80), (32, 96), (32, 256)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("block,D", GRAD_SHAPES, ids=_ids(GRAD_SHAPES))
def test_gradients_match_jax_grad_of_the_reference(block, D, causal):
    T = _length(block)
    q, k, v, do = _inputs(T, D, seed=2)
    layout = bsa._causal_layout(
        _config(psa, "bslongformer", block=block).make_layout(T), causal)
    sm = 1.0 / math.sqrt(D)

    def jax_loss(q, k, v):
        out = jbsa._reference_sparse(q, k, v, layout, block, causal, sm)
        return jnp.sum(out * do)

    grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = psa.sparse_attention(
        *leaves, sparsity_config=_config(psa, "bslongformer", block=block),
        causal=causal)
    out.backward(torch.from_numpy(do))
    for t, g, label in zip(leaves, grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{label}")


def test_deepspeed_default_config_matches_the_pallas_kernel():
    """DeepSpeed's default sparse-attention config (Fixed, block 16, 4
    local blocks and 1 global one, bidirectional) through both packages."""
    T, D = 512, 64
    q, k, v, _ = _inputs(T, D, seed=3)
    want = jsa.sparse_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        sparsity_config=jsa.FixedSparsityConfig(num_heads=2, block=16),
        causal=False, force_pallas=True)
    got = psa.sparse_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        sparsity_config=psa.FixedSparsityConfig(num_heads=2, block=16),
        causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


# ---------------------------------------------------------------------------
# the host-side lists: vectorized, bit-identical to the loops they replace
# ---------------------------------------------------------------------------

def _loop_layout_indices(layout):
    """``layout_indices`` as a loop over every (head, row)."""
    H, R, _ = layout.shape
    cnt = layout.sum(-1).astype(np.int32)
    A = int(cnt.max())
    idx = np.zeros((H, R, A), np.int32)
    for h in range(H):
        for r in range(R):
            active = np.nonzero(layout[h, r])[0]
            idx[h, r, :len(active)] = active
            idx[h, r, len(active):] = active[-1]
    return idx, cnt


def _loop_work_list(cnt, split):
    """``_work_list`` as a loop over every (head, row)."""
    items, merge, slots = [], [], 0
    for h, r in np.ndindex(*cnt.shape):
        n = int(cnt[h, r])
        if n <= split:
            items.append((h, r, 0, n, -1))
            continue
        k = -(-n // split)
        merge.append((h, r, slots, k))
        items += [(h, r, c * split, min(split, n - c * split), slots + c)
                  for c in range(k)]
        slots += k
    items.sort(key=lambda item: -item[3])
    return (np.asarray(items, np.int32).reshape(-1, 5),
            np.asarray(merge, np.int32).reshape(-1, 4), slots)


@pytest.mark.parametrize("block", [16, 32])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_vectorized_lists_are_bit_identical_to_the_loops(name, block):
    """For every layout of the sparse-attention tests at blocks of 16 and
    32, causally cut or not, rows and columns: ``layout_indices`` equals
    the loop version and the JAX package's, and ``_work_list`` the loop
    version at C 3 and at the strips' split."""
    for H, T in ((1, 512), (3, 1024)):
        raw = _config(psa, name, H, block=block).make_layout(T)
        for causal in (False, True):
            cut = bsa._causal_layout(raw, causal)
            for layout in (cut, np.swapaxes(cut, 1, 2)):
                if (layout.sum(-1) == 0).any():
                    continue
                idx_cnt = bsa.layout_indices(layout)
                for want in (_loop_layout_indices(layout),
                             jbsa.layout_indices(layout)):
                    for a, b in zip(idx_cnt, want):
                        assert a.dtype == b.dtype
                        np.testing.assert_array_equal(a, b)
                for split in (3, bsa._split(block)):
                    got = bsa._work_list(idx_cnt[1], split)
                    want = _loop_work_list(idx_cnt[1], split)
                    for a, b in zip(got[:2], want[:2]):
                        assert a.dtype == b.dtype
                        np.testing.assert_array_equal(a, b)
                    assert got[2] == want[2]


def test_work_list_keeps_empty_rows_and_weighted_layouts():
    """An empty row stays one item of no entries (a kernel wrapper called
    directly with such a layout writes zeros), and the vectorized
    ``layout_indices`` pads like the loop where ``sum`` and the count of
    nonzero entries differ (a layout of 0/2 values)."""
    cnt = np.asarray([[0, 5, 1], [7, 0, 3]], np.int32)
    for split in (1, 2, 5, 8):
        for a, b in zip(bsa._work_list(cnt, split),
                        _loop_work_list(cnt, split)):
            np.testing.assert_array_equal(a, b)
    layout = np.asarray([[[2, 0, 2], [0, 2, 0], [2, 2, 2]]])
    for a, b in zip(bsa.layout_indices(layout),
                    _loop_layout_indices(layout)):
        np.testing.assert_array_equal(a, b)


def test_split_is_counted_in_keys_on_the_strips():
    assert [bsa._split(b) for b in (16, 32, 48, 80, 64, 128, 256)] == \
        [128, 64, 42, 25, 16, 16, 16]
    assert [bsa.kernel_route(torch.bfloat16, b) for b in (16, 48, 64, 256)] \
        == ["strips", "strips", "tiles", "tiles"]
    assert bsa.kernel_route(torch.float32, 16) == "fp32"


def test_lists_of_the_caches_own_layouts_are_found_by_identity(monkeypatch):
    """A built-in config's layout and its causal cut are made once and kept
    read-only; their lists are found by the array's identity (the bits
    are not read again), while a caller's array is keyed by its bits, so
    an array changed in place between two calls gets its own lists."""
    cfg = psa.FixedSparsityConfig(num_heads=2, block=16)
    bsa._indices_cache.clear()
    bsa._layout_cache.clear()
    bsa._cut_cache.clear()
    q = torch.randn(1, 256, 2, 64)
    first = psa.sparse_attention(q, q, q, sparsity_config=cfg, causal=True)
    raw = bsa._config_layout(cfg, 256)
    cut = bsa._cut(raw, True)
    assert not raw.flags.writeable and not cut.flags.writeable
    assert bsa._cut(raw, True) is cut and bsa._cut(raw, False) is raw
    packbits = np.packbits

    def refuse(*args, **kw):
        raise AssertionError("the bits of an own layout were read")

    monkeypatch.setattr(np, "packbits", refuse)
    rows, cols = bsa._indices(cut, True, "cpu", 16)
    assert len(bsa._indices_cache) == 1
    again = psa.sparse_attention(q, q, q, sparsity_config=cfg, causal=True)
    torch.testing.assert_close(again, first, rtol=0, atol=0)
    monkeypatch.setattr(np, "packbits", packbits)

    mine = np.array(cut)                   # a caller's writeable copy
    r1, _ = bsa._indices(mine, True, "cpu", 16)
    assert len(bsa._indices_cache) == 2
    torch.testing.assert_close(r1.idx, rows.idx)
    mine[:, :, 1] = 1                      # changed in place
    r2, _ = bsa._indices(mine, True, "cpu", 16)
    assert len(bsa._indices_cache) == 3
    assert not torch.equal(r2.cnt, r1.cnt)
    # the same array at another route's split is another entry
    bsa._indices(cut, True, "cpu", 64)
    assert len(bsa._indices_cache) == 4


def test_kernel_domain_takes_every_multiple_of_16_and_five_head_dims():
    """``_check_kernel_domain`` (the CUDA tensors' check, called directly):
    blocks 16 … 256 and head dims 64, 80, 96, 128, 256 pass in bf16 and
    fp32; a block of 8 or 40 and a head dim of 72 raise, saying why."""
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 80, 96, 128, 256):
            q = torch.zeros(1, 16, 2, D, dtype=dtype)
            for block in (16, 32, 48, 64, 80, 128, 256):
                bsa._check_kernel_domain("k9", q, q, q, block)
    q = torch.zeros(1, 16, 2, 64, dtype=torch.bfloat16)
    for block in (8, 40):
        with pytest.raises(ValueError, match="multiple of 16") as err:
            bsa._check_kernel_domain("k9", q, q, q, block)
        assert "m16n8k16" in str(err.value) and "ROADMAP" not in \
            str(err.value)
    q = torch.zeros(1, 16, 2, 72, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim in") as err:
        bsa._check_kernel_domain("k9", q, q, q, 16)
    assert "ROADMAP" not in str(err.value)


# ---------------------------------------------------------------------------
# the strips (bf16, blocks that are not a multiple of 64), emulated
# ---------------------------------------------------------------------------

STRIP = bsa.STRIP


def _steps(layout, h, r, start, n, block):
    """Index tensors of the 16-key (16-query) steps of an item's ``n``
    active blocks from entry ``start``, in the list's order."""
    blocks = np.nonzero(layout[h, r])[0][start:start + n]
    return [torch.arange(b * block + t, b * block + t + STRIP)
            for b in blocks for t in range(0, block, STRIP)]


def _emulate_strip_forward(q, k, v, layout, block, causal, sm_scale, split):
    """``strip_fwd_kernel`` + ``merge_fwd_kernel`` on the CPU: each warp
    one 16-row strip of an item of ``_work_list(cnt, split)``; fp32 scores
    in log2 units from bf16 inputs; the steps at or before the strip (a
    prefix of the walk when causal), the diagonal step masked per element;
    an online softmax every 16 keys, the row sum from the unrounded P, P
    rounded to bf16 before P.V; a whole walk normalizes its rows, the
    strips of a split walk keep (O, m, l) and are merged through their
    maxima in the items' order; a row no item saw keeps zeros and -inf."""
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
        for s in range(block // STRIP):
            row0 = r * block + s * STRIP
            rows = torch.arange(row0, row0 + STRIP)
            steps = _steps(layout, h, r, start, n, block)
            if causal:
                steps = [c for c in steps if int(c[0]) <= row0]
            m = torch.full((B, STRIP), float("-inf"))
            l = torch.zeros(B, STRIP)
            o = torch.zeros(B, STRIP, D)
            for cols in steps:
                sc = qf[:, h, rows] @ kf[:, h, cols].transpose(-1, -2) \
                    * (sm_scale * LOG2E)
                if causal and int(cols[0]) == row0:
                    sc = sc.masked_fill(cols[None] > rows[:, None],
                                        float("-inf"))
                mx = torch.maximum(m, sc.amax(-1))
                base = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
                alpha = torch.exp2(m - base)
                p = torch.exp2(sc - base[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + p.bfloat16().float() @ vf[:, h,
                                                                      cols]
                m = mx
            if slot < 0:
                finish(h, rows, o, m, l)
            else:
                parts[slot, s] = (o, m, l)
    for h, r, slot0, k_items in merge:
        for s in range(block // STRIP):
            rows = torch.arange(r * block + s * STRIP,
                                r * block + (s + 1) * STRIP)
            items = [parts[slot0 + c, s] for c in range(k_items)]
            mx = torch.stack([m for _, m, _ in items]).amax(0)
            o, l = torch.zeros_like(items[0][0]), torch.zeros_like(mx)
            for oc, mc, lc in items:
                a = torch.where(torch.isinf(mx), torch.zeros_like(mx),
                                torch.exp2(mc - mx))
                o, l = o + a[..., None] * oc, l + a * lc
            finish(h, rows, o, mx, l)
    return out.transpose(1, 2).to(q.dtype), lse


def _emulate_strip_backward(q, k, v, out, lse, do, layout, block, causal,
                            sm_scale, split):
    """``strip_dq_kernel`` and ``strip_dkv_kernel`` (+ ``merge_sum_kernel``)
    on the CPU: P from lse (-inf gives zeros) and dS in fp32 from bf16
    inputs, each rounded to bf16 before its product; dQ summed over a
    strip's 16-key steps, dK and dV over a key strip's 16-query steps (the
    transposed lists), in the lists' order; the partials of a split walk
    summed in the items' order, then scaled."""
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

    def walk(lists, transposed, step_sums, outputs):
        work, merge, _ = bsa._work_list(lists.sum(-1).astype(np.int32),
                                        split)
        parts = {}
        for h, r, start, n, slot in work:
            for st in range(block // STRIP):
                own0 = r * block + st * STRIP
                own = torch.arange(own0, own0 + STRIP)
                steps = _steps(lists, h, r, start, n, block)
                if causal:
                    steps = [x for x in steps if (int(x[0]) >= own0
                                                  if transposed else
                                                  int(x[0]) <= own0)]
                sums = [torch.zeros(B, STRIP, D) for _ in outputs]
                for other in steps:
                    for acc, x in zip(sums, step_sums(h, own, other)):
                        acc += x
                if slot < 0:
                    for g, acc, c in zip(outputs, sums, (sm_scale, 1.0)):
                        grads[g][:, h, own] = acc * c
                else:
                    parts[slot, st] = sums
        for h, r, slot0, k_items in merge:
            for st in range(block // STRIP):
                own = torch.arange(r * block + st * STRIP,
                                   r * block + (st + 1) * STRIP)
                for i, (g, c) in enumerate(zip(outputs, (sm_scale, 1.0))):
                    acc = torch.zeros(B, STRIP, D)
                    for j in range(k_items):
                        acc += parts[slot0 + j, st][i]
                    grads[g][:, h, own] = acc * c

    walk(layout, False, lambda h, rows, cols: (
        dsb[:, h][:, rows][..., cols] @ kf[:, h, cols],), (0,))
    walk(np.swapaxes(layout, 1, 2), True, lambda h, keys, rows: (
        dsb[:, h][:, rows][..., keys].transpose(-1, -2) @ qf[:, h, rows],
        pb[:, h][:, rows][..., keys].transpose(-1, -2) @ dof[:, h, rows]),
        (1, 2))
    return tuple(g.transpose(1, 2).to(q.dtype) for g in grads)


def _within_bf16_tolerance(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= 2 ** -7 * np.abs(want) + 2e-2).all(), \
        f"{name}: max |err| {err.max():.3e}"


def _bf16(T, D, seed, H=2):
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(1, T, H, D).astype(
        np.float32)).bfloat16() for _ in range(4))


STRIP_CASES = [("bigbird", 16, 64, False), ("bigbird", 32, 64, True),
               ("bslongformer", 48, 80, True), ("fixed_per_head", 16, 96,
                                                True)]


@pytest.mark.parametrize("name,block,D,causal", STRIP_CASES,
                         ids=[f"{n}_block{b}_d{d}_{'causal' if c else 'full'}"
                              for n, b, d, c in STRIP_CASES])
def test_strip_walks_stay_inside_the_bf16_tolerance(name, block, D, causal):
    """The strips' algorithm with walks longer than 3 blocks cut into items
    and merged (BigBird's global row and column, the windows of the
    others): the forward, lse and the three gradients inside the card's
    bf16 tolerance against the plain versions and the JAX reference on the
    same inputs (B 1, H 2, T 8 blocks)."""
    T, split = 8 * block, 3
    sm = 1.0 / math.sqrt(D)
    layout = bsa._causal_layout(
        _config(psa, name, block=block).make_layout(T), causal)
    q, k, v, do = _bf16(T, D, seed=31)
    assert bsa._work_list(bsa.layout_indices(
        np.swapaxes(layout, 1, 2))[1], split)[2] > 0

    out, lse = _emulate_strip_forward(q, k, v, layout, block, causal, sm,
                                      split)
    grads = _emulate_strip_backward(q, k, v, out, lse, do, layout, block,
                                    causal, sm, split)
    ref_out, ref_lse = bsa.block_sparse_attention_fwd_plain(
        q, k, v, layout, block, causal, sm)
    args = (q, k, v, out, lse, do, layout, block, causal, sm)
    ref_grads = (bsa.block_sparse_attention_bwd_dq_plain(*args),
                 *bsa.block_sparse_attention_bwd_dkv_plain(*args))
    _within_bf16_tolerance(out.float(), ref_out.float(), "out vs plain")
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for label, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _within_bf16_tolerance(g.float(), r.float(), f"{label} vs plain")

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, do))

    def jax_loss(q, k, v):
        o = jbsa._reference_sparse(q, k, v, layout, block, causal, sm)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32)), o

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    _within_bf16_tolerance(out.float(), jout.astype(jnp.float32),
                           "out vs JAX")
    for label, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        _within_bf16_tolerance(g.float(), r.astype(jnp.float32),
                               f"{label} vs JAX")


def test_strips_keep_zeros_and_minus_inf_for_rows_that_see_no_key():
    """A layout with an empty row (a direct kernel call) at block 16 with
    C = 1: the empty row's strip is one item of no entries (zeros, lse =
    -inf, zero dQ); the full row is split into two items whose merge
    matches the plain version; the causal diagonal step masks per
    element."""
    q, k, v, do = _bf16(32, 64, seed=32, H=1)
    layout = np.asarray([[[0, 0], [1, 1]]])
    for causal in (False, True):
        out, lse = _emulate_strip_forward(q, k, v, layout, 16, causal,
                                          0.125, 1)
        assert not out[0, :16].any() and torch.isinf(lse[0, 0, :16]).all()
        assert (lse[0, 0, :16] < 0).all()
        ref_out, ref_lse = bsa.block_sparse_attention_fwd_plain(
            q, k, v, layout, 16, causal, 0.125)
        _within_bf16_tolerance(out.float(), ref_out.float(), "out vs plain")
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
        dq, dk, dv = _emulate_strip_backward(q, k, v, out, lse, do, layout,
                                             16, causal, 0.125, 1)
        assert not dq[0, :16].any()
        assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
        ref = (bsa.block_sparse_attention_bwd_dq_plain(
            q, k, v, out, lse, do, layout, 16, causal, 0.125),
            *bsa.block_sparse_attention_bwd_dkv_plain(
                q, k, v, out, lse, do, layout, 16, causal, 0.125))
        for label, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
            _within_bf16_tolerance(g.float(), r.float(), label)
