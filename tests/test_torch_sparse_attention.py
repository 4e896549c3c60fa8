"""The port's block-sparse attention (K9 plain versions) against the JAX
package, and the bf16 kernels' algorithm (work lists, split walks,
rounding points) emulated on the CPU.

The bf16 kernels' walks are emulated in
``test_torch_sparse_attention_walks.py`` (a file of their own, so that
pytest-xdist's ``--dist loadfile`` runs the two halves on two workers).

The layouts of every ``SparsityConfig`` and their active lists must be
bit-identical in both packages (the random blocks depend on the order of
the ``rng.choice`` calls). The same numpy-seeded inputs (B 2, T 256, H 2,
D 64, block 64, fp32) go through JAX ``sparse_attention(...,
force_pallas=True)`` (the Pallas kernel in interpret mode, as
``tests/unit/test_sparse_attention.py`` runs it) and through the port's
``sparse_attention`` on CPU tensors, which runs the plain forward and the
plain backward of the ``autograd.Function``. Tolerance: the forward 3e-5,
as the JAX package's own test; ``lse`` and the backward passes against
the Pallas kernels (``_fwd`` / ``_bwd``, interpret mode) 1e-5, and the
gradients against ``jax.grad`` of the JAX reference 1e-4: the two differ
only in summation order.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import block_sparse_attention as jbsa
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import sparse_attention as psa
from torch_threads import one_torch_thread  # noqa: F401

BLOCK = 64
CONFIGS = {
    "fixed": dict(cls="FixedSparsityConfig", num_local_blocks=2,
                  num_global_blocks=1),
    "fixed_per_head": dict(cls="FixedSparsityConfig", num_local_blocks=2,
                           num_global_blocks=1,
                           different_layout_per_head=True,
                           num_different_global_patterns=2),
    "fixed_unidirectional": dict(cls="FixedSparsityConfig",
                                 num_local_blocks=4, num_global_blocks=2,
                                 attention="unidirectional"),
    "variable": dict(cls="VariableSparsityConfig", num_random_blocks=1,
                     local_window_blocks=[1, 2], global_block_indices=[0]),
    "variable_per_head": dict(cls="VariableSparsityConfig",
                              num_random_blocks=2,
                              local_window_blocks=[2, 1, 3],
                              global_block_indices=[1],
                              global_block_end_indices=[3],
                              horizontal_global_attention=True,
                              different_layout_per_head=True, seed=5),
    "bigbird": dict(cls="BigBirdSparsityConfig", num_random_blocks=1,
                    num_sliding_window_blocks=3, num_global_blocks=1),
    "bigbird_per_head": dict(cls="BigBirdSparsityConfig",
                             num_random_blocks=2,
                             num_sliding_window_blocks=5,
                             num_global_blocks=2,
                             different_layout_per_head=True, seed=3),
    "bslongformer": dict(cls="BSLongformerSparsityConfig",
                         num_sliding_window_blocks=3,
                         global_block_indices=[0]),
    "bslongformer_ranges": dict(cls="BSLongformerSparsityConfig",
                                num_sliding_window_blocks=5,
                                global_block_indices=[0, 5],
                                global_block_end_indices=[2, 7],
                                attention="unidirectional"),
    "dense": dict(cls="DenseSparsityConfig"),
}
# the five the JAX package's own kernel test covers, plus per-head layouts
KERNEL_CONFIGS = ["fixed", "variable", "bigbird", "bslongformer", "dense",
                  "fixed_per_head", "bigbird_per_head"]


def _config(pkg, name, num_heads=2, block=BLOCK):
    kw = dict(CONFIGS[name])
    return getattr(pkg, kw.pop("cls"))(num_heads=num_heads, block=block,
                                       **kw)


def _inputs(B=2, T=256, H=2, D=64, seed=0):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(B, T, H, D).astype(np.float32) for _ in range(4))


def _bhtd(x):
    return jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))


def test_exports_match_the_jax_module():
    want = {n for n in dir(jsa) if not n.startswith("_")} - {
        "sparsity_config"}
    got = {n for n in dir(psa) if not n.startswith("_")} - {
        "sparsity_config"}
    assert got == want
    assert "sparse_attention" in got and "SparsityConfig" in got


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_layouts_and_lists_are_bit_identical(name):
    for H in (1, 2, 3):
        for T in (256, 512, 1024, 64 * 24):
            want = _config(jsa, name, H).make_layout(T)
            got = _config(psa, name, H).make_layout(T)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            for layout in (want, np.swapaxes(want, 1, 2),
                           want * np.tril(np.ones(want.shape[1:], np.int64))):
                if (layout.sum(-1) == 0).any():
                    continue
                for a, b in zip(bsa.layout_indices(layout),
                                jbsa.layout_indices(layout)):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_layout_indices_padding_and_empty_row():
    layout = np.asarray([[[1, 0, 1, 0], [0, 1, 0, 0],
                          [1, 1, 1, 1], [0, 0, 1, 1]]])
    idx, cnt = bsa.layout_indices(layout)
    assert cnt.tolist() == [[2, 1, 4, 2]]
    assert idx[0, 0].tolist() == [0, 2, 2, 2]
    for fn in (bsa.layout_indices, jbsa.layout_indices):
        with pytest.raises(ValueError, match="empty row"):
            fn(np.zeros((1, 2, 2), np.int64))


@pytest.mark.parametrize("name", KERNEL_CONFIGS)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_matches_the_pallas_kernel(name, causal):
    q, k, v, _ = _inputs()
    want = jsa.sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                sparsity_config=_config(jsa, name),
                                causal=causal, force_pallas=True)
    got = psa.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               sparsity_config=_config(psa, name),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def _jax_lists(layout):
    return [jnp.asarray(a) for a in jbsa.layout_indices(layout)
            + jbsa.layout_indices(np.swapaxes(layout, 1, 2))]


@pytest.mark.parametrize("name", ["bigbird", "fixed_per_head", "dense"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_lse_and_backward_passes_match_the_pallas_kernels(name, causal):
    """The plain forward's ``lse`` and the plain dQ and dK/dV, given the
    same ``out``, ``lse`` and ``dout``, against the Pallas kernels."""
    q, k, v, do = _inputs(seed=1)
    layout = bsa._causal_layout(_config(psa, name).make_layout(256), causal)
    sm = 1.0 / 8.0
    kv_idx, kv_cnt, q_idx, q_cnt = _jax_lists(layout)
    jq, jk, jv, jdo = (_bhtd(a) for a in (q, k, v, do))
    jout, jlse = jbsa._fwd(jq, jk, jv, kv_idx, kv_cnt, sm, causal, BLOCK,
                           BLOCK, True)
    jdq, jdk, jdv = jbsa._bwd((jq, jk, jv, jout, jlse), jdo, kv_idx, kv_cnt,
                              q_idx, q_cnt, sm, causal, BLOCK, BLOCK, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = bsa.block_sparse_attention_fwd(tq, tk, tv, layout, BLOCK,
                                              causal, sm)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    out = torch.from_numpy(np.array(jnp.transpose(jout, (0, 2, 1, 3))))
    lse = torch.from_numpy(np.array(jlse))
    dq = bsa.block_sparse_attention_bwd_dq(tq, tk, tv, out, lse, tdo, layout,
                                           BLOCK, causal, sm)
    dk, dv = bsa.block_sparse_attention_bwd_dkv(tq, tk, tv, out, lse, tdo,
                                                layout, BLOCK, causal, sm)
    for got, want, label in ((dq, jdq, "dq"), (dk, jdk, "dk"),
                             (dv, jdv, "dv")):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jnp.transpose(want, (0, 2, 1, 3))),
            rtol=1e-5, atol=1e-5, err_msg=label)


@pytest.mark.parametrize("name", ["bigbird", "bslongformer", "variable"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_gradients_match_jax_grad_of_the_reference(name, causal):
    q, k, v, do = _inputs(seed=2)
    layout = bsa._causal_layout(_config(psa, name).make_layout(256), causal)
    sm = 1.0 / 8.0

    def jax_loss(q, k, v):
        out = jbsa._reference_sparse(q, k, v, layout, BLOCK, causal, sm)
        return jnp.sum(out * do)

    grads = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = psa.sparse_attention(*leaves, sparsity_config=_config(psa, name),
                               causal=causal)
    out.backward(torch.from_numpy(do))
    for t, g, label in zip(leaves, grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{label}")


def test_plain_backward_matches_autograd_of_the_plain_forward():
    """The explicit dQ and dK/dV from the logsumexp (what the K9 backward
    kernels compute) equal autograd through the plain forward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B=1, T=192, D=16,
                                                        seed=3))
    layout = _config(psa, "bigbird", block=32).make_layout(192)
    for causal in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = bsa.block_sparse_attention_fwd_plain(*leaves, layout, 32,
                                                        causal)
        want = torch.autograd.grad(out, leaves, do)
        args = (q, k, v, out.detach(), lse.detach(), do, layout, 32, causal)
        got = (bsa.block_sparse_attention_bwd_dq_plain(*args),
               *bsa.block_sparse_attention_bwd_dkv_plain(*args))
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_global_row_of_degree_nb():
    """Non-causal BigBird: its global rows and columns see every block
    (degree nb in both lists), and the output matches the JAX kernel."""
    q, k, v, _ = _inputs(B=1, T=512, H=1, seed=4)
    layout = _config(psa, "bigbird", num_heads=1).make_layout(512)
    nb = layout.shape[1]
    _, cnt = bsa.layout_indices(layout)
    _, qcnt = bsa.layout_indices(np.swapaxes(layout, 1, 2))
    assert cnt.max() == nb and qcnt.max() == nb and cnt.min() < nb
    want = jsa.sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                layout=layout, causal=False,
                                force_pallas=True)
    got = psa.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               layout=layout, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


def _both_raise(call, match):
    q, k, v, _ = _inputs(B=1, T=250, H=2)
    with pytest.raises(ValueError, match=match) as want:
        call(jsa.sparse_attention, jnp.asarray(q), jnp.asarray(k),
             jnp.asarray(v), dict(force_pallas=True))
    with pytest.raises(ValueError, match=match) as got:
        call(psa.sparse_attention, torch.from_numpy(q), torch.from_numpy(k),
             torch.from_numpy(v), {})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["no_layout", "untiled", "not_square",
                                  "heads", "config_length"])
def test_validation_errors_match_jax(case):
    calls = {
        "no_layout": (lambda f, q, k, v, kw: f(q, k, v, **kw), "need"),
        "untiled": (lambda f, q, k, v, kw: f(
            q, k, v, layout=np.ones((2, 4, 4), np.int64), **kw), "tile"),
        "not_square": (lambda f, q, k, v, kw: f(
            q[:, :200], k[:, :200], v[:, :200],
            layout=np.ones((2, 4, 5), np.int64), **kw), "square"),
        "heads": (lambda f, q, k, v, kw: f(
            q[:, :200], k[:, :200], v[:, :200],
            layout=np.ones((3, 4, 4), np.int64), **kw), "heads"),
        "config_length": (lambda f, q, k, v, kw: f(
            q, k, v, sparsity_config=(jsa if "force_pallas" in kw else psa)
            .BigBirdSparsityConfig(num_heads=2, block=BLOCK), **kw),
            "multiple of block"),
    }
    _both_raise(*calls[case])


def test_empty_row_raises_in_both_packages():
    q, k, v, _ = _inputs(B=1, T=256, H=1)
    layout = np.ones((1, 4, 4), np.int64)
    layout[0, 2] = 0
    with pytest.raises(ValueError, match="empty row") as want:
        jsa.sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             layout=layout, force_pallas=True)
    with pytest.raises(ValueError, match="empty row") as got:
        psa.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                             layout=layout)
    assert str(got.value) == str(want.value)


def test_jax_only_options_and_other_devices_raise():
    q = torch.zeros(1, 128, 1, 64)
    cfg = psa.DenseSparsityConfig(num_heads=1, block=BLOCK)
    for kw in (dict(force_pallas=True), dict(interpret=True)):
        with pytest.raises(TypeError, match="unsupported options"):
            psa.sparse_attention(q, q, q, sparsity_config=cfg, **kw)
    m = q.to("meta")
    with pytest.raises(ValueError, match="not on meta"):
        psa.sparse_attention(m, m, m, sparsity_config=cfg)
    with pytest.raises(ValueError, match="every tensor"):
        bsa.block_sparse_attention_fwd(q, m, m, np.ones((1, 2, 2)), BLOCK)


def test_rows_that_see_no_key_get_zeros():
    """Only a direct call with an empty layout row makes one: zeros and
    ``lse = -inf``, forward and backward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(B=1, T=128, H=1))
    layout = np.asarray([[[0, 0], [1, 1]]])
    out, lse = bsa.block_sparse_attention_fwd(q, k, v, layout, BLOCK, False)
    assert not out[0, :BLOCK].any() and torch.isinf(lse[0, 0, :BLOCK]).all()
    assert torch.isfinite(lse[0, 0, BLOCK:]).all()
    dq = bsa.block_sparse_attention_bwd_dq(q, k, v, out, lse, do, layout,
                                           BLOCK, False)
    assert not dq[0, :BLOCK].any() and torch.isfinite(dq).all()


def test_lists_and_config_layouts_are_built_once(monkeypatch):
    cfg = psa.BigBirdSparsityConfig(num_heads=2, block=BLOCK)
    q = torch.randn(1, 512, 2, 64)
    bsa._indices_cache.clear()
    bsa._layout_cache.clear()
    work_lists = []
    build = bsa._work_list
    monkeypatch.setattr(bsa, "_work_list",
                        lambda cnt, *split: work_lists.append(cnt)
                        or build(cnt, *split))
    for _ in range(3):
        psa.sparse_attention(q, q, q, sparsity_config=cfg)
    assert len(bsa._indices_cache) == 1 and len(bsa._layout_cache) == 1
    assert len(work_lists) == 2      # the rows' and the columns', once
    rows, cols = next(iter(bsa._indices_cache.values()))
    assert rows.work.shape[1] == 5 and cols.merge.shape[1] == 4
    psa.sparse_attention(q, q, q, sparsity_config=cfg, causal=False)
    assert len(bsa._indices_cache) == 2 and len(work_lists) == 4
    cfg.seed = 1        # another config state: another layout
    psa.sparse_attention(q, q, q, sparsity_config=cfg)
    assert len(bsa._layout_cache) == 2
    assert not bsa._layout_cache[next(iter(bsa._layout_cache))].flags.writeable


def _banded_class(base):
    """A user layout in DeepSpeed's documented way: a ``SparsityConfig``
    subclass whose band width lives outside the dataclass fields, so two
    widths have the same ``repr``."""

    class Banded(base):
        def __init__(self, width, **kw):
            super().__init__(**kw)
            self.width = width

        def make_layout(self, seq_len):
            layout = self.setup_layout(seq_len)
            i = np.arange(layout.shape[1])
            layout[:, np.abs(i[:, None] - i[None, :]) < self.width] = 1
            return layout

    return Banded


BANDED = {psa: _banded_class(psa.SparsityConfig),
          jsa: _banded_class(jsa.SparsityConfig)}


def _banded(pkg, width):
    return BANDED[pkg](width, num_heads=2, block=BLOCK)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_user_subclass_layouts_are_not_cached_by_repr(causal):
    """Two instances of a user subclass with band widths 1 and 4 give
    different outputs, each equal to the JAX package's on the same inputs
    (the JAX package calls make_layout on every call)."""
    q, k, v, _ = _inputs()
    outs = []
    for width in (1, 4):
        cfg = _banded(psa, width)
        want = jsa.sparse_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    sparsity_config=_banded(jsa, width),
                                    causal=causal, force_pallas=True)
        got = psa.sparse_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                   sparsity_config=cfg, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                                   atol=3e-5)
        outs.append(got)
    assert repr(_banded(psa, 1)) == repr(_banded(psa, 4))
    assert not torch.allclose(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the bf16 kernels' work lists and rounding points, emulated on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_work_list_covers_every_active_block_once(name):
    """For every layout of this file, causally cut or not, and for the
    rows' and the columns' lists: the work items cover each (row, active
    block) pair once, hold at most C blocks, come longest first, and the
    items of a split row take consecutive slots in the row's order."""
    for causal in (True, False):
        cut = bsa._causal_layout(_config(psa, name).make_layout(1024), causal)
        for layout in (cut, np.swapaxes(cut, 1, 2)):
            if (layout.sum(-1) == 0).any():
                continue
            idx, cnt = bsa.layout_indices(layout)
            for split in (3, bsa.SPLIT_BLOCKS):
                work, merge, slots = bsa._work_list(cnt, split)
                entries = work[:, 3]
                assert (entries >= 1).all() and (entries <= split).all()
                assert (np.diff(entries) <= 0).all()
                seen = collections.Counter(
                    (h, r, int(a)) for h, r, start, n, _ in work
                    for a in idx[h, r, start:start + n])
                assert set(seen.values()) == {1}
                assert set(seen) == {(h, r, a) for h, r in np.ndindex(
                    *cnt.shape) for a in np.nonzero(layout[h, r])[0]}
                first = {slot: (h, r, start)
                         for h, r, start, _, slot in work if slot >= 0}
                assert sorted(first) == list(range(slots))
                for h, r, slot0, k in merge:
                    assert k == -(-cnt[h, r] // split) > 1
                    assert [first[slot0 + c] for c in range(k)] == \
                        [(h, r, c * split) for c in range(k)]
                whole = collections.Counter((h, r) for h, r, *_, slot
                                            in work if slot < 0)
                assert set(whole.values()) <= {1}
                assert len(whole) + len(merge) == cnt.size
                if split == 3 and cnt.max() > 3:
                    assert slots > 0

