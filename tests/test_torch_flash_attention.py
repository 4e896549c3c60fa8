"""The port's flash attention (K1/K2 plain versions) against the JAX kernel.

The same numpy-seeded inputs go through JAX ``flash_attention`` in Pallas
interpret mode (``force_pallas=True``, as ``tests/unit/test_flash_attention
.py`` runs it) and through the port's ``flash_attention`` on CPU tensors,
which runs the plain forward and the plain backward of the
``autograd.Function``. Tolerance: fp32 at 1e-5, forward and gradients;
the two differ only in summation order. The masked, GQA-native forward
(``key_mask=``) is held against the JAX kernel's masked mode at the
positions that see a key: where a left-padding query row sees none the
port returns zeros and the JAX kernel finite junk (ROADMAP.md Queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import (_reference_attention,
                                                      flash_attention as jfa)
from deepspeed_tpu_torch.ops import flash_attention as fa

CASES = {
    "causal": (2, 128, 128, True, None),
    "full": (1, 128, 128, False, None),
    "uneven_tiles": (1, 96, 96, True, None),
    "tq_lt_tk": (1, 32, 128, True, None),
    "window": (2, 128, 128, True, 32),
}


def _inputs(B, Tq, Tk, H=2, D=64, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, H, D).astype(np.float32)
    k = rs.randn(B, Tk, H, D).astype(np.float32)
    v = rs.randn(B, Tk, H, D).astype(np.float32)
    do = rs.randn(B, Tq, H, D).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_the_jax_kernel(case):
    B, Tq, Tk, causal, window = CASES[case]
    q, k, v, do = _inputs(B, Tq, Tk)
    block = 32 if window else 64

    def jax_loss(q, k, v):
        out = jfa(q, k, v, causal=causal, block_q=block, block_k=block,
                  interpret=True, force_pallas=True, window=window)
        return jnp.sum(out * do), out

    (_, want), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for t, g, name in zip((tq, tk, tv), grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


def test_plain_backward_matches_autograd_of_the_plain_forward():
    """The explicit backward from the logsumexp (what the K2 kernels
    compute) equals autograd through the plain forward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 70, 70, D=16))
    for causal, window in ((True, None), (False, None), (True, 8)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = fa.flash_attention_plain(*leaves, causal, window=window)
        want = torch.autograd.grad(out, leaves, do)
        got = fa.flash_attention_bwd_plain(q, k, v, out.detach(),
                                           lse.detach(), do, causal,
                                           window=window)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_row_that_sees_no_key_gets_zeros():
    """Tq > Tk under causality: the first Tq - Tk rows see no key. The
    port returns zeros there and lse = -inf (its K6 convention). The JAX
    reference gives a uniform softmax over all keys; the JAX kernel gives
    weight exp(-1e30 - (-1e30)) = 1 to each key of the tiles it visits (a
    q tile of 48 rows visits key tile 0 of 16 and skips tile 1). The rows
    that see keys agree."""
    q, k, v, _ = _inputs(1, 64, 32)
    got, lse = fa.flash_attention_fwd(*(torch.from_numpy(a)
                                        for a in (q, k, v)), causal=True)
    blind = 64 - 32
    assert torch.all(got[:, :blind] == 0)
    assert torch.all(torch.isneginf(lse[:, :, :blind]))
    assert torch.all(torch.isfinite(lse[:, :, blind:]))
    ref = np.asarray(_reference_attention(q, k, v, True, 1.0 / 8.0))
    kern = np.asarray(jfa(q, k, v, causal=True, block_q=48, block_k=16,
                          interpret=True, force_pallas=True))
    for want, keys in ((ref, 32), (kern, 16)):
        np.testing.assert_allclose(
            want[:, :blind], np.broadcast_to(
                v[:, :keys].mean(axis=1, keepdims=True),
                want[:, :blind].shape), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[:, blind:].numpy(), want[:, blind:],
                                   rtol=1e-5, atol=1e-5)


def test_wrappers_raise_instead_of_falling_back():
    meta = torch.zeros(1, 8, 2, 64, device="meta")
    before = [f.launches for f in (fa.flash_attention_fwd,
                                   fa.flash_attention_bwd_dq,
                                   fa.flash_attention_bwd_dkv)]
    with pytest.raises(ValueError, match="not on meta"):
        fa.flash_attention_fwd(meta, meta, meta)
    cpu = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="every tensor must be on"):
        fa.flash_attention_fwd(cpu, meta, cpu)
    with pytest.raises(ValueError, match="kv heads repeated"):
        fa.flash_attention_fwd(cpu, torch.zeros(1, 8, 1, 64),
                               torch.zeros(1, 8, 1, 64))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_fwd(cpu, cpu, cpu, window=0)
    assert [f.launches for f in (fa.flash_attention_fwd,
                                 fa.flash_attention_bwd_dq,
                                 fa.flash_attention_bwd_dkv)] == before


MASKED = {
    # name: (B, T, H, Hkv, window, block)
    "gqa4_left_padded": (3, 96, 8, 2, None, 32),
    "mha_left_padded": (2, 64, 2, 2, None, 64),
    "gqa_window": (3, 96, 4, 2, 24, 32),
    "uneven_tiles": (2, 80, 4, 1, None, 64),
}


def _masked_inputs(B, T, H, Hkv, seed=5, D=64):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, T, Hkv, D).astype(np.float32)
    v = rs.randn(B, T, Hkv, D).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[0, :T // 3] = 0                   # left padding
    mask[1, :5] = 0
    return q, k, v, mask


@pytest.mark.parametrize("case", sorted(MASKED))
def test_masked_gqa_forward_matches_the_jax_kernel(case):
    """Un-repeated kv heads, causal (+ window), left padding. Real
    positions (query rows whose own key is unmasked) agree with the Pallas
    kernel in interpret mode and the JAX reference at 1e-5; pad rows see
    no key and come back zero with lse = -inf."""
    B, T, H, Hkv, window, block = MASKED[case]
    q, k, v, mask = _masked_inputs(B, T, H, Hkv)
    kern = np.asarray(jfa(q, k, v, causal=True, block_q=block, block_k=block,
                          interpret=True, force_pallas=True, window=window,
                          key_mask=jnp.asarray(mask)))
    ref = np.asarray(_reference_attention(q, k, v, True, 1.0 / 8.0,
                                          window=window,
                                          key_mask=jnp.asarray(mask)))
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    before = fa.flash_attention_fwd_masked.launches
    got = fa.flash_attention(tq, tk, tv, causal=True, window=window,
                             key_mask=tm)
    out, lse = fa.flash_attention_fwd_masked(tq, tk, tv, tm, True,
                                             window=window)
    assert fa.flash_attention_fwd_masked.launches == before, "CPU: plain"
    torch.testing.assert_close(got, out, rtol=0, atol=0)
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], kern[real], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy()[real], ref[real], rtol=1e-5,
                               atol=1e-5)
    assert not got.numpy()[~real].any()
    assert torch.isneginf(lse.transpose(1, 2)[torch.from_numpy(~real)]).all()
    assert torch.isfinite(lse.transpose(1, 2)[torch.from_numpy(real)]).all()
    # the same function as repeated kv heads with the mask
    rep = H // Hkv
    wide, _ = fa.flash_attention_plain(
        tq, tk.repeat_interleave(rep, dim=2),
        tv.repeat_interleave(rep, dim=2), True, window=window, key_mask=tm)
    torch.testing.assert_close(got, wide, rtol=1e-6, atol=1e-6)


def test_masked_forward_refuses_a_gradient_and_bad_arguments():
    """The masked path is forward-only, as in the JAX package: inputs that
    require a gradient raise; so do a mask of the wrong shape, kv heads
    that do not divide the query heads, and tensors on two devices."""
    q, k, v, mask = (torch.from_numpy(a)
                     for a in _masked_inputs(2, 32, 4, 2))
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_attention(q.clone().requires_grad_(), k, v, key_mask=mask)
    with torch.no_grad():     # the serving and generate prefills' mode
        out = fa.flash_attention(q.clone().requires_grad_(), k, v,
                                 key_mask=mask)
    assert not out.requires_grad
    with pytest.raises(ValueError, match="key_mask must be"):
        fa.flash_attention(q, k, v, key_mask=mask[:, :-1])
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention(q[:, :, :3], k, v, key_mask=mask)
    with pytest.raises(ValueError, match="every tensor must be on"):
        fa.flash_attention(q, k, v, key_mask=mask.to("meta"))
    with pytest.raises(ValueError, match="not on meta"):
        fa.flash_attention(*(t.to("meta") for t in (q, k, v)),
                           key_mask=mask.to("meta"))
