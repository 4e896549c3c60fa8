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

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import (_reference_attention,
                                                      flash_attention as jfa)
from deepspeed_tpu_torch.ops import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    # name: (B, Tq, Tk, causal, window[, head dim, default 64])
    "causal": (2, 128, 128, True, None),
    "full": (1, 128, 128, False, None),
    "uneven_tiles": (1, 96, 96, True, None),
    "tq_lt_tk": (1, 32, 128, True, None),
    "window": (2, 128, 128, True, 32),
    # Phi-2's, GPT-NeoX-20B's and GPT-J-6B's head dims
    "causal_d80": (1, 128, 128, True, None, 80),
    "full_d96": (1, 96, 96, False, None, 96),
    "window_d96": (2, 64, 64, True, 24, 96),
    "causal_d256": (1, 128, 128, True, None, 256),
    "tq_lt_tk_d256": (1, 32, 96, True, None, 256),
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
    B, Tq, Tk, causal, window, D = (CASES[case] + (64,))[:6]
    q, k, v, do = _inputs(B, Tq, Tk, D=D)
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
    # what a CUDA tensor may hand the kernels (the device check bypassed):
    # head dims 64, 80, 96, 128 and 256 in bf16 or fp32, any whole group
    for D in (64, 80, 96, 128, 256):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 8, 6, D, dtype=dtype)
            kv = torch.zeros(1, 8, 2, D, dtype=dtype)
            fa._check_kernel_domain("fwd", q, q, q)
            fa._check_kernel_domain("masked", q, kv, kv)
    for D in (32, 72, 112, 192, 512):
        q = torch.zeros(1, 8, 2, D, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head_dim"):
            fa._check_kernel_domain("fwd", q, q, q)
    q = torch.zeros(1, 8, 6, 80, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or"):
        fa._check_kernel_domain("fwd", q.half(), q.half(), q.half())
    # a group that is not whole raises before any device is looked at
    with pytest.raises(ValueError, match="multiple of Hkv"):
        fa.flash_attention_fwd_masked(q, q[:, :, :4], q[:, :, :4],
                                      torch.ones(1, 8, dtype=torch.int32))


MASKED = {
    # name: (B, T, H, Hkv, window, block[, head dim, default 64])
    "gqa4_left_padded": (3, 96, 8, 2, None, 32),
    "mha_left_padded": (2, 64, 2, 2, None, 64),
    "gqa_window": (3, 96, 4, 2, 24, 32),
    "uneven_tiles": (2, 80, 4, 1, None, 64),
    # a group of 3 at the new head dims
    "gqa3_d80": (2, 64, 3, 1, None, 32, 80),
    "gqa3_d96_window": (2, 96, 6, 2, 40, 32, 96),
    "gqa3_d256": (2, 64, 3, 1, None, 64, 256),
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
    B, T, H, Hkv, window, block, D = (MASKED[case] + (64,))[:7]
    q, k, v, mask = _masked_inputs(B, T, H, Hkv, D=D)
    kern = np.asarray(jfa(q, k, v, causal=True, block_q=block, block_k=block,
                          interpret=True, force_pallas=True, window=window,
                          key_mask=jnp.asarray(mask)))
    ref = np.asarray(_reference_attention(q, k, v, True, 1.0 / math.sqrt(D),
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


LOG2E = 1.4426950408889634


def _emulate_tc_forward(q, k, v, sm_scale, BN=64):
    """The bf16 tensor-core forward's rounding points on the CPU: bf16
    inputs, fp32 scores in log2 units, an online softmax over key tiles of
    BN in the kernel's order, the row sum from the unrounded P, P rounded
    to bf16 before P.V, fp32 accumulation, causal."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,T,D]
    B, H, T, D = qf.shape
    rows = torch.arange(T)[:, None]
    m = torch.full((B, H, T), float("-inf"))
    l = torch.zeros(B, H, T)
    o = torch.zeros(B, H, T, D)
    for c0 in range(0, T, BN):
        cols = torch.arange(c0, min(c0 + BN, T))
        s = (qf @ kf[:, :, cols].transpose(-1, -2)) * (sm_scale * LOG2E)
        s = s.masked_fill(~(rows >= cols[None]), float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        base = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.bfloat16().float() @ vf[:, :, cols]
        m = mx
    out = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    lse = m * math.log(2.0) + torch.log(l)
    return out.transpose(1, 2).to(q.dtype), lse


def _emulate_tc_backward(q, k, v, out, lse, do, sm_scale, KN=64, BQ=64):
    """The bf16 dQ and dK/dV kernels' rounding points: P and dS in fp32
    from bf16 inputs, each rounded to bf16 before its product, fp32 sums
    over key tiles of ``KN`` (dQ) and query tiles of ``BQ`` (dK/dV) in the
    kernels' order. dK and dV come from one walk or, at D 256, from two
    walks that recompute the same P: the sums do not change."""
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    B, H, T, D = qf.shape
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (sm_scale * LOG2E)
    vis = torch.tril(torch.ones(T, T, dtype=torch.bool))
    p = torch.exp2(s - lse[..., None] * LOG2E).masked_fill(~vis, 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - delta[..., None])
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq, dk, dv = (torch.zeros(B, H, T, D) for _ in range(3))
    for t0 in range(0, T, KN):
        t = slice(t0, t0 + KN)
        dq += dsb[..., t] @ kf[:, :, t]
    for t0 in range(0, T, BQ):
        t = slice(t0, t0 + BQ)
        dk += dsb[:, :, t].transpose(-1, -2) @ qf[:, :, t]
        dv += pb[:, :, t].transpose(-1, -2) @ dof[:, :, t]
    return tuple((g * c).transpose(1, 2).to(q.dtype)
                 for g, c in ((dq, sm_scale), (dk, sm_scale), (dv, 1.0)))


def _within_bf16_tolerance(got, want, name):
    """chip_smoke.check_flash_attention's bf16 tolerance:
    |got - want| <= 2**-7 |want| + 2e-2."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= 2 ** -7 * np.abs(want) + 2e-2).all(), \
        f"{name}: max |err| {err.max():.3e}"


#: the bf16 kernels' tile plans by head dim: (T, dQ's key tile, dK/dV's
#: query tile); the forward's key tile is 64 at every D
TC_PLANS = {64: (1024, 64, 64), 80: (256, 64, 32), 96: (192, 64, 32),
            256: (256, 32, 32)}


def test_tensor_core_rounding_points_stay_inside_the_bf16_tolerance():
    """Rounding P and dS to bf16 before their products (what the bf16
    tensor-core kernels do) keeps the forward and the three gradients
    inside the card's bf16 tolerance, against the plain versions and
    against the JAX kernel in interpret mode, at the training shape
    (T 1024, D 64, causal) cut to B 1, H 2, and at D 80, 96 and 256
    (T 192-256) with those head dims' tile plans (``TC_PLANS``)."""
    for D, (T, kn, bq) in TC_PLANS.items():
        _check_tc_rounding(D, T, kn, bq)


def _check_tc_rounding(D, T, kn, bq):
    rs = np.random.RandomState(11)
    q, k, v, do = (torch.from_numpy(rs.randn(1, T, 2, D).astype(
        np.float32)).bfloat16() for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = _emulate_tc_forward(q, k, v, scale)
    grads = _emulate_tc_backward(q, k, v, out, lse, do, scale, KN=kn, BQ=bq)

    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, True, scale)
    ref_grads = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                             scale)
    _within_bf16_tolerance(out.float(), ref_out.float(), f"D {D} out vs plain")
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-4)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        _within_bf16_tolerance(g.float(), r.float(), f"D {D} {name} vs plain")

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                       for t in (q, k, v, do))

    def jax_loss(q, k, v):
        o = jfa(q, k, v, causal=True, block_q=128, block_k=128,
                interpret=True, force_pallas=True)
        return jnp.sum(o.astype(jnp.float32) * jdo.astype(jnp.float32)), o

    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(jq, jk, jv)
    _within_bf16_tolerance(out.float(), jout.astype(jnp.float32),
                           f"D {D} out vs JAX")
    for name, g, r in zip(("dq", "dk", "dv"), grads, jgrads):
        _within_bf16_tolerance(g.float(), r.astype(jnp.float32),
                               f"D {D} {name} vs JAX")
