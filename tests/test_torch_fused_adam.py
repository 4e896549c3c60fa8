"""The port's optimizers (K3's plain version) against the JAX Pallas sweep.

The same numpy-seeded params and per-step gradients go through the JAX
``scale_by_fused_adam`` / ``scale_by_fused_lamb`` in Pallas interpret
mode (params updated as the JAX engine does, ``p + u``) and through the
port's ``FusedAdam`` / ``FusedLamb`` on CPU tensors, for six steps with a
schedule lr. Tolerance: 1e-6 (relative, and absolute on values of order
1); the two run the same fp32 element ops, with the scalars (step size,
bias corrections) rounded once on each side. The step's scalars come
from the optimizer's device count as ``alpha`` (both packages compute it
in fp32), and a set ``skip`` flag leaves every tensor bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.fused_adam import (_run_leaf,
                                                 scale_by_fused_adam,
                                                 scale_by_fused_lamb)
from deepspeed_tpu_torch.ops.fused_adam import fused_adam, fused_adam_plain
from deepspeed_tpu_torch.ops.optimizers import (Adagrad, FusedAdam, FusedLamb,
                                                get_optimizer)
from deepspeed_tpu_torch.runtime.lr_schedules import WarmupDecayLR

SHAPES = {"w": (33, 17), "b": (17,), "e": (8200,)}
STEPS = 6


def _schedule():
    return WarmupDecayLR(warmup_min_lr=1e-4, warmup_max_lr=3e-3,
                         warmup_num_steps=3, total_num_steps=8,
                         warmup_type="linear")


def _trajectory(seed=0):
    rs = np.random.RandomState(seed)
    params = {n: rs.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: (rs.randn(*s) * 10 ** rs.uniform(-3, 1)).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _run_jax(tx, params, grads):
    params = {n: jnp.asarray(p) for n, p in params.items()}
    state = tx.init(params)
    for g in grads:
        u, state = tx.update({n: jnp.asarray(x) for n, x in g.items()},
                             state, params)
        params = jax.tree_util.tree_map(lambda p, d: p + d, params, u)
    return params, state


def _run_port(opt_cls, params, grads, **kw):
    ts = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    opt = opt_cls(list(ts.values()), **kw)
    for g in grads:
        opt.step([torch.from_numpy(g[n].copy()) for n in ts])
    return ts, opt


@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
def test_fused_adam_matches_the_pallas_sweep(adam_w_mode):
    params, grads = _trajectory()
    sched = _schedule()
    want, jstate = _run_jax(scale_by_fused_adam(
        lr=lambda c: jnp.asarray(jax.pure_callback(
            lambda s: np.float32(sched(int(s))),
            jax.ShapeDtypeStruct((), jnp.float32), c)),
        weight_decay=0.1, adam_w_mode=adam_w_mode, interpret=True),
        params, grads)
    got, opt = _run_port(FusedAdam, params, grads, lr=sched,
                         weight_decay=0.1, adam_w_mode=adam_w_mode)
    assert int(opt.count) == int(jstate.count) == STEPS
    for i, n in enumerate(SHAPES):
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(opt.exp_avg[i].numpy(),
                                   np.asarray(jstate.mu[n]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(opt.exp_avg_sq[i].numpy(),
                                   np.asarray(jstate.nu[n]), rtol=1e-6,
                                   atol=1e-9)


def test_fused_lamb_matches_the_pallas_sweep():
    params, grads = _trajectory(seed=1)
    want, _ = _run_jax(scale_by_fused_lamb(lr=2e-3, weight_decay=0.01,
                                           interpret=True), params, grads)
    got, _ = _run_port(FusedLamb, params, grads, lr=2e-3, weight_decay=0.01)
    for n in SHAPES:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


def test_grouped_lamb_matches_the_pallas_sweep_on_a_stacked_leaf():
    """A JAX leaf stacked ``[L, ...]`` (scanned layers) takes one trust
    ratio; the port's ``FusedLamb`` gets its L slices as tensors of one
    group, and the unstacked tensors as groups of their own."""
    rs = np.random.RandomState(3)
    L = 3
    # the slices differ in scale, so per-slice ratios would differ
    stacked = (rs.randn(L, 12, 7) * np.array([0.2, 1.0, 4.0])[:, None, None]
               ).astype(np.float32)
    bias = rs.randn(9).astype(np.float32)
    params = {"w": stacked, "b": bias}
    grads = [{"w": (rs.randn(L, 12, 7) * 10 ** rs.uniform(-3, 1)).astype(
        np.float32), "b": rs.randn(9).astype(np.float32)}
        for _ in range(STEPS)]
    want, _ = _run_jax(scale_by_fused_lamb(lr=2e-3, weight_decay=0.01,
                                           interpret=True), params, grads)
    ts = [torch.from_numpy(stacked[i].copy()) for i in range(L)] + \
        [torch.from_numpy(bias.copy())]
    opt = FusedLamb(ts, lr=2e-3, weight_decay=0.01,
                    groups=[list(range(L)), [L]])
    for g in grads:
        opt.step([torch.from_numpy(g["w"][i].copy()) for i in range(L)] +
                 [torch.from_numpy(g["b"].copy())])
    np.testing.assert_allclose(torch.stack(ts[:L]).numpy(),
                               np.asarray(want["w"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts[L].numpy(), np.asarray(want["b"]),
                               rtol=1e-6, atol=1e-6)
    # per-slice ratios (the port before grouping) miss the stacked leaf
    solo = [torch.from_numpy(stacked[i].copy()) for i in range(L)]
    opt = FusedLamb(solo, lr=2e-3, weight_decay=0.01)
    for g in grads:
        opt.step([torch.from_numpy(g["w"][i].copy()) for i in range(L)])
    assert not np.allclose(torch.stack(solo).numpy(), np.asarray(want["w"]),
                           rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="exactly once"):
        FusedLamb(ts, groups=[[0, 1], [1, 2, 3]])


def test_grad_scale_multiplies_the_gradients_first():
    """The engine's clip factor rides into the sweep as a scalar tensor:
    a step with ``grad_scale = s`` equals a step on ``s * g``."""
    params, grads = _trajectory(seed=2)
    scaled = [{n: g[n] * np.float32(0.25) for n in g} for g in grads]
    a, _ = _run_port(FusedAdam, params, scaled, lr=1e-3, weight_decay=0.1)
    ts = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    opt = FusedAdam(list(ts.values()), lr=1e-3, weight_decay=0.1)
    for g in grads:
        opt.step([torch.from_numpy(g[n].copy()) for n in ts],
                 grad_scale=torch.tensor(0.25))
    for n in SHAPES:
        torch.testing.assert_close(ts[n], a[n], rtol=1e-6, atol=1e-6)


def test_registry_and_knobs_that_raise():
    ps = [torch.zeros(4)]
    assert get_optimizer("Adam", ps, {"lr": 1e-3}).adam_w_mode
    assert not get_optimizer("Adam", ps, {"adam_w_mode": False}).adam_w_mode
    assert isinstance(get_optimizer("AdamW", ps, {"pallas": True}), FusedAdam)
    assert isinstance(get_optimizer("Lamb", ps, {}), FusedLamb)
    assert isinstance(get_optimizer("Adagrad", ps, {}), Adagrad)
    with pytest.raises(NotImplementedError, match="Queue 1"):
        get_optimizer("OneBitAdam", ps, {})
    with pytest.raises(ValueError, match="AMSGrad"):
        FusedAdam(ps, amsgrad=True)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        get_optimizer("sgd", ps, {})
    meta = [torch.zeros(4, device="meta")]
    before = fused_adam.launches
    with pytest.raises(ValueError, match="not on meta"):
        fused_adam(meta, meta, meta, meta, b1=0.9, b2=0.999, eps=1e-8,
                   weight_decay=0.0, adam_w_mode=True,
                   alpha=torch.zeros(3, device="meta"))
    assert fused_adam.launches == before


@pytest.mark.parametrize("adam_w_mode", [True, False], ids=["adamw", "l2"])
def test_plain_sweep_takes_alpha_from_a_device_count_and_skips(adam_w_mode):
    """K3's plain version with ``alpha`` computed from the optimizer's
    device count (``FusedAdam._alpha``) against the JAX Pallas sweep
    (``_run_leaf``, interpret mode) with alpha from the JAX count, three
    steps (1e-6); then a step with ``skip`` set and non-finite gradients
    leaves p, m and v bit-identical, and the optimizer's count stays."""
    params, grads = _trajectory(seed=4)
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-8, 0.1, 2e-3
    ts = {n: torch.from_numpy(p.copy()) for n, p in params.items()}
    opt = FusedAdam(list(ts.values()), lr=lr, weight_decay=wd,
                    adam_w_mode=adam_w_mode)
    jp = {n: jnp.asarray(p) for n, p in params.items()}
    jm = {n: jnp.zeros_like(p) for n, p in jp.items()}
    jv = {n: jnp.zeros_like(p) for n, p in jp.items()}
    for step, g in enumerate(grads[:3]):
        alpha = opt._alpha(opt.lr_at(opt.count))
        t = jnp.float32(step + 1)
        jalpha = jnp.stack([lr / (1.0 - b1 ** t), jnp.float32(lr),
                            1.0 / jnp.sqrt(1.0 - b2 ** t)])
        np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha),
                                   rtol=1e-6)
        for n in SHAPES:
            u, jm[n], jv[n] = _run_leaf(jp[n], jnp.asarray(g[n]), jm[n],
                                        jv[n], jalpha, b1, b2, eps, wd,
                                        adam_w_mode, True)
            jp[n] = jp[n] + u
        opt.step([torch.from_numpy(g[n].copy()) for n in SHAPES])
    assert int(opt.count) == 3
    for i, n in enumerate(SHAPES):
        np.testing.assert_allclose(ts[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(opt.exp_avg[i].numpy(),
                                   np.asarray(jm[n]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(opt.exp_avg_sq[i].numpy(),
                                   np.asarray(jv[n]), rtol=1e-6, atol=1e-9)
    before = [[t.clone() for t in lst]
              for lst in (list(ts.values()), opt.exp_avg, opt.exp_avg_sq)]
    bad = [torch.full(s, float("nan")) for s in SHAPES.values()]
    bad[0][0, 0] = float("inf")
    opt.step(bad, grad_scale=torch.tensor(float("nan")),
             skip=torch.tensor(True))
    assert int(opt.count) == 3
    for lst, old in zip((list(ts.values()), opt.exp_avg, opt.exp_avg_sq),
                        before):
        assert all(torch.equal(a, b) for a, b in zip(lst, old))
    # the same call without the flag writes NaN: the flag is what kept them
    fused_adam_plain(list(ts.values()), bad, opt.exp_avg, opt.exp_avg_sq,
                     b1=b1, b2=b2, eps=eps, weight_decay=wd,
                     adam_w_mode=adam_w_mode, alpha=alpha)
    assert all(torch.isnan(t).any() for t in ts.values())


def test_skipped_lamb_step_keeps_every_tensor():
    """LAMB with ``skip`` set: the direction written into the gradient
    buffers, the params, the moments and the count all stay."""
    params, grads = _trajectory(seed=5)
    ts = [torch.from_numpy(p.copy()) for p in params.values()]
    opt = FusedLamb(ts, lr=2e-3, weight_decay=0.01)
    opt.step([torch.from_numpy(g.copy()) for g in grads[0].values()])
    keep = [[t.clone() for t in lst] for lst in (ts, opt.exp_avg,
                                                 opt.exp_avg_sq)]
    bad = [torch.full(t.shape, float("inf")) for t in ts]
    opt.step(bad, skip=torch.tensor(True))
    assert int(opt.count) == 1
    assert all(torch.isinf(b).all() for b in bad)
    for lst, old in zip((ts, opt.exp_avg, opt.exp_avg_sq), keep):
        assert all(torch.equal(a, b) for a, b in zip(lst, old))


def test_cpu_launches_leave_the_device_run_counts_alone():
    """On the CPU the wrapper runs the plain version: no kernel ran, so no
    device run count exists or moves (``_runs.kernel_runs`` reads 0), and
    the Python launch count stays where it was."""
    from deepspeed_tpu_torch.ops import _runs

    rs = np.random.RandomState(0)
    lists = [[torch.from_numpy(rs.rand(37).astype(np.float32))]
             for _ in range(4)]
    before = fused_adam.launches
    assert fused_adam(*lists, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      adam_w_mode=True,
                      alpha=torch.tensor([1e-3, 1e-3, 1.0])) is None
    assert fused_adam.launches == before
    assert _runs.kernel_runs("fused_adam", "cpu") == 0
    assert not any(dev.type == "cpu" for _, dev in _runs._RUNS)
