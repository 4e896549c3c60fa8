"""The port's host libraries (``deepspeed_tpu_torch/csrc/host/``: SIMD
Adam and Adagrad, async IO) against the JAX package's.

Both packages build the same C++ with the same flags, so on the same
numpy-seeded arrays three steps of ``DeepSpeedCPUAdam`` (AdamW and L2 Adam,
with the fused bf16 output) and of ``DeepSpeedCPUAdagrad`` must leave
bitwise equal parameters, moments and bf16 copies. Each C++ step is held
to its plain PyTorch version at rtol 1e-6 (of the largest value: an
elementwise bound fails where a value crosses 0). A file either package's
aio handle writes, the other reads back bitwise (thread pool; io_uring
where the kernel has it). A compiler that fails raises; nothing steps in
numpy instead.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.adagrad.cpu_adagrad import \
    DeepSpeedCPUAdagrad as JaxCPUAdagrad
from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JaxCPUAdam
from deepspeed_tpu.ops.aio import handle as jaio
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.adagrad import (DeepSpeedCPUAdagrad,
                                             cpu_adagrad_step_plain)
from deepspeed_tpu_torch.ops.adam import (DeepSpeedCPUAdam,
                                          cpu_adam_step_plain)
from deepspeed_tpu_torch.ops.aio import aio_handle, uring_available

# leaves of odd sizes: SIMD bodies, scalar tails and threaded chunks
SIZES = (1000, 70001, 33)
STEPS = 3
RTOL = 1e-6


def _leaves(seed):
    rs = np.random.RandomState(seed)
    params = [(rs.randn(n) * 0.02).astype(np.float32) for n in SIZES]
    grads = [[(rs.randn(n) * 1e-3).astype(np.float32) for n in SIZES]
             for _ in range(STEPS)]
    return params, grads


def _bf16_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "l2_adam"])
def test_cpu_adam_steps_bitwise_as_the_jax_package(adamw):
    params, grads = _leaves(0)
    kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1,
              adamw_mode=adamw)
    jopt = JaxCPUAdam([p.copy() for p in params], **kw)
    popt = DeepSpeedCPUAdam([torch.from_numpy(p.copy()) for p in params],
                            **kw)
    jout = [np.empty(n, np.uint16) for n in SIZES]
    pout = [torch.empty(n, dtype=torch.bfloat16) for n in SIZES]
    for s, g in enumerate(grads):
        lr = 1e-3 * (s + 1) / STEPS
        jopt.step([x.copy() for x in g], lr=lr, bf16_out=jout)
        popt.step([torch.from_numpy(x.copy()) for x in g], lr=lr,
                  bf16_out=pout)
    for i in range(len(SIZES)):
        np.testing.assert_array_equal(popt.params[i].numpy(), jopt.params[i])
        np.testing.assert_array_equal(popt.exp_avg[i].numpy(),
                                      jopt.exp_avg[i])
        np.testing.assert_array_equal(popt.exp_avg_sq[i].numpy(),
                                      jopt.exp_avg_sq[i])
        np.testing.assert_array_equal(_bf16_bits(pout[i]), jout[i])


def test_cpu_adagrad_steps_bitwise_as_the_jax_package():
    params, grads = _leaves(1)
    kw = dict(lr=1e-2, eps=1e-10, weight_decay=0.1, num_threads=4)
    jopt = JaxCPUAdagrad([p.copy() for p in params], **kw)
    popt = DeepSpeedCPUAdagrad([torch.from_numpy(p.copy()) for p in params],
                               **kw)
    jout = [np.empty(n, np.uint16) for n in SIZES]
    pout = [torch.empty(n, dtype=torch.bfloat16) for n in SIZES]
    for g in grads:
        jopt.step([x.copy() for x in g], bf16_out=jout)
        popt.step([torch.from_numpy(x.copy()) for x in g], bf16_out=pout)
    for i in range(len(SIZES)):
        np.testing.assert_array_equal(popt.params[i].numpy(), jopt.params[i])
        np.testing.assert_array_equal(popt.sum_sq[i].numpy(), jopt.sum_sq[i])
        np.testing.assert_array_equal(_bf16_bits(pout[i]), jout[i])


def _close(got, want):
    err = float((got - want).abs().max())
    assert err <= RTOL * float(want.abs().max()), err


@pytest.mark.parametrize("adamw", [True, False], ids=["adamw", "l2_adam"])
def test_cpu_adam_steps_as_its_plain_version(adamw):
    params, grads = _leaves(2)
    kw = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)
    opt = DeepSpeedCPUAdam([torch.from_numpy(p.copy()) for p in params],
                           adamw_mode=adamw, **kw)
    plain = [(torch.from_numpy(p.copy()), torch.zeros(p.size),
              torch.zeros(p.size)) for p in params]
    out = [torch.empty(n, dtype=torch.bfloat16) for n in SIZES]
    pout = [torch.empty(n, dtype=torch.bfloat16) for n in SIZES]
    for s, g in enumerate(grads):
        opt.step([torch.from_numpy(x) for x in g], lr=1e-3, bf16_out=out)
        for (p, m, v), x, o in zip(plain, g, pout):
            cpu_adam_step_plain(p, torch.from_numpy(x), m, v, s + 1, 1e-3,
                                adamw_mode=adamw, bf16_out=o, **kw)
    for i, (p, m, v) in enumerate(plain):
        _close(opt.params[i], p)
        _close(opt.exp_avg[i], m)
        _close(opt.exp_avg_sq[i], v)
        _close(out[i].float(), pout[i].float())


def test_cpu_adagrad_steps_as_its_plain_version():
    params, grads = _leaves(3)
    opt = DeepSpeedCPUAdagrad([torch.from_numpy(p.copy()) for p in params],
                              lr=1e-2, eps=1e-10, weight_decay=0.1)
    plain = [(torch.from_numpy(p.copy()), torch.zeros(p.size))
             for p in params]
    for g in grads:
        opt.step([torch.from_numpy(x) for x in g])
        for (p, h), x in zip(plain, g):
            cpu_adagrad_step_plain(p, torch.from_numpy(x), h, 1e-2, 1e-10,
                                   0.1)
    for i, (p, h) in enumerate(plain):
        _close(opt.params[i], p)
        _close(opt.sum_sq[i], h)


BACKENDS = ["pool"] + (["uring"] if uring_available() else [])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("o_direct", [False, True],
                         ids=["buffered", "o_direct"])
def test_aio_files_cross_read_bitwise(tmp_path, backend, o_direct):
    rs = np.random.RandomState(4)
    data = rs.randn(3 << 18).astype(np.float32)        # 3 MiB
    port = aio_handle(block_size=1 << 20, num_threads=2,
                      use_o_direct=o_direct, backend=backend)
    jax_h = jaio.aio_handle(block_size=1 << 20, num_threads=2,
                            use_o_direct=o_direct, backend=backend)
    # the port writes, JAX reads (with an offset), and back
    port.async_pwrite(torch.from_numpy(data), str(tmp_path / "a.bin"))
    port.wait()
    got = np.empty_like(data)
    jax_h.pread(got, str(tmp_path / "a.bin"))
    np.testing.assert_array_equal(got, data)
    half = data[: data.size // 2].copy()
    jax_h.pwrite(half, str(tmp_path / "b.bin"), offset=4096)
    back = torch.empty(half.size)
    port.pread(back, str(tmp_path / "b.bin"), offset=4096)
    np.testing.assert_array_equal(back.numpy(), half)
    port.close()
    jax_h.close()


def test_a_failing_compiler_raises_and_nothing_steps(monkeypatch, tmp_path):
    """No host library, no step: a compiler that fails raises with its
    output, and so does an optimizer that needs the library."""
    monkeypatch.setattr(_build, "BUILD", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for cpu_adam"):
        _build.build_host(["cpu_adam"])
    p = torch.zeros(8)
    with pytest.raises(RuntimeError, match="failed for cpu_adagrad"):
        DeepSpeedCPUAdagrad([p])
    monkeypatch.setenv("CXX", str(tmp_path / "no_such_compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        DeepSpeedCPUAdam([p])
    assert not p.any()
