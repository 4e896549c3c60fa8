"""ZeRO-Offload in the port (``runtime/zero/offload.py`` and the engine's
offload path) against the JAX package's offload engine.

The tiny GPT-2 of ``tests/unit/test_offload.py`` (``GPT2Config.tiny``)
is initialised once in flax; its params go to the JAX engine and, through
``checkpoint.from_flax``, to the port's engine (``device="cpu"``). Both
train on the same numpy-seeded batches with AdamW, clipping 1.0 and the
host optimizer (the same C++ built with the same flags). Tolerances: the
losses 1e-5 relative, each step's gradients leaf by leaf (1e-5 of the
leaf's largest element at the first step, 1e-3 later) and the params 1e-4
after 4 steps (fp32; the two differ in the device summation order of the
gradients only; an element whose gradient is rounding noise in both
packages, the key bias above all, is held to Adam's reach instead). The fp16
case forces an overflow (scale 2**40) that both engines skip, halving
the scale. ``nvme`` spills the moments through the async-IO handle and
must step bitwise as ``cpu``; ZeRO stages 1-3 on one device take the
stage-0 step bitwise; a save resumes bitwise in the port and restores in
the JAX offload engine under its universal rule (the fp32 masters copied,
the moments reset).
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import GPT2Config as JaxConfig
from deepspeed_tpu.models import GPT2LMHeadModel as JaxGPT2
from deepspeed_tpu.parallel import topology
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.runtime.zero.config import \
    DeepSpeedZeroOffloadOptimizerConfig
from deepspeed_tpu_torch.runtime.zero.offload import HostOffloadOptimizer
from torch_threads import one_torch_thread  # noqa: F401

SEQ = 16


@pytest.fixture
def one_device_mesh():
    saved = topology.get_mesh(), topology.get_topology()
    yield topology.build_mesh(devices=jax.devices()[:1])
    topology.set_mesh(*saved)


@pytest.fixture(scope="module")
def flax_params():
    params = jax.jit(JaxGPT2(JaxConfig.tiny()).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.device_get(params)


def _config(device="cpu", gas=1, stage=1, **extra):
    cfg = {"train_batch_size": 4 * gas, "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-2, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": stage},
           "steps_per_print": 0, **extra}
    if device:
        cfg["zero_optimization"]["offload_optimizer"] = {"device": device}
    return cfg


def _port(params, config):
    cfg = GPT2Config.tiny()
    engine, *_ = dt.initialize(
        model=GPT2LMHeadModel(cfg), config=config,
        model_parameters=flax_to_torch_state_dict(params, cfg), device="cpu")
    return engine


def _jax(params, config, mesh):
    engine, *_ = ds.initialize(model=JaxGPT2(JaxConfig.tiny()), config=config,
                               model_parameters=params, mesh=mesh)
    return engine


def _batches(n, rows, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": ids, "labels": ids} for ids in
            (rs.randint(0, 256, (rows, SEQ)).astype(np.int32)
             for _ in range(n))]


def _masters(engine):
    return {n: t.clone() for n, t in engine.module_state_dict().items()}


def _record_jax_grads(engine, cfg):
    """Wrap the JAX offload engine's host step so that each step's
    gradients (before the step scales them in place) are kept, in the
    port's names and layouts."""
    seen, step = [], engine._host_opt.step

    def record(grads, **kw):
        grads = jax.tree_util.tree_map(
            lambda a: np.array(a, np.float32), grads)
        seen.append({n: t.float() for n, t in
                     flax_to_torch_state_dict(grads, cfg).items()})
        return step(grads, **kw)

    engine._host_opt.step = record
    return seen


@pytest.mark.parametrize("gas", [1, 2], ids=["gas1", "gas2"])
def test_cpu_offload_matches_the_jax_offload_engine(gas, flax_params,
                                                    one_device_mesh):
    """The losses at 1e-5, each step's gradients leaf by leaf (below) and
    the params after 4 steps at 1e-4."""
    config = _config("cpu", gas=gas)
    jeng = _jax(flax_params, dict(config), one_device_mesh)
    peng = _port(flax_params, dict(config))
    assert jeng._offload and peng._offload and peng.optimizer is None
    jax_grads = _record_jax_grads(jeng, GPT2Config.tiny())
    names = peng._trainable_names
    at_floor = {n: torch.zeros_like(t, dtype=torch.bool)
                for n, t in zip(names, peng._trainable)}
    for batch in _batches(4, 4 * gas):
        want = float(jeng.train_batch(batch=batch))
        got = float(peng.train_batch(batch=batch))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        norm = peng.get_global_grad_norm()
        np.testing.assert_allclose(norm, jeng._last_grad_norm, rtol=1e-4)
        # each leaf's gradient, to its largest element: 1e-5 at the first
        # step (equal weights, fp32, the device summation order apart);
        # then 1e-3, since the noise elements below have moved by up to lr
        # in each package
        tol = 1e-5 if len(jax_grads) == 1 else 1e-3
        for name, g in zip(names, peng._grads):
            ref = jax_grads[-1][name]
            err = (g - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), (name, err)
        # an element below fp32's resolution of the whole gradient in both
        # packages, and not exactly 0 in both, is rounding noise (the key
        # bias's gradient is 0 analytically), which Adam turns into an
        # update of up to ~lr
        floor = np.finfo(np.float32).eps * norm
        for name, g in zip(names, peng._grads):
            ref = jax_grads[-1][name]
            at_floor[name] |= (g.abs() <= floor) & (ref.abs() <= floor) & \
                ((g != 0) | (ref != 0))
    assert len(jax_grads) == 4
    assert peng._host_opt.step_count == jeng._host_opt.step_count == 4
    assert set(peng.offload_times) == {"grad_step", "d2h", "host_step",
                                       "h2d"}
    want = flax_to_torch_state_dict(jax.device_get(jeng.state.params),
                                    GPT2Config.tiny())
    hidden = GPT2Config.tiny().n_embd
    for name, p in peng.module_state_dict().items():
        got, ref = p.numpy(), want[name].float().numpy()
        noise = at_floor[name].numpy()
        if name.endswith("attn.c_attn.bias"):
            # the key bias is noise whole; it may not hide anything else
            key = np.zeros_like(noise)
            key[hidden:2 * hidden] = True
            assert noise[key].all(), name
            rest = noise[~key]
        else:
            rest = noise
        assert rest.sum() <= max(1, 0.01 * rest.size), (name, rest.sum())
        np.testing.assert_allclose(got[~noise], ref[~noise], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
        assert np.all(np.abs(got[noise] - ref[noise]) <= 2 * 4 * 1e-2), name


def test_fp16_overflow_skips_and_halves_the_scale_in_both(flax_params,
                                                          one_device_mesh):
    config = _config("cpu", fp16={"enabled": True, "initial_scale_power": 40,
                                  "hysteresis": 1})
    jeng = _jax(flax_params, dict(config), one_device_mesh)
    peng = _port(flax_params, dict(config))
    before = _masters(peng)
    for batch in _batches(2, 4):
        want = float(jeng.train_batch(batch=batch))
        got = float(peng.train_batch(batch=batch))
        np.testing.assert_allclose(got, want, rtol=2e-3)
    assert peng.get_skipped_steps() == jeng.skipped_steps == 2
    assert peng.loss_scale == jeng.loss_scale == 2.0 ** 38
    assert peng._host_opt.step_count == 0
    assert peng.get_global_grad_norm() is None
    for name, t in _masters(peng).items():
        assert torch.equal(t, before[name]), name


def test_nvme_offload_steps_bitwise_as_cpu(flax_params, tmp_path):
    cpu = _port(flax_params, _config("cpu"))
    config = _config("nvme")
    config["zero_optimization"]["offload_optimizer"]["nvme_path"] = \
        str(tmp_path / "swap")
    nvme = _port(flax_params, config)
    for batch in _batches(3, 4):
        assert float(cpu.train_batch(batch=batch)) == \
            float(nvme.train_batch(batch=batch))
    assert any(f.startswith("moment") for f in os.listdir(tmp_path / "swap"))
    assert all(b is None for b in nvme._host_opt._moments[0])
    # both moments of every master, each way, each step
    io = nvme._host_opt.swap_io()
    n = sum(m.numel() for m in nvme._host_opt.master)
    assert io["read_bytes"] == io["write_bytes"] == 3 * 2 * 4 * n
    assert io["read_inflight_s"] >= io["read_wait_s"] > 0
    got, want = _masters(nvme), _masters(cpu)
    assert all(torch.equal(got[n], want[n]) for n in want)
    sd = nvme._host_opt.state_dict()
    for mine, theirs in zip(sd["moments"][1], cpu._host_opt._moments[1]):
        assert torch.equal(mine, theirs)


def test_nvme_without_a_path_spills_to_a_directory_of_its_own(tmp_path,
                                                              monkeypatch):
    """Two optimizers with ``nvme`` and no ``nvme_path`` in one temporary
    directory step as the ``cpu`` one does, each its own moments."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rs = np.random.RandomState(5)
    leaves = [rs.randn(7, 5).astype(np.float32), rs.randn(3).astype(np.float32)]
    grads = [[rs.randn(*l.shape).astype(np.float32) for l in leaves]
             for _ in range(2)]

    def opt(device):
        return HostOffloadOptimizer(
            [torch.from_numpy(l.copy()) for l in leaves], "AdamW",
            {"lr": 1e-2}, DeepSpeedZeroOffloadOptimizerConfig(device=device))

    first, second, cpu = opt("nvme"), opt("nvme"), opt("cpu")
    assert first._nvme_dir != second._nvme_dir
    assert {os.path.dirname(o._nvme_dir) for o in (first, second)} == \
        {str(tmp_path)}
    for step in range(2):
        first.step([torch.from_numpy(g.copy()) for g in grads[step]])
        second.step([torch.from_numpy(-g) for g in grads[step]])
        cpu.step([torch.from_numpy(g.copy()) for g in grads[step]])
    assert all(torch.equal(a, b) for a, b in zip(first.master, cpu.master))
    assert not torch.equal(first.master[0], second.master[0])


def test_zero_stages_on_one_device_take_the_stage_zero_step(flax_params,
                                                            one_device_mesh):
    """Stages 1-3 shard nothing on one device: the port's step at each
    stage is bitwise the stage-0 step, and the JAX engine on a one-device
    mesh at stage 2 takes the same losses."""
    losses = {}
    for stage in (0, 1, 2, 3):
        engine = _port(flax_params, _config(None, stage=stage))
        assert engine.zero_optimization_stage() == stage
        losses[stage] = [float(engine.train_batch(batch=b))
                         for b in _batches(2, 4)]
    assert losses[1] == losses[2] == losses[3] == losses[0]
    jeng = _jax(flax_params, _config(None, stage=2), one_device_mesh)
    want = [float(jeng.train_batch(batch=b)) for b in _batches(2, 4)]
    np.testing.assert_allclose(losses[2], want, rtol=1e-5)


def test_offload_save_resumes_bitwise_and_restores_in_jax(flax_params,
                                                          one_device_mesh,
                                                          tmp_path):
    batches = _batches(4, 4)
    first = _port(flax_params, _config("cpu"))
    for b in batches[:2]:
        first.train_batch(batch=b)
    first.save_checkpoint(str(tmp_path), tag="t2")
    saved = _masters(first)
    assert os.path.exists(tmp_path / "t2.host_optimizer.npz")
    cont = [float(first.train_batch(batch=b)) for b in batches[2:]]

    second = _port(flax_params, _config("cpu"))
    second.load_checkpoint(str(tmp_path))
    assert second._host_opt.step_count == 2 and second.global_steps == 2
    assert [float(second.train_batch(batch=b)) for b in batches[2:]] == cont
    got, want = _masters(second), _masters(first)
    assert all(torch.equal(got[n], want[n]) for n in want)

    # the JAX offload engine's universal restore: the fp32 masters come
    # from the checkpoint exactly, the moments and the count reset
    jeng = _jax(flax_params, _config("cpu"), one_device_mesh)
    jeng.load_checkpoint(str(tmp_path / "t2"), load_universal=True)
    assert jeng._host_opt.step_count == 0 and jeng.global_steps == 2
    leaves = jax.tree_util.tree_leaves(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jeng.state.params),
        [m.reshape(s) for m, s in zip(jeng._host_opt.master,
                                      jeng._host_opt._shapes)]))
    jax_masters = flax_to_torch_state_dict(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jeng.state.params), leaves),
        GPT2Config.tiny())
    for name, t in saved.items():
        assert torch.equal(jax_masters[name].float(), t), name
    assert all(not m.any() for bank in jeng._host_opt._moments
               for m in bank)

    # and the port's own universal restore follows the same rule
    third = _port(flax_params, _config("cpu"))
    third.load_checkpoint(str(tmp_path / "t2"), load_universal=True)
    assert third._host_opt.step_count == 0
    got = _masters(third)
    assert all(torch.equal(got[n], saved[n]) for n in saved)
