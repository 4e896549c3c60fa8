"""The port's training engine on any ``nn.Module`` against the JAX engine
on the same flax module.

- A generic module: ``tests/unit/simple_model.py``'s ``SimpleModel`` and
  its torch twin below, on the same weights (``checkpoint/from_flax.py``
  ``flax_dense_to_torch_state_dict``), trained five steps with a client
  optimizer (``optax.adam`` / ``optax.sgd`` with momentum against
  ``torch.optim.Adam`` / ``SGD``), with a ``loss_fn``, and with the
  config's optimizer (K3's plain version): losses and final params 1e-5.
- ``training_data``: ``initialize`` returns the data loader, whose batches
  equal the JAX loader's over two epochs; both engines train from them.
- Monitors: the ``csv_monitor`` files of both engines hold the same names
  and steps, the ``Train/Samples`` values at 1e-5; TensorBoard writes an
  event file, and without the ``tensorboard`` package it raises naming it;
  the ``tracing`` block arms the process-global tracer.
- The config blocks this slice ports parse as the JAX package's.
"""

import csv
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import deepspeed_tpu as ds
from deepspeed_tpu.parallel import topology
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDSConfig
from deepspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JaxDataLoader
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import \
    flax_dense_to_torch_state_dict
from deepspeed_tpu_torch.monitor import tracing
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from tests.unit.simple_model import SimpleModel, batch_of
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 5
HIDDEN = 16


class SimpleModelTwin(nn.Module):
    """``SimpleModel`` in torch: ``nlayers`` Dense + relu, a Dense to one
    output, the mean squared error against ``y``. The layers carry the
    flax module names, and each computes in the promoted dtype of its
    input and weights, as flax ``Dense`` does (the engine binds fp16 or
    bf16 weights; the batch stays fp32)."""

    def __init__(self, dim=HIDDEN, hidden=HIDDEN, nlayers=2, out="loss"):
        super().__init__()
        self.nlayers, self.out = nlayers, out
        for i in range(nlayers):
            setattr(self, f"Dense_{i}", nn.Linear(dim if i == 0 else hidden,
                                                  hidden))
        setattr(self, f"Dense_{nlayers}", nn.Linear(hidden, 1))

    @staticmethod
    def _dense(layer, h):
        dt = torch.promote_types(h.dtype, layer.weight.dtype)
        return nn.functional.linear(h.to(dt), layer.weight.to(dt),
                                    layer.bias.to(dt))

    def forward(self, x, y):
        h = x
        for i in range(self.nlayers):
            h = torch.relu(self._dense(getattr(self, f"Dense_{i}"), h))
        pred = self._dense(getattr(self, f"Dense_{self.nlayers}"),
                           h).squeeze(-1)
        loss = ((pred - y) ** 2).mean()
        if self.out == "tuple":
            return loss, pred
        if self.out == "dict":
            return {"loss": loss, "pred": pred}
        return loss


@pytest.fixture
def one_device_mesh():
    saved = topology.get_mesh(), topology.get_topology()
    mesh = topology.build_mesh(devices=jax.devices()[:1])
    yield mesh
    topology.set_mesh(*saved)


def _params():
    return jax.device_get(SimpleModel().init(jax.random.PRNGKey(3),
                                             **batch_of(2))["params"])


def _twin(params, **kw):
    model = SimpleModelTwin(**kw)
    model.load_state_dict(flax_dense_to_torch_state_dict(params))
    return model


def _assert_same_params(jeng, peng, params_like, rtol=1e-5):
    want = flax_dense_to_torch_state_dict(jax.device_get(jeng.state.params))
    got = peng.module_state_dict()
    assert set(got) == set(want)
    for name, p in want.items():
        np.testing.assert_allclose(got[name].numpy(), p.numpy(), rtol=rtol,
                                   atol=1e-6, err_msg=name)


def test_dense_tree_converter_names_and_transposes():
    params = _params()
    sd = flax_dense_to_torch_state_dict(params)
    assert set(sd) == {f"Dense_{i}.{w}" for i in range(3)
                       for w in ("weight", "bias")}
    np.testing.assert_array_equal(sd["Dense_1.weight"].numpy(),
                                  np.asarray(params["Dense_1"]["kernel"]).T)
    nested = flax_dense_to_torch_state_dict({"block": params})
    assert set(nested) == {f"block.{k}" for k in sd}
    with pytest.raises(ValueError, match="not a Dense leaf"):
        flax_dense_to_torch_state_dict({"norm": {"scale": np.ones(2)}})


CLIENT = {
    "adam": (lambda: optax.adam(1e-2),
             lambda ps: torch.optim.Adam(ps, lr=1e-2)),
    "sgd_momentum": (lambda: optax.sgd(1e-2, momentum=0.9),
                     lambda ps: torch.optim.SGD(ps, lr=1e-2, momentum=0.9)),
}


@pytest.mark.parametrize("loss_fn", [False, True], ids=["forward", "loss_fn"])
@pytest.mark.parametrize("opt", sorted(CLIENT))
def test_client_optimizer_matches_the_jax_engine(opt, loss_fn,
                                                 one_device_mesh):
    """Five steps of gas 2 with clipping; with ``loss_fn`` both packages
    scale the module's loss by 2 and return an aux."""
    params = _params()
    config = {"train_batch_size": 16, "gradient_accumulation_steps": 2,
              "gradient_clipping": 1.0, "steps_per_print": 0}
    jax_opt, torch_opt = CLIENT[opt]
    jmodel = SimpleModel()
    jkw, pkw = {}, {}
    if loss_fn:
        def jax_loss(p, batch, rng):
            return 2.0 * jmodel.apply({"params": p}, **batch), ()

        def port_loss(module, batch, generator):
            assert isinstance(generator, torch.Generator)
            return 2.0 * module(**batch), ()
        jkw, pkw = {"loss_fn": jax_loss}, {"loss_fn": port_loss}
    jeng, *_ = ds.initialize(model=jmodel, config=dict(config),
                             model_parameters=params, optimizer=jax_opt(),
                             mesh=one_device_mesh, **jkw)
    twin = _twin(params)
    client = torch_opt(twin.parameters())
    peng, got_opt, loader, _ = dt.initialize(
        model=twin, config=dict(config), optimizer=client, device="cpu",
        **pkw)
    assert got_opt is client and peng.optimizer is client and loader is None
    assert all(p.dtype == torch.float32 and any(p is m for m in
                                                peng.master.values())
               for g in client.param_groups for p in g["params"])
    for step in range(STEPS):
        batch = batch_of(16, seed=step)
        want = float(jeng.train_batch(batch=batch))
        got = float(peng.train_batch(batch=batch))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(peng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-5)
    assert int(peng.step_count) == STEPS
    assert peng.get_lr() == [1e-2]
    _assert_same_params(jeng, peng, params)


@pytest.mark.parametrize("out", ["loss", "tuple", "dict"])
def test_generic_module_with_the_config_optimizer(out, one_device_mesh):
    """The config's Adam (K3's plain version) over a generic module's own
    parameters, its forward returning a scalar, a tuple or a dict: five
    steps against the JAX engine (1e-5)."""
    params = _params()
    config = {"train_batch_size": 8, "steps_per_print": 0,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    jeng, *_ = ds.initialize(model=SimpleModel(), config=dict(config),
                             model_parameters=params, mesh=one_device_mesh)
    peng, *_ = dt.initialize(model=_twin(params, out=out), config=dict(config),
                             device="cpu")
    for step in range(STEPS):
        batch = batch_of(8, seed=10 + step)
        np.testing.assert_allclose(float(peng.train_batch(batch=batch)),
                                   float(jeng.train_batch(batch=batch)),
                                   rtol=1e-5)
    _assert_same_params(jeng, peng, params)


def test_deepspeed_parameter_form_trains_only_the_given_parameters():
    """``model_parameters=model.parameters()`` (DeepSpeed's form) over a
    subset: the rest stay frozen; a foreign tensor, a stepped client
    optimizer and a client optimizer beside the config's are refused."""
    twin = _twin(_params())
    # a generator, as model.parameters() is
    chosen = (p for n, p in twin.named_parameters() if n.startswith("Dense_2"))
    before = {n: p.detach().clone() for n, p in twin.named_parameters()}
    eng, *_ = dt.initialize(model=twin, model_parameters=chosen,
                            config={"train_batch_size": 8,
                                    "steps_per_print": 0}, device="cpu")
    assert eng._trainable_names == ["Dense_2.weight", "Dense_2.bias"]
    eng.train_batch(batch=batch_of(8))
    after = eng.module_state_dict()
    for name, p in before.items():
        assert torch.equal(after[name], p) != name.startswith("Dense_2")
    with pytest.raises(ValueError, match="not a parameter"):
        dt.initialize(model=_twin(_params()), model_parameters=[
            torch.zeros(2)], config={"train_batch_size": 8}, device="cpu")
    twin = _twin(_params())
    client = torch.optim.SGD(twin.parameters(), lr=0.1)
    with pytest.raises(ValueError, match="not both"):
        dt.initialize(model=twin, optimizer=client, device="cpu", config={
            "train_batch_size": 8, "optimizer": {"type": "Adam"}})
    twin(**{k: torch.from_numpy(v) for k, v in batch_of(2).items()}
         ).backward()
    client.step()
    client = torch.optim.Adam(twin.parameters(), lr=0.1)
    twin(**{k: torch.from_numpy(v) for k, v in batch_of(2).items()}
         ).backward()
    client.step()
    with pytest.raises(ValueError, match="must not have stepped"):
        dt.initialize(model=twin, optimizer=client, device="cpu",
                      config={"train_batch_size": 8})
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        dt.initialize(model=_twin(_params()), optimizer=optax.adam(1e-3),
                      device="cpu", config={"train_batch_size": 8})
    with pytest.raises(TypeError, match="nn.Module"):
        dt.initialize(model=SimpleModel(), device="cpu",
                      config={"train_batch_size": 8})


def test_client_optimizer_takes_the_schedule_and_skips_fp16_overflows():
    """A config schedule feeds a client optimizer's lr from the device
    count (the JAX WarmupLR values); an fp16 overflow skips its step (the
    count, the params and the optimizer state stay) uncaptured."""
    from deepspeed_tpu.runtime import lr_schedules as jax_lr

    sched = {"type": "WarmupLR", "params": {"warmup_min_lr": 0.0,
                                            "warmup_max_lr": 1e-2,
                                            "warmup_num_steps": 4,
                                            "warmup_type": "linear"}}
    twin = _twin(_params())
    eng, *_ = dt.initialize(model=twin, optimizer=torch.optim.SGD(
        twin.parameters(), lr=1.0), device="cpu", config={
            "train_batch_size": 8, "steps_per_print": 0, "scheduler": sched})
    want = jax_lr.get_lr_schedule("WarmupLR", dict(sched["params"]))
    for step in range(3):
        eng.train_batch(batch=batch_of(8, seed=step))
        np.testing.assert_allclose(eng.get_lr()[0], float(want(step)),
                                   rtol=1e-6)
    twin = _twin(_params())
    eng, *_ = dt.initialize(model=twin, optimizer=torch.optim.Adam(
        twin.parameters(), lr=1e-2), device="cpu", config={
            "train_batch_size": 8, "steps_per_print": 0,
            "fp16": {"enabled": True, "initial_scale_power": 130}})
    before = {n: p.clone() for n, p in eng.module_state_dict().items()}
    # a loss scale of 2**130 overflows the scaled loss itself
    assert np.isfinite(float(eng.train_batch(batch=batch_of(8))))
    assert eng.get_skipped_steps() == 1 and int(eng.step_count) == 0
    assert not eng.optimizer.state
    for name, p in eng.module_state_dict().items():
        assert torch.equal(p, before[name]), name


def test_checkpoints_of_a_generic_module_name_their_item(tmp_path):
    eng, *_ = dt.initialize(model=_twin(_params()), device="cpu",
                            config={"train_batch_size": 8})
    with pytest.raises(NotImplementedError, match="item 7"):
        eng.save_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# the data loader
# ---------------------------------------------------------------------------

def _dataset(n=40, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(HIDDEN).astype(np.float32),
             "y": np.float32(rs.randn())} for _ in range(n)]


@pytest.mark.parametrize("kind", ["dict", "tuple", "array"])
def test_loader_yields_the_jax_batches_over_two_epochs(kind):
    data = _dataset()
    if kind == "tuple":
        data = [(d["x"], d["y"]) for d in data]
    elif kind == "array":
        data = [d["x"] for d in data]
    for kw in ({}, {"shuffle": False}, {"drop_last": False, "seed": 3}):
        got, want = DeepSpeedDataLoader(data, 6, **kw), \
            JaxDataLoader(data, 6, **kw)
        assert len(got) == len(want)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            a, b = list(got), list(want)
            assert len(a) == len(b) > 0
            for x, y in zip(a, b):
                assert sorted(x) == sorted(y)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
    loader = RepeatingLoader(DeepSpeedDataLoader(data, 16))
    assert len([next(loader) for _ in range(5)]) == 5


def test_training_data_feeds_both_engines_alike(one_device_mesh):
    """``initialize(training_data=...)`` returns a loader of microbatches;
    both engines train five gas-2 steps from their own loaders (the same
    order) to the same losses (1e-5)."""
    params = _params()
    data = _dataset(80, seed=1)
    config = {"train_batch_size": 8, "gradient_accumulation_steps": 2,
              "steps_per_print": 0,
              "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    jeng, _, jloader, _ = ds.initialize(
        model=SimpleModel(), config=dict(config), model_parameters=params,
        training_data=data, mesh=one_device_mesh)
    peng, _, ploader, _ = dt.initialize(model=_twin(params),
                                        config=dict(config),
                                        training_data=data, device="cpu")
    assert isinstance(ploader, DeepSpeedDataLoader)
    assert ploader.batch_size == jloader.batch_size == 4
    jit, pit = iter(RepeatingLoader(jloader)), iter(RepeatingLoader(ploader))
    for _ in range(STEPS):
        np.testing.assert_allclose(float(peng.train_batch(data_iter=pit)),
                                   float(jeng.train_batch(data_iter=jit)),
                                   rtol=1e-5)


# ---------------------------------------------------------------------------
# monitors and tracing
# ---------------------------------------------------------------------------

def _read_csvs(path):
    out = {}
    for f in sorted(glob.glob(os.path.join(path, "*.csv"))):
        with open(f) as fh:
            rows = list(csv.reader(fh))
        out[os.path.basename(f)] = (rows[0], [(int(r[0]), float(r[1]))
                                              for r in rows[1:]])
    return out


def test_csv_monitor_files_match_the_jax_engine(tmp_path, one_device_mesh):
    """fp16 with clipping, so every JAX event is written: the same files
    (names and headers), the same steps, ``Train/Samples`` values at
    1e-5 (the registry's are wall times)."""
    params = _params()

    def config(name):
        return {"train_batch_size": 8, "steps_per_print": 0,
                "fp16": {"enabled": True, "initial_scale_power": 8},
                "gradient_clipping": 1.0,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
                "csv_monitor": {"enabled": True,
                                "output_path": str(tmp_path),
                                "job_name": name}}
    jeng, *_ = ds.initialize(model=SimpleModel(), config=config("jax"),
                             model_parameters=params, mesh=one_device_mesh)
    peng, *_ = dt.initialize(model=_twin(params), config=config("port"),
                             device="cpu")
    for step in range(3):
        batch = batch_of(8, seed=step)
        jeng.train_batch(batch=batch)
        peng.train_batch(batch=batch)
    want = _read_csvs(tmp_path / "jax")
    got = _read_csvs(tmp_path / "port")
    assert set(got) == set(want) and "Train_Samples_loss_scale.csv" in got
    for name, (header, rows) in want.items():
        assert got[name][0] == header
        assert [s for s, _ in got[name][1]] == [s for s, _ in rows], name
        if name.startswith("Train_Samples"):
            np.testing.assert_allclose([v for _, v in got[name][1]],
                                       [v for _, v in rows], rtol=1e-5,
                                       err_msg=name)


def test_tensorboard_writes_and_names_a_missing_package(tmp_path,
                                                        monkeypatch):
    pytest.importorskip("tensorboard")
    config = {"train_batch_size": 8, "steps_per_print": 0,
              "tensorboard": {"enabled": True, "output_path": str(tmp_path),
                              "job_name": "tb"}}
    eng, *_ = dt.initialize(model=_twin(_params()), config=dict(config),
                            device="cpu")
    eng.train_batch(batch=batch_of(8))
    eng.monitor.tb_monitor.summary_writer.close()
    assert glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="'tensorboard' package"):
        dt.initialize(model=_twin(_params()), config=dict(config),
                      device="cpu")


def test_tracing_block_arms_the_process_global_tracer(tmp_path):
    tracing.reset_default()
    try:
        eng, *_ = dt.initialize(model=_twin(_params()), device="cpu", config={
            "train_batch_size": 8, "steps_per_print": 0,
            "tracing": {"enabled": True, "capacity": 64,
                        "dir": str(tmp_path)}})
        assert eng.tracer is tracing.get_tracer() and eng.tracer.enabled
        assert tracing.default_flight_recorder() is not None
        for step in range(2):
            eng.train_batch(batch=batch_of(8, seed=step))
        names = [e["name"] for e in eng.tracer.events()]
        assert names.count("train_step") == names.count("train_batch") == 2
    finally:
        tracing.reset_default()
    eng, *_ = dt.initialize(model=_twin(_params()), device="cpu",
                            config={"train_batch_size": 8})
    assert not eng.tracer.enabled


# ---------------------------------------------------------------------------
# the config blocks
# ---------------------------------------------------------------------------

BLOCKS = {
    "progressive_layer_drop": ({"enabled": True, "theta": 0.4,
                                "gamma": 0.01},
                               ("enabled", "theta", "gamma")),
    "activation_checkpointing": ({"partition_activations": True,
                                  "cpu_checkpointing": True,
                                  "contiguous_memory_optimization": True,
                                  "number_checkpoints": 3,
                                  "synchronize_checkpoint_boundary": True,
                                  "profile": True},
                                 ("partition_activations",
                                  "cpu_checkpointing",
                                  "contiguous_memory_optimization",
                                  "number_checkpoints",
                                  "synchronize_checkpoint_boundary",
                                  "profile")),
    "tensorboard": ({"enabled": False, "output_path": "/x",
                     "job_name": "j"}, ("enabled", "output_path",
                                        "job_name")),
    "csv_monitor": ({"enabled": False, "output_path": "/y"},
                    ("enabled", "output_path", "job_name")),
    "tracing": ({"enabled": False, "capacity": 16, "flight_events": 8,
                 "comm": False}, ("enabled", "capacity", "dir",
                                  "flight_events", "comm")),
}


@pytest.mark.parametrize("block", sorted(BLOCKS) + ["defaults"])
def test_ported_blocks_parse_as_the_jax_config(block):
    pd = {"train_batch_size": 2, "memory_breakdown": True,
          "dump_state": True}
    if block != "defaults":
        pd[block] = dict(BLOCKS[block][0])
    got, want = DeepSpeedConfig(dict(pd)), JaxDSConfig(dict(pd),
                                                       world_size=1)
    for name, (_, fields) in BLOCKS.items():
        for field in fields:
            assert getattr(getattr(got, name), field) == \
                getattr(getattr(want, name), field), (name, field)
    assert got.memory_breakdown is want.memory_breakdown is True
    assert got.dump_state is want.dump_state is True
    with pytest.raises(NotImplementedError, match="wandb"):
        DeepSpeedConfig({"train_batch_size": 2, "wandb": {"enabled": True}})
    assert DeepSpeedConfig({"train_batch_size": 2,
                            "wandb": {"enabled": False}})
