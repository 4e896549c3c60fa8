"""The port's ``pipe/`` against the JAX package's.

- The instruction streams of ``TrainSchedule``, ``InferenceSchedule``
  and ``DataParallelSchedule`` (a copy of the JAX module) are identical
  for S in {1, 2, 4} stages and M in {1, 3, 8} microbatches.
- ``PipelineModule`` finds the same homogeneous body and stage bounds as
  the JAX module for every ``partition_method`` and stage count.
- The port's one-stage ``PipelineEngine`` takes the loss and the
  gradients of JAX's two-stage pipeline (``_pipeline_loss_fn`` on a
  ``pipe`` mesh of the test's CPU devices) on the same tied module (the
  embedding doubles as the head), at 1e-5: fp32 in both, the two differ in
  summation order only.
- More than one stage raises naming ROADMAP item 9; ZeRO stage 3 and an
  unknown schedule raise as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.pipe as jpipe
from deepspeed_tpu.models.layers import cross_entropy_loss as jax_ce
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import pipe
from deepspeed_tpu_torch.models.layers import cross_entropy_loss
from torch_pipe_twins import Block, EmbedIn, HeadOut, block_state, edge_state

from unit.test_pipeline import Block as FBlock
from unit.test_pipeline import EmbedIn as FEmbedIn
from unit.test_pipeline import HeadOut as FHeadOut
from torch_threads import one_torch_thread  # noqa: F401


def _instructions(sched):
    return [[repr(cmd) for cmd in step] for step in sched]


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("M", [1, 3, 8])
def test_schedules_emit_the_jax_instruction_streams(S, M):
    for stage in range(S):
        for name in ("TrainSchedule", "InferenceSchedule"):
            got = getattr(pipe, name)(M, S, stage)
            want = getattr(jpipe, name)(M, S, stage)
            assert _instructions(got) == _instructions(want), (name, stage)
            assert got.num_pipe_buffers() == want.num_pipe_buffers()
    got, want = pipe.DataParallelSchedule(M, 1, 0), \
        jpipe.DataParallelSchedule(M, 1, 0)
    assert _instructions(got) == _instructions(want)
    from deepspeed_tpu.pipe.schedule import bubble_fraction
    from deepspeed_tpu_torch.pipe.schedule import bubble_fraction as pb
    assert pb(M, S) == bubble_fraction(M, S)


def _specs(pkg, embed, block, head, n_body, extra_head=False):
    layers = [pkg.LayerSpec(embed), *[pkg.LayerSpec(block)
                                      for _ in range(n_body)]]
    layers.append(pkg.LayerSpec(head))
    if extra_head:
        layers.append(pkg.LayerSpec(head))
    return layers


@pytest.mark.parametrize("method", ["uniform", "parameters", "type"])
def test_stage_bounds_match_the_jax_module(method):
    for S, n_body, extra in ((1, 4, False), (2, 4, False), (4, 8, True),
                             (2, 6, True)):
        jm = jpipe.PipelineModule(_specs(jpipe, FEmbedIn, FBlock, FHeadOut,
                                         n_body, extra), num_stages=S,
                                  loss_fn=jax_ce, partition_method=method)
        pm = pipe.PipelineModule(_specs(pipe, EmbedIn, Block, HeadOut,
                                        n_body, extra), num_stages=S,
                                 loss_fn=cross_entropy_loss,
                                 partition_method=method)
        assert pm._body_slice == jm._body_slice
        assert pm.layers_per_stage == jm.layers_per_stage
        lo, hi = jm._body_slice
        lp = jm.layers_per_stage
        want = [(0 if s == 0 else lo + s * lp,
                 len(jm.specs) if s == S - 1 else lo + (s + 1) * lp)
                for s in range(S)]
        assert pm.stage_bounds() == want
        assert len(pm) == len(jm)
    with pytest.raises(ValueError, match="does not divide"):
        pipe.PipelineModule(_specs(pipe, EmbedIn, Block, HeadOut, 3), 2,
                            cross_entropy_loss)


def _tied(pkg, embed, block, n_body, forward_fn, stages=1):
    return pkg.PipelineModule(
        [pkg.TiedLayerSpec("embed", embed),
         *[pkg.LayerSpec(block) for _ in range(n_body)],
         pkg.TiedLayerSpec("embed", embed, forward_fn=forward_fn)],
        num_stages=stages, loss_fn=jax_ce if pkg is jpipe
        else cross_entropy_loss)


def test_one_stage_engine_takes_the_loss_and_grads_of_the_jax_pipeline():
    from deepspeed_tpu.parallel import build_mesh
    from deepspeed_tpu.pipe.engine import _pipeline_loss_fn

    S, M, n_body = 2, 2, 4
    jm = _tied(jpipe, FEmbedIn, FBlock, n_body,
               lambda m, p, x: x @ p["embed"]["embedding"].T, stages=S)
    rs = np.random.RandomState(0)
    ids, labels = rs.randint(0, 64, (8, 8)), rs.randint(0, 64, (8, 8))
    params = jm.init_params(jax.random.PRNGKey(0), jnp.asarray(ids))
    loss_fn = _pipeline_loss_fn(jm, build_mesh(pipe=S), M)
    jloss, jgrads = jax.value_and_grad(lambda p: loss_fn(
        p, {"inputs": jnp.asarray(ids), "labels": jnp.asarray(labels)},
        None)[0])(params)

    pm = _tied(pipe, EmbedIn, Block, n_body,
               lambda m, x: x @ m.embed.weight.T)
    stages = jax.device_get(params["stages"])
    flat = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]),
                                  stages)
    with torch.no_grad():
        pm.tied["embed"].load_state_dict(edge_state(
            jax.device_get(params["tied"]["embed"])))
        for i, layer in enumerate(pm.body):
            layer.load_state_dict(block_state(
                jax.tree_util.tree_map(lambda a: a[i], flat)))
    engine, *_ = dt.initialize(
        model=pm, config={"train_batch_size": 8,
                          "gradient_accumulation_steps": M,
                          "steps_per_print": 0}, device="cpu")
    assert isinstance(engine, pipe.PipelineEngine)
    assert engine.micro_batches == M and engine.time_checkpoint_chunk == 2
    assert engine.gradient_accumulation_steps == 1
    batch = {"inputs": torch.from_numpy(ids), "labels": torch.from_numpy(labels)}
    loss = engine._loss(batch)
    grads = dict(zip(engine._trainable_names,
                     torch.autograd.grad(loss, engine._trainable)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    jg = jax.device_get(jgrads)
    gflat = jax.tree_util.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]),
                                   jg["stages"])
    want = {f"tied.embed.{k}": v for k, v in
            edge_state(jg["tied"]["embed"]).items()}
    for i in range(n_body):
        want.update({f"body.{i}.{k}": v for k, v in block_state(
            jax.tree_util.tree_map(lambda a: a[i], gflat)).items()})
    assert set(want) == set(grads)
    for name, w in want.items():
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # and a step trains
    before = float(engine.train_batch(batch=batch))
    assert float(engine.train_batch(batch=batch)) < before


def test_more_stages_raise_naming_item_9_and_bad_configs_raise():
    pm = pipe.PipelineModule(_specs(pipe, EmbedIn, Block, HeadOut, 4),
                             num_stages=2, loss_fn=cross_entropy_loss)
    with pytest.raises(NotImplementedError, match="item 9"):
        dt.initialize(model=pm, config={"train_batch_size": 4},
                      device="cpu")
    one = pipe.PipelineModule(_specs(pipe, EmbedIn, Block, HeadOut, 4),
                              num_stages=1, loss_fn=cross_entropy_loss)
    with pytest.raises(NotImplementedError, match="item 9"):
        dt.initialize(model=one, config={"train_batch_size": 4,
                                         "pipeline": {"stages": 2}},
                      device="cpu")
    with pytest.raises(ValueError, match="stage 3"):
        dt.initialize(model=one, config={"train_batch_size": 4,
                                         "zero_optimization": {"stage": 3}},
                      device="cpu")
    with pytest.raises(ValueError, match="schedule"):
        dt.initialize(model=one, config={"train_batch_size": 4, "pipeline": {
            "schedule": "interleaved"}}, device="cpu")
    with pytest.raises(ValueError, match="model_parameters"):
        dt.initialize(model=one, config={"train_batch_size": 4},
                      model_parameters={}, device="cpu")
    with pytest.raises(RuntimeError, match="nn.Module"):
        pipe.LayerSpec(int)
