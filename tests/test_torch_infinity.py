"""ZeRO-Infinity in the port (``runtime/zero/infinity.py``) against the
JAX package's ``ZeroInfinityEngine``.

The module of ``tests/unit/test_infinity.py`` (an embedding, 4 blocks of
width 32, a head) is built in flax; the JAX engine's initial bf16 weights
(its host body and device edges) go into the port's twin module, so both
engines start from the same bf16 weights and fp32 masters. Both stream
blocks of 2 layers in bf16 and step AdamW on the host; 3 steps at gas 2
with WarmupLR, on the same numpy-seeded batches. Tolerances: each step's
bf16 gradients leaf by leaf to bf16's resolution of the leaf's largest
element (the frameworks round at different places); the host step then
takes the JAX engine's gradients in both, and the losses, grad norms and
fp32 masters are held to 1e-5. The NVMe body, the full-NVMe mode and a
checkpoint round trip must step bitwise as the RAM run; the config
refusals raise as in JAX; the device holds the edges and two blocks.
"""

import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.pipe import LayerSpec as JLayerSpec
from deepspeed_tpu.pipe import PipelineModule as JPipelineModule
from deepspeed_tpu.models.layers import cross_entropy_loss as jax_ce
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models.layers import cross_entropy_loss
from deepspeed_tpu_torch.pipe import LayerSpec, PipelineModule
from deepspeed_tpu_torch.runtime.zero.infinity import ZeroInfinityEngine
from torch_pipe_twins import Block, EmbedIn, HeadOut, block_state, edge_state

from unit.test_infinity import Block as FBlock
from unit.test_infinity import Embed as FEmbed
from unit.test_infinity import Head as FHead
from torch_threads import one_torch_thread  # noqa: F401

VOCAB, HIDDEN = 64, 32


def _cfg(device="cpu", block_layers=2, gas=2, sched=True, **over):
    cfg = {"train_batch_size": 8, "gradient_accumulation_steps": gas,
           "zero_optimization": {"offload_param": {
               "device": device, "block_layers": block_layers}},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}},
           "steps_per_print": 0}
    if sched:
        cfg["scheduler"] = {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": 1e-2,
            "warmup_num_steps": 4, "warmup_type": "linear"}}
    cfg["zero_optimization"]["offload_param"].update(over)
    return cfg


def _port_module(layers=4, hidden=HIDDEN):
    return PipelineModule(
        [LayerSpec(EmbedIn, VOCAB, hidden),
         *[LayerSpec(Block, hidden) for _ in range(layers)],
         LayerSpec(HeadOut, VOCAB, hidden)],
        num_stages=1, loss_fn=cross_entropy_loss)


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"inputs": rs.randint(0, VOCAB, (8, 16)),
             "labels": rs.randint(0, VOCAB, (8, 16))} for _ in range(n)]


@pytest.fixture(scope="module")
def jax_start():
    """The JAX engine's initial bf16 weights, in the port's layout."""
    module = JPipelineModule(
        [JLayerSpec(FEmbed, hidden=HIDDEN),
         *[JLayerSpec(FBlock, hidden=HIDDEN) for _ in range(4)],
         JLayerSpec(FHead)], num_stages=1, loss_fn=jax_ce)
    engine, *_ = ds.initialize(model=module, config=_cfg(),
                               example_batch=_batches(1)[0],
                               rng=jax.random.PRNGKey(0))
    edges = jax.device_get(engine.edge_params)
    to32 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), tree)
    state = {"prefix.0." + k: v for k, v in
             edge_state(to32(edges["prefix"]["0"])).items()}
    state.update({"suffix.0." + k: v for k, v in
                  edge_state(to32(edges["suffix"]["0"])).items()})
    for i, layer in enumerate(engine.host_body):
        state.update({f"body.{i}.{k}": v
                      for k, v in block_state(to32(layer)).items()})
    return engine, state


def _port(state, config, layers=4):
    module = _port_module(layers)
    if state is not None:
        module.load_state_dict(state)
    engine, *_ = dt.initialize(model=module, config=config, device="cpu")
    return engine


def _host_state(engine):
    return [m.clone() for m in engine._host_opt.master]


def _jax_grads_in_port_order(grads, engine):
    """A JAX Infinity step's gradient tree ({"body": blocks, "edges"}) as
    the port engine's list of leaves: each block's stacked leaves by
    name, then the edges."""
    out = []
    for blk in grads["body"]:
        layers = [block_state(jax.tree_util.tree_map(lambda a: a[i], blk))
                  for i in range(engine.block_layers)]
        out += [torch.stack([l[n] for l in layers]) for n in engine._names]
    edges = {"prefix.0." + k: v for k, v in
             edge_state(grads["edges"]["prefix"]["0"]).items()}
    edges.update({"suffix.0." + k: v for k, v in
                  edge_state(grads["edges"]["suffix"]["0"]).items()})
    return out + [edges[n] for n in engine._edge_names]


def _jax_masters(jeng, peng):
    """The JAX Infinity engine's fp32 masters in the port's order."""
    tree = jax.tree_util.tree_structure(
        {"body": jeng.host_blocks, "edges": jeng.edge_params})
    shapes = [l.shape for l in jax.tree_util.tree_leaves(
        {"body": jeng.host_blocks, "edges": jeng.edge_params})]
    return _jax_grads_in_port_order(jax.tree_util.tree_unflatten(
        tree, [np.asarray(m).reshape(s) for m, s in
               zip(jeng._host_opt.master, shapes)]), peng)


def test_streams_the_jax_engines_steps(jax_start):
    """Three steps at gas 2 under WarmupLR. The gradients are bf16 in
    both, and the two frameworks round them at different places (XLA's
    CPU fusions keep fp32 inside a fusion, torch rounds each op's output),
    so each step's gradients are held leaf by leaf to 8 of bf16's steps
    (2**-5) of the leaf's largest element and of its norm (2.2% and 1.8%
    at most here; a gradient of the wrong sign or zero is off by 100% or
    more). The port's host step then takes the JAX engine's gradients, so
    the update path (the host step, the bf16 writeback into the staging
    blocks and the edges) is held exactly: the fp32 masters and the edges
    bitwise at every step, the grad norm at 1e-5. The losses: 1e-5 at the
    first step, from the same bf16 weights; then 1e-3, since with equal
    weights the two frameworks' bf16 forwards still round apart (1.7e-4
    at the third step)."""
    jeng, state = jax_start
    peng = _port(state, _cfg())
    assert isinstance(peng, ZeroInfinityEngine)
    assert peng.n_blocks == jeng.n_blocks == 2 and peng.gas == 2
    jax_grads, port_grads = [], []
    jstep, pstep = jeng._host_opt.step, peng._host_opt.step

    def jrecord(grads, **kw):
        grads = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                       grads)
        jax_grads.append(_jax_grads_in_port_order(grads, peng))
        return jstep(grads, **kw)

    def precord(grads, **kw):
        port_grads.append([g.clone() for g in grads])
        return pstep([g.clone() for g in jax_grads[-1]], **kw)

    jeng._host_opt.step = jrecord
    peng._host_opt.step = precord
    for step, batch in enumerate(_batches(3)):
        want = float(jeng.train_batch(batch))
        got = float(peng.train_batch(batch))
        np.testing.assert_allclose(got, want, rtol=1e-5 if step == 0
                                   else 1e-3)
        np.testing.assert_allclose(peng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-5)
        assert len(port_grads[-1]) == len(jax_grads[-1])
        for g, ref in zip(port_grads[-1], jax_grads[-1]):
            assert g.shape == ref.shape
            err = (g - ref).abs().max().item()
            assert err <= 2 ** -5 * ref.abs().max().item(), err
            assert (g - ref).norm() <= 2 ** -5 * ref.norm()
        # the same gradients, the same host kernel: the same masters
        assert all(torch.equal(mine, theirs.reshape(-1)) for mine, theirs
                   in zip(peng._host_opt.master, _jax_masters(jeng, peng)))
    assert peng._host_opt.current_lr() == jeng._host_opt.current_lr()
    assert peng.global_steps == jeng.global_steps == 3
    # the bf16 weights that the next step streams: the staging blocks and
    # the device edges
    to32 = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), jax.device_get(tree))
    want = _jax_grads_in_port_order({"body": to32(jeng.host_blocks),
                                     "edges": to32(jeng.edge_params)}, peng)
    mine = [blk[n] for blk in peng.host_blocks for n in peng._names] + \
        peng._edges
    assert len(mine) == len(want)
    for got, theirs in zip(mine, want):
        assert torch.equal(got.float().cpu(), theirs)


def test_streamed_gradients_equal_the_dense_gradients():
    """The block-streamed forward, the per-block recompute and the edges'
    two contributions give the gradients of the whole model run at once
    in bf16 on the same weights, bitwise."""
    torch.manual_seed(3)
    state = {k: v.to(torch.bfloat16).float()
             for k, v in _port_module().state_dict().items()}
    engine = _port(state, _cfg(gas=1, sched=False))
    seen = []
    step = engine._host_opt.step

    def record(grads, **kw):
        seen.extend(g.clone() for g in grads)
        return step(grads, **kw)

    engine._host_opt.step = record
    batch = _batches(1, seed=4)[0]
    engine.train_batch(batch)
    dense = _port_module()
    dense.load_state_dict(state)
    dense.to(torch.bfloat16)
    loss = dense(torch.as_tensor(batch["inputs"]),
                 torch.as_tensor(batch["labels"])).float()
    grads = dict(zip([n for n, _ in dense.named_parameters()],
                     torch.autograd.grad(loss, list(dense.parameters()))))
    want = [torch.stack([grads[f"body.{b * 2 + i}.{n}"] for i in range(2)])
            for b in range(2) for n in engine._names]
    want += [grads[n] for n in engine._edge_names]
    assert len(seen) == len(want)
    for got, w in zip(seen, want):
        assert torch.equal(got.reshape(-1), w.float().reshape(-1))


@pytest.mark.parametrize("mode", ["nvme_body", "full_nvme"])
def test_nvme_modes_step_bitwise_as_ram(mode, tmp_path):
    torch.manual_seed(0)
    state = _port_module().state_dict()
    ram = _port(state, _cfg())
    over = {"nvme_path": str(tmp_path / "swap")}
    config = _cfg("nvme", **over)
    if mode == "full_nvme":
        config["zero_optimization"]["offload_optimizer"] = {
            "device": "nvme", "nvme_path": str(tmp_path / "moments")}
    nvme = _port(state, config)
    for batch in _batches(2):
        assert float(ram.train_batch(batch)) == float(nvme.train_batch(batch))
    files = os.listdir(tmp_path / "swap")
    assert any(f.startswith("block") for f in files)
    assert all(torch.equal(a, b) for a, b in zip(_host_state(ram),
                                                 _host_state(nvme)))
    assert all(torch.equal(a[n], b[n]) for a, b in zip(
        ram.host_blocks, nvme.host_blocks) for n in a)
    if mode == "full_nvme":
        assert nvme._full_nvme and "masters" in files
        assert any(f.startswith("grad_block") for f in files)
        assert any(f.startswith("moment") for f in
                   os.listdir(tmp_path / "moments"))


def test_checkpoint_round_trip_resumes_bitwise(tmp_path):
    torch.manual_seed(1)
    state = _port_module().state_dict()
    batches = _batches(3, seed=2)
    first = _port(state, _cfg())
    for b in batches[:2]:
        first.train_batch(b)
    first.save_checkpoint(str(tmp_path))
    cont = float(first.train_batch(batches[2]))
    second = _port(None, _cfg())
    second.load_checkpoint(str(tmp_path))
    assert second.global_steps == 2 and second._host_opt.step_count == 2
    assert float(second.train_batch(batches[2])) == cont
    assert all(torch.equal(a, b) for a, b in zip(_host_state(first),
                                                 _host_state(second)))


def test_config_refusals_raise_as_in_jax():
    with pytest.raises(ValueError, match="offload_param"):
        ZeroInfinityEngine(_port_module(), config={"train_batch_size": 8},
                           device="cpu")
    with pytest.raises(ValueError, match="block_layers"):
        _port(None, _cfg(block_layers=3))
    with pytest.raises(NotImplementedError, match="item 9"):
        ZeroInfinityEngine(_port_module(), config=_cfg(), device="cpu",
                           mesh=object())
    two = PipelineModule([LayerSpec(EmbedIn), LayerSpec(Block),
                          LayerSpec(Block), LayerSpec(HeadOut)],
                         num_stages=2, loss_fn=cross_entropy_loss)
    with pytest.raises(ValueError, match="num_stages=1"):
        ZeroInfinityEngine(two, config=_cfg(), device="cpu")
    # more than one stage with offload_param goes to the PipelineEngine,
    # which needs as many devices
    with pytest.raises(NotImplementedError, match="item 9"):
        dt.initialize(model=two, config=_cfg(), device="cpu")
    with pytest.raises(ValueError, match="client optimizer"):
        dt.initialize(model=_port_module(), config=_cfg(), device="cpu",
                      optimizer=torch.optim.SGD([torch.zeros(1)], lr=1.0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if torch.cuda.is_available():
            raise RuntimeError("device='cpu'")
        dt.initialize(model=_port_module(), config=_cfg())


def test_device_holds_two_blocks_and_the_edges():
    engine = _port(None, _cfg(block_layers=1, gas=1, sched=False), layers=16)
    edges = sum(p.numel() * 2 for p in engine._edges)
    block = engine.body_param_bytes() // 16
    assert engine.device_resident_bytes() == edges + 2 * block
    assert engine.device_resident_bytes() < engine.body_param_bytes() / 4 \
        + edges
    engine.track_device_memory = True
    loss0 = engine.train_batch(_batches(1)[0]).item()
    assert engine.last_peak_device_bytes == engine.device_resident_bytes()
    # each block once forward and once backward, but for the two that the
    # slots still hold when the backward starts
    assert engine.h2d_bytes == (2 * 16 - 2) * block
    engine.prefetch = False
    assert float(engine.train_batch(_batches(1)[0])) < loss0
