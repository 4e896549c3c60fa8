"""The rest of the port's Llama training subset against the JAX package's.

Tiny Llama (2 layers, GQA 2, fp32), one set of flax params for both
packages (``checkpoint/from_flax.py``), numpy-seeded batches:

- remat policies: each of the four policies gives JAX's loss and gradients
  under the same policy (1e-5), and what a block keeps orders as
  ``nothing < dots_no_batch <= dots`` (tensors saved outside the blocks,
  counted with ``saved_tensors_hooks``, plus the matmul outputs each
  policy keeps); ``offload_dots_no_batch`` keeps the ``dots_no_batch`` set
  in its host stash and nothing more on the device than ``nothing``;
- the chunked loss: value and gradients against the JAX
  ``chunked_cross_entropy_loss`` (1e-6) with a bias, ignored labels and a
  ragged tail, and the model's loss and gradients with the tied and the
  untied head against the plain loss (``tests/unit/test_chunked_loss.py``);
- padded training: logits and loss with left and right padding against
  the JAX model (1e-5), and five engine steps on padded batches against the
  JAX engine (losses 1e-5, params 1e-4);
- progressive layer drop: the theta schedule (1e-7), the block gating
  against the JAX model with the keep decisions fixed in both (the JAX
  draw is patched inside the test), keep rates over 2000 draws within 4
  sigma of p_l, and the engine's theta and gates on the device count;
- ``checkpointing``: the JAX facade's tests
  (``tests/unit/test_checkpointing_api.py``) on the port's, and a
  checkpointed dropout block against the direct one.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models import layers as jax_layers
from deepspeed_tpu.parallel import topology
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JaxPLD
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch import checkpointing
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models import layers
from deepspeed_tpu_torch.models import llama as llama_mod
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from torch_threads import one_torch_thread  # noqa: F401

POLICIES = ["nothing", "dots", "dots_no_batch", "offload_dots_no_batch"]
B, T = 2, 12


def _flax_params(jcfg):
    return jax.device_get(jax.jit(JaxLlama(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _port_model(cfg, params):
    """The port's model on the flax params, each a leaf with a gradient."""
    model = LlamaForCausalLM(cfg)
    sd = {k: v.clone().requires_grad_(True)
          for k, v in flax_to_torch_state_dict(params, cfg).items()}
    model.load_state_dict(sd, assign=True)
    return model


def _grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _assert_grads(model, jax_grads, cfg, rtol=1e-5, atol=1e-6):
    want = flax_to_torch_state_dict(jax.device_get(jax_grads), cfg)
    got = _grads(model)
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


def _ids(seed=0, vocab=256, shape=(B, T)):
    return np.random.RandomState(seed).randint(0, vocab, shape)


# ---------------------------------------------------------------------------
# remat policies
# ---------------------------------------------------------------------------

def test_policy_names_and_error_match_jax():
    for name in POLICIES:
        assert layers.resolve_remat_policy(name).name == name
        jax_layers.resolve_remat_policy(name)
        assert LlamaConfig.tiny(remat_policy=name).remat_policy == name
    with pytest.raises(ValueError) as got:
        layers.resolve_remat_policy("everything")
    with pytest.raises(ValueError) as want:
        jax_layers.resolve_remat_policy("everything")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        LlamaConfig.tiny(remat_policy="all")
    with pytest.raises(ValueError, match="loss_chunk"):
        LlamaConfig.tiny(loss_chunk=-1)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_jax(policy):
    """Loss and every gradient of a padded batch (the plain attention, so
    ``dots`` also keeps the attention's batched matmuls) against the JAX
    model under the same policy."""
    jcfg = JaxConfig.tiny(remat=True, remat_policy=policy)
    params = _flax_params(jcfg)
    ids = _ids(1)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    jmodel = JaxLlama(jcfg)
    want, jgrads = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask)))(params)
    cfg = LlamaConfig.tiny(remat=True, remat_policy=policy)
    model = _port_model(cfg, params)
    t = torch.from_numpy(ids)
    loss = model(t, labels=t, attention_mask=torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _assert_grads(model, jgrads, cfg)


def _kept_bytes(policy, monkeypatch):
    """(bytes saved outside the blocks, matmul outputs a policy keeps on
    the device, bytes in the offload stash) over one padded training
    forward, and the loss."""
    kept = []
    real = layers._save_policy

    def counting(saved):
        inner = real(saved)

        def policy_fn(ctx, func, *args, **kwargs):
            decision = inner(ctx, func, *args, **kwargs)
            if decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE \
                    and not ctx.is_recompute:
                kept.append(ctx.op_output.numel() *
                            ctx.op_output.element_size())
            return decision
        return policy_fn

    monkeypatch.setattr(layers, "_save_policy", counting)
    cfg = LlamaConfig.tiny(remat=True, remat_policy=policy)
    model = _port_model(cfg, _flax_params(JaxConfig.tiny()))
    outside = []

    def pack(t):
        outside.append(t.numel() * t.element_size())
        return t

    ids = torch.from_numpy(_ids(2))
    mask = torch.ones_like(ids)
    mask[0, :3] = 0
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = model(ids, labels=ids, attention_mask=mask)
    stash = sum(s.nbytes for s in model.model._stashes)
    loss.backward()
    return sum(outside), sum(kept), stash, float(loss.detach())


def test_what_each_policy_keeps(monkeypatch):
    got = {p: _kept_bytes(p, monkeypatch) for p in POLICIES}
    outside = {p: g[0] for p, g in got.items()}
    assert len(set(outside.values())) == 1, outside
    device = {p: g[0] + g[1] for p, g in got.items()}
    assert device["nothing"] < device["dots_no_batch"] <= device["dots"]
    # the attention einsums are batched: dots keeps them, dots_no_batch not
    assert device["dots_no_batch"] < device["dots"]
    assert device["offload_dots_no_batch"] == device["nothing"]
    assert got["offload_dots_no_batch"][2] == got["dots_no_batch"][1] > 0
    assert all(g[2] == 0 for p, g in got.items()
               if p != "offload_dots_no_batch")
    assert len({g[3] for g in got.values()}) == 1, "the same forward"


def test_offload_stash_is_reused_across_steps():
    """The stash keeps one buffer a (save, shape, dtype): a second step
    reuses every buffer."""
    cfg = LlamaConfig.tiny(remat=True, remat_policy="offload_dots_no_batch")
    model = _port_model(cfg, _flax_params(JaxConfig.tiny()))
    ids = torch.from_numpy(_ids(3))
    model(ids, labels=ids).backward()
    first = {k: v.data_ptr() for s in model.model._stashes
             for k, v in s.buffers.items()}
    model(ids, labels=ids).backward()
    again = {k: v.data_ptr() for s in model.model._stashes
             for k, v in s.buffers.items()}
    assert first == again and len(first) == 7 * cfg.num_hidden_layers // 2


# ---------------------------------------------------------------------------
# the chunked loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ignore_ragged", "bias", "one_chunk"])
def test_chunked_loss_matches_jax(case):
    rs = np.random.RandomState(0)
    b, t, h, v, chunk = {"ignore_ragged": (2, 24, 16, 50, 10),
                         "bias": (2, 8, 12, 33, 5),
                         "one_chunk": (1, 6, 8, 20, 64)}[case]
    hidden = rs.randn(b, t, h).astype(np.float32)
    w = (rs.randn(h, v) * 0.1).astype(np.float32)
    bias = (rs.randn(v) * 0.1).astype(np.float32) if case == "bias" \
        else None
    labels = rs.randint(0, v, (b, t))
    labels[0, :5] = -100

    def jax_loss(hidden, w, bias):
        return jax_layers.chunked_cross_entropy_loss(
            hidden, w, jnp.asarray(labels), bias=bias, chunk=chunk)

    argnums = (0, 1, 2) if bias is not None else (0, 1)
    jl, jg = jax.value_and_grad(jax_loss, argnums=argnums)(
        jnp.asarray(hidden), jnp.asarray(w),
        None if bias is None else jnp.asarray(bias))
    th = torch.from_numpy(hidden).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(
        True)
    loss = layers.chunked_cross_entropy_loss(
        th, tw, torch.from_numpy(labels), bias=tb, chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6,
                               atol=1e-6)
    got = [th.grad, tw.grad] + ([tb.grad] if tb is not None else [])
    for g, want in zip(got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    # the plain loss is the same function
    plain = layers.cross_entropy_loss(
        torch.from_numpy(hidden) @ torch.from_numpy(w) +
        (0 if bias is None else torch.from_numpy(bias)),
        torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss.detach()), float(plain),
                               rtol=1e-6)


def test_chunked_loss_masks_everything_to_zero():
    """Every label ignored: ``s / max(c, 1)`` = 0, with zero gradients."""
    h = torch.randn(1, 4, 8, requires_grad=True)
    w = torch.randn(8, 16, requires_grad=True)
    loss = layers.chunked_cross_entropy_loss(
        h, w, torch.full((1, 4), -100), chunk=3)
    loss.backward()
    assert float(loss.detach()) == 0.0 and not h.grad.abs().sum() and \
        not w.grad.abs().sum()


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_model_chunked_loss_matches_the_plain_loss_and_jax(tied):
    """``tests/unit/test_chunked_loss.py``'s model-level case (loss 1e-5,
    gradients 1e-4), then the port's chunked loss and gradients against
    the JAX chunked model's."""
    kw = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=4, max_position_embeddings=32,
              tie_word_embeddings=tied, remat=False)
    params = _flax_params(JaxConfig(**kw))
    ids = _ids(2, 128, (2, 16))
    jmodel = JaxLlama(JaxConfig(**kw, loss_chunk=8))
    jl, jg = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids)))(params)
    t = torch.from_numpy(ids)
    out = {}
    for chunk in (0, 8):
        cfg = LlamaConfig(**kw, loss_chunk=chunk)
        model = _port_model(cfg, params)
        loss = model(t, labels=t)
        loss.backward()
        out[chunk] = (float(loss.detach()), _grads(model))
    np.testing.assert_allclose(out[8][0], out[0][0], rtol=1e-5, atol=1e-6)
    for name, g in out[0][1].items():
        np.testing.assert_allclose(out[8][1][name].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out[8][0], float(jl), rtol=1e-5)
    want = flax_to_torch_state_dict(jax.device_get(jg), LlamaConfig(**kw))
    for name, g in want.items():
        np.testing.assert_allclose(out[8][1][name].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    with torch.no_grad():
        assert model(t).shape == (2, 16, 128), "logits without labels"


# ---------------------------------------------------------------------------
# padded training
# ---------------------------------------------------------------------------

def _masks(kind):
    mask = np.ones((B, T), np.int32)
    if kind == "left":
        mask[0, :4] = 0
        mask[1, :1] = 0
    else:
        mask[0, 8:] = 0
        mask[1, 11:] = 0
    return mask


@pytest.mark.parametrize("kind", ["left", "right"])
def test_padded_forward_matches_jax(kind):
    """Logits and loss with a padding mask against the JAX model (1e-5);
    a left-padding query sees only pads and gets JAX's uniform weights,
    so its logits are finite and equal too."""
    jcfg = JaxConfig.tiny(remat=False)
    params = _flax_params(jcfg)
    ids = _ids(4)
    mask = _masks(kind)
    labels = np.where(mask > 0, ids, -100)
    jmodel = JaxLlama(jcfg)
    j = dict(attention_mask=jnp.asarray(mask))
    want_logits = jmodel.apply({"params": params}, jnp.asarray(ids), **j)
    want_loss = jmodel.apply({"params": params}, jnp.asarray(ids),
                             labels=jnp.asarray(labels), **j)
    model = _port_model(LlamaConfig.tiny(), params)
    t, m = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        logits = model(t, attention_mask=m)
        loss = model(t, labels=torch.from_numpy(labels), attention_mask=m)
    assert torch.isfinite(logits).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


def test_biased_attention_matches_jax_where_a_row_sees_only_pads():
    """Every masked logit rounds to -1e9 (-2e9 for a future pad), so a
    query that sees only pads spreads its weight evenly over the -1e9
    keys, as the JAX XLA path does: finite, and equal to JAX's (1e-6)."""
    rs = np.random.RandomState(3)
    q, k, v = (rs.randn(1, 4, 2, 8).astype(np.float32) for _ in range(3))
    mask = np.array([[0, 0, 1, 1]])
    want = jax_layers.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        bias=jax_layers.key_mask_to_bias(jnp.asarray(mask)), causal=True)
    got = layers.biased_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        layers.key_mask_to_bias(torch.from_numpy(mask)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # query 1 sees pads 0 and 1; keys 2 and 3 are in its future: all -1e9
    np.testing.assert_allclose(got[0, 1].numpy(), v[0].mean(0),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture
def one_device_mesh():
    saved = topology.get_mesh(), topology.get_topology()
    mesh = topology.build_mesh(devices=jax.devices()[:1])
    yield mesh
    topology.set_mesh(*saved)


def test_padded_engine_steps_match_the_jax_engine(one_device_mesh):
    """Five AdamW steps with clipping on right- and left-padded batches
    (labels -100 on the pads), remat under ``dots`` and the chunked loss
    in both packages: losses 1e-5, final params 1e-4. The lr is 1e-3:
    padding leaves gradients near 0, whose fp32 sign the two frameworks'
    summation orders can flip, and Adam then moves such a param by ~lr a
    step in opposite directions (at lr 3e-3 one weight of 8192 parts by
    1.9e-4 after five steps, with or without dots and the chunked loss,
    while the losses agree to 1e-7)."""
    over = dict(remat=True, remat_policy="dots", loss_chunk=16)
    jcfg = JaxConfig.tiny(**over)
    params = _flax_params(jcfg)
    config = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.1}},
              "gradient_clipping": 0.5, "steps_per_print": 0}
    jeng, *_ = ds.initialize(model=JaxLlama(jcfg), config=dict(config),
                             model_parameters=params, mesh=one_device_mesh)
    cfg = LlamaConfig.tiny(**over)
    peng, *_ = dt.initialize(model=LlamaForCausalLM(cfg), config=dict(config),
                             model_parameters=flax_to_torch_state_dict(
                                 params, cfg), device="cpu")
    rs = np.random.RandomState(5)
    for step in range(5):
        ids = rs.randint(0, 256, (4, T)).astype(np.int32)
        lengths = rs.randint(4, T + 1, 4)
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.int32)
        if step % 2:
            mask = mask[:, ::-1].copy()
        batch = {"input_ids": ids, "labels": np.where(mask > 0, ids, -100),
                 "attention_mask": mask}
        want = float(jeng.train_batch(batch=batch))
        got = float(peng.train_batch(batch=batch))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    want = flax_to_torch_state_dict(jax.device_get(jeng.state.params), cfg)
    for name, p in peng.module_state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# progressive layer drop
# ---------------------------------------------------------------------------

def test_pld_theta_schedule_matches_jax():
    for theta, gamma in ((0.5, 0.001), (0.3, 0.1), (0.9, 0.01)):
        got, want = ProgressiveLayerDrop(theta, gamma), JaxPLD(theta, gamma)
        for step in (0, 1, 7, 100, 5000):
            for s in (step, torch.tensor(step, dtype=torch.int32)):
                g = got.get_theta(s)
                assert g.dtype == torch.float32 and g.dim() == 0
                np.testing.assert_allclose(float(g),
                                           float(want.get_theta(step)),
                                           rtol=1e-7, atol=1e-7)
        assert got.get_state() == want.get_state()


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
def test_pld_gating_matches_jax_with_fixed_keep_decisions(scan, monkeypatch):
    """theta 0.6 over 4 layers with the keep decisions fixed (layers 1
    and 3 dropped) in both packages: loss and gradients 1e-5."""
    kw = dict(num_hidden_layers=4, remat=True, scan_layers=scan)
    jcfg = JaxConfig.tiny(**kw)
    params = _flax_params(jcfg)
    keep = np.array([True, False, True, False])
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p: jnp.asarray(keep))
    monkeypatch.setattr(llama_mod, "pld_keep",
                        lambda p, generator=None: torch.from_numpy(keep))
    ids = _ids(6)
    jmodel = JaxLlama(jcfg)
    want, jgrads = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
        pld_theta=jnp.float32(0.6),
        rngs={"pld": jax.random.PRNGKey(1)}))(params)
    cfg = LlamaConfig.tiny(**kw)
    model = _port_model(cfg, params)
    t = torch.from_numpy(ids)
    loss = model(t, labels=t, pld_theta=torch.tensor(0.6))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    _assert_grads(model, jgrads, cfg)
    p = 1 - (np.arange(4) + 1) / 4 * 0.4
    np.testing.assert_allclose(model.model.last_pld_gates.numpy(),
                               np.where(keep, 1 / p, 0), rtol=1e-6)


def test_pld_keep_rates_follow_p_l():
    """2000 draws of 24 layers' gates at theta 0.5 from one generator:
    each layer keeps within 4 sigma of 2000 p_l, and a dropped layer's
    gate is 0, a kept one's 1 / p_l."""
    L, n, theta = 24, 2000, 0.5
    g = torch.Generator().manual_seed(0)
    gates = torch.stack([llama_mod.pld_gates(torch.tensor(theta), L, g)
                         for _ in range(n)])
    p = 1 - (np.arange(L) + 1) / L * (1 - theta)
    kept = (gates > 0).sum(0).numpy()
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(kept - n * p) <= 4 * sigma + 1e-9), (kept, n * p)
    np.testing.assert_allclose(gates.max(0).values.numpy(), 1 / p,
                               rtol=1e-6)


def test_engine_pld_theta_follows_the_device_count():
    """The engine computes theta on its step count each step and the model
    draws its gates from the engine's generator; loss_fn and a model
    without pld_theta are refused, as in JAX."""
    config = {"train_batch_size": 2, "steps_per_print": 0,
              "progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                         "gamma": 0.1}}
    eng, *_ = dt.initialize(model=LlamaForCausalLM(LlamaConfig.tiny()),
                            config=config, device="cpu")
    ids = _ids(7, shape=(2, 8))
    sched, gates = JaxPLD(0.5, 0.1), []
    for step in range(4):
        assert np.isfinite(float(eng.train_batch(
            batch={"input_ids": ids, "labels": ids})))
        np.testing.assert_allclose(float(eng.pld_theta),
                                   float(sched.get_theta(step)), rtol=1e-7)
        gates.append(eng.module.model.last_pld_gates.clone())
    assert torch.equal(gates[0], torch.ones(2)), "theta 1 keeps every layer"
    with pytest.raises(ValueError, match="default model loss path"):
        dt.initialize(model=LlamaForCausalLM(LlamaConfig.tiny()),
                      config=config, device="cpu",
                      loss_fn=lambda m, b, g: (m(**b), ()))

    class NoPLD(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(2))

        def forward(self, x):
            return (self.w * x).sum()

    with pytest.raises(ValueError, match="accepting pld_theta"):
        dt.initialize(model=NoPLD(), config=config, device="cpu")


# ---------------------------------------------------------------------------
# the activation-checkpointing API
# ---------------------------------------------------------------------------

@pytest.fixture
def reset_checkpointing():
    checkpointing.reset()
    ds.checkpointing.reset()
    yield
    checkpointing.reset()
    ds.checkpointing.reset()


def _block(w, x):
    h = torch.tanh(x @ w)
    return torch.sum(h * h)


def _jax_block(w, x):
    h = jnp.tanh(x @ w)
    return jnp.sum(h * h)


@pytest.mark.parametrize("cpu", [False, True], ids=["nothing", "offload"])
def test_checkpoint_matches_direct_value_and_grad(reset_checkpointing, cpu):
    """As the JAX test: value 1e-6, gradients 5e-5; and against the JAX
    facade's value and gradient under the same configuration."""
    checkpointing.configure(checkpoint_in_cpu=cpu)
    ds.checkpointing.configure(checkpoint_in_cpu=cpu)
    rs = np.random.RandomState(0)
    w, x = rs.randn(16, 16).astype(np.float32), \
        rs.randn(4, 16).astype(np.float32)
    tw = torch.from_numpy(w).requires_grad_(True)
    tx = torch.from_numpy(x)
    direct = _block(tw, tx)
    (dg,) = torch.autograd.grad(direct, tw)
    ck = checkpointing.checkpoint(_block, tw, tx)
    (cg,) = torch.autograd.grad(ck, tw)
    np.testing.assert_allclose(float(ck), float(direct), rtol=1e-6)
    np.testing.assert_allclose(cg.numpy(), dg.numpy(), rtol=5e-5, atol=1e-6)
    jv, jg = jax.value_and_grad(lambda w: ds.checkpointing.checkpoint(
        _jax_block, w, jnp.asarray(x)))(jnp.asarray(w))
    np.testing.assert_allclose(float(ck), float(jv), rtol=1e-5)
    np.testing.assert_allclose(cg.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5)


def _dropout_block(w, x, fork):
    h = torch.tanh(x @ w)
    with (checkpointing.get_cuda_rng_tracker().fork() if fork
          else contextlib.nullcontext()):
        h = torch.nn.functional.dropout(h, 0.5, training=True)
    return torch.sum(h * h)


@pytest.mark.parametrize("fork", [False, True], ids=["global", "tracker"])
@pytest.mark.parametrize("cpu", [False, True], ids=["nothing", "offload"])
def test_checkpointed_dropout_matches_direct_grad(reset_checkpointing, cpu,
                                                  fork):
    """A block that draws dropout masks, from the default generator or
    under the tracker's ``fork()``: checkpointed, its value and gradient
    equal the direct block's on the same seeds (the recompute draws the
    forward's masks again, as ``jax.checkpoint`` replays its key), and
    both generators end where the direct run left them."""
    checkpointing.configure(checkpoint_in_cpu=cpu)
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.randn(16, 16).astype(np.float32))
    x = torch.from_numpy(rs.randn(8, 16).astype(np.float32))
    tracker = checkpointing.get_cuda_rng_tracker()

    def run(fn):
        checkpointing.model_parallel_cuda_manual_seed(5)
        torch.manual_seed(0)
        tw = w.clone().requires_grad_(True)
        v = fn(_dropout_block, tw, x, fork)
        (g,) = torch.autograd.grad(v, tw)
        return v, g, tracker.get_states()["model-parallel-rng"], \
            torch.get_rng_state()

    dv, dg, d_tracked, d_global = run(lambda f, *a: f(*a))
    cv, cg, c_tracked, c_global = run(checkpointing.checkpoint)
    assert float(cv) == float(dv)
    assert torch.equal(cg, dg)
    assert torch.equal(c_tracked, d_tracked)
    assert torch.equal(c_global, d_global)
    # the masks matter: the next draws give another value
    assert float(_dropout_block(w, x, fork)) != float(dv)


def test_checkpoint_actually_remats(reset_checkpointing):
    """The block's forward runs again in the backward."""
    calls = []

    def block(w, x):
        calls.append(1)
        return _block(w, x)

    w = torch.ones(8, 8, requires_grad=True)
    checkpointing.checkpoint(block, w, torch.ones(2, 8)).backward()
    assert len(calls) == 2


def test_configure_from_ds_config_maps_cpu_checkpointing(reset_checkpointing):
    cfg = {"activation_checkpointing": {"cpu_checkpointing": True,
                                        "profile": True,
                                        "number_checkpoints": 4}}
    checkpointing.configure(deepspeed_config=cfg)
    ds.checkpointing.configure(deepspeed_config=cfg)
    assert checkpointing.is_configured()
    for key in ("policy", "profile", "num_checkpoints"):
        assert checkpointing._config[key] == ds.checkpointing._config[key]
    assert checkpointing._config["policy"] == "offload_dots_no_batch"
    v = checkpointing.checkpoint(_block, torch.ones(8, 8), torch.ones(2, 8))
    assert np.isfinite(float(v))
    with pytest.raises(ValueError, match="unknown keys"):
        checkpointing.configure(deepspeed_config={
            "activation_checkpointing": {"cpu_checkpoint": True}})


def test_repeated_configure_refines_never_resets(reset_checkpointing):
    checkpointing.configure(deepspeed_config={
        "activation_checkpointing": {"cpu_checkpointing": True}})
    checkpointing.configure(num_checkpoints=8)
    assert checkpointing._config["policy"] == "offload_dots_no_batch"
    assert checkpointing._config["num_checkpoints"] == 8


def test_rng_tracker_holds_real_generator_states(reset_checkpointing):
    """``model_parallel_cuda_manual_seed`` registers the seed's state;
    ``fork`` draws from a tracked state and keeps where it left it,
    leaving the default generator as it was."""
    checkpointing.model_parallel_cuda_manual_seed(1234)
    assert checkpointing.get_rng_state()["seed"] == 1234
    tracker = checkpointing.get_cuda_rng_tracker()
    assert tracker.seeds["model-parallel-rng"] == 1234
    tracker.add("model-parallel-rng", 7)
    ref = torch.Generator().manual_seed(7)
    before = torch.get_rng_state()
    with tracker.fork():
        first = torch.rand(4)
    with tracker.fork():
        second = torch.rand(4)
    assert torch.equal(first, torch.rand(4, generator=ref))
    assert torch.equal(second, torch.rand(4, generator=ref))
    assert torch.equal(torch.get_rng_state(), before)
    assert torch.equal(tracker.get_states()["model-parallel-rng"],
                       ref.get_state())
    with pytest.raises(KeyError):
        with tracker.fork("other"):
            pass


def test_manual_seed_registers_in_tracker_and_reset(reset_checkpointing):
    checkpointing.model_parallel_cuda_manual_seed(99)
    tracker = checkpointing.get_cuda_rng_tracker()
    assert tracker.seeds["model-parallel-rng"] == 99
    assert torch.equal(tracker.get_states()["model-parallel-rng"],
                       torch.Generator().manual_seed(99).get_state())
    states = tracker.get_states()
    tracker.reset()
    assert tracker.get_states() == {}
    tracker.set_states(states)
    assert set(tracker.get_states()) == {"model-parallel-rng"}
