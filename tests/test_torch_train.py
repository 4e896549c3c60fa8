"""The port's training stack against the JAX package's.

- Config: the batch triangulation of both ``DeepSpeedConfig`` classes on
  the same dicts, and every block the port does not implement raising
  ``NotImplementedError`` that names its ``ROADMAP.md`` queue entry.
- LR schedules over 50 steps (Python int and device-count tensor steps)
  and the fp16 loss-scale automaton over an overflow sequence (Python and
  tensor flags), against the JAX ones (both fp32: schedules at 1e-6
  relative; the automaton exactly).
- The engine: the flax params of ``LlamaConfig.tiny`` go to the JAX engine
  as ``model_parameters`` and, through ``checkpoint/from_flax.py``, to the
  port's engine; both train five steps in fp32 on the same numpy-seeded
  batches. The JAX engine gets a one-device mesh, so it triangulates the
  same batch as the port (the global-mean loss is the same math at any
  data-parallel width). Tolerances: losses 1e-5 relative and final params
  1e-4 (absolute and relative); the two differ only in fp32 summation
  order, compounded over five Adam (or LAMB) steps. LAMB runs with the
  JAX model's layers scanned (one trust ratio an ``[L, ...]`` leaf, which
  the port spans over the per-layer tensors) and unscanned. Then
  ``eval_batch``, the ``forward``/``backward``/``step`` micro-step API and
  an fp16 step that overflows and is skipped.
- The generic transformer (``models/transformer.py``) in both engines:
  BERT's MLM model under an MLM ``loss_fn`` on LAMB, scanned and
  unscanned, and an OPT-style LM on AdamW, five steps each (losses 1e-5,
  final params 1e-4).
- The device-resident step against JAX ``TrainState``: gas 2 with
  WarmupDecayLR, OneCycle, and fp16 dynamic scaling through two
  overflows, a recovery and a third overflow. After every step the
  port's device step count, skipped steps, loss scale and lr equal the
  JAX state's (exactly; the lr at 1e-6) and the losses agree (fp32
  1e-5, fp16 5e-4: the two frameworks round fp16 activations at
  different places). The final fp32 params are held at 1e-4, except the
  elements whose gradient was, at some step, nonzero and at most fp32's
  epsilon times the global gradient norm: such a gradient is rounding
  noise in both packages (OneCycle's ``embed_tokens[222, 33]`` has -1.7e-8
  in the port, -6.5e-9 in the JAX engine, at a norm of 4.37), and Adam
  normalizes it into an update of up to ~lr either way; those are held to
  twice the summed lr.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.parallel import topology
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDSConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_ls
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, FP16Config
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler
from torch_threads import one_torch_thread  # noqa: F401

STEPS = 5
BATCH, SEQ = 4, 16

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

BATCH_CONFIGS = {
    "train": {"train_batch_size": 8},
    "micro": {"train_micro_batch_size_per_gpu": 4},
    "train_micro": {"train_batch_size": 8,
                    "train_micro_batch_size_per_gpu": 2},
    "train_gas": {"train_batch_size": 12, "gradient_accumulation_steps": 3},
    "micro_gas": {"train_micro_batch_size_per_gpu": 2,
                  "gradient_accumulation_steps": 4},
    "all_auto": {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
                 "gradient_accumulation_steps": "auto"},
}


@pytest.mark.parametrize("case", sorted(BATCH_CONFIGS))
def test_batch_triangulation_matches_jax(case):
    pd = BATCH_CONFIGS[case]
    got, want = DeepSpeedConfig(dict(pd)), JaxDSConfig(dict(pd), world_size=1)
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                "gradient_accumulation_steps"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.precision == want.precision == "fp32"


def test_config_checks(tmp_path):
    with pytest.raises((ValueError, AssertionError)):
        JaxDSConfig({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3,
                     "gradient_accumulation_steps": 2})
    with pytest.raises(ValueError, match="train_batch_size is not equal"):
        DeepSpeedConfig({"train_batch_size": 8,
                         "train_micro_batch_size_per_gpu": 3,
                         "gradient_accumulation_steps": 2})
    with pytest.raises(ValueError, match="needs to be provided"):
        DeepSpeedConfig({})
    with pytest.raises(ValueError, match="unknown DeepSpeed config keys"):
        DeepSpeedConfig({"train_batch_size": 2, "trian_batch": 1})
    with pytest.raises(ValueError, match="fp16: unknown keys"):
        DeepSpeedConfig({"train_batch_size": 2, "fp16": {"enable": True}})
    with pytest.raises(ValueError, match="cannot both"):
        DeepSpeedConfig({"train_batch_size": 2, "fp16": {"enabled": True},
                         "bf16": {"enabled": True}})
    path = tmp_path / "ds.json"
    path.write_text('{"train_batch_size": 2, "train_batch_size": 4}')
    with pytest.raises(ValueError, match="Duplicate keys"):
        DeepSpeedConfig(str(path))
    path.write_text(json.dumps({"train_batch_size": 4, "bf16": {
        "enabled": True}, "gradient_clipping": "auto"}))
    cfg = DeepSpeedConfig(str(path))
    assert (cfg.precision, cfg.gradient_clipping) == ("bf16", 0.0)
    assert FP16Config.from_dict({"loss_scale": "auto"}).loss_scale == 0.0


UNPORTED = {
    "overlap_grad_sync": {"zero_optimization": {"overlap_grad_sync": True}},
    "sparse_gradients": {"sparse_gradients": True},
    "curriculum_learning": {"curriculum_learning": {"enabled": True}},
    "quantize_training": {"quantize_training": {"enabled": True}},
    "compression_training": {"compression_training": {
        "weight_quantization": {}}},
    "pipeline": {"pipeline": {"stages": 2}},
    "parallel": {"parallel": {"tensor": 2}},
    "flops_profiler": {"flops_profiler": {"enabled": True}},
    "elasticity": {"elasticity": {"enabled": True}},
    # the block itself is ported; its heartbeat acts under elasticity
    "fault_tolerance": {"fault_tolerance": {"heartbeat_interval": 5},
                        "elasticity": {"enabled": True}},
    "onebit": {"optimizer": {"type": "OneBitAdam", "params": {}}},
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_knobs_raise(case):
    model = LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        dt.initialize(model=model, config={"train_batch_size": 2,
                                           **UNPORTED[case]}, device="cpu")


#: knobs that raised until the offload slice: ZeRO stages 1-3 (nothing to
#: shard on one device), the offload blocks (``offload_param`` on a model
#: that is not a ``PipelineModule`` is accepted and unread, as in JAX) and
#: the Adagrad optimizer
PORTED_SINCE_OFFLOAD = {
    "zero_stage1": {"zero_optimization": {"stage": 1}},
    "offload_optimizer": {"zero_optimization": {
        "offload_optimizer": {"device": "cpu"}}},
    "offload_param": {"zero_optimization": {"offload_param": {
        "device": "cpu"}}},
    "adagrad": {"optimizer": {"type": "Adagrad", "params": {}}},
}


@pytest.mark.parametrize("case", sorted(PORTED_SINCE_OFFLOAD))
def test_knobs_that_raised_before_the_offload_slice_train(case):
    model = LlamaForCausalLM(LlamaConfig.tiny())
    engine, *_ = dt.initialize(model=model, config={
        "train_batch_size": 2, **PORTED_SINCE_OFFLOAD[case]}, device="cpu")
    ids = np.random.RandomState(0).randint(0, 64, (2, 8))
    loss = engine.train_batch(batch={"input_ids": ids, "labels": ids})
    assert np.isfinite(float(loss))
    assert (engine.optimizer is None) == (case == "offload_optimizer")


def test_amp_block_is_ignored_with_a_warning_as_in_jax(one_device_mesh,
                                                       monkeypatch):
    """Both configs accept an enabled ``amp`` block with a warning, and two
    steps with it take the losses of two steps without it, in both
    engines."""
    from deepspeed_tpu.runtime import config as jax_config_mod
    from deepspeed_tpu_torch.runtime import config as config_mod

    warned = {"jax": [], "port": []}
    monkeypatch.setattr(jax_config_mod.logger, "warning",
                        lambda msg, *a, **k: warned["jax"].append(msg))
    monkeypatch.setattr(config_mod.logger, "warning",
                        lambda msg, *a, **k: warned["port"].append(msg))
    amp = {"amp": {"enabled": True}}
    base = CASES["adamw_gas_clip_warmup"][1]
    for cls, key in ((JaxDSConfig, "jax"), (DeepSpeedConfig, "port")):
        before = len(warned[key])
        cls({"train_batch_size": 1, **amp})
        assert [m for m in warned[key][before:] if "amp" in m], key
    losses = {}
    for name, config in (("plain", base), ("amp", {**base, **amp})):
        jeng, (peng, *_), cfg = _engines({}, config, one_device_mesh)
        losses[name] = [
            (float(jeng.train_batch(batch={"input_ids": ids,
                                           "labels": ids})),
             float(peng.train_batch(batch={"input_ids": ids,
                                           "labels": ids})))
            for ids in _batches(cfg.vocab_size, n=2)]
    assert losses["amp"] == losses["plain"]
    for want, got in losses["amp"]:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_unported_initialize_arguments_raise():
    """An ``mpu`` names the distributed slice; a padded training batch
    (its ``attention_mask``) trains."""
    model = LlamaForCausalLM(LlamaConfig.tiny())
    cfg = {"train_batch_size": 2}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        dt.initialize(model=model, config=cfg, device="cpu", mpu=object())
    engine, *_ = dt.initialize(model=model, config=cfg, device="cpu")
    ids = np.zeros((2, 8), np.int64)
    mask = np.ones_like(ids)
    mask[0, 5:] = 0
    assert np.isfinite(float(engine.train_batch(batch={
        "input_ids": ids, "labels": np.where(mask > 0, ids, -100),
        "attention_mask": mask})))


# ---------------------------------------------------------------------------
# lr schedules and the loss scaler
# ---------------------------------------------------------------------------

SCHEDULES = {
    "WarmupLR_log": ("WarmupLR", {"warmup_min_lr": 1e-5,
                                  "warmup_max_lr": 3e-3,
                                  "warmup_num_steps": 20}),
    "WarmupLR_linear": ("WarmupLR", {"warmup_min_lr": 0.0,
                                     "warmup_max_lr": 1e-3,
                                     "warmup_num_steps": 15,
                                     "warmup_type": "linear"}),
    "WarmupDecayLR": ("WarmupDecayLR", {"warmup_min_lr": 1e-5,
                                        "warmup_max_lr": 2e-3,
                                        "warmup_num_steps": 10,
                                        "total_num_steps": 40}),
    "OneCycle": ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                              "cycle_first_step_size": 12,
                              "cycle_second_step_size": 18,
                              "decay_step_size": 5, "decay_lr_rate": 0.3}),
    "OneCycle_nodecay": ("OneCycle", {"cycle_min_lr": 1e-4,
                                      "cycle_max_lr": 1e-2,
                                      "cycle_first_step_size": 20}),
    "LRRangeTest": ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                                    "lr_range_test_step_size": 7,
                                    "lr_range_test_step_rate": 0.5}),
    "LRRangeTest_stair": ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                                          "lr_range_test_step_size": 7,
                                          "lr_range_test_staircase": True}),
}


@pytest.mark.parametrize("case", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(case):
    """50 steps, as Python ints and as the 0-d int32 tensors the
    optimizer's device count is; both packages compute in fp32 and the
    port returns 0-d fp32 tensors: 1e-6 relative."""
    name, params = SCHEDULES[case]
    got_s = lr_schedules.get_lr_schedule(name, dict(params))
    want_s = jax_lr.get_lr_schedule(name, dict(params))
    want = [float(want_s(s)) for s in range(50)]
    for steps in (range(50), [torch.tensor(s, dtype=torch.int32)
                              for s in range(50)]):
        got = [got_s(s) for s in steps]
        assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
        np.testing.assert_allclose([float(g) for g in got], want,
                                   rtol=1e-6, atol=1e-12)
        if name == "OneCycle":
            np.testing.assert_allclose([float(got_s.get_mom(s))
                                        for s in steps],
                                       [float(want_s.get_mom(s))
                                        for s in range(50)], rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown lr schedule"):
        lr_schedules.get_lr_schedule("Cosine", {})


@pytest.mark.parametrize("fp16", [
    {"initial_scale_power": 4, "loss_scale_window": 3, "hysteresis": 2},
    {"initial_scale_power": 3, "loss_scale_window": 2, "hysteresis": 1,
     "min_loss_scale": 2.0},
    {"loss_scale": 128.0}], ids=["hysteresis2", "hysteresis1_min", "static"])
def test_loss_scaler_matches_jax(fp16):
    """The automaton over an overflow sequence with clean runs, single
    overflows between clean steps and overflow bursts: scale, iteration
    and hysteresis agree exactly after every step, with the flags given
    as Python bools and as bool tensors, and the port's state stays in
    0-d fp32 / int32 tensors."""
    from deepspeed_tpu.runtime.config import FP16Config as JaxFP16Config

    got = loss_scaler.create_loss_scaler(FP16Config(enabled=True, **fp16))
    want = jax_ls.create_loss_scaler(JaxFP16Config(enabled=True, **fp16))
    overflows = [0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 1, 1, 1,
                 1, 0, 0, 0, 0, 0, 0, 0]
    for i, o in enumerate(overflows):
        flag = bool(o) if i % 2 else torch.tensor(bool(o))
        got = loss_scaler.update_scale(got, flag)
        want = jax_ls.update_scale(want, jnp.bool_(o))
        assert (got.cur_scale.dtype, got.cur_iter.dtype,
                got.cur_hysteresis.dtype) == (torch.float32, torch.int32,
                                              torch.int32)
        assert (float(got.cur_scale), int(got.cur_iter),
                int(got.cur_hysteresis)) == (
            float(want.cur_scale), int(want.cur_iter),
            int(want.cur_hysteresis))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_LAMB = {"train_batch_size": BATCH,
         "optimizer": {"type": "Lamb",
                       "params": {"lr": 3e-3, "weight_decay": 0.01}},
         "gradient_clipping": 0.05, "steps_per_print": 0}

CASES = {
    # GQA 2, untied head; AdamW, gas 2, clipping that triggers, WarmupLR
    "adamw_gas_clip_warmup": (
        {},
        {"train_batch_size": BATCH, "gradient_accumulation_steps": 2,
         "optimizer": {"type": "AdamW",
                       "params": {"lr": 3e-3, "weight_decay": 0.1}},
         "scheduler": {"type": "WarmupLR",
                       "params": {"warmup_min_lr": 1e-4,
                                  "warmup_max_lr": 3e-3,
                                  "warmup_num_steps": 3,
                                  "warmup_type": "linear"}},
         "gradient_clipping": 0.05, "steps_per_print": 0}),
    # sliding window, tied head; Adam with L2 decay folded into the grads
    "l2adam_window_tied": (
        {"sliding_window": 4, "tie_word_embeddings": True},
        {"train_batch_size": BATCH,
         "optimizer": {"type": "Adam",
                       "params": {"lr": 2e-3, "weight_decay": 0.05,
                                  "adam_w_mode": False}},
         "gradient_clipping": 1.0, "steps_per_print": 0}),
    # LAMB over the JAX default layout: one trust ratio a [L, ...] leaf,
    # which the port spans over the layers' copies of each weight
    "lamb_scanned": ({"scan_layers": True}, _LAMB),
    # LAMB with unscanned layers: one trust ratio a tensor in both
    "lamb_unscanned": ({"scan_layers": False}, _LAMB),
    # Adagrad (optax's, after the decay) under a schedule and clipping
    "adagrad_decay_warmup": (
        {},
        {"train_batch_size": BATCH,
         "optimizer": {"type": "Adagrad",
                       "params": {"lr": 1e-2, "eps": 1e-10,
                                  "weight_decay": 0.01}},
         "scheduler": {"type": "WarmupLR",
                       "params": {"warmup_min_lr": 1e-3,
                                  "warmup_max_lr": 1e-2,
                                  "warmup_num_steps": 3,
                                  "warmup_type": "linear"}},
         "gradient_clipping": 0.05, "steps_per_print": 0}),
}


@pytest.fixture
def one_device_mesh():
    saved = topology.get_mesh(), topology.get_topology()
    mesh = topology.build_mesh(devices=jax.devices()[:1])
    yield mesh
    topology.set_mesh(*saved)


def _engines(over, config, mesh):
    """The JAX engine and the port's on the same flax params."""
    jcfg = JaxConfig.tiny(remat=False, **over)
    params = jax.device_get(jax.jit(JaxLlama(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = LlamaConfig.tiny(**over)
    jeng, *_ = ds.initialize(model=JaxLlama(jcfg), config=dict(config),
                             model_parameters=params, mesh=mesh)
    out = dt.initialize(model=LlamaForCausalLM(cfg), config=dict(config),
                        model_parameters=flax_to_torch_state_dict(params, cfg),
                        device="cpu")
    return jeng, out, cfg


def _batches(vocab, n=STEPS, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_trajectory_matches_the_jax_engine(case, one_device_mesh):
    over, config = CASES[case]
    jeng, (peng, opt, none, sched), cfg = _engines(over, config,
                                                   one_device_mesh)
    assert opt is peng.optimizer and none is None
    assert sched is peng.lr_scheduler
    assert peng.gradient_accumulation_steps == \
        jeng.gradient_accumulation_steps
    for ids in _batches(cfg.vocab_size):
        want = float(jeng.train_batch(batch={"input_ids": ids,
                                             "labels": ids}))
        got = float(peng.train_batch(batch={"input_ids": ids,
                                            "labels": ids}))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(peng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
        # the clipping of every case triggers on every step
        assert peng.get_global_grad_norm() > config["gradient_clipping"]
    assert peng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    want = flax_to_torch_state_dict(jax.device_get(jeng.state.params), cfg)
    got = peng.module_state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


GENERIC_BASE = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=32)
BERT = dict(GENERIC_BASE, causal=False, pre_layernorm=False,
            embedding_layernorm=True, final_layernorm=False,
            type_vocab_size=2, mlm_head=True, tie_word_embeddings=True,
            norm_eps=1e-12, initializer_range=0.02)

#: case -> (TransformerConfig, MLM?, engine config)
GENERIC_CASES = {
    "bert_mlm_lamb_scanned": (dict(BERT), True, _LAMB),
    "bert_mlm_lamb_unscanned": (dict(BERT, scan_layers=False), True, _LAMB),
    "opt_lm_adamw": (dict(GENERIC_BASE, pos_offset=2, activation="relu"),
                     False, CASES["adamw_gas_clip_warmup"][1]),
}


def _mlm_batches(vocab, n=STEPS, seed=3):
    """BERT MLM batches: 15% of the positions labelled (the rest -100),
    a right-padded row, token types."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rs.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
        labels = np.where(rs.rand(BATCH, SEQ) < 0.15, ids, -100)
        labels[:, 0] = ids[:, 0]              # at least one a row
        mask = np.ones((BATCH, SEQ), np.int32)
        mask[-1, SEQ - 5:] = 0
        labels[mask == 0] = -100
        types = (np.arange(SEQ)[None] >= SEQ // 2).astype(np.int32) \
            .repeat(BATCH, 0)
        out.append({"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": types, "labels": labels.astype(
                        np.int32)})
    return out


@pytest.mark.parametrize("case", sorted(GENERIC_CASES))
def test_generic_models_train_as_the_jax_engine(case, one_device_mesh):
    """Five steps of the generic transformer in both engines on the same
    flax params: BERT's ``TransformerForMaskedLM`` under an MLM
    ``loss_fn`` on LAMB (scanned: one trust ratio an ``[L, ...]`` leaf;
    unscanned), an OPT-style ``TransformerLMHeadModel`` on AdamW with
    labels. Losses 1e-5, final params 1e-4."""
    from deepspeed_tpu.models import layers as jlayers
    from deepspeed_tpu.models import transformer as jt
    from deepspeed_tpu_torch.models import layers as tlayers
    from deepspeed_tpu_torch.models import transformer as tt

    kw, mlm, config = GENERIC_CASES[case]
    jcls = jt.TransformerForMaskedLM if mlm else jt.TransformerLMHeadModel
    tcls = tt.TransformerForMaskedLM if mlm else tt.TransformerLMHeadModel
    jmodel = jcls(jt.TransformerConfig(**kw))
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = tt.TransformerConfig(**kw)
    jkw, pkw = {}, {}
    if mlm:
        def jax_loss(p, batch, rng):
            logits = jmodel.apply({"params": p}, batch["input_ids"],
                                  batch["attention_mask"],
                                  batch["token_type_ids"])
            return jlayers.cross_entropy_loss(logits, batch["labels"]), ()

        def port_loss(module, batch, generator):
            logits = module(batch["input_ids"], batch["attention_mask"],
                            batch["token_type_ids"])
            return tlayers.cross_entropy_loss(logits, batch["labels"]), ()

        jkw, pkw = {"loss_fn": jax_loss}, {"loss_fn": port_loss}
        batches = _mlm_batches(cfg.vocab_size)
    else:
        batches = [{"input_ids": ids, "labels": ids}
                   for ids in _batches(cfg.vocab_size)]
    jeng, *_ = ds.initialize(model=jmodel, config=dict(config),
                             model_parameters=params, mesh=one_device_mesh,
                             **jkw)
    peng, *_ = dt.initialize(model=tcls(cfg), config=dict(config),
                             model_parameters=flax_to_torch_state_dict(
                                 params, cfg), device="cpu", **pkw)
    for batch in batches:
        want = float(jeng.train_batch(batch=dict(batch)))
        got = float(peng.train_batch(batch=dict(batch)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(peng.get_global_grad_norm(),
                                   jeng.get_global_grad_norm(), rtol=1e-4)
    want = flax_to_torch_state_dict(jax.device_get(jeng.state.params), cfg)
    got = peng.module_state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_eval_batch_and_micro_step_api(one_device_mesh):
    """``eval_batch`` against the JAX engine's (1e-5); the micro-step API
    (``engine(mb)``, ``backward``, ``step``) takes the same optimizer step
    as ``train_batch`` on the concatenated microbatches, bit for bit."""
    over, config = CASES["adamw_gas_clip_warmup"]
    jeng, (peng, *_), cfg = _engines(over, config, one_device_mesh)
    ids = _batches(cfg.vocab_size, n=1, seed=3)[0]
    batch = {"input_ids": ids, "labels": ids}
    np.testing.assert_allclose(float(peng.eval_batch(batch)),
                               float(jeng.eval_batch(batch)), rtol=1e-5)

    twin, *_ = dt.initialize(model=LlamaForCausalLM(cfg), config=dict(config),
                             model_parameters=peng.module_state_dict(),
                             device="cpu")
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    losses, stepped = [], []
    for mb in halves:
        losses.append(twin(mb))
        twin.backward(losses[-1])
        stepped.append(twin.step())
    assert stepped[0] is None and stepped[1] is not None
    assert twin.global_steps == 1 and twin.micro_steps == 2
    want_loss = peng.train_batch(batch=batch)
    # the lazy loss of a microbatch is one eval forward on the weights of
    # the moment it is read
    np.testing.assert_allclose(float(losses[0]), float(twin.eval_batch(
        halves[0])), rtol=1e-6)
    assert np.isfinite(float(want_loss))
    for name, p in peng.module_state_dict().items():
        torch.testing.assert_close(twin.module_state_dict()[name], p,
                                   rtol=0, atol=0, msg=name)


def test_fp16_overflow_skips_the_step(one_device_mesh):
    """A loss scale of 2**40 overflows the fp16 backward in both engines:
    params, optimizer state and step count stay, the skip is counted and
    the scale automaton moves (hysteresis 2: the first overflow spends it,
    the second halves the scale). A scale of 2**8 then trains."""
    config = {"train_batch_size": BATCH, "steps_per_print": 0,
              "fp16": {"enabled": True, "initial_scale_power": 40},
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    jeng, (peng, *_), cfg = _engines({}, config, one_device_mesh)
    before = {n: p.clone() for n, p in peng.module_state_dict().items()}
    scales = []
    for ids in _batches(cfg.vocab_size, n=2):
        for eng in (jeng, peng):
            assert np.isfinite(float(eng.train_batch(
                batch={"input_ids": ids, "labels": ids})))
        assert peng.get_global_grad_norm() is None
        scales.append((peng.loss_scale, jeng.loss_scale))
    assert scales == [(2.0 ** 40, 2.0 ** 40), (2.0 ** 39, 2.0 ** 39)]
    assert peng.get_skipped_steps() == jeng.get_skipped_steps() == 2
    assert int(peng.optimizer.count) == int(jeng.state.step) == 0
    assert all(torch.equal(peng.module_state_dict()[n], p)
               for n, p in before.items())
    assert all(not m.any() for m in peng.optimizer.exp_avg)

    peng.loss_scaler = loss_scaler.create_loss_scaler(
        FP16Config(enabled=True, initial_scale_power=8))
    ids = _batches(cfg.vocab_size, n=1, seed=1)[0]
    peng.train_batch(batch={"input_ids": ids, "labels": ids})
    assert peng.get_skipped_steps() == 2 and int(peng.optimizer.count) == 1
    assert np.isfinite(peng.get_global_grad_norm())
    assert not torch.equal(peng.module_state_dict()["model.norm.weight"],
                           before["model.norm.weight"])


_DEVICE_STATE = {
    # gas 2 with the schedule on the device count: warm-up, then decay
    "gas2_warmup_decay": (
        {"train_batch_size": BATCH, "gradient_accumulation_steps": 2,
         "optimizer": {"type": "AdamW",
                       "params": {"lr": 3e-3, "weight_decay": 0.1}},
         "scheduler": {"type": "WarmupDecayLR",
                       "params": {"warmup_min_lr": 1e-4,
                                  "warmup_max_lr": 3e-3,
                                  "warmup_num_steps": 2,
                                  "total_num_steps": 6}},
         "gradient_clipping": 1.0, "steps_per_print": 0}, STEPS),
    # OneCycle: up, down, then the decay leg
    "onecycle": (
        {"train_batch_size": BATCH,
         "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
         "scheduler": {"type": "OneCycle",
                       "params": {"cycle_min_lr": 1e-4,
                                  "cycle_max_lr": 3e-3,
                                  "cycle_first_step_size": 2,
                                  "cycle_second_step_size": 1,
                                  "decay_step_size": 1,
                                  "decay_lr_rate": 0.5}},
         "gradient_clipping": 1.0, "steps_per_print": 0}, STEPS),
    # fp16 at 2**19 with hysteresis 1 and a window of 2: two overflows
    # (2**19, 2**18), clean steps at 2**17, the scale doubled back to
    # 2**18, which overflows again later (the tiny model's fp16 backward
    # overflows at 2**19 and not at 2**17 in both packages)
    "fp16_overflows": (
        {"train_batch_size": BATCH, "steps_per_print": 0,
         "fp16": {"enabled": True, "initial_scale_power": 19,
                  "hysteresis": 1, "loss_scale_window": 2},
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}, 8),
}


@pytest.mark.parametrize("case", sorted(_DEVICE_STATE))
def test_device_train_state_matches_the_jax_train_state(case,
                                                        one_device_mesh):
    """After every step: the port's device step count (the optimizer's),
    skipped steps, loss scale and lr equal JAX ``TrainState``'s, the
    losses agree, and the state stays on the device (0-d tensors)."""
    config, steps = _DEVICE_STATE[case]
    fp16 = "fp16" in config
    jeng, (peng, *_), cfg = _engines({}, config, one_device_mesh)
    skips = []
    names = list(peng.module_state_dict())
    at_floor = {n: torch.zeros(p.shape, dtype=torch.bool)
                for n, p in peng.module_state_dict().items()}
    lr_sum = 0.0
    for ids in _batches(cfg.vocab_size, n=steps):
        lr_sum += float(np.max(peng.get_lr()))
        want = float(jeng.train_batch(batch={"input_ids": ids,
                                             "labels": ids}))
        got = float(peng.train_batch(batch={"input_ids": ids,
                                            "labels": ids}))
        np.testing.assert_allclose(got, want, rtol=5e-4 if fp16 else 1e-5)
        assert int(peng.optimizer.count) == int(jeng.state.step)
        assert peng.get_skipped_steps() == jeng.get_skipped_steps()
        assert peng.loss_scale == jeng.loss_scale
        assert peng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
        skips.append(peng.get_skipped_steps())
        if not fp16:
            # a gradient element below fp32's resolution of the whole
            # gradient (eps32 x its global norm) is rounding noise in both
            # packages, and Adam's m / (sqrt(v) + eps) turns that noise
            # into an update of up to ~lr in a direction of its own
            floor = np.finfo(np.float32).eps * peng.get_global_grad_norm()
            for name, g in zip(names, peng._grads):
                at_floor[name] |= (g.abs() > 0) & (g.abs() <= floor)
    assert peng.optimizer.count.dtype == torch.int32
    assert peng.optimizer.count.dim() == 0
    if fp16:
        assert skips == [1, 2, 2, 2, 2, 3, 3, 3]
        assert peng.loss_scaler.cur_scale.dim() == 0
    else:
        assert skips == [0] * steps
        want = flax_to_torch_state_dict(jax.device_get(jeng.state.params),
                                        cfg)
        for name, p in peng.module_state_dict().items():
            got, ref, noise = p.numpy(), want[name].numpy(), \
                at_floor[name].numpy()
            np.testing.assert_allclose(got[~noise], ref[~noise], rtol=1e-4,
                                       atol=1e-4, err_msg=name)
            # the noise elements: each step moves them by at most ~lr in
            # either package
            assert np.all(np.abs(got[noise] - ref[noise]) <= 2 * lr_sum), \
                name
