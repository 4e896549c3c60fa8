"""The port's checkpoints against the JAX package's.

Both packages run in one process on the same numpy-seeded batches; the
JAX engine gets a one-device mesh (as in ``tests/test_torch_train.py``).

- Cross-loading, both ways, for AdamW in bf16 with scanned layers, LAMB
  with unscanned layers, and fp16 through overflow skips: one engine
  trains 3 steps and saves; the other package's fresh engine loads the
  save (JAX -> port: JAX ``save_checkpoint`` + ``convert_checkpoint``,
  then the port's ``load_checkpoint(..., load_universal=True)``; port ->
  JAX: the port's ``save_checkpoint``, then JAX ``load_checkpoint(
  <dir>/<tag>, load_universal=True)``). Right after the load the params
  are equal exactly and the step count, skipped steps, loss scale and lr
  equal, and every leaf of the two states (params, moments, counts,
  loss scale) is equal exactly; then both take more steps on the same
  batches: the counters equal after every step, losses within 1e-5
  relative and the final params within 1e-4 in fp32 (LAMB). In fp16 and
  bf16 the two frameworks round activations and products at different
  places, so a gradient element near 0 can take the other sign, and Adam
  moves a param by about the lr whatever the gradient's size: a param
  may part by up to 2 lr a step. There the losses are held to 5e-4 (fp16,
  as in ``tests/test_torch_train.py``) and 1e-3 (bf16) and the params to
  2 lr a step taken after the load; an uninterrupted run of both
  packages from the same weights parts as far (bf16, lr 3e-3: 3.9e-4 in
  the loss and 8.2e-3 in a param over 6 steps).
- At step 0 a port engine built from JAX params writes the leaf names,
  shapes, dtypes and values that JAX ``save_universal(state)`` writes, for
  those three configs and six more whose optax states nest differently.
- Port -> port: a save at step 3 loaded into an engine built from other
  weights continues bit for bit as the uninterrupted run.
- ``load_universal`` options: ``load_optimizer_states=False`` keeps the
  fresh moments and count; a missing leaf raises ``KeyError`` naming it
  and a shape mismatch ``ValueError``, in both packages.
- ``save_16bit_model`` writes the keys, dtypes, shapes and bytes JAX's
  does; ``zero_to_fp32`` the flat names and values; ``init_inference(
  checkpoint=)`` serves the tokens of ``params=``; the two CLIs run; a
  v1 (single ``state.npz``) directory still loads.
- Config: ``fault_tolerance`` and ``checkpoint`` at the JAX defaults.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
from deepspeed_tpu.checkpoint import universal as jax_universal
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.parallel import topology
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDSConfig
from deepspeed_tpu.utils import zero_to_fp32 as jax_z2f
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint import universal
from deepspeed_tpu_torch.checkpoint.engine import save_pytree
from deepspeed_tpu_torch.checkpoint.from_flax import (flax_to_torch_state_dict,
                                                      torch_to_flax)
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.utils import zero_to_fp32
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, SEQ = 4, 16
SAVED_AT = 3

CASES = {
    # AdamW in bf16 over the JAX default layout, the lr warming up across
    # the save
    "adamw_bf16_scanned": (
        {"scan_layers": True},
        {"train_batch_size": BATCH, "bf16": {"enabled": True},
         "optimizer": {"type": "AdamW",
                       "params": {"lr": 3e-3, "weight_decay": 0.1}},
         "scheduler": {"type": "WarmupLR",
                       "params": {"warmup_min_lr": 1e-4,
                                  "warmup_max_lr": 3e-3,
                                  "warmup_num_steps": 5,
                                  "warmup_type": "linear"}},
         "gradient_clipping": 1.0, "steps_per_print": 0}, 3),
    "lamb_unscanned": (
        {"scan_layers": False},
        {"train_batch_size": BATCH,
         "optimizer": {"type": "Lamb",
                       "params": {"lr": 3e-3, "weight_decay": 0.01}},
         "gradient_clipping": 0.05, "steps_per_print": 0}, 3),
    # fp16 at 2**19, hysteresis 1, window 2: skips [1, 2, 2, 2, 2, 3, 3,
    # 3] over 8 steps (tests/test_torch_train.py), the save after 3
    "fp16_skips": (
        {},
        {"train_batch_size": BATCH, "steps_per_print": 0,
         "fp16": {"enabled": True, "initial_scale_power": 19,
                  "hysteresis": 1, "loss_scale_window": 2},
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}, 5),
}


def _tolerances(config, steps):
    """(loss rtol, param atol) after ``steps`` steps taken together."""
    lr = config["optimizer"]["params"]["lr"]
    if "fp16" in config:
        return 5e-4, 2 * lr * steps
    if "bf16" in config:
        return 1e-3, 2 * lr * steps
    return 1e-5, 1e-4


@pytest.fixture
def one_device_mesh():
    saved = topology.get_mesh(), topology.get_topology()
    mesh = topology.build_mesh(devices=jax.devices()[:1])
    yield mesh
    topology.set_mesh(*saved)


def _flax_params(over, seed=0):
    jcfg = JaxConfig.tiny(remat=False, **over)
    return jcfg, jax.device_get(jax.jit(JaxLlama(jcfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])


def _jax_engine(over, config, mesh, seed=0):
    jcfg, params = _flax_params(over, seed)
    jeng, *_ = ds.initialize(model=JaxLlama(jcfg), config=dict(config),
                             model_parameters=params, mesh=mesh)
    return jeng, params


def _port_engine(over, config, params=None, seed=None):
    """A port engine on the flax ``params`` (or on its own seeded
    weights)."""
    cfg = LlamaConfig.tiny(**over)
    if seed is not None:
        config = dict(config, seed=seed)
    sd = None if params is None else flax_to_torch_state_dict(params, cfg)
    eng, *_ = dt.initialize(model=LlamaForCausalLM(cfg), config=dict(config),
                            model_parameters=sd, device="cpu")
    return eng, cfg


def _batches(vocab, n, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
            for _ in range(n)]


def _step(eng, ids):
    return float(eng.train_batch(batch={"input_ids": ids, "labels": ids}))


def _counters(eng):
    """(step count, skipped steps, loss scale) of either engine."""
    if hasattr(eng, "state"):
        return int(eng.state.step), eng.get_skipped_steps(), eng.loss_scale
    return int(eng.optimizer.count), eng.get_skipped_steps(), eng.loss_scale


def _assert_same_params(peng, jeng, cfg, rtol, atol):
    want = flax_to_torch_state_dict(jax.device_get(jeng.state.params), cfg)
    got = peng.module_state_dict()
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def _assert_same_state(jeng, peng, tmp_path):
    """Every leaf of the JAX state and of the port's (as the port saves
    it) is equal exactly."""
    jax_universal.save_universal(jeng.state, str(tmp_path / "want"))
    peng.save_checkpoint(str(tmp_path / "got"), tag="now")
    want, _ = jax_universal.load_universal(str(tmp_path / "want"))
    got, _ = universal.load_universal(str(tmp_path / "got" / "now"))
    assert set(got) == set(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name


def _continue_together(jeng, peng, cfg, batches, config):
    loss_rtol, param_tol = _tolerances(config, len(batches))
    for ids in batches:
        want, got = _step(jeng, ids), _step(peng, ids)
        np.testing.assert_allclose(got, want, rtol=loss_rtol)
        assert _counters(peng) == _counters(jeng)
        assert peng.global_steps == jeng.global_steps
        assert peng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    _assert_same_params(peng, jeng, cfg, param_tol, param_tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_jax_save_resumes_in_the_port(case, one_device_mesh, tmp_path):
    over, config, more = CASES[case]
    jeng, _ = _jax_engine(over, config, one_device_mesh)
    batches = _batches(256, SAVED_AT + more)
    for ids in batches[:SAVED_AT]:
        _step(jeng, ids)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    jax_universal.convert_checkpoint(str(tmp_path / "jax"),
                                     str(tmp_path / "universal"))
    peng, cfg = _port_engine(over, config, seed=7)
    ptrs = [p.data_ptr() for p in peng.master.values()]
    _, client_state = peng.load_checkpoint(str(tmp_path / "universal"),
                                           load_universal=True)
    assert client_state["global_steps"] == SAVED_AT == peng.global_steps
    assert [p.data_ptr() for p in peng.master.values()] == ptrs
    assert _counters(peng) == _counters(jeng)
    assert peng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    _assert_same_state(jeng, peng, tmp_path)
    _continue_together(jeng, peng, cfg, batches[SAVED_AT:], config)


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_port_save_resumes_in_the_jax_engine(case, one_device_mesh,
                                               tmp_path):
    over, config, more = CASES[case]
    jeng, params = _jax_engine(over, config, one_device_mesh, seed=3)
    peng, cfg = _port_engine(over, config, params=_flax_params(over)[1])
    batches = _batches(256, SAVED_AT + more, seed=1)
    for ids in batches[:SAVED_AT]:
        _step(peng, ids)
    peng.save_checkpoint(str(tmp_path))
    _, client_state = jeng.load_checkpoint(
        str(tmp_path / f"global_step{SAVED_AT}"), load_universal=True)
    assert client_state["global_steps"] == SAVED_AT == jeng.global_steps
    assert _counters(jeng) == _counters(peng)
    assert jeng.get_lr() == pytest.approx(peng.get_lr(), rel=1e-6)
    _assert_same_state(jeng, peng, tmp_path)
    _continue_together(jeng, peng, cfg, batches[SAVED_AT:], config)


_WARMUP = {"type": "WarmupLR", "params": {"warmup_num_steps": 4}}

#: other optimizer configs, each nesting the optax state its own way in
#: the JAX engine (a schedule adds a count; clipping wraps the chain)
LAYOUTS = {
    "adam_l2_schedule": {"optimizer": {"type": "Adam", "params": {
        "lr": 1e-3, "adam_w_mode": False, "weight_decay": 0.1}},
        "scheduler": _WARMUP},
    "adam_schedule_clip": {"optimizer": {"type": "Adam", "params": {
        "lr": 1e-3, "adam_w_mode": False}}, "scheduler": _WARMUP,
        "gradient_clipping": 1.0},
    "adamw_schedule": {"optimizer": {"type": "AdamW", "params": {
        "lr": 1e-3}}, "scheduler": _WARMUP},
    "lamb_schedule_clip": {"optimizer": {"type": "Lamb", "params": {
        "lr": 1e-3}}, "scheduler": _WARMUP, "gradient_clipping": 1.0},
    "adamw_pallas_clip": {"optimizer": {"type": "AdamW", "params": {
        "lr": 1e-3, "pallas": True}}, "gradient_clipping": 1.0},
    "default_optimizer_schedule": {"scheduler": _WARMUP},
}


@pytest.mark.parametrize("case", sorted(CASES) + sorted(LAYOUTS))
def test_leaf_names_shapes_and_dtypes_match_jax_at_step_zero(
        case, one_device_mesh, tmp_path):
    over, config, _ = CASES[case] if case in CASES else \
        ({}, dict(LAYOUTS[case], train_batch_size=BATCH, steps_per_print=0),
         0)
    jeng, params = _jax_engine(over, config, one_device_mesh)
    peng, _ = _port_engine(over, config, params=params)
    jax_universal.save_universal(jeng.state, str(tmp_path / "jax"))
    peng.save_checkpoint(str(tmp_path / "port"))
    want, wmeta = jax_universal.load_universal(str(tmp_path / "jax"))
    got, gmeta = universal.load_universal(
        str(tmp_path / "port" / "global_step0"))
    assert gmeta["format"] == wmeta["format"]
    assert set(got) == set(want)
    for name in want:
        w, g = wmeta["leaves"][name], gmeta["leaves"][name]
        assert (g["shape"], g["dtype"]) == (w["shape"], w["dtype"]), name
        assert np.array_equal(got[name], want[name]), name


def test_a_port_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """fp16 through its skips and bf16 AdamW with a warming lr: a save at
    step 3 loaded into an engine built from other weights (after it took
    a step of its own) takes steps 4-6 bit for bit as the run that never
    stopped, its tensors written in place."""
    for case in ("fp16_skips", "adamw_bf16_scanned"):
        over, config, _ = CASES[case]
        batches = _batches(256, 6, seed=2)
        a, _ = _port_engine(over, config)
        want = []
        for i, ids in enumerate(batches):
            want.append(_step(a, ids))
            if i == 2:
                a.save_checkpoint(str(tmp_path / case))
        b, _ = _port_engine(over, config, seed=11)
        _step(b, batches[0])
        tensors = [b.optimizer.count, b._skipped] + \
            list(b.master.values()) + b.optimizer.exp_avg + \
            b.optimizer.exp_avg_sq
        ptrs = [t.data_ptr() for t in tensors]
        b.load_checkpoint(str(tmp_path / case))
        assert [t.data_ptr() for t in tensors] == ptrs
        assert (b.global_steps, b.micro_steps) == (3, 3)
        got = [_step(b, ids) for ids in batches[3:]]
        assert got == want[3:], case
        assert _counters(b) == _counters(a)
        for name, p in a.module_state_dict().items():
            assert torch.equal(b.module_state_dict()[name], p), name


def _save_and_edit(tmp_path, edit):
    """A tiny port save at step 1, its tag directory edited by ``edit``
    (a function of the universal meta); returns the tag directory."""
    over, config, _ = CASES["lamb_unscanned"]
    eng, _ = _port_engine(over, config)
    _step(eng, _batches(256, 1)[0])
    eng.save_checkpoint(str(tmp_path))
    tag_dir = str(tmp_path / "global_step1")
    path = os.path.join(tag_dir, universal.META_FILE)
    with open(path) as f:
        meta = json.load(f)
    edit(meta)
    with open(path, "w") as f:
        json.dump(meta, f)
    return tag_dir


def test_load_without_optimizer_states_keeps_fresh_moments(tmp_path):
    tag_dir = _save_and_edit(tmp_path, lambda meta: None)
    over, config, _ = CASES["lamb_unscanned"]
    eng, _ = _port_engine(over, config, seed=5)
    eng.load_checkpoint(tag_dir, load_universal=True,
                        load_optimizer_states=False)
    assert int(eng.optimizer.count) == 0 and eng.global_steps == 1
    assert not any(m.any() for m in eng.optimizer.exp_avg)
    assert not any(m.any() for m in eng.optimizer.exp_avg_sq)
    flat, _ = universal.load_universal(tag_dir)
    got = eng.module_state_dict()["model.norm.weight"].numpy()
    assert np.array_equal(got, flat["params/model/norm/scale"])


def test_a_missing_leaf_or_a_wrong_shape_raises_in_both_packages(
        tmp_path, one_device_mesh):
    name = "opt_state/1/0/mu/model/layers_1/mlp/up_proj/kernel"
    tag_dir = _save_and_edit(tmp_path / "missing",
                             lambda meta: meta["leaves"].pop(name))
    over, config, _ = CASES["lamb_unscanned"]
    peng, _ = _port_engine(over, config)
    jeng, _ = _jax_engine(over, config, one_device_mesh)
    for eng in (peng, jeng):
        with pytest.raises(KeyError, match=name):
            eng.load_checkpoint(tag_dir, load_universal=True)
    # without the optimizer states the missing moment is not needed
    peng.load_checkpoint(tag_dir, load_universal=True,
                         load_optimizer_states=False)

    def wider(meta):
        meta["leaves"]["params/model/norm/scale"]["shape"] = [65]

    tag_dir = _save_and_edit(tmp_path / "shape", wider)
    path = os.path.join(tag_dir, universal.load_universal(tag_dir)[1][
        "leaves"]["params/model/norm/scale"]["file"])
    np.save(path, np.ones(65, np.float32))
    before = peng.module_state_dict()["lm_head.weight"].clone()
    for eng in (peng, jeng):
        with pytest.raises(ValueError, match="shape mismatch"):
            eng.load_checkpoint(tag_dir, load_universal=True)
    # nothing was written before the mismatch was found
    assert torch.equal(peng.module_state_dict()["lm_head.weight"], before)


@pytest.mark.parametrize("over", [{"scan_layers": True},
                                  {"scan_layers": False,
                                   "tie_word_embeddings": True}],
                         ids=["scanned", "unscanned_tied"])
def test_save_16bit_model_writes_the_jax_file(over, one_device_mesh,
                                              tmp_path):
    config = CASES["adamw_bf16_scanned"][1]
    jeng, params = _jax_engine(over, config, one_device_mesh)
    peng, _ = _port_engine(over, config, params=params)
    jeng.save_16bit_model(str(tmp_path / "jax"))
    peng.save_16bit_model(str(tmp_path / "port"))
    want = np.load(str(tmp_path / "jax" / "pytorch_model.npz"))
    got = np.load(str(tmp_path / "port" / "pytorch_model.npz"))
    assert got.files == want.files
    for key in want.files:
        w, g = want[key], got[key]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        assert g.tobytes() == w.tobytes(), key


def test_zero_to_fp32_gives_the_jax_names_and_values(one_device_mesh,
                                                     tmp_path):
    over, config, _ = CASES["adamw_bf16_scanned"]
    jeng, params = _jax_engine(over, config, one_device_mesh)
    peng, cfg = _port_engine(over, config, params=params)
    jeng.save_checkpoint(str(tmp_path / "jax"))
    peng.save_checkpoint(str(tmp_path / "port"))
    want = jax_z2f.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "jax"))
    got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "port"))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.float32
        assert np.array_equal(got[name], want[name]), name
    # a flax template filled from the save, and the state dict it maps to
    filled = zero_to_fp32.load_state_dict_from_zero_checkpoint(
        torch_to_flax(peng.module_state_dict(), cfg), str(tmp_path / "port"))
    sd = flax_to_torch_state_dict(filled, cfg)
    for name, p in peng.module_state_dict().items():
        assert torch.equal(sd[name], p), name


def _serve(model, engine):
    srv = dt.ServingEngine(engine, dt.ServingConfig(
        max_batch_size=4, block_size=8, num_blocks=48, max_model_len=64,
        prefill_chunk_tokens=8, prefill_token_budget=16))
    rs = np.random.RandomState(4)
    rids = [srv.submit(rs.randint(0, 256, int(rs.randint(3, 20))),
                       max_new_tokens=6) for _ in range(5)]
    res = srv.run()
    return [list(res[r].tokens) for r in rids]


@pytest.mark.parametrize("layout", ["state_dict", "flax"])
def test_init_inference_from_a_checkpoint_serves_the_params_tokens(
        layout, tmp_path):
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg)
    params = model.init_params(seed=3)
    tree = params if layout == "state_dict" else torch_to_flax(params, cfg)
    save_pytree(str(tmp_path / "weights"), tree)
    want = _serve(model, dt.init_inference(model, params=params,
                                           dtype=torch.float32,
                                           device="cpu"))
    got = _serve(model, dt.init_inference(
        LlamaForCausalLM(cfg), checkpoint=str(tmp_path / "weights"),
        dtype=torch.float32, device="cpu"))
    assert got == want and all(len(t) == 6 for t in got)


def test_init_inference_from_an_hf_checkpoint_directory_serves_its_weights(
        tmp_path):
    """An HF checkpoint directory (a ``config.json``) is module
    injection's: ``init_inference(checkpoint=dir)`` builds the port model
    from it and serves the tokens of the same weights passed as params."""
    import os

    os.environ.setdefault("USE_TF", "0")
    import transformers

    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128)).eval()
    hf.save_pretrained(tmp_path)
    eng = dt.init_inference(checkpoint=str(tmp_path), dtype=torch.float32,
                            device="cpu")
    assert isinstance(eng.module, LlamaForCausalLM)
    model = LlamaForCausalLM(eng.module.config)
    want = _serve(model, dt.init_inference(
        model, params=hf.state_dict(), dtype=torch.float32, device="cpu"))
    assert _serve(model, eng) == want and all(len(t) == 6 for t in want)


def test_the_fault_tolerance_and_checkpoint_blocks_take_the_jax_defaults():
    from deepspeed_tpu.runtime.config import FaultToleranceConfig

    pd = {"train_batch_size": 2, "fault_tolerance": {}, "checkpoint": {}}
    got, want = DeepSpeedConfig(dict(pd)), JaxDSConfig(dict(pd),
                                                       world_size=1)
    defaults = FaultToleranceConfig()
    for field in ("enabled", "verify_on_load", "manifest_checksums",
                  "heartbeat_interval", "save_retries", "save_retry_backoff",
                  "keep_checkpoints"):
        assert getattr(got.fault_tolerance, field) == \
            getattr(defaults, field) == getattr(want.fault_tolerance, field)
    assert got.load_universal_checkpoint == want.load_universal_checkpoint
    assert got.use_node_local_storage == want.use_node_local_storage
    pd = {"train_batch_size": 2, "fault_tolerance": {"enabled": True,
                                                     "save_retries": 5},
          "checkpoint": {"load_universal": True,
                         "use_node_local_storage": True}}
    got, want = DeepSpeedConfig(dict(pd)), JaxDSConfig(dict(pd),
                                                       world_size=1)
    assert got.fault_tolerance.save_retries == 5
    assert got.load_universal_checkpoint is want.load_universal_checkpoint \
        is True
    with pytest.raises(ValueError, match="unknown keys"):
        DeepSpeedConfig({"train_batch_size": 2,
                         "checkpoint": {"tag_validation": "Warn"}})
    with pytest.raises(NotImplementedError, match=r"wandb"):
        DeepSpeedConfig({"train_batch_size": 2,
                         "wandb": {"enabled": True}})
    with pytest.raises(NotImplementedError, match=r"item 9"):
        DeepSpeedConfig({"train_batch_size": 2,
                         "comms_logger": {"enabled": True}})


def test_load_universal_in_the_config_reads_a_universal_directory(tmp_path):
    over, config, _ = CASES["lamb_unscanned"]
    a, _ = _port_engine(over, config)
    _step(a, _batches(256, 1)[0])
    a.save_checkpoint(str(tmp_path))
    b, _ = _port_engine(over, dict(config, checkpoint={
        "load_universal": True}), seed=9)
    b.load_checkpoint(str(tmp_path / "global_step1"))
    for name, p in a.module_state_dict().items():
        assert torch.equal(b.module_state_dict()[name], p), name


def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", *args], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_the_universal_cli_converts_a_save(tmp_path):
    over, config, _ = CASES["fp16_skips"]
    eng, _ = _port_engine(over, config)
    _step(eng, _batches(256, 1)[0])
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    stdout = _run_cli("deepspeed_tpu_torch.checkpoint.universal",
                      str(tmp_path / "ckpt"), str(tmp_path / "out"))
    assert "wrote universal checkpoint" in stdout
    got, meta = jax_universal.load_universal(str(tmp_path / "out"))
    want, _ = universal.load_universal(str(tmp_path / "ckpt" /
                                           "global_step1"))
    assert meta["client_state"]["global_steps"] == 1 and meta["step"] == 1
    assert set(got) == set(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    shutil.rmtree(str(tmp_path / "out"))


def test_the_zero_to_fp32_cli_writes_the_masters(tmp_path):
    over, config, _ = CASES["adamw_bf16_scanned"]
    eng, _ = _port_engine(over, config)
    _step(eng, _batches(256, 1)[0])
    eng.save_checkpoint(str(tmp_path / "ckpt"))
    out = str(tmp_path / "fp32.npz")
    stdout = _run_cli("deepspeed_tpu_torch.utils.zero_to_fp32",
                      str(tmp_path / "ckpt"), out)
    assert "wrote" in stdout
    z = np.load(out)
    want = torch_to_flax(eng.module_state_dict(), eng.module.config)
    assert np.array_equal(z["model/layers/block/mlp/up_proj/kernel"],
                          want["model"]["layers"]["block"]["mlp"]["up_proj"]
                          ["kernel"])
    assert len(z.files) == 12


def test_a_v1_universal_directory_still_loads(tmp_path):
    """The single-``state.npz`` form reads as in the JAX package."""
    np.savez(tmp_path / "state.npz",
             **{"params/w": np.eye(2, dtype=np.float32), "step": np.int32(4)})
    with open(tmp_path / universal.META_FILE, "w") as f:
        json.dump({"format": "deepspeed_tpu_universal_v1", "step": 4,
                   "client_state": {},
                   "leaves": {"params/w": {"shape": [2, 2],
                                           "dtype": "float32"},
                              "step": {"shape": [], "dtype": "int32"}}}, f)
    got, meta = universal.load_universal(str(tmp_path))
    want, _ = jax_universal.load_universal(str(tmp_path))
    assert meta["step"] == 4 and set(got) == set(want)
    template = {"params": {"w": torch.zeros(2, 2)},
                "step": torch.zeros((), dtype=torch.int32)}
    universal.restore_into(template, str(tmp_path))
    assert torch.equal(template["params"]["w"], torch.eye(2))
    assert int(template["step"]) == 4
