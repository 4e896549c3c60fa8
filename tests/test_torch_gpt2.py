"""The port's GPT-2 against the JAX package's.

The JAX ``GPT2LMHeadModel`` (``GPT2Config.tiny``: 2 layers, width 64, 4
heads of 16) is initialised from a seed, and its flax params go to the
port through ``checkpoint.from_flax.flax_to_torch_state_dict``. On the CPU
the port's attention wrappers run their plain versions.

- the config takes every JAX field at its JAX default, keeps the presets,
  and refuses the distributed knobs naming their item;
- the dense forward's logits and the loss with ``labels`` (plain, chunked,
  under a padding mask) equal the JAX model's at fp32 1e-5, with the JAX
  layers scanned and unrolled;
- a cached decode, token by token, gives the full forward's logits;
- ``init_inference(...).generate`` gives the JAX engine's greedy tokens
  in fp32 (mixed-length left-padded prompts, buckets on and off, an int8
  cache, the masked flash prefill, the static decode loop, int8 and int4
  weights);
- the unified and the two-program serving engines (monolithic prefill,
  and 8-token chunks with the prefix cache) serve the JAX serving engine's
  tokens, finish reasons and preemptions, through the port's paged
  attention wrappers, with no page leaked;
- requests longer than ``n_positions`` are refused, and so is a dense
  forward past the position table;
- attention dropout draws in training mode only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxGPT2
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.models import layers as layers_mod
from torch_threads import one_torch_thread  # noqa: F401


def _params(**over):
    model = JaxGPT2(JaxConfig.tiny(**over))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return model, jax.device_get(params)


@pytest.fixture(scope="module")
def tiny():
    model, params = _params()
    return model, params, flax_to_torch_state_dict(params, GPT2Config.tiny())


def _prompts(lens, seed=0, vocab=256):
    """Left-padded ``(ids, mask)`` int32 arrays."""
    rs = np.random.RandomState(seed)
    T = max(lens)
    ids = np.zeros((len(lens), T), np.int32)
    mask = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        ids[b, T - n:] = rs.randint(1, vocab, n)
        mask[b, T - n:] = 1
    return ids, mask


def test_every_jax_config_field_is_accepted_at_its_jax_default():
    jax_fields = {f.name: f.default
                  for f in dataclasses.fields(JaxConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(GPT2Config)}
    assert ours == jax_fields
    for preset in ("gpt2_125m", "tiny"):
        assert dataclasses.asdict(getattr(GPT2Config, preset)()) == \
            dataclasses.asdict(getattr(JaxConfig, preset)())
    assert GPT2Config.gpt2_125m().head_dim == 64


@pytest.mark.parametrize("knob", [dict(quantized_collectives=True),
                                  dict(quantized_psum_block=128)])
def test_distributed_knobs_raise_naming_their_item(knob):
    with pytest.raises(NotImplementedError, match="item 9"):
        GPT2Config.tiny(**knob)


FORWARD = {
    # name: (model overrides, padding mask)
    "scanned": ({}, False),
    "unrolled": ({"scan_layers": False}, False),
    "padded": ({}, True),
    "loss_chunk": ({"loss_chunk": 8}, False),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_and_loss_match_jax(case):
    over, padded = FORWARD[case]
    jmodel, params = _params(**over)
    cfg = GPT2Config.tiny(**over)
    model = GPT2LMHeadModel(cfg)
    model.load_state_dict(flax_to_torch_state_dict(params, cfg), assign=True)
    model.eval()
    ids = np.random.RandomState(1).randint(0, 256, (2, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    if padded:
        mask[1, 8:] = 0
    kw = dict(attention_mask=jnp.asarray(mask)) if padded else {}
    tkw = dict(attention_mask=torch.as_tensor(mask)) if padded else {}
    t_ids = torch.as_tensor(ids).long()
    with torch.no_grad():
        if not cfg.loss_chunk:
            want = np.asarray(jmodel.apply({"params": params},
                                           jnp.asarray(ids), **kw))
            np.testing.assert_allclose(model(t_ids, **tkw).numpy(), want,
                                       rtol=1e-5, atol=1e-5)
        want = float(jmodel.apply({"params": params}, jnp.asarray(ids),
                                  labels=jnp.asarray(ids), **kw))
        got = float(model(t_ids, labels=t_ids, **tkw))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dense_forward_past_n_positions_raises(tiny):
    _, _, sd = tiny
    model = GPT2LMHeadModel(GPT2Config.tiny())
    model.load_state_dict(sd, assign=True)
    ids = torch.zeros((1, 129), dtype=torch.long)
    with torch.no_grad():
        with pytest.raises(ValueError, match="129 tokens .*n_positions=128"):
            model(ids)
        with pytest.raises(ValueError, match="n_positions=128"):
            model(ids, labels=ids)
        assert model(ids[:, :128]).shape == (1, 128, 256)


def test_attention_dropout_draws_in_training_mode_only(tiny):
    """``attn_pdrop`` changes nothing in eval mode; in training mode the
    attention's probabilities are dropped with torch's draws, the same
    ones under the same seed."""
    _, _, sd = tiny
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 256, (2, 12)))
    base = GPT2LMHeadModel(GPT2Config.tiny())
    base.load_state_dict(sd, assign=True)
    drop = GPT2LMHeadModel(GPT2Config.tiny(attn_pdrop=0.5))
    drop.load_state_dict(sd, assign=True)
    with torch.no_grad():
        want = base.eval()(ids)
        torch.testing.assert_close(drop.eval()(ids), want, rtol=0, atol=0)
        drop.train()
        torch.manual_seed(3)
        first = drop(ids)
        torch.manual_seed(3)
        again = drop(ids)
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    assert torch.isfinite(first).all()
    assert not torch.allclose(first, want, atol=1e-3)


def test_cached_decode_equals_full_forward(tiny):
    _, _, sd = tiny
    cfg = GPT2Config.tiny()
    model = GPT2LMHeadModel(cfg)
    model.load_state_dict(sd, assign=True)
    model.eval()
    ids = torch.as_tensor(np.random.RandomState(2).randint(0, 256, (2, 10)))
    with torch.no_grad():
        full = model(ids)
        cache = model.init_cache(2, 16, dtype=torch.float32)
        mask = torch.zeros((2, 16), dtype=torch.int32)
        mask[:, :4] = 1
        logits, _ = model(ids[:, :4], cache=cache, cache_index=0,
                          attention_mask=mask)
        steps = [logits]
        for t in range(4, 10):
            mask[:, t] = 1
            logits, _ = model(ids[:, t:t + 1], cache=cache, cache_index=t,
                              attention_mask=mask)
            steps.append(logits)
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(),
                               full.numpy(), rtol=1e-4, atol=1e-5)


GENERATE = {
    # name: (model overrides, prompt lengths, generate kw, engine kw)
    "mixed_lengths_bucketed": ({}, (5, 11, 3), dict(max_new_tokens=12), {}),
    "bucketing_off": ({}, (7, 2, 13), dict(max_new_tokens=10),
                      dict(bucket_shapes=False)),
    "int8_kv_cache": ({}, (9, 4), dict(max_new_tokens=9),
                      dict(kv_cache_int8=True)),
    "flash_prefill": ({"prefill_flash_from_empty": True}, (5, 11, 3),
                      dict(max_new_tokens=9), {}),
    "cuda_graph_loop": ({}, (5, 11, 3), dict(max_new_tokens=12),
                        dict(enable_cuda_graph=True)),
    "int8_weights": ({}, (5, 11, 3), dict(max_new_tokens=12),
                     dict(quantize_weights="int8")),
    "int4_weights": ({}, (6, 10), dict(max_new_tokens=9),
                     dict(quantize_weights="int4")),
}


@pytest.mark.parametrize("case", sorted(GENERATE))
def test_generate_tokens_identical_to_jax(tiny, case, monkeypatch):
    over, lens, gen_kw, engine_kw = GENERATE[case]
    jmodel, params, sd = tiny
    cfg = GPT2Config.tiny(**over)
    ids, mask = _prompts(lens, seed=len(case))
    jeng = jds.init_inference(JaxGPT2(JaxConfig.tiny(**over)), params=params,
                              dtype="fp32", **engine_kw)
    want = np.asarray(jeng.generate(jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    **gen_kw))
    calls = {"decode": 0, "flash": 0}
    for name, key in (("decode_attention", "decode"),
                      ("flash_prefill_from_empty", "flash")):
        real = getattr(layers_mod, name)

        def spy(*a, _real=real, _key=key, **kw):
            # the kernels on the card take contiguous tensors
            assert all(t.is_contiguous() for t in a if torch.is_tensor(t))
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(layers_mod, name, spy)
    teng = dt.init_inference(GPT2LMHeadModel(cfg), params=sd, dtype="fp32",
                             device="cpu", **engine_kw)
    got = teng.generate(ids, attention_mask=mask, **gen_kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert calls["decode"] > 0
    assert calls["flash"] == (cfg.n_layer if cfg.prefill_flash_from_empty
                              else 0)
    if "quantize_weights" in engine_kw:
        assert teng.quant_summary["leaves"] == 4 * cfg.n_layer
        layer = teng.module.transformer.h[0]
        assert layer.mlp.c_fc.qweight.dtype == (
            torch.uint8 if engine_kw["quantize_weights"] == "int4"
            else torch.int8)
        assert layer.attn.c_attn.bias is not None


SERVE = {
    # name: (serving config, prompt lengths, new tokens)
    "unified": (dict(mixed_step=True, prefill_chunk_tokens=8,
                     prefill_token_budget=16),
                (3, 18, 11, 33, 7, 40, 25), (5, 9, 4, 7, 6, 8, 5)),
    "unified_preemption": (dict(mixed_step=True, prefill_chunk_tokens=8,
                                prefill_token_budget=16, num_blocks=10),
                           (17, 21, 14, 19), (12, 12, 12, 12)),
    "two_program": (dict(mixed_step=False), (3, 18, 11, 33, 7),
                    (5, 9, 4, 7, 6)),
    "two_program_chunked_prefix": (dict(mixed_step=False,
                                        prefill_chunk_tokens=8,
                                        prefix_cache=True),
                                   (18, 33, 7, 25), (6, 5, 8, 4)),
}


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serving_tokens_identical_to_jax(tiny, case, monkeypatch):
    jmodel, params, sd = tiny
    over, lens, new = SERVE[case]
    kw = dict(dict(max_batch_size=4, block_size=8, num_blocks=48,
                   max_model_len=64), **over)
    rs = np.random.RandomState(7)
    prefix = list(rs.randint(1, 256, 16))
    prompts = [prefix + list(rs.randint(1, 256, n)) if kw.get("prefix_cache")
               else list(rs.randint(1, 256, n)) for n in lens]
    calls = {}
    for name in ("ragged_paged_attention", "paged_decode_attention",
                 "paged_prefill_attention"):
        real = getattr(layers_mod, name)

        def spy(*a, _real=real, _name=name, **k):
            assert all(t.is_contiguous() for t in a if torch.is_tensor(t))
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(layers_mod, name, spy)

    def serve(srv):
        out = []
        # with the prefix cache, a seed request first (pages index as
        # chunks land), then the rest together
        phases = [prompts[:1], prompts[1:]] if kw.get("prefix_cache") \
            else [prompts]
        at = 0
        for phase in phases:
            rids = [srv.submit(p, max_new_tokens=n)
                    for p, n in zip(phase, new[at:at + len(phase)])]
            at += len(phase)
            res = srv.run()
            out += [(res[r].state, res[r].finish_reason, res[r].tokens)
                    for r in rids]
        return out

    jeng = jds.init_inference(jmodel, params=params, dtype="fp32")
    jsrv = JaxServingEngine(jeng, JaxServingConfig(**kw))
    teng = dt.init_inference(GPT2LMHeadModel(GPT2Config.tiny()), params=sd,
                             dtype="fp32", device="cpu")
    tsrv = dt.ServingEngine(teng, dt.ServingConfig(**kw))
    want = serve(jsrv)
    got = serve(tsrv)
    assert got == want
    assert all(state == "finished" for state, _, _ in got)
    assert tsrv.metrics.preemptions == jsrv.metrics.preemptions
    if case == "unified_preemption":
        assert tsrv.metrics.preemptions > 0, "pool sized to force preemption"
    if kw.get("prefix_cache"):
        assert tsrv.metrics.prefix_hits == jsrv.metrics.prefix_hits > 0
    tsrv.block_pool.check_consistent()
    assert tsrv.block_pool.used_count == 0, "leaked pages"
    if kw["mixed_step"]:
        assert set(calls) == {"ragged_paged_attention"}
    else:
        assert calls["paged_decode_attention"] > 0
        assert ("paged_prefill_attention" in calls) == \
            bool(kw.get("prefill_chunk_tokens"))


def test_requests_past_n_positions_are_refused(tiny):
    _, _, sd = tiny
    teng = dt.init_inference(GPT2LMHeadModel(GPT2Config.tiny()), params=sd,
                             dtype="fp32", device="cpu")
    with pytest.raises(ValueError, match="128 positions"):
        dt.ServingEngine(teng, dt.ServingConfig(block_size=8,
                                                max_model_len=256))
    ids, mask = _prompts((100, 20))
    with pytest.raises(ValueError, match="128 positions"):
        teng.generate(ids, attention_mask=mask, max_new_tokens=40)
    # the longest prompt decides, and bucketing's trimmed tokens may run
    # past the table
    out = teng.generate(ids, attention_mask=mask, max_new_tokens=20)
    assert out.shape == (2, 20)
