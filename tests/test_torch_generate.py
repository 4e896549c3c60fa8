"""Dense generation of the PyTorch port against the JAX package.

``init_inference(...).generate`` of the port (``device="cpu"``, so K4
and K5 run their plain versions) against the JAX ``init_inference(...)
.generate`` on the same flax params carried across the weight bridge, in
fp32 with greedy decoding: the tokens must be identical with mixed-length
left-padded prompts, shape bucketing on and off, an EOS with and without
the early exit, an int8 KV cache, a sliding window, and int8 / int4
weights (quantized by each package from the same fp weights; the codes
are bit-identical). The two differ only by fp32 summation order, far
below the tiny model's logit gaps on these seeds. The dense forward's
logits agree at 1e-5. Sampling cannot reproduce ``jax.random``, so the
top-k / top-p candidate sets are compared instead. Quantized serving
yields the tokens of the same engine's ``generate`` (the JAX package's
invariant), and those of the JAX engine. The generic transformer's
families have their own file, ``tests/test_torch_generate_generic.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.inference.engine import _sample_logits as jax_sample
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.inference.engine import _sample_logits
from deepspeed_tpu_torch.inference.quant import quantize_state_dict
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models import layers as layers_mod
from deepspeed_tpu_torch.ops.decode_attention import decode_attention
from torch_threads import one_torch_thread  # noqa: F401


def _params(over):
    model = JaxLlama(JaxConfig.tiny(remat=False, **over))
    return model, jax.jit(model.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def tiny():
    model, params = _params({})
    return model, params, flax_to_torch_state_dict(jax.device_get(params),
                                                   LlamaConfig.tiny())


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


def _both(jmodel, jparams, sd, cfg, ids, mask, gen_kw, **engine_kw):
    jeng = jds.init_inference(jmodel, params=jparams, dtype="fp32",
                              **engine_kw)
    want = np.asarray(jeng.generate(jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    **gen_kw))
    teng = dt.init_inference(LlamaForCausalLM(cfg), params=sd, dtype="fp32",
                             device="cpu", **engine_kw)
    got = teng.generate(ids, attention_mask=mask, **gen_kw)
    return got.numpy(), want, teng


CASES = {
    # name: (prompt lengths, generate kwargs, engine kwargs)
    "mixed_lengths_bucketed": ((5, 11, 3), dict(max_new_tokens=12), {}),
    "bucketing_off": ((7, 2, 13), dict(max_new_tokens=10),
                      dict(bucket_shapes=False)),
    "int8_kv_cache": ((9, 4), dict(max_new_tokens=9),
                      dict(kv_cache_int8=True)),
    "int8_weights": ((5, 11, 3), dict(max_new_tokens=12),
                     dict(quantize_weights="int8")),
    "int4_weights": ((6, 10), dict(max_new_tokens=9),
                     dict(quantize_weights="int4")),
    "int4_group32_int8_kv": ((8, 3), dict(max_new_tokens=7),
                             dict(quantize_weights="int4",
                                  quantize_group_size=32,
                                  kv_cache_int8=True)),
    # the static decode loop that a CUDA device captures, run uncaptured
    "cuda_graph_loop": ((5, 11, 3), dict(max_new_tokens=12),
                        dict(enable_cuda_graph=True)),
    "cuda_graph_loop_int8_weights_int8_kv": (
        (9, 4), dict(max_new_tokens=9),
        dict(enable_cuda_graph=True, quantize_weights="int8",
             kv_cache_int8=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_tokens_identical_to_jax(tiny, case):
    jmodel, jparams, sd = tiny
    lens, gen_kw, engine_kw = CASES[case]
    ids, mask = _prompts(lens, seed=len(case))
    got, want, teng = _both(jmodel, jparams, sd, LlamaConfig.tiny(), ids,
                            mask, gen_kw, **engine_kw)
    assert got.shape == (len(lens), gen_kw["max_new_tokens"])
    np.testing.assert_array_equal(got, want)
    if "quantize_weights" in engine_kw:
        assert teng.quant_summary["leaves"] == 7 * 2
        assert teng.module.model.layers[0].mlp.down_proj.qweight.dtype == (
            torch.uint8 if engine_kw["quantize_weights"] == "int4"
            else torch.int8)


def test_sliding_window_tokens_identical_to_jax():
    jmodel, jparams = _params({"sliding_window": 4})
    cfg = LlamaConfig.tiny(sliding_window=4)
    sd = flax_to_torch_state_dict(jax.device_get(jparams), cfg)
    ids, mask = _prompts((9, 3, 12), seed=5)
    got, want, _ = _both(jmodel, jparams, sd, cfg, ids, mask,
                         dict(max_new_tokens=11))
    np.testing.assert_array_equal(got, want)


FLASH_PREFILL = {
    # name: (model overrides, prompt lengths, engine kwargs)
    "left_padded_bucketed": ({}, (5, 11, 3), {}),
    "bucketing_off": ({}, (7, 2, 13), dict(bucket_shapes=False)),
    "window": ({"sliding_window": 4}, (9, 3, 12), {}),
    "int8_kv_cache": ({}, (9, 4), dict(kv_cache_int8=True)),
}


@pytest.mark.parametrize("case", sorted(FLASH_PREFILL))
def test_flash_prefill_from_empty_tokens_identical_to_jax(case, monkeypatch):
    """``prefill_flash_from_empty=True``: the prefill of ``generate``
    attends its fresh, un-repeated K/V through the masked flash wrapper
    (once per layer; the decode steps stay on the K4 wrapper) and the
    greedy tokens of a left-padded batch equal the JAX engine's with the
    same flag, and the port's without it."""
    over, lens, engine_kw = FLASH_PREFILL[case]
    over = dict(over, prefill_flash_from_empty=True)
    jmodel, jparams = _params(over)
    cfg = LlamaConfig.tiny(**over)
    sd = flax_to_torch_state_dict(jax.device_get(jparams), cfg)
    ids, mask = _prompts(lens, seed=3)
    calls = []
    real = layers_mod.flash_prefill_from_empty

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(layers_mod, "flash_prefill_from_empty", spy)
    got, want, _ = _both(jmodel, jparams, sd, cfg, ids, mask,
                         dict(max_new_tokens=9), **engine_kw)
    np.testing.assert_array_equal(got, want)
    assert len(calls) == cfg.num_hidden_layers, "one prefill, every layer"
    T = calls[0][0][1]
    assert calls[0] == ((len(lens), T, 4, 16), (len(lens), T, 2, 16)), \
        "kv heads are not repeated"
    plain_cfg = dataclasses.replace(cfg, prefill_flash_from_empty=False)
    plain = dt.init_inference(LlamaForCausalLM(plain_cfg), params=sd,
                              dtype="fp32", device="cpu", **engine_kw)
    np.testing.assert_array_equal(
        plain.generate(ids, attention_mask=mask, max_new_tokens=9).numpy(),
        got)
    assert len(calls) == cfg.num_hidden_layers


@pytest.mark.parametrize("decode_loop", ["while", "scan"])
@pytest.mark.parametrize("lens", [(7,), (5, 11, 3)], ids=["one", "three"])
def test_eos_tokens_identical_to_jax(tiny, decode_loop, lens):
    """An EOS that the greedy stream emits early: rows that finish keep
    emitting it, and with one row the "while" loop stops at once and
    fills the tail with it."""
    jmodel, jparams, sd = tiny
    ids, mask = _prompts(lens, seed=6)
    free, _, _ = _both(jmodel, jparams, sd, LlamaConfig.tiny(), ids, mask,
                       dict(max_new_tokens=12))
    eos = int(free[0, 2])
    got, want, teng = _both(jmodel, jparams, sd, LlamaConfig.tiny(), ids,
                            mask, dict(max_new_tokens=12, eos_token_id=eos),
                            decode_loop=decode_loop)
    np.testing.assert_array_equal(got, want)
    row = list(got[0])
    assert row[row.index(eos):] == [eos] * (12 - row.index(eos))


@pytest.mark.parametrize("gen_kw", [
    dict(max_new_tokens=12), dict(max_new_tokens=12, eos_token_id="early"),
    dict(max_new_tokens=10, do_sample=True, top_k=20, seed=3)],
    ids=["greedy", "eos", "sampled"])
def test_static_decode_loop_repeats_the_uncaptured_tokens(tiny, gen_kw):
    """With enable_cuda_graph (uncaptured on the CPU) generate keeps the
    decode tensors of its last shape between calls: two calls on one
    engine, and a call at another prompt length in between, give the
    tokens of an engine that keeps nothing, greedy, with an EOS that stops
    the loop early, and sampled (the draws follow the step with the same
    generator)."""
    _, _, sd = tiny
    engines = [dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()),
                                 params=sd, dtype="fp32", device="cpu",
                                 enable_cuda_graph=graphed)
               for graphed in (False, True)]
    ids, mask = _prompts((5, 11, 3), seed=8)
    other, omask = _prompts((4, 2), seed=9)
    kw = dict(gen_kw)
    if kw.get("eos_token_id") == "early":
        kw["eos_token_id"] = int(engines[0].generate(
            ids, attention_mask=mask, max_new_tokens=4)[0, 2])
    want = engines[0].generate(ids, attention_mask=mask, **kw)
    want_other = engines[0].generate(other, attention_mask=omask, **kw)
    static = engines[1]
    assert torch.equal(static.generate(ids, attention_mask=mask, **kw), want)
    assert torch.equal(static.generate(other, attention_mask=omask, **kw),
                       want_other)
    assert torch.equal(static.generate(ids, attention_mask=mask, **kw), want)
    assert len(static._decode_graphs) == 1 and not engines[0]._decode_graphs


def test_graphed_decode_keeps_only_the_last_shape(tiny):
    """enable_cuda_graph keeps the decode tensors of one shape: each
    decoding call at another batch, prompt bucket, token count or EOS id
    releases the last one's, and a call without a decode step (one new
    token) keeps them."""
    _, _, sd = tiny
    eng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                            dtype="fp32", device="cpu",
                            enable_cuda_graph=True)
    calls = [((5, 11, 3), dict(max_new_tokens=6)),
             ((4, 2), dict(max_new_tokens=6)),
             ((20, 9), dict(max_new_tokens=6)),
             ((4, 2), dict(max_new_tokens=12)),
             ((4, 2), dict(max_new_tokens=12, eos_token_id=5))]
    for i, (lens, kw) in enumerate(calls):
        ids, mask = _prompts(lens, seed=10 + i)
        eng.generate(ids, attention_mask=mask, **kw)
        assert len(eng._decode_graphs) == 1
        key = next(iter(eng._decode_graphs))
        eng.generate(ids, attention_mask=mask, max_new_tokens=1)
        assert list(eng._decode_graphs) == [key]
    assert key[0] == 2 and key[3:] == (False, 5)


def test_early_exit_stops_decoding(tiny, monkeypatch):
    """With every row done, the "while" loop runs no further forward."""
    _, _, sd = tiny
    eng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                            dtype="fp32", device="cpu")
    ids, mask = _prompts((7,), seed=6)
    eos = int(eng.generate(ids, attention_mask=mask, max_new_tokens=4)[0, 1])
    calls = []
    monkeypatch.setattr(layers_mod, "decode_attention",
                        lambda *a, **kw: calls.append(1) or
                        decode_attention(*a, **kw))
    out = eng.generate(ids, attention_mask=mask, max_new_tokens=16,
                       eos_token_id=eos)
    L = LlamaConfig.tiny().num_hidden_layers
    assert len(calls) == L, "one decode step, then every row was done"
    assert out[0, 1:].tolist() == [eos] * 15


def test_decode_steps_go_through_the_kernel_wrapper(tiny, monkeypatch):
    """Each decode step calls the K4 wrapper once per layer (the prefill
    takes the plain cached attention), on CPU tensors here."""
    _, _, sd = tiny
    eng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                            dtype="fp32", device="cpu")
    calls = []

    def spy(q, *args, **kw):
        calls.append(q.device.type)
        return decode_attention(q, *args, **kw)

    monkeypatch.setattr(layers_mod, "decode_attention", spy)
    ids, mask = _prompts((5, 9), seed=2)
    eng.generate(ids, attention_mask=mask, max_new_tokens=6)
    assert calls == ["cpu"] * (LlamaConfig.tiny().num_hidden_layers * 5)


@pytest.mark.parametrize("mode", [None, "int8"])
def test_forward_logits_match_jax(tiny, mode):
    jmodel, jparams, sd = tiny
    ids = np.random.RandomState(8).randint(0, 256, (2, 10))
    kw = {} if mode is None else {"quantize_weights": mode}
    want = np.asarray(jds.init_inference(jmodel, params=jparams, dtype="fp32",
                                         **kw).forward(jnp.asarray(ids)))
    got = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                            dtype="fp32", device="cpu", **kw).forward(ids)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.7), (4, 0.8)])
def test_top_k_top_p_candidates_match_jax(top_k, top_p):
    """Both samplers draw only from the same candidate set: 400 draws per
    row on each side (every candidate has probability >= 5%, so each
    appears on both sides with overwhelming odds)."""
    logits = np.asarray([[3.0, 2.8, 2.6, 2.4, 2.2, -1.0, -2.0, -3.0],
                         [0.1, 2.0, 1.9, -4.0, 1.8, 1.7, 1.6, -1.0]],
                        np.float32)
    n = 400
    jd = np.asarray(jax.vmap(lambda k: jax_sample(
        jnp.asarray(logits), k, True, 1.0, top_k, top_p))(
            jax.random.split(jax.random.PRNGKey(0), n)))
    gen = torch.Generator().manual_seed(0)
    td = np.stack([_sample_logits(torch.from_numpy(logits), gen, True, 1.0,
                                  top_k, top_p).numpy() for _ in range(n)])
    for r in range(logits.shape[0]):
        assert set(td[:, r]) == set(jd[:, r])


def test_sampling_is_seeded_and_keeps_shapes(tiny):
    _, _, sd = tiny
    eng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                            dtype="fp32", device="cpu")
    ids, mask = _prompts((6, 4), seed=9)
    kw = dict(attention_mask=mask, max_new_tokens=10, do_sample=True,
              top_k=20, temperature=0.8)
    a = eng.generate(ids, seed=3, **kw)
    assert torch.equal(a, eng.generate(ids, seed=3, **kw))
    assert a.shape == (2, 10)
    eng.profile_model_time()
    eng.generate(ids, **kw)
    times = eng.model_times()
    assert len(times) == 1 and times[0] > 0 and eng.model_times() == []


def _traffic(seed=5, n=4):
    rs = np.random.RandomState(seed)
    return [(rs.randint(1, 256, int(rs.choice([5, 9, 14, 21]))),
             int(rs.choice([4, 8]))) for _ in range(n)]


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_serving_equals_generate_and_jax(tiny, mode):
    """Quantized weights in the serving engine (K5 in the mixed step): its
    tokens equal the same engine's generate, and the JAX engine's."""
    jmodel, jparams, sd = tiny
    teng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()), params=sd,
                             dtype="fp32", device="cpu",
                             quantize_weights=mode)
    jeng = jds.init_inference(jmodel, params=jparams, dtype="fp32",
                              quantize_weights=mode)
    srv = dt.ServingEngine(teng, dt.ServingConfig(
        max_batch_size=4, block_size=8, num_blocks=64, max_model_len=64))
    traffic = _traffic()
    rids = [srv.submit(p, max_new_tokens=n) for p, n in traffic]
    outs = srv.run()
    assert all(outs[r].state == "finished" for r in rids)
    assert srv.block_pool.used_count == 0
    for (p, n), r in zip(traffic, rids):
        mine = teng.generate(p[None], max_new_tokens=n)[0].tolist()
        theirs = np.asarray(jeng.generate(jnp.asarray(p)[None],
                                          max_new_tokens=n))[0].tolist()
        assert outs[r].tokens == mine == theirs


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int4", 0),
                                        ("int4", 32)])
def test_bridge_carries_a_quantized_tree(tiny, mode, group):
    """The JAX engine's quantized params carried across equal the port's
    own quantization of the carried-across fp weights, tensor for tensor
    (codes untransposed, scales fp32), and load into the quantized
    model."""
    jmodel, jparams, sd = tiny
    jeng = jds.init_inference(jmodel, params=jparams, dtype="fp32",
                              quantize_weights=mode,
                              quantize_group_size=group)
    cfg = LlamaConfig.tiny(quantize_weights=mode, quantize_group_size=group)
    carried = flax_to_torch_state_dict(jax.device_get(jeng.params), cfg)
    model = LlamaForCausalLM(cfg)
    mine, report = quantize_state_dict(sd, model, mode, group)
    assert sorted(carried) == sorted(mine) == sorted(model.state_dict())
    for name, t in mine.items():
        assert carried[name].dtype == t.dtype, name
        assert torch.equal(carried[name], t), name
    assert len(report) == 7 * cfg.num_hidden_layers
    eng = dt.init_inference(model, params=carried, dtype="fp32",
                            device="cpu")
    ids, mask = _prompts((5, 3), seed=4)
    want = np.asarray(jeng.generate(jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    max_new_tokens=6))
    np.testing.assert_array_equal(
        eng.generate(ids, attention_mask=mask, max_new_tokens=6).numpy(),
        want)


def test_config_validation():
    model = LlamaForCausalLM(LlamaConfig.tiny())
    for bad in ({"decode_loop": "for"}, {"quantize_weights": "int2"}):
        with pytest.raises(ValueError):
            dt.init_inference(model, params=model.init_params(),
                              device="cpu", **bad)
    with pytest.raises(ValueError, match="quantize_weights"):
        LlamaConfig.tiny(quantize_weights="fp8")


