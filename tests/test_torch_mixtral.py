"""Mixtral (``models/mixtral.py``) and its HF injection against the JAX
package and HF.

The HF tiny model of ``tests/unit/test_mixtral.py`` goes through both
packages' ``match_policy`` (the same class) and module injection; the
JAX ``MixtralForCausalLM``'s flax params (seeded ``model.init``) go
through the bridge (``checkpoint.from_flax``, scanned and unscanned). All
in fp32 on numpy-seeded inputs:

- logits equal HF's and JAX's within 1e-5 (also with a sliding window
  shorter than the sequence);
- greedy ``generate`` tokens equal the JAX engine's (left-padded prompts;
  with and without ``prefill_flash_from_empty``, whose masked flash
  wrapper and the K4 wrapper are called once per layer a prefill / a
  decode step);
- a cached decode's logits equal the full forward's within 1e-5;
- one token a row takes the touched-expert route (the dense route never
  runs), whose output equals the dense route's within 1e-6 and JAX's
  decode step's within 1e-5;
- the aux loss (token-masked with a padded batch) equals JAX's within
  1e-6, and three AdamW steps through both engines give losses (LM + aux)
  within 1e-4, scanned and unscanned;
- the legacy grouped ``quantize`` gives the JAX engine's tokens;
- ``quantize_weights`` raises ``ValueError`` and the paged serving engine
  ``TypeError``, as in JAX; ``ep_size > 1`` raises (a deliberate
  difference: one device).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

os.environ.setdefault("USE_TF", "0")
transformers = pytest.importorskip("transformers")

import deepspeed_tpu as jds  # noqa: E402
from deepspeed_tpu.models.mixtral import MixtralConfig as JaxConfig  # noqa
from deepspeed_tpu.models.mixtral import MixtralForCausalLM as JaxMixtral  # noqa
from deepspeed_tpu.models.mixtral import MixtralModel as JaxMixtralModel  # noqa
from deepspeed_tpu.module_inject import match_policy as jax_match  # noqa
from deepspeed_tpu.module_inject import \
    replace_transformer_layer as jax_replace  # noqa: E402
from deepspeed_tpu.parallel import topology  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.checkpoint.from_flax import \
    flax_to_torch_state_dict  # noqa: E402
from deepspeed_tpu_torch.models import mixtral  # noqa: E402
from deepspeed_tpu_torch.models import (MixtralConfig,  # noqa: E402
                                        MixtralForCausalLM)
from deepspeed_tpu_torch.module_inject import (match_policy,  # noqa: E402
                                               replace_transformer_layer)

#: fp32 logits and outputs; a route against the other; training losses
TOL, ROUTE_TOL, TRAIN_TOL = 1e-5, 1e-6, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf(seed=0, **over):
    torch.manual_seed(seed)
    cfg = transformers.MixtralConfig(**dict(dict(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, num_local_experts=4,
        num_experts_per_tok=2, attention_dropout=0.0), **over))
    return transformers.MixtralForCausalLM(cfg).eval()


def _port(model, sd):
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def _jax_model(seed=0, **over):
    jcfg = JaxConfig.tiny(**over)
    model = JaxMixtral(jcfg)
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"])
    return jcfg, model, params


def _prompts(lens, seed=0, vocab=128):
    """Left-padded ``(ids, mask)`` int32 arrays."""
    rs = np.random.RandomState(seed)
    T = max(lens)
    ids = np.zeros((len(lens), T), np.int32)
    mask = np.zeros((len(lens), T), np.int32)
    for b, n in enumerate(lens):
        ids[b, T - n:] = rs.randint(1, vocab, n)
        mask[b, T - n:] = 1
    return ids, mask


@pytest.mark.parametrize("window", [None, 8])
def test_policy_match_and_logits_match_hf_and_jax(window):
    hf = _hf(sliding_window=window) if window else _hf()
    assert type(match_policy(hf)).__name__ == \
        type(jax_match(hf)).__name__ == "HFMixtralLayerPolicy"
    model, sd = replace_transformer_layer(hf)
    assert model.config.sliding_window == window
    jmodel, jparams = jax_replace(hf)
    ids = np.random.RandomState(7 if window else 1).randint(
        0, 128, (2, 24 if window else 12))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
        got = _port(model, sd)(torch.tensor(ids)).numpy()
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_hf_training_loss_matches_hf_including_aux():
    hf = _hf(seed=4)
    model, sd = replace_transformer_layer(hf)
    ids = torch.tensor(np.random.RandomState(5).randint(0, 128, (2, 12)))
    with torch.no_grad():
        out = hf(ids, labels=ids, output_router_logits=True)
        got = _port(model, sd)(ids, labels=ids)
    np.testing.assert_allclose(float(got), float(out.loss), rtol=TOL)


def test_an_hf_directory_loads_as_the_hf_model(tmp_path):
    """``init_inference(checkpoint=<HF directory>)`` stacks each layer's
    experts from the shards as they are read."""
    hf = _hf(seed=2)
    hf.save_pretrained(tmp_path, max_shard_size="40KB")
    assert len(list(tmp_path.glob("*.safetensors"))) > 2
    eng = dt.init_inference(checkpoint=str(tmp_path), dtype=torch.float32,
                            device="cpu")
    ids = np.random.RandomState(3).randint(0, 128, (2, 10))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    np.testing.assert_allclose(eng.forward(ids).numpy(), ref, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("flash", [False, True],
                         ids=["plain_prefill", "flash_prefill"])
def test_generate_tokens_identical_to_jax(flash, monkeypatch):
    from deepspeed_tpu_torch.models import llama

    jcfg, jmodel, jparams = _jax_model()
    cfg = MixtralConfig.tiny(prefill_flash_from_empty=flash)
    sd = flax_to_torch_state_dict(jparams, cfg)
    calls = {"decode": 0, "flash": 0}

    def spy(name, real):
        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapped

    from deepspeed_tpu_torch.models import layers
    monkeypatch.setattr(layers, "decode_attention",
                        spy("decode", layers.decode_attention))
    monkeypatch.setattr(layers, "flash_prefill_from_empty",
                        spy("flash", layers.flash_prefill_from_empty))
    assert llama.attend_cache is layers.attend_cache
    ids, mask = _prompts((5, 11, 3), seed=4)
    jeng = jds.init_inference(jmodel, params=jparams, dtype="fp32")
    want = np.asarray(jeng.generate(jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    max_new_tokens=8))
    teng = dt.init_inference(MixtralForCausalLM(cfg), params=sd,
                             dtype="fp32", device="cpu")
    got = teng.generate(ids, attention_mask=mask, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    L = cfg.num_hidden_layers
    assert calls == {"decode": L * 7, "flash": L if flash else 0}
    assert set(teng.module_state_dict()) == set(sd)


def test_hf_generate_matches_the_jax_engine():
    hf = _hf()
    ids = np.random.RandomState(2).randint(0, 128, (2, 8))
    want = np.asarray(jds.init_inference(hf, dtype="fp32", mp_size=1)
                      .generate(ids, max_new_tokens=6, do_sample=False))
    got = dt.init_inference(hf, dtype="fp32", device="cpu").generate(
        ids, max_new_tokens=6, do_sample=False).numpy()
    np.testing.assert_array_equal(got, want)


def test_cached_decode_matches_full_forward():
    _, _, jparams = _jax_model()
    cfg = MixtralConfig.tiny()
    model = _port(MixtralForCausalLM(cfg),
                  flax_to_torch_state_dict(jparams, cfg))
    B, T = 2, 10
    ids = torch.tensor(np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                        (B, T)))
    with torch.no_grad():
        full = model(ids)
        cache = model.init_cache(B, T, dtype=torch.float32)
        key_mask = torch.zeros((B, T), dtype=torch.int32)
        key_mask[:, :6] = 1
        logits, cache = model(ids[:, :6], cache=cache,
                              cache_index=torch.tensor(0),
                              attention_mask=key_mask)
        np.testing.assert_allclose(logits.numpy(), full[:, :6].numpy(),
                                   rtol=TOL, atol=TOL)
        for t in range(6, T):
            key_mask[:, t] = 1
            step, cache = model(ids[:, t:t + 1], cache=cache,
                                cache_index=torch.tensor(t),
                                attention_mask=key_mask)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].numpy(),
                                       rtol=TOL, atol=TOL)


def test_decode_route_computes_only_touched_experts(monkeypatch):
    """A decode step (T 1, E 4 > K 2) runs the touched-expert route and
    never the dense one; its output equals the dense route's on the same
    routing, and the step's logits equal JAX's (whose T 1 route gathers
    too)."""
    jcfg, jmodel, jparams = _jax_model()
    cfg = MixtralConfig.tiny()
    model = _port(MixtralForCausalLM(cfg),
                  flax_to_torch_state_dict(jparams, cfg))
    routes = {"touched": [], "every": 0}
    touched, every = mixtral.touched_experts, mixtral.every_expert

    def spy_touched(x, w1, w3, w2, topk_w, topk_idx):
        out = touched(x, w1, w3, w2, topk_w, topk_idx)
        routes["touched"].append((x, w1, w3, w2, topk_w, topk_idx, out))
        return out

    def spy_every(*args):
        routes["every"] += 1
        return every(*args)

    monkeypatch.setattr(mixtral, "touched_experts", spy_touched)
    monkeypatch.setattr(mixtral, "every_expert", spy_every)
    B, P = 3, 8
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (B, P))
    mask = np.ones((B, P + 4), np.int32)
    mask[:, P:] = 0
    cache = model.init_cache(B, P + 4, dtype=torch.float32)
    with torch.no_grad():
        got, _ = model(torch.tensor(ids[:, :1]), cache=cache,
                       cache_index=torch.tensor(P),
                       attention_mask=torch.tensor(mask))
    assert routes["every"] == 0
    assert len(routes["touched"]) == cfg.num_hidden_layers
    E = cfg.num_local_experts
    for x, w1, w3, w2, topk_w, topk_idx, out in routes["touched"]:
        combine = (topk_w[..., None] *
                   torch.nn.functional.one_hot(topk_idx, E)).sum(dim=1)
        dense = every(x, w1, w3, w2, combine)
        np.testing.assert_allclose(out.numpy(), dense.numpy(),
                                   rtol=ROUTE_TOL, atol=ROUTE_TOL)
    jcache = jmodel.init_cache(B, P + 4, dtype=jnp.float32)
    want, _ = jmodel.apply({"params": jparams}, jnp.asarray(ids[:, :1]),
                           attention_mask=jnp.asarray(mask), cache=jcache,
                           cache_index=jnp.int32(P))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_aux_loss_matches_jax_with_a_padded_batch():
    _, _, jparams = _jax_model(seed=3)
    cfg = MixtralConfig.tiny()
    model = _port(MixtralForCausalLM(cfg),
                  flax_to_torch_state_dict(jparams, cfg))
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 12))
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    _, want = JaxMixtralModel(JaxConfig.tiny()).apply(
        {"params": jparams["model"]}, jnp.asarray(ids),
        attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        _, got = model.model(torch.tensor(ids),
                             attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=ROUTE_TOL)
    assert float(got) > 0


@pytest.mark.parametrize("scan_layers", [True, False])
def test_training_losses_match_the_jax_engine(scan_layers):
    """AdamW in fp32, 3 steps (remat on, as the JAX default): the loss,
    LM plus the weighted aux, equals JAX's at each step."""
    config = {"train_batch_size": 4, "steps_per_print": 0,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 3e-3, "weight_decay": 0.1}},
              "gradient_clipping": 1.0}
    saved = topology.get_mesh(), topology.get_topology()
    mesh = topology.build_mesh(devices=jax.devices()[:1])
    try:
        jcfg, jmodel, jparams = _jax_model(scan_layers=scan_layers,
                                           remat=True)
        jeng, *_ = jds.initialize(model=jmodel, config=dict(config),
                                  model_parameters=jparams, mesh=mesh)
        cfg = MixtralConfig.tiny(scan_layers=scan_layers, remat=True)
        peng, *_ = dt.initialize(
            model=MixtralForCausalLM(cfg), config=dict(config),
            model_parameters=flax_to_torch_state_dict(jparams, cfg),
            device="cpu")
        rs = np.random.RandomState(0)
        for _ in range(3):
            ids = rs.randint(0, cfg.vocab_size, (4, 16)).astype(np.int32)
            batch = {"input_ids": ids, "labels": ids}
            want = float(jeng.train_batch(batch=batch))
            got = float(peng.train_batch(batch=batch))
            np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)
    finally:
        topology.set_mesh(*saved)


def test_legacy_quantize_tokens_identical_to_jax():
    """The legacy grouped ``quantize`` reads Mixtral's stacked expert
    leaves through ``flax_leaves`` as JAX quantizes them: greedy tokens
    equal the JAX engine's (fp32 compute)."""
    _, jmodel, jparams = _jax_model()
    cfg = MixtralConfig.tiny()
    ids = np.random.RandomState(0).randint(1, 128, (2, 8))
    want = np.asarray(jds.init_inference(
        jmodel, params=jparams, dtype="fp32", quantize=True).generate(
        jnp.asarray(ids), max_new_tokens=6))
    got = dt.init_inference(
        MixtralForCausalLM(cfg), params=flax_to_torch_state_dict(jparams,
                                                                 cfg),
        dtype="fp32", quantize=True, device="cpu").generate(
        ids, max_new_tokens=6).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_serving_and_ep_size_raise():
    _, jmodel, jparams = _jax_model()
    cfg = MixtralConfig.tiny()
    sd = flax_to_torch_state_dict(jparams, cfg)
    with pytest.raises(ValueError, match="quantizable projections"):
        jds.init_inference(jmodel, params=jparams, dtype="fp32",
                           quantize_weights="int8")
    with pytest.raises(ValueError, match="quantizable projections"):
        dt.init_inference(MixtralForCausalLM(cfg), params=sd, dtype="fp32",
                          device="cpu", quantize_weights="int8")
    from deepspeed_tpu.inference.serving import ServingEngine as JaxServing
    with pytest.raises(TypeError, match="init_paged_cache"):
        JaxServing(jds.init_inference(jmodel, params=jparams, dtype="fp32"))
    eng = dt.init_inference(MixtralForCausalLM(cfg), params=sd,
                            dtype="fp32", device="cpu")
    with pytest.raises(TypeError, match="init_paged_cache"):
        dt.ServingEngine(eng, dt.ServingConfig())
    # deliberate difference: expert parallelism needs more than one device
    with pytest.raises(NotImplementedError, match="item 9"):
        dt.init_inference(MixtralForCausalLM(cfg), params=sd, dtype="fp32",
                          device="cpu", ep_size=2)
    dt.init_inference(MixtralForCausalLM(cfg), params=sd, dtype="fp32",
                      device="cpu", ep_size=1)
