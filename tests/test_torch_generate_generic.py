"""Dense generation of the generic transformer's families against the JAX
package (``models/transformer.py`` in both).

The JAX ``TransformerLMHeadModel``'s flax params (seeded ``model.init``)
go through the bridge to the port's; both engines generate greedily in
fp32 from the same left-padded numpy prompts. For OPT (learned positions
at +2, ReLU), BLOOM (ALiBi, embedding LN), GPT-NeoX (a quarter rotary,
the parallel residual), GPT-J (interleaved rotary, one shared LN, a
biased head), GPT-Neo with local and all-global layers, Falcon
(multi-query) and Phi, and Phi and GPT-J again at head dims 80 and 256:
the tokens equal the JAX engine's with and
without ``prefill_flash_from_empty``, and the K4 and masked K1 wrappers
are called exactly where the config is eligible (no ALiBi, no
``attention_layers``), once per layer a decode step and a prefill. The
static decode loop (captured on a card) and an int8 cache give JAX's
tokens too; ``quantize_weights`` and the paged serving engines are
refused as the JAX engine refuses them. (Kept apart from
``tests/test_torch_generate.py`` so that the suite's files spread over
its workers.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, which only
    contend for the cores with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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

GENERIC_BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    max_position_embeddings=128)

#: family -> (TransformerConfig overrides, the kernels' routes eligible)
GENERIC = {
    "opt": (dict(pos_offset=2, activation="relu"), True),
    "bloom_alibi": (dict(pos_embedding="alibi", embedding_layernorm=True,
                         tie_word_embeddings=True, activation="gelu_new"),
                    False),
    "gpt_neox": (dict(pos_embedding="rope", rotary_pct=0.25,
                      parallel_residual=True), True),
    "gptj": (dict(pos_embedding="rope", rotary_pct=0.5,
                  rope_style="interleaved", parallel_residual=True,
                  shared_parallel_ln=True, attention_bias=False,
                  lm_head_bias=True, activation="gelu_new"), True),
    "gpt_neo_local": (dict(attention_layers=("global", "local"),
                           attention_window=4, attention_scale=1.0,
                           attention_bias=False, attention_out_bias=True,
                           tie_word_embeddings=True), False),
    # attention_layers set, all global: the window machinery goes, the
    # kernels stay off (as in JAX)
    "gpt_neo_all_global": (dict(attention_layers=("global",),
                                attention_scale=1.0), False),
    "falcon_mqa": (dict(num_key_value_heads=1, pos_embedding="rope",
                        parallel_residual=True, shared_parallel_ln=True,
                        attention_bias=False, mlp_bias=False,
                        tie_word_embeddings=True), True),
    "phi": (dict(pos_embedding="rope", rotary_pct=0.5,
                 parallel_residual=True, shared_parallel_ln=True,
                 lm_head_bias=True), True),
}
# Phi-2's head dim (80, rotary on 0.4 of it) and GPT-J-6B's (256, rotary
# on a quarter), two heads each
GENERIC["phi_d80"] = (dict(GENERIC["phi"][0], hidden_size=160,
                           num_attention_heads=2, rotary_pct=0.4), True)
GENERIC["gptj_d256"] = (dict(GENERIC["gptj"][0], hidden_size=512,
                             num_attention_heads=2, rotary_pct=0.25), True)


@pytest.mark.parametrize("flash", [False, True],
                         ids=["plain_prefill", "flash_prefill"])
@pytest.mark.parametrize("family", sorted(GENERIC))
def test_generic_family_tokens_identical_to_jax(family, flash, monkeypatch):
    """Greedy tokens of a left-padded batch equal the JAX engine's for
    each generic family, with and without ``prefill_flash_from_empty``;
    the decode steps go through the K4 wrapper (once per layer a step)
    and the flagged prefill through the masked flash wrapper (once per
    layer) exactly where the config is eligible, and never elsewhere."""
    from deepspeed_tpu.models import transformer as jt
    from deepspeed_tpu_torch.models import transformer as tt

    over, eligible = GENERIC[family]
    kw = dict(GENERIC_BASE, **over, prefill_flash_from_empty=flash)
    jmodel = jt.TransformerLMHeadModel(jt.TransformerConfig(**kw))
    jparams = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = tt.TransformerConfig(**kw)
    sd = flax_to_torch_state_dict(jparams, cfg)
    calls = {"decode": 0, "flash": 0}

    def spy(name, real):
        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapped

    monkeypatch.setattr(tt, "decode_attention",
                        spy("decode", tt.decode_attention))
    monkeypatch.setattr(tt, "flash_prefill_from_empty",
                        spy("flash", tt.flash_prefill_from_empty))
    ids, mask = _prompts((5, 11, 3), seed=len(family))
    jeng = jds.init_inference(jmodel, params=jparams, dtype="fp32")
    want = np.asarray(jeng.generate(jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    max_new_tokens=8))
    teng = dt.init_inference(tt.TransformerLMHeadModel(cfg), params=sd,
                             dtype="fp32", device="cpu")
    got = teng.generate(ids, attention_mask=mask, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
    L = cfg.num_hidden_layers
    assert calls == {"decode": L * 7 if eligible else 0,
                     "flash": L if eligible and flash else 0}


def test_generic_generate_graphed_loop_and_int8_cache_match_jax():
    """The static decode loop (captured on a card) and an int8 KV cache on
    the generic model give the JAX engine's tokens."""
    from deepspeed_tpu.models import transformer as jt
    from deepspeed_tpu_torch.models import transformer as tt

    kw = dict(GENERIC_BASE, **GENERIC["gpt_neox"][0])
    jmodel = jt.TransformerLMHeadModel(jt.TransformerConfig(**kw))
    jparams = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"])
    cfg = tt.TransformerConfig(**kw)
    sd = flax_to_torch_state_dict(jparams, cfg)
    ids, mask = _prompts((9, 4), seed=11)
    for engine_kw in (dict(enable_cuda_graph=True), dict(kv_cache_int8=True)):
        jeng = jds.init_inference(jmodel, params=jparams, dtype="fp32",
                                  **engine_kw)
        want = np.asarray(jeng.generate(jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask),
                                        max_new_tokens=9))
        teng = dt.init_inference(tt.TransformerLMHeadModel(cfg), params=sd,
                                 dtype="fp32", device="cpu", **engine_kw)
        for _ in range(2):      # the second call reuses the kept loop
            got = teng.generate(ids, attention_mask=mask, max_new_tokens=9)
            np.testing.assert_array_equal(got.numpy(), want)


def test_generic_models_refuse_quantize_weights_and_paged_serving():
    """As in the JAX engine: ``quantize_weights`` needs declared
    quantizable projections, and the serving engines need
    ``init_paged_cache`` (the JAX message, not an AttributeError)."""
    from deepspeed_tpu_torch.models import transformer as tt

    model = tt.TransformerLMHeadModel(tt.TransformerConfig(**GENERIC_BASE))
    params = model.init_params()
    with pytest.raises(ValueError, match="quantizable projections"):
        dt.init_inference(model, params=params, device="cpu",
                          quantize_weights="int8")
    eng = dt.init_inference(model, params=params, device="cpu",
                            dtype="fp32")
    with pytest.raises(TypeError, match="has no init_paged_cache: paged "
                                        "serving supports the Llama and "
                                        "GPT-2 families"):
        dt.ServingEngine(eng, dt.ServingConfig())
