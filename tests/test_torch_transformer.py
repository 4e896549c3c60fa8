"""The port's generic transformer against the JAX ``models/transformer.py``.

Both packages get the same flax params (``model.init`` of the JAX model,
seeded) through the bridge (``checkpoint.from_flax``) and the same
numpy-seeded ids and masks. Each case turns on option axes of the block:
learned (OPT's +2 offset), rotary (partial, interleaved), ALiBi (a
non-power-of-two head count) or no positions; pre- and post-LN; the
parallel residual with two LayerNorms and with one shared; GQA; GPT-Neo's
mixed local/global layers and the all-global case; token types with the
embedding LayerNorm and BERT's MLM head; scanned and unscanned layers.

Tolerances: fp32 logits 1e-5 (a few dozen fp32 ops deep, summation order
only); the gradients of one loss 1e-4; a bf16 forward (params and
activations bf16 in both) within 4e-2 of the JAX bf16 logits, which are
themselves that far from fp32 (each projection rounds to bf16, 8 bits of
mantissa, and the two frameworks round in different places inside a
matmul). The cached decode (prefill, then one token a step, through the
kernels' routes and the plain composite-bias route) equals the full
forward at 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.checkpoint.from_flax import (flax_to_torch_state_dict,
                                                      torch_to_flax)
from deepspeed_tpu_torch.models import transformer as tt
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64)

#: case -> TransformerConfig overrides (both packages)
CASES = {
    "opt_learned_offset_relu": dict(pos_offset=2, activation="relu"),
    "opt350m_post_ln": dict(pre_layernorm=False, final_layernorm=False,
                            pos_offset=2, tie_word_embeddings=True),
    "neox_partial_rotary_parallel": dict(
        pos_embedding="rope", rotary_pct=0.25, parallel_residual=True),
    "gptj_interleaved_shared_ln": dict(
        pos_embedding="rope", rotary_pct=0.5, rope_style="interleaved",
        parallel_residual=True, shared_parallel_ln=True,
        attention_bias=False, lm_head_bias=True, activation="gelu_new"),
    "bloom_alibi_6_heads": dict(
        hidden_size=48, num_attention_heads=6, pos_embedding="alibi",
        embedding_layernorm=True, tie_word_embeddings=True,
        activation="gelu_new"),
    "gpt_neo_mixed_layers": dict(
        num_hidden_layers=4, attention_layers=("global", "local"),
        attention_window=3, attention_scale=1.0, attention_bias=False,
        attention_out_bias=True, tie_word_embeddings=True),
    "gpt_neo_all_global": dict(attention_layers=("global",),
                               attention_scale=1.0),
    "falcon_gqa_rope": dict(
        num_key_value_heads=1, pos_embedding="rope", parallel_residual=True,
        shared_parallel_ln=True, attention_bias=False, mlp_bias=False,
        tie_word_embeddings=True),
    "no_positions_unscanned": dict(pos_embedding="none", scan_layers=False),
    "phi_rope_unscanned": dict(
        pos_embedding="rope", rotary_pct=0.5, parallel_residual=True,
        shared_parallel_ln=True, lm_head_bias=True, scan_layers=False),
}

BERT = dict(BASE, causal=False, pre_layernorm=False, embedding_layernorm=True,
            final_layernorm=False, type_vocab_size=2, mlm_head=True,
            tie_word_embeddings=True, norm_eps=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, which only
    contend for the cores with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(over, mlm=False):
    kw = dict(BERT if mlm else BASE, **over)
    jcls = jt.TransformerForMaskedLM if mlm else jt.TransformerLMHeadModel
    tcls = tt.TransformerForMaskedLM if mlm else tt.TransformerLMHeadModel
    jm = jcls(jt.TransformerConfig(**kw))
    tm = tcls(tt.TransformerConfig(**kw))
    ids = np.random.RandomState(0).randint(0, kw["vocab_size"], (2, 12))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # perturb the LayerNorms and biases so each shows
    rs = np.random.RandomState(7)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + rs.randn(*a.shape).astype(a.dtype) * 0.1
        if str(p[-1].key) in ("scale", "bias", "mlm_bias") else a, params)
    sd = flax_to_torch_state_dict(params, tm.config)
    tm.load_state_dict(sd, strict=True, assign=True)
    return jm, tm, params


def _batch(vocab, seed=1, B=2, T=12, pad=3):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (B, T))
    mask = np.ones((B, T), np.int32)
    mask[1, T - pad:] = 0
    return ids, mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "padded"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_match_jax(case, masked):
    jm, tm, params = _models(CASES[case])
    ids, mask = _batch(jm.config.vocab_size)
    kw = dict(attention_mask=mask) if masked else {}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                               **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids),
                 **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["opt_learned_offset_relu",
                                  "neox_partial_rotary_parallel",
                                  "gptj_interleaved_shared_ln",
                                  "bloom_alibi_6_heads",
                                  "gpt_neo_mixed_layers"])
def test_loss_gradients_match_jax(case):
    jm, tm, params = _models(CASES[case])
    ids, _ = _batch(jm.config.vocab_size, seed=2)

    def loss(p):
        return jm.apply({"params": p}, jnp.asarray(ids),
                        labels=jnp.asarray(ids))

    jl, jg = jax.value_and_grad(loss)(params)
    for p in tm.parameters():
        p.requires_grad_(True)
    tl = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5, rtol=1e-5)
    want = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jg),
                                    tm.config)
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for n in got:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("case", ["scanned", "unscanned"])
def test_bert_mlm_logits_and_gradients_match_jax(case):
    jm, tm, params = _models({"scan_layers": case == "scanned"}, mlm=True)
    ids, mask = _batch(jm.config.vocab_size, seed=3)
    types = np.random.RandomState(4).randint(0, 2, ids.shape)

    def logits(p):
        return jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                        jnp.asarray(types))

    def loss(p):
        return jnp.mean(logits(p) ** 2)

    want = np.asarray(logits(params))
    jg = jax.grad(loss)(params)
    for p in tm.parameters():
        p.requires_grad_(True)
    got = tm(torch.from_numpy(ids), torch.from_numpy(mask),
             torch.from_numpy(types))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=1e-5)
    (got ** 2).mean().backward()
    want_g = flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, jg),
                                      tm.config)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("case", ["opt_learned_offset_relu",
                                  "bloom_alibi_6_heads",
                                  "gptj_interleaved_shared_ln"])
def test_bf16_forward_matches_jax_bf16(case):
    jm, tm, params = _models(CASES[case])
    ids, mask = _batch(jm.config.vocab_size, seed=5)
    p16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                 params)
    want = np.asarray(jm.apply({"params": p16}, jnp.asarray(ids),
                               attention_mask=jnp.asarray(mask)
                               ).astype(jnp.float32))
    tm.to(torch.bfloat16)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(mask)).float().numpy()
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids),
                              attention_mask=jnp.asarray(mask)))
    assert np.abs(want - ref).max() > 1e-3   # bf16 really rounds
    np.testing.assert_allclose(got, want, atol=4e-2, rtol=0)


@pytest.mark.parametrize("flash", [False, True],
                         ids=["plain_prefill", "flash_prefill"])
@pytest.mark.parametrize("case", ["opt_learned_offset_relu",
                                  "neox_partial_rotary_parallel",
                                  "bloom_alibi_6_heads",
                                  "gpt_neo_mixed_layers",
                                  "falcon_gqa_rope"])
def test_cached_decode_equals_full_forward(case, flash):
    over = dict(CASES[case], prefill_flash_from_empty=flash)
    _, tm, _ = _models(over)
    B, T, new = 2, 7, 5
    rs = np.random.RandomState(6)
    ids = torch.from_numpy(rs.randint(0, tm.config.vocab_size, (B, T + new)))
    with torch.no_grad():
        full = tm(ids)
        cache = tm.init_cache(B, T + new, dtype=torch.float32)
        key_mask = torch.zeros((B, T + new), dtype=torch.int32)
        key_mask[:, :T] = 1
        lg, cache = tm(ids[:, :T], cache=cache, cache_index=0,
                       attention_mask=key_mask)
        steps = [lg]
        for t in range(T, T + new - 1):
            key_mask[:, t] = 1
            lg, cache = tm(ids[:, t:t + 1], cache=cache, cache_index=t,
                           attention_mask=key_mask)
            steps.append(lg)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               full[:, :T + new - 1].numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("case", ["opt_learned_offset_relu",
                                  "bloom_alibi_6_heads",
                                  "gpt_neo_mixed_layers"])
def test_cached_prefill_and_decode_match_jax(case):
    """Left-padded prompts through both packages' cached paths (the JAX
    model on its composite-bias route, the port's on the kernels' raw-mask
    route where eligible)."""
    jm, tm, params = _models(CASES[case])
    B, T, S = 2, 6, 9
    ids, _ = _batch(jm.config.vocab_size, seed=8, B=B, T=T)
    mask = np.zeros((B, S), np.int32)
    mask[0, :T], mask[1, 2:T] = 1, 1
    pos = np.clip(np.cumsum(mask[:, :T], -1) - 1, 0, None)
    jc = jm.init_cache(B, S, dtype=jnp.float32)
    jl, jc = jm.apply({"params": params}, jnp.asarray(ids),
                      attention_mask=jnp.asarray(mask), cache=jc,
                      cache_index=jnp.int32(0), positions=jnp.asarray(pos))
    tc = tm.init_cache(B, S, dtype=torch.float32)
    with torch.no_grad():
        tl, tc = tm(torch.from_numpy(ids), attention_mask=torch.from_numpy(
            mask), cache=tc, cache_index=0, positions=torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy()[mask[:, :T] > 0],
                               np.asarray(jl)[mask[:, :T] > 0], atol=1e-5,
                               rtol=1e-5)
    tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]
    mask[:, T] = 1
    p = mask.sum(-1, keepdims=True) - 1
    jl, _ = jm.apply({"params": params}, jnp.asarray(tok),
                     attention_mask=jnp.asarray(mask), cache=jc,
                     cache_index=jnp.int32(T), positions=jnp.asarray(p))
    with torch.no_grad():
        tl, _ = tm(torch.from_numpy(tok), attention_mask=torch.from_numpy(
            mask), cache=tc, cache_index=T, positions=torch.from_numpy(p))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)


def test_every_jax_config_field_is_accepted_at_its_jax_default():
    jf = {f.name: f.default for f in dataclasses.fields(jt.TransformerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tt.TransformerConfig)}
    assert jf == tf
    j, t = jt.TransformerConfig(rotary_pct=0.3), \
        tt.TransformerConfig(rotary_pct=0.3)
    for prop in ("head_dim", "kv_heads", "rotary_dim"):
        assert getattr(j, prop) == getattr(t, prop)
    # rounded, not truncated
    assert tt.TransformerConfig(hidden_size=80 * 4, num_attention_heads=4,
                                rotary_pct=0.4).rotary_dim == 32
    for q_len in (1, 5):
        for over in ({}, {"pos_embedding": "alibi"},
                     {"attention_layers": ("global",)},
                     {"prefill_flash_from_empty": True}):
            jc = jt.TransformerConfig(decode_attention_impl="pallas", **over)
            tc = tt.TransformerConfig(**over)
            assert jc.pallas_decode_eligible(q_len) == \
                tc.pallas_decode_eligible(q_len)
            assert jc.prefill_flash_eligible(q_len) == \
                tc.prefill_flash_eligible(q_len)


@pytest.mark.parametrize("knob,value,error", [
    ("attention_impl", "ring", NotImplementedError),
    ("attention_impl", "bogus", ValueError),
    ("pos_embedding", "sinusoidal", ValueError),
    ("activation", "swish", ValueError),
    ("remat_policy", "everything", ValueError),
    ("attention_layers", ("global", "sparse"), ValueError),
])
def test_fields_off_their_accepted_values_raise(knob, value, error):
    with pytest.raises(error):
        tt.TransformerConfig(**{knob: value})


@pytest.mark.parametrize("n_heads", [4, 6, 12, 71])
def test_alibi_slopes_and_bias_match_jax(n_heads):
    np.testing.assert_array_equal(tt.alibi_slopes(n_heads),
                                  jt.alibi_slopes(n_heads))
    np.testing.assert_array_equal(tt.alibi_bias(n_heads, 9).numpy(),
                                  np.asarray(jt.alibi_bias(n_heads, 9)))


def test_bridge_round_trips_generic_trees():
    for over, mlm in ((CASES["gpt_neo_mixed_layers"], False),
                      (CASES["no_positions_unscanned"], False), ({}, True)):
        _, tm, params = _models(over, mlm=mlm)
        back = torch_to_flax(tm.state_dict(), tm.config)
        flat = jax.tree_util.tree_leaves_with_path(params)
        want = {jax.tree_util.keystr(p): a for p, a in flat}
        got = {jax.tree_util.keystr(p): a for p, a in
               jax.tree_util.tree_leaves_with_path(back)}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_init_params_follow_the_jax_init():
    cfg = tt.TransformerConfig(**dict(BASE, initializer_range=0.02,
                                      adjust_init_range=True,
                                      num_hidden_layers=8, hidden_size=256,
                                      intermediate_size=512))
    sd = tt.TransformerLMHeadModel(cfg).init_params(seed=3)
    q = sd["model.layers.0.attn.q_proj.weight"]
    o = sd["model.layers.0.attn.o_proj.weight"]
    assert 0.018 < float(q.std()) < 0.022
    assert 0.018 / 4 < float(o.std()) < 0.022 / 4      # / sqrt(2 * 8)
    assert float(sd["model.layers.0.ln_attn.weight"].min()) == 1.0
    assert float(sd["model.layers.0.attn.q_proj.bias"].abs().max()) == 0.0
