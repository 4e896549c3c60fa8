"""The port's module injection against HF transformers and the JAX package.

Tiny HF models (2 layers, hidden 64) are built from their config classes
with ``torch.manual_seed`` (nothing is downloaded), their norms and biases
perturbed so that each fold and bias shows. For GPT-2, Llama, Mistral with
a binding sliding window, Qwen2 (tied and untied), Gemma and the generic
families (OPT pre- and post-LN, BLOOM, GPT-NeoX, GPT-J, GPT-Neo with its
local layers, Falcon multi-query and the new architecture, Phi):

- ``match_policy`` picks the same class in both packages (for every one
  of the 13 registered policies);
- ``init_inference(hf_model, device="cpu")`` gives HF's logits at fp32
  1e-5 and those of the JAX ``replace_transformer_layer`` at 1e-4 (the
  generic families) or the JAX injection test's 2e-3, and HF's and the
  JAX engine's greedy tokens;
- BERT (``TransformerForMaskedLM``) gives HF's and the JAX model's MLM
  logits at 1e-4 under a padding mask and token types;
- Phi's refusals and Falcon's fused-QKV splits are the JAX policies';
- Mixtral, whose target stood outside the port until it was ported,
  matches the same policy in both packages and converts to HF's logits
  (its parity with JAX: ``tests/test_torch_mixtral.py``).

HF checkpoint directories (``save_pretrained`` of a tiny Llama, GPT-2 and
one model of each generic family, sharded safetensors and ``.bin``): both
packages' ``load_checkpoint_dir`` and ``init_inference(checkpoint=dir)``
give the same logits and tokens; a bf16 load stays bf16; a directory
without weights raises ``FileNotFoundError`` in both.
"""

import json
import os
from torch_threads import one_torch_thread  # noqa: F401

os.environ.setdefault("USE_TF", "0")   # transformers without TensorFlow

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import transformers  # noqa: E402

import deepspeed_tpu as jds  # noqa: E402
from deepspeed_tpu.module_inject import match_policy as jax_match  # noqa: E402
from deepspeed_tpu.module_inject import \
    replace_transformer_layer as jax_replace  # noqa: E402
from deepspeed_tpu.module_inject.replace_module import \
    load_checkpoint_dir as jax_load_dir  # noqa: E402
from deepspeed_tpu.module_inject.replace_policy import \
    _split_fused_qkv as jax_split  # noqa: E402
import deepspeed_tpu_torch as dt  # noqa: E402
from deepspeed_tpu_torch.module_inject import (  # noqa: E402
    HFLlamaLayerPolicy, generic_policies, load_checkpoint_dir, match_policy,
    replace_transformer_layer, revert_transformer_layer)
from deepspeed_tpu_torch.module_inject.replace_policy import \
    _split_fused_qkv  # noqa: E402
from deepspeed_tpu_torch.models import (GPT2LMHeadModel,  # noqa: E402
                                        LlamaForCausalLM)

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)

#: family -> a factory of its tiny HF model
FAMILIES = {
    "gpt2": lambda: transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)),
    "llama": lambda: transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**SMALL)),
    "mistral_window": lambda: transformers.MistralForCausalLM(
        transformers.MistralConfig(**SMALL, sliding_window=4)),
    "qwen2_untied": lambda: transformers.Qwen2ForCausalLM(
        transformers.Qwen2Config(**SMALL, tie_word_embeddings=False)),
    "qwen2_tied": lambda: transformers.Qwen2ForCausalLM(
        transformers.Qwen2Config(**SMALL, tie_word_embeddings=True)),
    "gemma": lambda: transformers.GemmaForCausalLM(transformers.GemmaConfig(
        **dict(SMALL, num_key_value_heads=1), head_dim=16)),
    # the generic families (models/transformer.py)
    "opt": lambda: transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64, dropout=0.0)),
    "opt350m_post_ln": lambda: transformers.OPTForCausalLM(
        transformers.OPTConfig(
            vocab_size=128, hidden_size=64, ffn_dim=128,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=64, dropout=0.0,
            do_layer_norm_before=False)),
    "bloom": lambda: transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=128, hidden_size=64, n_layer=2, n_head=4,
        hidden_dropout=0.0, attention_dropout=0.0)),
    "gpt_neox": lambda: transformers.GPTNeoXForCausalLM(
        transformers.GPTNeoXConfig(**SMALL, rotary_pct=0.25,
                                   attention_dropout=0.0,
                                   hidden_dropout=0.0)),
    "gptj": lambda: transformers.GPTJForCausalLM(transformers.GPTJConfig(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        rotary_dim=8, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)),
    "gpt_neo": lambda: transformers.GPTNeoForCausalLM(
        transformers.GPTNeoConfig(
            vocab_size=128, max_position_embeddings=64, hidden_size=64,
            num_layers=4, num_heads=4,
            attention_types=[[["global", "local"], 2]], window_size=4,
            resid_dropout=0.0, embed_dropout=0.0, attention_dropout=0.0)),
    "falcon_multi_query": lambda: transformers.FalconForCausalLM(
        transformers.FalconConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, bias=False, parallel_attn=True,
            alibi=False, new_decoder_architecture=False, multi_query=True,
            max_position_embeddings=64, attention_dropout=0.0,
            hidden_dropout=0.0)),
    "falcon_new_arch": lambda: transformers.FalconForCausalLM(
        transformers.FalconConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_kv_heads=2, bias=True,
            new_decoder_architecture=True, max_position_embeddings=64,
            attention_dropout=0.0, hidden_dropout=0.0)),
    "phi": lambda: transformers.PhiForCausalLM(transformers.PhiConfig(
        **SMALL, partial_rotary_factor=0.5, attention_dropout=0.0,
        resid_pdrop=0.0, embd_pdrop=0.0)),
}

#: the encoder family (no generate): BERT with its MLM head
BERT = lambda: transformers.BertForMaskedLM(transformers.BertConfig(  # noqa
    vocab_size=128, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=64,
    type_vocab_size=2, hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0))

#: the JAX policy each family matches
POLICY = {"gpt2": "HFGPT2LayerPolicy", "llama": "HFLlamaLayerPolicy",
          "mistral_window": "HFLlamaLayerPolicy",
          "qwen2_untied": "HFQwen2LayerPolicy",
          "qwen2_tied": "HFQwen2LayerPolicy", "gemma": "HFGemmaLayerPolicy",
          "opt": "HFOPTLayerPolicy", "opt350m_post_ln": "HFOPTLayerPolicy",
          "bloom": "HFBloomLayerPolicy", "gpt_neox": "HFGPTNeoXLayerPolicy",
          "gptj": "HFGPTJLayerPolicy", "gpt_neo": "HFGPTNeoLayerPolicy",
          "falcon_multi_query": "HFFalconLayerPolicy",
          "falcon_new_arch": "HFFalconLayerPolicy",
          "phi": "HFPhiLayerPolicy"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, which only
    contend for the cores with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hf(family, seed=0):
    torch.manual_seed(seed)
    model = (BERT if family == "bert" else FAMILIES[family])().eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            # norms off 1 (Gemma's off 0) and biases off 0
            if name.endswith("bias") or "norm" in name or ".ln_" in name:
                p.add_(0.1 * torch.randn_like(p))
    return model


@pytest.fixture(scope="module")
def hf_models():
    return {family: _hf(family) for family in list(FAMILIES) + ["bert"]}


def _ids(T=8, seed=2):
    return np.random.RandomState(seed).randint(1, 128, (2, T))


def _hf_greedy(hf, ids, new):
    eos = hf.generation_config.eos_token_id
    with torch.no_grad():
        out = hf.generate(torch.tensor(ids), max_new_tokens=new,
                          do_sample=False, pad_token_id=eos,
                          eos_token_id=eos).numpy()[:, ids.shape[1]:]
    # HF stops when every row has ended; the engines fill the rest with EOS
    return np.pad(out, ((0, 0), (0, new - out.shape[1])),
                  constant_values=-1 if eos is None else eos), eos


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_and_greedy_tokens_match_hf_and_jax(hf_models, family):
    hf = hf_models[family]
    assert type(match_policy(hf)).__name__ == \
        type(jax_match(hf)).__name__ == POLICY[family]
    ids = _ids(T=12, seed=1)
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    eng = dt.init_inference(hf, dtype="fp32", device="cpu")
    np.testing.assert_allclose(eng(ids).numpy(), ref, rtol=1e-5, atol=1e-5)
    jmodel, jparams = jax_replace(hf)
    jax_logits = np.asarray(jmodel.apply({"params": jparams},
                                         jnp.asarray(ids)))
    # the generic families at 1e-4 (their parity bar), the others at the JAX
    # injection test's 2e-3
    tol = 1e-4 if type(eng.module).__name__.startswith("Transformer") \
        else 2e-3
    np.testing.assert_allclose(eng(ids).numpy(), jax_logits, rtol=tol,
                               atol=tol)

    ids = _ids()
    want, eos = _hf_greedy(hf, ids, 6)
    got = eng.generate(ids, max_new_tokens=6, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    jeng = jds.init_inference(hf, dtype="fp32", mp_size=1)
    np.testing.assert_array_equal(
        got, np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=6,
                                      eos_token_id=eos)))


def test_conversion_keeps_dtype_and_device_and_folds(hf_models):
    """Torch to torch: a bf16 HF model's tensors stay bf16 (no fp32 copy),
    GPT-2's Conv1D weights are transposed, Gemma's norms hold ``1 + w``
    and a tied head has no tensor."""
    gpt2 = _hf("gpt2").to(torch.bfloat16)
    model, sd = replace_transformer_layer(gpt2)
    assert isinstance(model, GPT2LMHeadModel)
    assert set(sd) == set(model.state_dict())
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    hf_sd = gpt2.state_dict()
    name = "transformer.h.1.mlp.c_fc.weight"
    assert torch.equal(sd[name], hf_sd[name].t())
    assert "lm_head.weight" not in sd
    gemma = hf_models["gemma"]
    model, sd = replace_transformer_layer(gemma)
    assert isinstance(model, LlamaForCausalLM)
    name = "model.layers.0.input_layernorm.weight"
    assert torch.equal(sd[name], 1.0 + gemma.state_dict()[name])
    assert model.config.embed_scale == 8.0 and model.config.head_dim == 16
    qwen, sd = replace_transformer_layer(hf_models["qwen2_tied"])
    assert qwen.config.tie_word_embeddings and "lm_head.weight" not in sd
    assert "model.layers.0.self_attn.q_proj.bias" in sd
    mistral, _ = replace_transformer_layer(hf_models["mistral_window"])
    assert mistral.config.sliding_window == 4


def test_explicit_policy_and_refusals(hf_models):
    """``injection_policy`` as a class or instance; a policy of the wrong
    type, an HF option the port cannot represent, and revert raise."""
    llama = hf_models["llama"]
    ids = _ids()
    base = dt.init_inference(llama, dtype="fp32", device="cpu")(ids)
    for policy in (HFLlamaLayerPolicy, HFLlamaLayerPolicy()):
        eng = dt.init_inference(llama, dtype="fp32", device="cpu",
                                injection_policy=policy,
                                replace_with_kernel_inject=True,
                                replace_method="auto", max_batch_size=4)
        assert torch.equal(eng(ids), base)
    with pytest.raises(TypeError, match="DSPolicy"):
        replace_transformer_layer(llama, policy=object())
    scaled = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        **SMALL, rope_scaling={"rope_type": "linear", "factor": 2.0}))
    with pytest.raises(NotImplementedError, match="RoPE type"):
        replace_transformer_layer(scaled)
    with pytest.raises(NotImplementedError, match="out-of-place"):
        revert_transformer_layer(llama)


UNPORTED = {
    "HFMixtralLayerPolicy": lambda: transformers.MixtralForCausalLM(
        transformers.MixtralConfig(**SMALL, num_local_experts=4,
                                   num_experts_per_tok=2)),
}


@pytest.mark.parametrize("policy", sorted(UNPORTED))
def test_unported_families_match_as_in_jax_and_name_item_10(policy):
    """The family item 10 brought (Mixtral) matches the same policy in
    both packages and now converts: HF's logits at fp32 1e-5."""
    hf = UNPORTED[policy]()
    assert type(match_policy(hf)).__name__ == \
        type(jax_match(hf)).__name__ == policy
    eng = dt.init_inference(hf.eval(), dtype="fp32", device="cpu")
    ids = _ids(T=12, seed=3)
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
    np.testing.assert_allclose(eng.forward(ids).numpy(), ref, rtol=1e-5,
                               atol=1e-5)


def test_bert_mlm_logits_match_hf_and_jax(hf_models):
    hf = hf_models["bert"]
    assert type(match_policy(hf)).__name__ == \
        type(jax_match(hf)).__name__ == "HFBertLayerPolicy"
    ids = _ids(T=12, seed=1)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    types = np.random.RandomState(5).randint(0, 2, ids.shape)
    with torch.no_grad():
        ref = hf(torch.tensor(ids), attention_mask=torch.tensor(mask),
                 token_type_ids=torch.tensor(types)).logits.numpy()
    eng = dt.init_inference(hf, dtype="fp32", device="cpu")
    assert type(eng.module).__name__ == "TransformerForMaskedLM"
    got = eng(ids, attention_mask=torch.tensor(mask),
              token_type_ids=torch.tensor(types)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    jmodel, jparams = jax_replace(hf)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids),
                                   jnp.asarray(mask), jnp.asarray(types)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("over,match", [
    ({"qk_layernorm": True}, "qk_layernorm"),
    ({"tie_word_embeddings": True}, "tied-embedding Phi")])
def test_phi_refusals_match_jax(over, match):
    hf = transformers.PhiForCausalLM(transformers.PhiConfig(**SMALL, **over))
    with pytest.raises(NotImplementedError, match=match):
        dt.init_inference(hf, dtype="fp32", device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        jax_replace(hf)


def test_falcon_layouts_split_as_in_jax():
    """Each fused-QKV layout of Falcon (classic multi-query, classic
    multi-head, the new architecture's groups) splits into the rows the
    JAX policy gives (it returns them transposed, as flax kernels)."""
    from deepspeed_tpu.module_inject.replace_policy import \
        HFFalconLayerPolicy as JaxFalcon
    from deepspeed_tpu_torch.module_inject.replace_policy import \
        HFFalconLayerPolicy
    for kw in (dict(multi_query=True), dict(multi_query=False),
               dict(new_decoder_architecture=True, num_kv_heads=2)):
        hc = transformers.FalconConfig(vocab_size=128, hidden_size=64,
                                       num_hidden_layers=2,
                                       num_attention_heads=4, **kw)
        cfg = HFFalconLayerPolicy.convert_config(hc)
        jcfg = JaxFalcon.convert_config(hc, True)
        rows = (cfg.num_attention_heads + 2 * cfg.kv_heads) * cfg.head_dim
        w = np.random.RandomState(0).randn(rows, 64).astype(np.float32)
        got = HFFalconLayerPolicy._split_falcon_qkv(torch.from_numpy(w), hc,
                                                    cfg)
        want = JaxFalcon._split_falcon_qkv(w, hc, jcfg)
        for g, wv in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def test_the_registry_keeps_the_jax_order():
    from deepspeed_tpu.module_inject import generic_policies as jax_policies

    assert [p.__name__ for p in generic_policies] == \
        [p.__name__ for p in jax_policies]
    assert [p.hf_model_types for p in generic_policies] == \
        [p.hf_model_types for p in jax_policies]


@pytest.mark.parametrize("interleaved", [True, False])
def test_split_fused_qkv_matches_jax(interleaved):
    rs = np.random.RandomState(3)
    w = rs.randn(3 * 4 * 8, 32).astype(np.float32)
    b = rs.randn(3 * 4 * 8).astype(np.float32)
    (ks, bs) = _split_fused_qkv(torch.from_numpy(w), torch.from_numpy(b), 4,
                                8, interleaved=interleaved)
    (jks, jbs) = jax_split(w, b, 4, 8, interleaved=interleaved)
    for got, want in zip(ks + bs, list(jks) + list(jbs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


DIRS = {
    # name: (family, save_pretrained kwargs)
    "llama_sharded_safetensors": ("llama", dict(max_shard_size="60KB")),
    "llama_bin": ("llama", dict(safe_serialization=False)),
    "gpt2_sharded_bin": ("gpt2", dict(max_shard_size="60KB",
                                      safe_serialization=False)),
    "gpt2_safetensors": ("gpt2", {}),
    "opt_sharded_safetensors": ("opt", dict(max_shard_size="60KB")),
    "bloom_bin": ("bloom", dict(safe_serialization=False)),
    "gpt_neox_sharded_safetensors": ("gpt_neox",
                                     dict(max_shard_size="60KB")),
    "bert_safetensors": ("bert", {}),
    "gptj_sharded_bin": ("gptj", dict(max_shard_size="60KB",
                                      safe_serialization=False)),
    "gpt_neo_safetensors": ("gpt_neo", {}),
    "falcon_new_arch_sharded_safetensors": ("falcon_new_arch",
                                            dict(max_shard_size="60KB")),
    "phi_safetensors": ("phi", {}),
}

#: the port model each family's directory builds
MODEL_OF = {"gpt2": "GPT2LMHeadModel", "llama": "LlamaForCausalLM",
            "bert": "TransformerForMaskedLM"}


@pytest.mark.parametrize("case", sorted(DIRS))
def test_checkpoint_directories_load_as_in_jax(hf_models, case, tmp_path):
    family, save_kw = DIRS[case]
    hf = hf_models[family]
    hf.save_pretrained(tmp_path, **save_kw)
    files = os.listdir(tmp_path)
    if "max_shard_size" in save_kw:
        index = [f for f in files if f.endswith(".index.json")]
        assert index, files
        with open(tmp_path / index[0]) as f:
            assert len(set(json.load(f)["weight_map"].values())) >= 3
    model, sd = load_checkpoint_dir(str(tmp_path))
    assert type(model).__name__ == MODEL_OF.get(family,
                                                "TransformerLMHeadModel")
    jmodel, jparams = jax_load_dir(str(tmp_path))
    ids = _ids(T=10, seed=3)
    eng = dt.init_inference(checkpoint=str(tmp_path), dtype="fp32",
                            device="cpu")
    got = eng(ids).numpy()
    with torch.no_grad():
        np.testing.assert_allclose(got, hf(torch.tensor(ids)).logits.numpy(),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids))),
        rtol=2e-3, atol=2e-3)
    if family != "bert":
        ids = _ids(T=6, seed=4)
        want, eos = _hf_greedy(hf, ids, 4)
        np.testing.assert_array_equal(
            eng.generate(ids, max_new_tokens=4, eos_token_id=eos).numpy(),
            want)
    # a bf16 load casts each tensor as it is read
    _, sd16 = load_checkpoint_dir(str(tmp_path), dtype=torch.bfloat16,
                                  device="cpu")
    assert set(sd16) == set(sd)
    assert all(t.dtype == torch.bfloat16 for t in sd16.values())


def test_a_directory_without_weights_raises_in_both(hf_models, tmp_path):
    hf_models["llama"].config.save_pretrained(tmp_path)
    with pytest.raises(FileNotFoundError, match="no model weights"):
        load_checkpoint_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no model weights"):
        dt.init_inference(checkpoint=str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError, match="no model weights"):
        jax_load_dir(str(tmp_path))


def test_no_fallback_without_a_card_or_transformers(hf_models, tmp_path,
                                                    monkeypatch):
    """Without a card the entry points raise unless the caller asks for
    the CPU, for an HF model and an HF directory alike; a directory read
    without ``transformers`` raises ImportError."""
    import sys

    hf_models["gpt2"].save_pretrained(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.init_inference(hf_models["gpt2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.init_inference(checkpoint=str(tmp_path))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        dt.init_inference(checkpoint=str(tmp_path), device="cpu")
