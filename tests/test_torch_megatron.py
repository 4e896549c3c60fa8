"""Megatron-LM checkpoints (``MegatronLayerPolicy``) in the port against
the JAX package.

The cases of ``tests/unit/test_megatron_policy.py`` run on both packages
on one synthetic state dict (numpy-seeded, the JAX test's
``_megatron_sd``): the config inferred from the shapes is the JAX config
field for field; both QKV layouts (version 0 contiguous, 2.0
head-interleaved) convert to logits within 1e-5 of JAX's (fp32) and
recover the original q kernel;
the ``encoder`` names convert; two TP shards written as ``mp_rank_0{0,1}``
files load through ``from_megatron_checkpoint`` to the unsharded state
dict's logits (and JAX's from the same files); a state dict without
Megatron layers raises ``KeyError`` in both; and greedy ``generate`` on
the converted model gives the JAX engine's tokens.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.checkpoint.reshape import \
    split_state_dict as jax_split_state_dict
from deepspeed_tpu.module_inject.replace_policy import \
    MegatronLayerPolicy as JaxPolicy
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.module_inject import replace_policy
from deepspeed_tpu_torch.module_inject.replace_policy import \
    MegatronLayerPolicy
from tests.unit.test_megatron_policy import (HEADS, INTER, LAYERS, MAXPOS,
                                             VOCAB, _megatron_sd)
from torch_threads import one_torch_thread  # noqa: F401

#: fp32 logits
TOL = 1e-5


def _logits(model, sd, ids):
    model.load_state_dict(sd, strict=True, assign=True)
    with torch.no_grad():
        return model.eval()(torch.tensor(ids)).numpy()


@pytest.mark.parametrize("prefix", ["language_model.transformer.",
                                    "language_model.encoder."])
def test_config_inferred_from_shapes_is_the_jax_config(prefix):
    sd = _megatron_sd(prefix=prefix)
    got = MegatronLayerPolicy.infer_config(sd, HEADS)
    want = JaxPolicy.infer_config(sd, HEADS)
    assert (got.vocab_size, got.hidden_size, got.num_hidden_layers,
            got.intermediate_size, got.max_position_embeddings) == \
        (VOCAB, 32, LAYERS, INTER, MAXPOS)
    shared = {f.name for f in dataclasses.fields(got)} & \
        {f.name for f in dataclasses.fields(want)}
    for name in sorted(shared):
        assert getattr(got, name) == getattr(want, name), name
    assert got.pos_embedding == "learned" and got.tie_word_embeddings
    model, psd = MegatronLayerPolicy.convert_state_dict(HEADS, sd)
    assert model.config.num_hidden_layers == LAYERS
    assert set(psd) == set(model.state_dict())


@pytest.mark.parametrize("version", [0, 2.0])
def test_convert_and_forward_match_jax(version):
    sd = _megatron_sd(qkv_version=version)
    jmodel, jparams = JaxPolicy.convert_state_dict(HEADS, sd,
                                                   qkv_version=version)
    model, psd = MegatronLayerPolicy.convert_state_dict(
        HEADS, sd, qkv_version=version)
    ids = np.arange(10)[None, :] % VOCAB
    got = _logits(model, psd, ids)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    assert got.shape == (1, 10, VOCAB) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the QKV split recovers the original q, whatever the rows' layout
    expected_q = sd["language_model.transformer.layers.0._expected_q"]
    np.testing.assert_array_equal(
        psd["model.layers.0.attn.q_proj.weight"].numpy(), expected_q)


def test_tp_sharded_files_load_as_the_unsharded_state_dict(tmp_path):
    """``mp_rank_00`` / ``mp_rank_01`` files (TP 2, version 2.0) through
    ``from_megatron_checkpoint`` give the unsharded state dict's logits,
    and JAX's from the same files."""
    full = _megatron_sd(seed=3)
    files = []
    for rank in range(2):
        shard = jax_split_state_dict(full, num_ranks=2, rank=rank)
        path = tmp_path / f"mp_rank_{rank:02d}_model_states.npz"
        np.savez(path, **shard)
        files.append(str(path))
    ids = (np.arange(12)[None, :] * 5) % VOCAB
    whole = _logits(*MegatronLayerPolicy.convert_state_dict(HEADS, full),
                    ids)
    sharded = _logits(*MegatronLayerPolicy.from_megatron_checkpoint(
        files, num_attention_heads=HEADS), ids)
    np.testing.assert_allclose(sharded, whole, rtol=TOL, atol=TOL)
    jmodel, jparams = JaxPolicy.from_megatron_checkpoint(
        files, num_attention_heads=HEADS)
    np.testing.assert_allclose(
        sharded, np.asarray(jmodel.apply({"params": jparams},
                                         jnp.asarray(ids))),
        rtol=TOL, atol=TOL)


def test_a_state_dict_without_megatron_layers_raises_in_both():
    for policy in (JaxPolicy, MegatronLayerPolicy):
        with pytest.raises(KeyError, match="Megatron"):
            policy.infer_config({"foo": np.zeros(2)}, HEADS)


def test_megatron_is_called_by_name_only():
    assert MegatronLayerPolicy.hf_model_types == ()
    assert MegatronLayerPolicy not in replace_policy.generic_policies


def test_generate_tokens_identical_to_jax():
    """Greedy tokens of left-padded prompts through both engines, fp32."""
    sd = _megatron_sd(seed=5)
    jmodel, jparams = JaxPolicy.convert_state_dict(HEADS, sd)
    model, psd = MegatronLayerPolicy.convert_state_dict(HEADS, sd)
    rs = np.random.RandomState(1)
    ids = np.zeros((3, 9), np.int32)
    mask = np.zeros((3, 9), np.int32)
    for b, n in enumerate((9, 4, 6)):
        ids[b, 9 - n:] = rs.randint(1, VOCAB, n)
        mask[b, 9 - n:] = 1
    want = np.asarray(jds.init_inference(jmodel, params=jparams,
                                         dtype="fp32").generate(
        jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        max_new_tokens=8))
    got = dt.init_inference(model, params=psd, dtype="fp32",
                            device="cpu").generate(
        ids, attention_mask=mask, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)
