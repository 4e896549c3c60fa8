"""One packed mixed step of the PyTorch port's Llama against the JAX model.

The flax params of ``LlamaConfig.tiny`` go through the weight bridge
(``checkpoint/from_flax.py``); both models then run one packed ragged
step (a decode row, mid-prompt chunk rows, an idle row, padding) over the
same random pool and descriptors. Logits at the packed tokens and the
whole updated pool must agree at ``1e-4`` in fp32: the two differ only by
summation order in matmuls and softmax (~1e-6 relative per op, a few
dozen ops deep). Cases: GQA (2 kv heads), a sliding window, and the
per-family knobs (q/k/v bias, tied embeddings, unscanned layers, gelu,
embedding scale, head_dim override).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.layers import paged_cache_index as jax_index
from deepspeed_tpu_torch import init_inference
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models.layers import paged_cache_index

CASES = {
    "gqa": {},
    "sliding_window": {"sliding_window": 4},
    "family_knobs": {"attention_qkv_bias": True, "tie_word_embeddings": True,
                     "mlp_activation": "gelu_tanh", "embed_scale": 8.0,
                     "head_dim_override": 24},
}


def _packed_step(cfg, seed, N=20, bs=8, nb=4):
    """Random pool + one packed batch: row 0 decodes at position 13, row 1
    is a chunk at 8..13, row 2 is idle, row 3 a chunk at 0..4; the packed
    axis ends in 3 padding tokens."""
    rs = np.random.RandomState(seed)
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    pool = {n: rs.randn(L, N, Hkv, bs, D).astype(np.float32)
            for n in ("k", "v")}
    bt = np.full((4, nb), N, np.int32)
    bt[0, :2], bt[1, :2], bt[3, :1] = [4, 9], [2, 17], [11]
    segs = {0: (13, 1), 1: (8, 6), 3: (0, 5)}     # row: (start, n)
    T = 1 + 6 + 5 + 3
    ids = np.zeros((1, T), np.int32)
    pos = np.full((1, T), -1, np.int32)
    trow = np.full((1, T), -1, np.int32)
    qs, ql, cs, cl = (np.zeros(4, np.int32) for _ in range(4))
    cursor = 0
    for r, (start, n) in segs.items():
        ids[0, cursor:cursor + n] = rs.randint(1, cfg.vocab_size, n)
        pos[0, cursor:cursor + n] = np.arange(start, start + n)
        trow[0, cursor:cursor + n] = r
        qs[r], ql[r], cs[r], cl[r] = cursor, n, start, start + n
        cursor += n
    desc = (bt, pos, cl)
    kw = dict(chunk_start=cs, token_rows=trow, query_start=qs, query_len=ql)
    return pool, ids, desc, kw, trow[0] >= 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_step_matches_jax(case):
    over = CASES[case]
    jcfg = JaxConfig.tiny(remat=False,
                          scan_layers=case != "family_knobs", **over)
    model = JaxLlama(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(**over)
    pool, ids, desc, kw, claimed = _packed_step(cfg, seed=1)

    want_logits, want_pool = model.apply(
        {"params": params}, jnp.asarray(ids),
        cache={n: jnp.asarray(a) for n, a in pool.items()},
        cache_index=jax_index(*desc, **kw))

    engine = init_inference(LlamaForCausalLM(cfg),
                            params=flax_to_torch_state_dict(
                                jax.device_get(params), cfg),
                            dtype="fp32", device="cpu")
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    with torch.inference_mode():
        logits, out_pool = engine.module(torch.from_numpy(ids).long(),
                                         cache=tpool,
                                         cache_index=paged_cache_index(
                                             *desc, **kw))
    assert out_pool is tpool, "the pool is updated in place"
    np.testing.assert_allclose(logits[0, claimed].numpy(),
                               np.asarray(want_logits)[0, claimed],
                               rtol=1e-4, atol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tpool[n].numpy(), np.asarray(want_pool[n]),
                                   rtol=1e-4, atol=1e-4, err_msg=n)


def test_bridge_maps_every_parameter():
    """The bridge fills the port's state_dict exactly: every key, every
    shape (kernels transposed to Linear's [out, in]). Cases: GQA scanned,
    the family knobs unscanned, and the llama_400m layout (MHA, untied
    head, scanned layers) at narrow width."""
    narrow_400m = dict(hidden_size=64, intermediate_size=176,
                       num_attention_heads=4, num_key_value_heads=4,
                       vocab_size=320, num_hidden_layers=3)
    for make, over, scan in ((JaxConfig.tiny, CASES["family_knobs"], False),
                             (JaxConfig.tiny, {}, True),
                             (JaxConfig.llama_400m, narrow_400m, True)):
        jcfg = make(remat=False, scan_layers=scan, **over)
        params = jax.jit(JaxLlama(jcfg).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        cfg = getattr(LlamaConfig, make.__name__)(**over)
        sd = flax_to_torch_state_dict(jax.device_get(params), cfg)
        want = {k: tuple(v.shape)
                for k, v in LlamaForCausalLM(cfg).state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == want


def _jax_defaults(cls):
    import dataclasses
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_every_jax_llama_config_field_is_accepted_at_its_jax_default():
    """Each field of the JAX ``LlamaConfig``, at its JAX default, builds the
    port's config (alone and all together); the port's defaults are the
    JAX ones; ``dataclasses.replace`` and the weight bridge work on a
    config built with every field, scanned and unscanned."""
    import dataclasses
    defaults = _jax_defaults(JaxConfig)
    assert set(defaults) <= {f.name for f in dataclasses.fields(LlamaConfig)}
    for name, value in defaults.items():
        LlamaConfig(**{name: value})
        assert getattr(LlamaConfig(), name) == value, name
    full = LlamaConfig(**defaults)
    for scan in (True, False):
        over = dict(attention_impl="flash", decode_attention_impl="pallas",
                    flash_block_q=128, flash_block_k=64, scan_layers=scan)
        jcfg = JaxConfig.tiny(remat=False, **over)
        cfg = dataclasses.replace(full, **dataclasses.asdict(
            LlamaConfig.tiny(**over)))
        assert cfg == LlamaConfig.tiny(**over)
        params = jax.jit(JaxLlama(jcfg).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        sd = flax_to_torch_state_dict(jax.device_get(params), cfg)
        assert set(sd) == set(LlamaForCausalLM(cfg).state_dict())


@pytest.mark.parametrize("knob,error", [
    ({"quantized_collectives": True}, NotImplementedError),
    ({"quantized_psum_block": 128}, NotImplementedError),
    ({"attention_impl": "pallas"}, ValueError),
    ({"decode_attention_impl": "flash"}, ValueError),
    ({"flash_block_q": 0}, ValueError),
    ({"flash_block_k": -64}, ValueError),
    ({"scan_layers": "yes"}, ValueError)],
    ids=["quantized_collectives", "psum_block", "attention_impl",
         "decode_impl", "block_q", "block_k", "scan_layers"])
def test_llama_fields_off_their_accepted_values_raise(knob, error):
    """The quantized collectives name the distributed slice (ROADMAP.md
    Queue 1, item 9); values the JAX model would refuse raise ValueError."""
    match = r"ROADMAP.md Queue 1, item 9\)" \
        if error is NotImplementedError else None
    with pytest.raises(error, match=match):
        LlamaConfig.tiny(**knob)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("remat", [False, True])
def test_dense_training_forward_matches_jax(case, remat):
    """The dense path: logits and the shifted-label loss of a [2, 12]
    batch against the JAX model at 1e-4 (fp32), with the blocks run
    directly or through the recompute wrapper."""
    over = CASES[case]
    jcfg = JaxConfig.tiny(remat=False, scan_layers=case != "family_knobs",
                          **over)
    model = JaxLlama(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.RandomState(2).randint(0, jcfg.vocab_size, (2, 12))
    want_logits = model.apply({"params": params}, jnp.asarray(ids))
    want_loss = model.apply({"params": params}, jnp.asarray(ids),
                            labels=jnp.asarray(ids))
    cfg = LlamaConfig.tiny(remat=remat, **over)
    torch_model = LlamaForCausalLM(cfg)
    torch_model.load_state_dict(flax_to_torch_state_dict(
        jax.device_get(params), cfg), assign=True)
    tids = torch.from_numpy(ids)
    loss = torch_model(tids, labels=tids)
    loss.backward()      # through the recompute wrapper when remat
    with torch.no_grad():
        logits = torch_model(tids)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)


def test_model_runs_only_the_packed_paged_step():
    """What the model still refuses: the quantized collectives (item 9);
    the contiguous cache, the packed step and the per-row paged append
    (the two-program engine's) all run, a padded training batch gives a
    finite loss, and the from-empty flash prefill, every remat policy and
    loss chunking are configs the model takes."""
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg)
    engine = init_inference(model, params=model.init_params(seed=0),
                            dtype="fp32", device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.long)
    pool = model.init_paged_cache(4, 8, dtype=torch.float32)
    logits, out = engine.module(ids, cache=pool, cache_index=paged_cache_index(
        np.full((1, 1), 2), np.array([[0, 1, 2, -1]]), np.array([3])))
    assert out is pool and logits.shape == (1, 4, cfg.vocab_size)
    assert pool["k"][:, 2, :, :3].abs().sum() > 0, "appended through the row"
    assert not pool["k"][:, 2, :, 3:].abs().sum(), "the pad is dropped"
    assert not pool["k"][:, [0, 1, 3]].abs().sum()
    pad = torch.tensor([[1, 1, 1, 0]])
    assert torch.isfinite(engine.module(ids, labels=ids, attention_mask=pad))
    assert engine.module(ids).shape == (1, 4, cfg.vocab_size)
    cache = engine.module.init_cache(1, 6, dtype=torch.float32)
    logits, out = engine.module(ids, cache=cache, cache_index=0,
                                attention_mask=torch.ones(1, 6))
    assert out is cache and logits.shape == (1, 4, cfg.vocab_size)
    assert cache["k"][:, :, :, :4].abs().sum() > 0
    assert not cache["k"][:, :, :, 4:].abs().sum(), "appended in place"
    with pytest.raises(ValueError, match="mlp_activation"):
        LlamaConfig.tiny(mlp_activation="relu")
    for knob in ({"quantized_collectives": True},
                 {"quantized_psum_block": 128}):
        with pytest.raises(NotImplementedError, match="Queue 1"):
            LlamaConfig.tiny(**knob)
    assert LlamaConfig.tiny(remat_policy="dots", loss_chunk=64).loss_chunk \
        == 64
    assert LlamaConfig.tiny(
        prefill_flash_from_empty=True).prefill_flash_from_empty
