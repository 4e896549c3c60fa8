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
    shape (kernels transposed to Linear's [out, in])."""
    for over, scan in ((CASES["family_knobs"], False), ({}, True)):
        jcfg = JaxConfig.tiny(remat=False, scan_layers=scan, **over)
        params = jax.jit(JaxLlama(jcfg).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
        cfg = LlamaConfig.tiny(**over)
        sd = flax_to_torch_state_dict(jax.device_get(params), cfg)
        want = {k: tuple(v.shape)
                for k, v in LlamaForCausalLM(cfg).state_dict().items()}
        assert {k: tuple(v.shape) for k, v in sd.items()} == want


def test_model_runs_only_the_packed_paged_step():
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg)
    engine = init_inference(model, params=model.init_params(seed=0),
                            dtype="fp32", device="cpu")
    with pytest.raises(NotImplementedError, match="packed paged mixed step"):
        engine.module(torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="mlp_activation"):
        LlamaConfig.tiny(mlp_activation="relu")
