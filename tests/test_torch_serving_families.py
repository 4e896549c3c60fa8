"""Gemma- and Qwen2-shaped models served by the port's engines against the
JAX ServingEngine.

Two narrow 2-layer configurations carry the deltas of the families the
port's paged kernels now take on the card: a Gemma-shaped one (head dim 256
through ``head_dim_override``, so query heads x head dim is not the hidden
width; a GQA group of 2; the tanh GELU MLP; embeddings scaled by
sqrt(hidden) and tied to the LM head) and a Qwen2-shaped one (a group of 7
and biases on q/k/v, rope_theta 1e6). Each is served by both packages on
the same flax parameters (``flax_to_torch_state_dict``), fp32 and greedy,
through the unified step and the two-program engine, with the prefix cache
on and pages of 8 and of 32 tokens (neither is the kernels' earlier 16):
a seed request, then requests sharing its prefix, then a multi-turn
replay. Tokens, finish reasons and prefix hits must be identical, and
both engines must end with no page in use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu as jds
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from torch_threads import one_torch_thread  # noqa: F401

FAMILIES = {
    # Gemma: 4 heads of 256 on 2 kv heads over a hidden width of 64,
    # GeGLU (tanh), sqrt(hidden)-scaled tied embeddings
    "gemma": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, head_dim_override=256,
                  mlp_activation="gelu_tanh", embed_scale=64 ** 0.5,
                  tie_word_embeddings=True, max_position_embeddings=128,
                  rms_norm_eps=1e-6, remat=False),
    # Qwen2: 14 heads of 16 on 2 kv heads (a group of 7), q/k/v biases
    "qwen2": dict(vocab_size=256, hidden_size=224, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=14,
                  num_key_value_heads=2, attention_qkv_bias=True,
                  rope_theta=1e6, max_position_embeddings=128,
                  rms_norm_eps=1e-6, remat=False),
}
PREFIX = 40     # shared prompt tokens: a full page of 32, five of 8


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    """(name, the JAX and the port inference engine on the same
    weights)."""
    over = FAMILIES[request.param]
    jmodel = JaxLlama(JaxConfig(**over))
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    jeng = jds.init_inference(jmodel, params=params, dtype="fp32")
    cfg = LlamaConfig(**over)
    teng = dt.init_inference(
        LlamaForCausalLM(cfg), params=flax_to_torch_state_dict(params, cfg),
        dtype="fp32", device="cpu")
    return request.param, jeng, teng


def _phases(rs):
    """A seed request, then four sharing its PREFIX-token prefix (one the
    identical prompt)."""
    prefix = list(rs.randint(1, 256, PREFIX))
    seed = prefix + list(rs.randint(1, 256, 5))
    batch = [(prefix + list(rs.randint(1, 256, n)), 6) for n in (3, 9, 17)]
    return seed, [[(seed, 7)], batch + [(seed, 4)]]


def _serve(srv, phases):
    out = []
    for phase in phases:
        rids = [srv.submit(p, max_new_tokens=n) for p, n in phase]
        res = srv.run()
        out += [(res[r].state, res[r].finish_reason, res[r].tokens)
                for r in rids]
    return out


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["unified", "two_program"])
@pytest.mark.parametrize("block_size", [8, 32])
def test_family_serves_the_jax_engines_tokens(family, block_size, mixed):
    """The port's engine and the JAX engine of the same kind, prefix cache
    on, pages of ``block_size``: identical tokens, finish reasons and
    prefix hits (the replay of the seed's prompt plus its answer hits the
    pages its decode filled), and no page left in use."""
    name, jeng, teng = family
    kw = dict(max_batch_size=4, block_size=block_size,
              num_blocks=512 // block_size, max_model_len=128,
              mixed_step=mixed, prefix_cache=True, prefill_chunk_tokens=16,
              prefill_token_budget=32)
    jsrv = JaxServingEngine(jeng, JaxServingConfig(**kw))
    tsrv = dt.ServingEngine(teng, dt.ServingConfig(**kw))
    rs = np.random.RandomState(17)
    seed, phases = _phases(rs)
    want = _serve(jsrv, phases)
    got = _serve(tsrv, phases)
    turn = [[(seed + got[0][2] + list(rs.randint(1, 256, 3)), 4)]]
    want += _serve(jsrv, turn)
    got += _serve(tsrv, turn)
    assert got == want, name
    assert all(state == "finished" for state, _, _ in got)
    jm, tm = jsrv.metrics, tsrv.metrics
    assert (tm.prefix_hits, tm.cached_prefill_tokens) == \
        (jm.prefix_hits, jm.cached_prefill_tokens)
    assert tm.prefix_hits >= 4
    for srv in (jsrv, tsrv):
        srv.block_pool.check_consistent()
        assert srv.block_pool.used_count == 0, "leaked pages"
    if not mixed:
        assert tsrv.prefill_chunk_calls > 0 and tsrv.decode_calls > 0
