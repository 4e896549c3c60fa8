"""The PyTorch port's ServingEngine against the JAX ServingEngine.

Same seeded traffic, same weights (through the weight bridge), fp32 and
greedy sampling, the unified mixed step on both sides: every request's
tokens, terminal state and finish reason must be identical, and the
port must end with zero pages in use and a consistent pool. One case
feeds multi-chunk prompts, the other a pool small enough to force
preemption. The rest checks the port's serving surface on the CPU:
admission control, cancel, drain, and the knobs later slices bring.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.inference.serving import (BlockPool, BlockPoolError,
                                                   RejectedError)
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models import llama as llama_mod
from deepspeed_tpu_torch.ops.ragged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)

SETTINGS = dict(max_batch_size=4, block_size=8, num_blocks=48,
                max_model_len=64, prefill_chunk_tokens=8,
                prefill_token_budget=16)


@pytest.fixture(scope="module")
def engines():
    jcfg = JaxConfig.tiny(remat=False)
    model = JaxLlama(jcfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    jeng = jds.init_inference(model, params=params, dtype="fp32")
    cfg = LlamaConfig.tiny()
    teng = dt.init_inference(
        LlamaForCausalLM(cfg),
        params=flax_to_torch_state_dict(jax.device_get(params), cfg),
        dtype="fp32", device="cpu")
    return jeng, teng


def _serve(srv, prompts, new):
    rids = [srv.submit(p, max_new_tokens=n) for p, n in zip(prompts, new)]
    res = srv.run()
    return [(res[r].state, res[r].finish_reason, res[r].tokens)
            for r in rids]


TRAFFIC = {
    # prompts of 2..5 chunks next to short ones, more requests than slots
    "multi_chunk": dict(lens=(3, 18, 11, 33, 7, 40, 25), new=(5, 9, 4, 7, 6,
                                                              8, 5),
                        over={}),
    # 10 pages for 4 slots of up to 6 pages each: decoders must preempt
    "preemption": dict(lens=(17, 21, 14, 19), new=(12, 12, 12, 12),
                       over={"num_blocks": 10}),
}


@pytest.mark.parametrize("case", sorted(TRAFFIC))
def test_tokens_identical_to_jax_engine(engines, case):
    jeng, teng = engines
    spec = TRAFFIC[case]
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, 256, n) for n in spec["lens"]]
    kw = dict(SETTINGS, **spec["over"])
    jsrv = JaxServingEngine(jeng, JaxServingConfig(**kw))
    tsrv = dt.ServingEngine(teng, dt.ServingConfig(**kw))
    want = _serve(jsrv, prompts, spec["new"])
    got = _serve(tsrv, prompts, spec["new"])
    assert got == want
    assert all(state == "finished" for state, _, _ in got)
    tsrv.block_pool.check_consistent()
    assert tsrv.block_pool.used_count == 0, "leaked pages"
    assert tsrv.metrics.preemptions == jsrv.metrics.preemptions
    if case == "preemption":
        assert tsrv.metrics.preemptions > 0, "pool sized to force preemption"
    assert tsrv.compile_counts == {"mixed_step": 1}


def test_kernel_path_serves_the_same_tokens_on_cpu(engines, monkeypatch):
    """The model attends through the kernel wrapper, once per layer per
    packed step, and the wrapper takes the plain version for CPU tensors:
    same tokens as a model wired straight to the plain version."""
    _, teng = engines
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 256, n) for n in (9, 30, 4)]

    def serve():
        srv = dt.ServingEngine(teng, dt.ServingConfig(**SETTINGS, trace=True))
        out = _serve(srv, prompts, (6, 6, 6))
        steps = sum(e["name"] == "mixed_step" for e in srv.tracer.events())
        return out, steps

    calls = []

    def spy(*args, **kw):
        calls.append(args[0].device)
        return ragged_paged_attention(*args, **kw)

    monkeypatch.setattr(llama_mod, "ragged_paged_attention", spy)
    via_wrapper, steps = serve()
    assert len(calls) == teng.module.config.num_hidden_layers * steps > 0
    assert {d.type for d in calls} == {"cpu"}
    monkeypatch.setattr(llama_mod, "ragged_paged_attention",
                        ragged_paged_attention_plain)
    plain, _ = serve()
    assert via_wrapper == plain


def test_int8_pool_serves_and_frees_everything(engines):
    _, teng = engines
    ieng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()),
                             params=teng.module.state_dict(), dtype="fp32",
                             device="cpu", kv_cache_int8=True)
    srv = dt.ServingEngine(ieng, dt.ServingConfig(**SETTINGS))
    assert srv.pool["k"].dtype == torch.int8
    rs = np.random.RandomState(5)
    out = _serve(srv, [rs.randint(1, 256, n) for n in (12, 20)], (5, 5))
    assert all(s == "finished" and len(t) == 5 for s, _, t in out)
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0


def test_block_pool_rejects_double_foreign_and_excess():
    pool = BlockPool(4, 8)
    a = pool.allocate(3, "a")
    with pytest.raises(BlockPoolError, match="exhausted"):
        pool.allocate(2, "b")
    with pytest.raises(BlockPoolError, match="owned by"):
        pool.free(a[:1], "b")
    with pytest.raises(BlockPoolError, match="double free"):
        pool.free([a[0], a[0]], "a")
    assert pool.used_count == 3, "a refused free mutates nothing"
    pool.free(a, "a")
    pool.check_consistent()
    assert pool.used_count == 0 and pool.free_count == 4
    pool._free.pop()
    with pytest.raises(BlockPoolError, match="leaked"):
        pool.check_consistent()


def test_admission_control_cancel_and_drain(engines):
    _, teng = engines
    srv = dt.ServingEngine(teng, dt.ServingConfig(**dict(
        SETTINGS, max_queue_depth=2)))
    rs = np.random.RandomState(9)
    a = srv.submit(rs.randint(1, 256, 20), max_new_tokens=20)
    b = srv.submit(rs.randint(1, 256, 5), max_new_tokens=3)
    assert srv.try_submit(rs.randint(1, 256, 5)) is None  # queue full
    # a higher-priority newcomer displaces the lowest-priority queued one
    c = srv.submit(rs.randint(1, 256, 5), max_new_tokens=3, priority=1)
    assert srv.poll(b).state == "cancelled"
    srv.step()
    assert srv.cancel(a) and not srv.cancel(a)
    outs = srv.drain()
    assert outs[c].state == "finished" and outs[a].state == "cancelled"
    with pytest.raises(RejectedError):
        srv.submit([1, 2, 3])
    srv.resume_admission()
    d = srv.submit([1, 2, 3], max_new_tokens=2)
    assert list(srv.stream(d)) == srv.poll(d).tokens
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0
    with pytest.raises(ValueError, match="max_model_len"):
        srv.submit(list(range(60)), max_new_tokens=10)


@pytest.mark.parametrize("knob", [
    {"mixed_step": False}, {"mixed_step_buckets": True},
    {"prefix_cache": True}, {"spec_tokens": 2}, {"host_cache_blocks": 8},
    {"step_watchdog_s": 1.0}])
def test_knobs_of_later_slices_raise(knob):
    with pytest.raises(NotImplementedError, match="slice of the port"):
        dt.ServingConfig(**knob)


@pytest.mark.parametrize("knob", [
    {"mp_size": 2}, {"quantize": True}, {"dtype": "int8"},
    {"quantize_weights": "int8"}, {"quantized_collectives": True},
    {"checkpoint": "/nonexistent"}])
def test_inference_knobs_of_later_slices_raise(knob):
    model = LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(NotImplementedError, match="slice of the port"):
        dt.init_inference(model, params=model.init_params(), device="cpu",
                          **knob)
