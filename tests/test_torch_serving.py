"""The PyTorch port's ServingEngine against the JAX ServingEngine.

Same seeded traffic, same weights (through the weight bridge), fp32 and
greedy sampling, the unified mixed step on both sides: every request's
tokens, terminal state and finish reason must be identical, and the
port must end with zero pages in use and a consistent pool. One case
feeds multi-chunk prompts, the other a pool small enough to force
preemption. Bucketed packed widths (``mixed_step_buckets``) and the
static-buffer step that ``enable_cuda_graph`` captures on a CUDA device
(uncaptured here) serve the JAX engine's tokens too. The rest checks the
port's serving surface on the CPU: admission control, cancel, drain, and
the knobs later slices bring.
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


#: mixed_step_buckets traffic (tests/unit/serving/test_speculative.py's
#: bucketed case): prompts of 1-5 chunks then a decode-only tail; with the
#: prefix cache, with a pool small enough to preempt, with an int8 pool
BUCKETS = dict(lens=(40, 6, 9, 12), new=(8, 24, 20, 16),
               settings=dict(max_batch_size=4, block_size=8, num_blocks=64,
                             max_model_len=128, prefill_chunk_tokens=8,
                             prefill_token_budget=16))
BUCKET_CASES = {"prefix_cache": ({"prefix_cache": True}, {}),
                "preemption": ({"num_blocks": 12}, {}),
                "int8_pool": ({"prefix_cache": True},
                              {"kv_cache_int8": True})}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_bucketed_widths_serve_the_jax_tokens(engines, case):
    """mixed_step_buckets: the port serves the JAX engine's tokens, finish
    reasons and preemptions with the same flag, and its own default
    engine's, over the same widths (4, 8, 16, 19 at 4 slots and a budget
    of 16);
    compile_counts["mixed_step"] counts the widths run, within the set,
    and the decode-only tail runs the narrowest; with enable_cuda_graph
    (the static buffers, uncaptured on the CPU) the tokens stay the same.
    No page leaks."""
    jeng, teng = engines
    over, engine_kw = BUCKET_CASES[case]
    if engine_kw:
        jeng = jds.init_inference(jeng.module, params=jeng.params,
                                  dtype="fp32", **engine_kw)
    sd = teng.module.state_dict()
    rs = np.random.RandomState(41)
    prompts = [rs.randint(1, 256, n) for n in BUCKETS["lens"]]
    kw = dict(BUCKETS["settings"], **over)
    jsrv = JaxServingEngine(jeng, JaxServingConfig(mixed_step_buckets=True,
                                                   **kw))
    want = _serve(jsrv, prompts, BUCKETS["new"])
    runs = {}
    for name, graphed, buckets in (("default", False, False),
                                   ("buckets", False, True),
                                   ("graph_buckets", True, True)):
        eng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()),
                                params=sd, dtype="fp32", device="cpu",
                                enable_cuda_graph=graphed, **engine_kw)
        srv = dt.ServingEngine(eng, dt.ServingConfig(
            mixed_step_buckets=buckets, trace=True, **kw))
        runs[name] = srv, _serve(srv, prompts, BUCKETS["new"])
        srv.block_pool.check_consistent()
        assert srv.block_pool.used_count == 0, (name, "leaked pages")
        assert srv.metrics.preemptions == jsrv.metrics.preemptions, name
    assert runs["default"][1] == want
    for name in ("buckets", "graph_buckets"):
        srv, got = runs[name]
        assert got == want, name
        widths = srv.mixed_step_widths
        assert widths == jsrv.mixed_step_widths == [4, 8, 16, 19]
        assert srv.mixed_step_tokens == jsrv.mixed_step_tokens == 19
        run = [e["args"]["width"] for e in srv.tracer.events()
               if e["name"] == "mixed_step"]
        assert srv.compile_counts["mixed_step"] == len(set(run)) \
            <= len(widths)
        assert set(run) <= set(widths) and run[-1] == widths[0]
    if case == "preemption":
        assert jsrv.metrics.preemptions > 0, "pool sized to force preemption"
    assert runs["default"][0].mixed_step_widths == [19]


@pytest.mark.parametrize("case", sorted(TRAFFIC))
def test_static_step_serves_the_jax_tokens(engines, case):
    """enable_cuda_graph without buckets: the unified step over static
    buffers (one host-to-device copy of the packed arrays, one read of
    the tokens and flags), uncaptured on the CPU, serves the JAX engine's
    tokens at the full width."""
    jeng, teng = engines
    spec = TRAFFIC[case]
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, 256, n) for n in spec["lens"]]
    kw = dict(SETTINGS, **spec["over"])
    want = _serve(JaxServingEngine(jeng, JaxServingConfig(**kw)), prompts,
                  spec["new"])
    eng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()),
                            params=teng.module.state_dict(), dtype="fp32",
                            device="cpu", enable_cuda_graph=True)
    srv = dt.ServingEngine(eng, dt.ServingConfig(**kw))
    assert _serve(srv, prompts, spec["new"]) == want
    assert srv.compile_counts == {"mixed_step": 1}
    assert srv.block_pool.used_count == 0


def test_mixed_step_buckets_and_graphs_need_the_unified_step(engines):
    """As in the JAX engine, mixed_step_buckets without mixed_step raises
    ValueError; enable_cuda_graph on the two-program engine builds and
    serves (its forwards run over static buffers; nothing is captured on
    the CPU), the same tokens as without it."""
    _, teng = engines
    with pytest.raises(ValueError, match="mixed_step=True"):
        dt.ServingEngine(teng, dt.ServingConfig(mixed_step=False,
                                                mixed_step_buckets=True))
    eng = dt.init_inference(LlamaForCausalLM(LlamaConfig.tiny()),
                            params=teng.module.state_dict(), dtype="fp32",
                            device="cpu", enable_cuda_graph=True)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(1, 256, n) for n in (9, 30, 4)]
    outs = [_serve(dt.ServingEngine(e, dt.ServingConfig(
        mixed_step=False, **SETTINGS)), prompts, (5, 5, 5))
        for e in (eng, teng)]
    assert outs[0] == outs[1]
    assert all(len(tokens) == 5 for _, _, tokens in outs[0])


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
    {"spec_tokens": 2}, {"host_cache_blocks": 8}])
def test_knobs_of_later_slices_raise(knob):
    with pytest.raises(NotImplementedError, match="slice of the port"):
        dt.ServingConfig(**knob)


def _jax_defaults(cls):
    import dataclasses
    return {f.name: f.default if f.default is not dataclasses.MISSING
            else f.default_factory() for f in dataclasses.fields(cls)}


def test_every_jax_config_field_is_accepted_at_its_jax_default():
    """Each field of the JAX DeepSpeedInferenceConfig and ServingConfig, at
    its JAX default, builds the port's config (alone and all together),
    and DeepSpeed's usual init_inference(..., replace_with_kernel_inject=
    True) runs."""
    from deepspeed_tpu.inference.config import \
        DeepSpeedInferenceConfig as JaxInferenceConfig
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig

    for jcls, cls in ((JaxInferenceConfig, DeepSpeedInferenceConfig),
                      (JaxServingConfig, dt.ServingConfig)):
        defaults = _jax_defaults(jcls)
        for name, value in defaults.items():
            cls(**{name: value})
        cls(**defaults)
    model = LlamaForCausalLM(LlamaConfig.tiny())
    params = model.init_params()
    for inject in (True, False):
        eng = dt.init_inference(model, params=params, device="cpu",
                                dtype="fp32",
                                replace_with_kernel_inject=inject)
        assert eng.config.replace_with_kernel_inject is inject
    srv = dt.init_serving(model, params=params, device="cpu", dtype="fp32",
                          replace_with_kernel_inject=True,
                          serving_config=dt.ServingConfig(
                              **_jax_defaults(JaxServingConfig)))
    rid = srv.submit([1, 2, 3], max_new_tokens=2)
    assert len(srv.run()[rid].tokens) == 2


@pytest.mark.parametrize("knob,item", [
    ({"ep_size": 2}, "10"), ({"injection_policy": object()}, "4"),
    ({"replace_method": "layer"}, "4"), ({"max_batch_size": 16}, "4"),
    ({"quantize_groups": 64}, "2c"), ({"quantized_psum_block": 128}, "9"),
    ({"allow_unsafe_tp": True}, "9")])
def test_inference_fields_off_their_no_op_values_name_their_item(knob, item):
    model = LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP.md Queue 1, item {item}\)"):
        dt.init_inference(model, params=model.init_params(), device="cpu",
                          **knob)


@pytest.mark.parametrize("knob,item", [
    ({"spec_ngram": 4}, "2c"),
    ({"drafter": object()}, "2c"), ({"host_cache_bytes": 1 << 20}, "2c"),
    ({"sync_promote": True}, "2c")])
def test_serving_fields_off_their_jax_defaults_name_their_item(knob, item):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP.md Queue 1, item {item}\)"):
        dt.ServingConfig(**knob)


def test_monitor_receives_the_serving_counters(engines):
    """init_serving's monitor= gets metrics.to_events(step) every
    monitor_every steps, as in the JAX engine."""
    class Monitor:
        def __init__(self):
            self.steps = []

        def write_events(self, events):
            self.steps.append(events[0][2])
            assert any(e[0] == "serving/steps" for e in events)

    _, teng = engines
    mon = Monitor()
    srv = dt.ServingEngine(teng, dt.ServingConfig(monitor_every=2, **SETTINGS),
                           monitor=mon)
    srv.submit([1, 2, 3], max_new_tokens=5)
    srv.run()
    assert mon.steps and all(s % 2 == 0 for s in mon.steps)
    assert len(mon.steps) == srv.metrics.steps // 2


@pytest.mark.parametrize("knob", [
    {"mp_size": 2}, {"quantize": True}, {"dtype": "int8"},
    {"dequant_per_step": True}, {"quantized_collectives": True},
    {"checkpoint": "/nonexistent"}])
def test_inference_knobs_of_later_slices_raise(knob):
    model = LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(NotImplementedError, match="slice of the port"):
        dt.init_inference(model, params=model.init_params(), device="cpu",
                          **knob)
