"""The port's performance accounting (``deepspeed_tpu_torch/monitor/perf.py``)
against the JAX package's ``monitor/perf.py``.

Fingerprints, their diffs and the recompile sentinel behave as in
``tests/unit/test_perf_accounting.py``; the hand estimates equal the JAX
ones exactly on the same configs; the peak table holds the H100 and no
TPU; watermarks are absent on the CPU; the serving engines'
``perf_summary()`` has the JAX shape and program names; the training
engine registers ``train_step`` with its gauges; ``generate`` registers
one prefill and one decode program per bucket.
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
from deepspeed_tpu.monitor import perf as jperf
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.monitor import perf
from deepspeed_tpu_torch.monitor.registry import MetricsRegistry
from deepspeed_tpu_torch.monitor.tracing import Tracer


@pytest.fixture(scope="module")
def engines():
    model = JaxLlama(JaxConfig.tiny(remat=False))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    jeng = jds.init_inference(model, params=params, dtype="fp32")
    cfg = LlamaConfig.tiny()
    teng = dt.init_inference(
        LlamaForCausalLM(cfg),
        params=flax_to_torch_state_dict(jax.device_get(params), cfg),
        dtype="fp32", device="cpu")
    return jeng, teng, params


# ---------------------------------------------------------------------------
# fingerprints and the sentinel
# ---------------------------------------------------------------------------

SPEC_CASES = {
    "int32": lambda: np.zeros((4, 2), np.int32),
    "float32": lambda: np.zeros((3,), np.float32),
    "static": lambda: 7,
    "tuple_of_statics": lambda: (False, 1.0),
    "tree": lambda: {"a": [np.zeros((2, 2), np.float32)] * 3,
                     "b": np.zeros((5,), np.int8)},
    "nested_order": lambda: {"z": np.zeros((1,), np.int32),
                             "a": (np.zeros((2,), np.float32), 3)},
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_matches_jax(case):
    x = SPEC_CASES[case]()
    assert perf.spec(x) == jperf.spec(x)


def test_spec_of_tensors_and_modules():
    assert perf.spec(torch.zeros((4, 2), dtype=torch.int32)) == "int32[4,2]"
    assert perf.spec(torch.zeros(3, dtype=torch.bfloat16)) == "bfloat16[3]"
    s = perf.spec({"a": [torch.zeros(2, 2)] * 3,
                   "b": torch.zeros(5, dtype=torch.int8)})
    assert s.startswith("pytree[4:") and "float32[2,2] x3" in s
    m = torch.nn.Linear(4, 3)
    assert perf.spec(m) == perf.spec(dict(m.state_dict()))


def test_fingerprint_diff_matches_jax():
    old = {"x": "f32[2]", "y": "f32[3]", "w": "i8[1]"}
    new = {"x": "f32[2]", "y": "f32[4]", "z": "i32[1]"}
    assert perf.fingerprint_diff(old, new) == jperf.fingerprint_diff(old, new)
    assert set(perf.fingerprint_diff(old, new)) == {"y", "z", "w"}
    assert perf.fingerprint(a=np.zeros((2,), np.int32), b=3) == \
        jperf.fingerprint(a=np.zeros((2,), np.int32), b=3)


def test_sentinel_fires_once_per_change_and_names_offender():
    tracer = Tracer(capacity=64)
    metrics = MetricsRegistry()
    reg = perf.ProgramRegistry(tracer=tracer, metrics=metrics, scope="t")
    fp = perf.fingerprint(tables=np.zeros((8, 16), np.int32),
                          lens=np.zeros((8,), np.int32))
    assert reg.observe_call("decode", fp) is None       # registration
    assert reg.observe_call("decode", dict(fp)) is None  # stable: no alarm
    changed = perf.fingerprint(tables=np.zeros((8, 17), np.int32),
                               lens=np.zeros((8,), np.int32))
    diff = reg.observe_call("decode", changed)
    assert diff == {"tables": ("int32[8,16]", "int32[8,17]")}
    prog = reg.program("decode")
    assert (prog.recompiles, prog.compiles, prog.calls) == (1, 2, 3)
    assert reg.recompile_total == 1
    assert metrics.counter("recompiles", program="decode").value == 1
    evs = [e for e in tracer.events() if e["name"] == "recompile"]
    assert len(evs) == 1
    assert evs[0]["args"]["program"] == "decode"
    assert evs[0]["args"]["args"] == ["tables"]
    assert evs[0]["args"]["changed"]["tables"] == ["int32[8,16]",
                                                  "int32[8,17]"]
    assert reg.observe_call("decode", dict(changed)) is None
    assert reg.observe_call("decode", fp) is not None
    assert reg.program("decode").recompiles == 2


def test_program_table_rows_match_jax():
    rows = {}
    for mod in (perf, jperf):
        reg = mod.ProgramRegistry(scope="s")
        reg.observe_call("p", {"x": "f32[2]"})
        reg.set_cost("p", 123.0, 456.0, "estimate")
        (rows[mod],) = reg.table()
    assert set(rows[perf]) == set(rows[jperf])
    assert rows[perf]["fingerprint"] == rows[jperf]["fingerprint"]
    assert rows[perf]["name"] == "s/p" and rows[perf]["compiles"] == 1


def test_live_program_table_is_weak():
    import gc

    reg = perf.ProgramRegistry(scope="ephemeral")
    reg.observe_call("gone", {"x": "1"})
    assert "ephemeral/gone" in {r["name"] for r in perf.live_program_table()}
    del reg
    gc.collect()
    assert "ephemeral/gone" not in {r["name"]
                                    for r in perf.live_program_table()}


def test_capture_cost_is_an_estimate_latched_once_and_never_raises():
    acc = perf.PerfAccounting(scope="t")
    acc.capture_cost("p", lambda: {"flops": 42.0, "bytes_accessed": 8.0})
    acc.capture_cost("p", lambda: {"flops": 7.0})
    prog = acc.programs.program("p")
    assert (prog.flops, prog.bytes_accessed, prog.cost_source) == \
        (42.0, 8.0, "estimate")

    def boom():
        raise RuntimeError("estimator bug")

    acc.capture_cost("q", boom)
    assert acc.programs.program("q").cost_source is None


def test_utilization_math_with_known_peaks():
    acc = perf.PerfAccounting(scope="t", device_kind="NVIDIA H100 80GB HBM3")
    acc.capture_cost("p", lambda: {"flops": 2e12, "bytes_accessed": 1e9})
    vals = acc.on_program_step("p", dt_s=1e-2, tokens=100)
    assert vals["mfu"] == pytest.approx(2e12 / (1e-2 * 989.4e12))
    assert vals["mbu"] == pytest.approx(1e9 / (1e-2 * 3.35e12))
    assert vals["tokens_per_sec_per_chip"] == pytest.approx(1e4)


# ---------------------------------------------------------------------------
# hand estimates: exactly the JAX package's
# ---------------------------------------------------------------------------

CONFIGS = {"tiny": "tiny", "llama3_8b": "llama3_8b",
           "llama_400m": "llama_400m"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("ctx", [1, 256, 2048])
def test_transformer_estimates_equal_jax(name, ctx):
    cfg = getattr(LlamaConfig, CONFIGS[name])()
    jcfg = getattr(JaxConfig, CONFIGS[name])()
    assert perf.transformer_flops_per_token(cfg, ctx) == \
        jperf.transformer_flops_per_token(jcfg, ctx)
    assert perf.estimate_decode_step_flops(cfg, 8, ctx) == \
        jperf.estimate_decode_step_flops(jcfg, 8, ctx)
    for kv in (1, 2):
        assert perf.estimate_decode_step_bytes(cfg, 8, ctx, 12345, kv) == \
            jperf.estimate_decode_step_bytes(jcfg, 8, ctx, 12345, kv)


def test_param_bytes_equal_jax(engines):
    _, teng, params = engines
    assert perf.param_bytes(teng.module) == jperf.param_bytes(params)


def test_train_step_flops_is_the_bench_formula():
    assert perf.train_step_flops(1000, 8, 1024, 24, 1024) == \
        6.0 * 1000 * 8 * 1024 + 12.0 * 24 * 8 * 1024 * 1024 * 1024


# ---------------------------------------------------------------------------
# peaks, watermarks, meta
# ---------------------------------------------------------------------------

def test_device_peaks_are_the_cards():
    assert perf.device_peaks("NVIDIA H100 80GB HBM3") == (989.4e12, 3.35e12)
    assert perf.device_peaks("cpu") == (None, None)
    assert perf.device_peaks(None) == (None, None)
    assert not any("TPU" in k for k in perf.DEVICE_PEAKS)


def test_memory_watermarks_absent_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the watermarks are real")
    assert perf.device_memory_stats() == []
    assert perf.hbm_watermarks() == (None, None)
    acc = perf.PerfAccounting(scope="t")
    assert acc.memory_watermarks() == (None, None)
    assert acc.device_kind == "cpu" and acc.peak_flops is None


def test_perf_meta_carries_provenance():
    meta = perf.perf_meta()
    for key in ("schema", "git_sha", "torch", "cuda", "host", "platform",
                "device_kind", "device_count", "wall_time"):
        assert key in meta, key
    assert meta["torch"] == torch.__version__
    assert meta["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

SERVE = dict(max_batch_size=4, block_size=8, num_blocks=48, max_model_len=64,
             prefill_chunk_tokens=8, prefill_token_budget=16)


@pytest.mark.parametrize("over", [{}, {"mixed_step_buckets": True},
                                  {"mixed_step": False},
                                  {"mixed_step": False,
                                   "prefill_chunk_tokens": 0}],
                         ids=["unified", "buckets", "chunked", "monolithic"])
def test_serving_perf_summary_has_the_jax_shape(engines, over):
    """The same traffic through both engines: perf_summary() has the JAX
    keys, the same program names with the same call counts, one compile
    each and no recompile; the gauges and the recompile/HBM fields of the
    metrics are filled (the utilization ones are None on the CPU, where
    no peak is known, and set when a peak is given)."""
    jeng, teng, _ = engines
    kw = dict(SERVE, **over)
    jsrv = JaxServingEngine(jeng, JaxServingConfig(**kw))
    tsrv = dt.ServingEngine(teng, dt.ServingConfig(**kw))
    rs = np.random.RandomState(3)
    prompts = [rs.randint(1, 256, n) for n in (5, 19, 11, 30)]
    for srv in (jsrv, tsrv):
        for p in prompts:
            srv.submit(p, max_new_tokens=6)
        srv.run()
    js, ts = jsrv.perf_summary(), tsrv.perf_summary()
    assert set(ts) == set(js)
    assert set(ts["utilization"]) <= {r["name"].split("/")[1]
                                      for r in ts["programs"]}
    jrows = {r["name"]: r for r in js["programs"]}
    trows = {r["name"]: r for r in ts["programs"]}
    assert set(trows) == set(jrows)
    for name, row in trows.items():
        assert set(row) == set(jrows[name])
        assert row["calls"] == jrows[name]["calls"], name
        assert (row["compiles"], row["recompiles"]) == (1, 0), name
        assert row["cost_source"] == "estimate" and row["flops"] > 0
    assert ts["device_kind"] == "cpu" and ts["peak_flops_per_chip"] is None
    m = tsrv.metrics
    assert m.recompiles == 0 and m.hbm_bytes_in_use is None
    gauges = ("mixed_mfu", "mixed_mbu") if tsrv._mixed else \
        ("decode_mfu", "decode_mbu")
    assert all(getattr(m, g) is None for g in gauges)
    per_s = "mixed_tokens_per_sec_per_chip" if tsrv._mixed else \
        "decode_tokens_per_sec_per_chip"
    assert getattr(m, per_s) > 0
    # a known peak turns the same step into gauges
    tsrv.perf.peak_flops, tsrv.perf.peak_hbm_bw = 1e15, 1e12
    for p in prompts[:2]:
        tsrv.submit(p, max_new_tokens=6)
    tsrv.run()
    assert all(getattr(m, g) > 0 for g in gauges)


def test_forced_new_shape_trips_the_sentinel_naming_the_argument():
    """A training batch of another length: the train_step program
    recompiles once, the alarm names ``batch``, and the cost follows the
    new shape."""
    cfg = LlamaConfig.tiny()
    eng, *_ = dt.initialize(
        model=LlamaForCausalLM(cfg), device="cpu",
        config={"train_batch_size": 2, "steps_per_print": 0,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
    tracer = Tracer(capacity=64)
    eng.perf.programs.tracer = tracer
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (2, 16)))
    eng.train_batch(batch={"input_ids": ids, "labels": ids})
    short = ids[:, :8]
    eng.train_batch(batch={"input_ids": short, "labels": short})
    prog = eng.perf.programs.program("train_step")
    assert (prog.recompiles, prog.compiles, prog.calls) == (1, 2, 2)
    (ev,) = [e for e in tracer.events() if e["name"] == "recompile"]
    assert ev["args"]["args"] == ["batch"]
    n = sum(p.numel() for p in eng.master.values())
    assert prog.flops == perf.train_step_flops(n, 2, 8, cfg.num_hidden_layers,
                                               cfg.hidden_size)
    assert eng.registry.counter("recompiles", program="train_step").value == 1


def test_training_engine_registers_train_step_with_gauges():
    cfg = LlamaConfig.tiny()
    eng, *_ = dt.initialize(
        model=LlamaForCausalLM(cfg), device="cpu",
        config={"train_batch_size": 4, "gradient_accumulation_steps": 2,
                "steps_per_print": 0,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}})
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (4, 16)))
    for _ in range(3):
        eng.train_batch(batch={"input_ids": ids, "labels": ids})
    summary = eng.perf_summary()
    (row,) = summary["programs"]
    assert row["name"] == "train/train_step"
    assert (row["calls"], row["compiles"], row["recompiles"]) == (3, 1, 0)
    n = sum(p.numel() for p in eng.master.values())
    assert row["flops"] == perf.train_step_flops(
        n, 4, 16, cfg.num_hidden_layers, cfg.hidden_size)
    snap = eng.registry.snapshot()
    assert snap["train_batch_s_count"] == 3
    assert snap["train_tflops_per_chip"] > 0
    assert "train_mfu" not in snap   # no known peak on the CPU


def test_dense_generate_registers_per_bucket_programs(engines):
    _, teng, _ = engines
    ids = np.arange(1, 9)[None]
    teng.generate(ids, max_new_tokens=4)
    teng.generate(ids, max_new_tokens=4)           # same bucket
    teng.generate(np.arange(1, 21)[None], max_new_tokens=4)  # new bucket
    teng.generate(ids, max_new_tokens=1)           # prefill only
    table = {r["name"]: r for r in teng.perf.programs.table()}
    small = table["inference/prefill[b1,t8]"]
    assert (small["calls"], small["compiles"], small["recompiles"]) == \
        (3, 1, 0)
    dec = table["inference/decode[b1,t8,n4]"]
    assert (dec["calls"], dec["compiles"], dec["recompiles"]) == (2, 1, 0)
    assert dec["flops"] > 0 and dec["bytes_accessed"] > 0
    assert "inference/prefill[b1,t32]" in table
    assert "inference/decode[b1,t32,n4]" in table
    assert "inference/decode[b1,t8,n1]" not in table
