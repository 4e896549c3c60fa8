"""The port's flight recorder and trace schema.

The port's trace events pass the JAX package's schema check
(``validate_event``, which ``tools/trace_view.py`` runs); a watchdog trip,
a logit quarantine and each ``DS_FAULT`` firing leave one dump apiece in
``trace_dir``, in the JAX dump format (``tools/trace_view.py`` reads it),
whose header names the request it hit; a disabled tracer records
nothing; ``dump_trace`` writes Chrome-trace JSON that the same reader
loads.
"""

import json
import os

import numpy as np
import pytest

from deepspeed_tpu.monitor.tracing import validate_event as jax_validate
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.monitor import tracing
from deepspeed_tpu_torch.utils import fault_injection as faults
from tools import trace_view

pytestmark = pytest.mark.serving

SCFG = dict(max_batch_size=2, block_size=8, num_blocks=16, max_model_len=32)


@pytest.fixture(scope="module")
def engine():
    model = LlamaForCausalLM(LlamaConfig.tiny())
    return dt.init_inference(model, params=model.init_params(seed=0),
                             dtype="fp32", device="cpu")


def _serve(srv, n=2, seed=0, new=5):
    rs = np.random.RandomState(seed)
    rids = [srv.submit(rs.randint(1, 256, int(rs.randint(3, 9))),
                       max_new_tokens=new) for _ in range(n)]
    srv.run()
    return rids


def _dumps(trace_dir):
    out = {}
    for f in sorted(os.listdir(trace_dir)):
        if f.startswith("flight_"):
            events, header = trace_view.load_events(os.path.join(trace_dir, f))
            assert trace_view.validate(events) is None
            assert header["events"] == len(events)
            out.setdefault(header["trigger"], []).append(header)
    return out


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["unified", "two_program"])
def test_trip_quarantine_and_faults_each_dump_naming_the_rid(
        engine, tmp_path, monkeypatch, mixed):
    srv = dt.ServingEngine(engine, dt.ServingConfig(
        mixed_step=mixed, step_watchdog_s=0.3, trace_dir=str(tmp_path),
        flight_events=64, **SCFG))
    assert srv.tracer.enabled and srv.flight is not None
    _serve(srv, n=1)                              # warm: exempt, no dumps
    assert _dumps(tmp_path) == {}

    monkeypatch.setenv(faults.ENV_VAR, "slow_step:seconds=0.8:fails=1")
    faults.reset()
    tripped = _serve(srv, n=2, seed=1)
    if srv._wedged is not None:
        srv._wedged.join(5)
    monkeypatch.setenv(faults.ENV_VAR, "corrupt_logits:fails=1:slot=0")
    faults.reset()
    poisoned = _serve(srv, n=2, seed=2)
    monkeypatch.setenv(faults.ENV_VAR, "flaky_prefill:fails=1")
    faults.reset()
    flaky = _serve(srv, n=2, seed=3)
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    srv.flight.disarm()

    outs = {r: srv.poll(r) for r in tripped + poisoned + flaky}
    trip_rids = [r for r in tripped if outs[r].finish_reason ==
                 "step_watchdog"]
    (bad,) = [r for r in poisoned if outs[r].finish_reason ==
              "corrupt_logits"]
    assert outs[flaky[0]].finish_reason == "prefill_error:RuntimeError"
    d = _dumps(tmp_path)
    assert sorted(d) == ["fault_corrupt_logits", "fault_flaky_prefill",
                         "fault_slow_step", "logit_quarantine",
                         "watchdog_trip"]
    assert all(len(v) == 1 for v in d.values())
    (trip,) = d["watchdog_trip"]
    assert trip["detail"]["rids"] == trip_rids and trip_rids
    assert trip["detail"]["budget_s"] == 0.3
    assert trip["metrics"]["watchdog_trips"] == 1
    assert d["fault_slow_step"][0]["detail"]["rids"] == trip_rids
    assert d["logit_quarantine"][0]["detail"]["rid"] == bad
    assert bad in d["fault_corrupt_logits"][0]["detail"]["rids"]
    assert d["fault_flaky_prefill"][0]["detail"]["rids"] == [flaky[0]]
    for headers in d.values():
        assert headers[0]["kind"] == "flight_recorder"
        assert 0 < headers[0]["events"] <= 64


def test_events_pass_both_schemas_and_dump_trace_loads(engine, tmp_path):
    srv = dt.ServingEngine(engine, dt.ServingConfig(
        trace_dir=str(tmp_path), ttft_slo_s=10.0, **SCFG))
    rids = _serve(srv, n=3)
    events = srv.tracer.events()
    assert events
    for ev in events:
        assert tracing.validate_event(ev) is None
        assert jax_validate(ev) is None
    path = srv.dump_trace()
    assert os.path.dirname(path) == str(tmp_path)
    doc = json.load(open(path))
    assert {e["name"] for e in doc["traceEvents"]} >= {"mixed_step", "step",
                                                      "request"}
    loaded, header = trace_view.load_events(path)
    assert header is None and trace_view.validate(loaded) is None
    verdicts = [e["args"]["slo"] for e in loaded if e["name"] == "request"]
    assert verdicts == ["good"] * len(rids)
    other = srv.dump_trace(str(tmp_path / "named.json"))
    assert json.load(open(other))["traceEvents"]
    srv.flight.disarm()


def test_validate_event_names_each_problem():
    ok = {"name": "a", "ph": "X", "ts": 1.0, "dur": 2.0}
    assert tracing.validate_event(ok) is None
    for bad in ([], {"ph": "i", "ts": 0}, dict(ok, ph="B"),
                dict(ok, ts=-1), dict(ok, dur=None), dict(ok, tid="x"),
                dict(ok, cat=3), dict(ok, args=[])):
        assert tracing.validate_event(bad) == jax_validate(bad) is not None


def test_disabled_tracer_records_nothing(engine):
    srv = dt.ServingEngine(engine, dt.ServingConfig(**SCFG))
    assert not srv.tracer.enabled and srv.flight is None
    _serve(srv, n=3)
    assert len(srv.tracer) == 0 and srv.tracer.events() == []
    assert srv.tracer.span("x") is tracing._NULL_SPAN
    with pytest.raises(ValueError, match="trace_dir"):
        srv.dump_trace()


def test_recorder_never_raises_and_arming_is_exclusive_per_dir(tmp_path):
    tr = tracing.Tracer(capacity=8)
    tr.instant("x")
    blocked = tmp_path / "file"
    blocked.write_text("")
    assert tracing.FlightRecorder(str(blocked / "sub"), tr).record("t") is None
    a = tracing.FlightRecorder(str(tmp_path / "d"), tr)
    b = tracing.FlightRecorder(str(tmp_path / "d"), tr)
    a.arm_faults()
    b.arm_faults()
    try:
        faults._notify("probe", {"step": 1})
        assert len(a.dumps) == 1 and b.dumps == []
    finally:
        a.disarm()
        b.disarm()
    faults._notify("probe", {"step": 2})
    assert len(a.dumps) == 1
