"""The serving engine's watchdog and chaos points on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device is
present. On a machine with one, run them with
``python -m pytest --noconftest tests/test_torch_cuda_serving.py -m cuda``.

- a ``slow_step`` past the budget during a replayed (captured) step trips
  the watchdog, fails the step's requests, and serving resumes on the
  same graphs: nothing is captured again;
- a probabilistic chaos storm under ``enable_cuda_graph`` on both engines
  leaves every request terminal, no page leaked, and the graphs and
  program table as they were;
- device work past the budget (a spin kernel ahead of a warm replay)
  trips the watchdog on the read-back's CUDA event; the engine skips
  device work while the event is pending, leaks no page, captures
  nothing again, and the next request's tokens are the ones it gave
  before the hang;
- a guarded step's device work runs on the calling thread and its
  current stream, asserted from inside the step; the tokens equal the
  unguarded engine's.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: chip_smoke.py's small serving model: 2 layers, head_dim 128, GQA 2
SMALL = dict(vocab_size=512, hidden_size=256, intermediate_size=512,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1)
SCFG = dict(max_batch_size=4, block_size=16, num_blocks=64,
            max_model_len=256, prefill_token_budget=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def fault(monkeypatch):
    from deepspeed_tpu_torch.utils import fault_injection as faults

    def arm(spec):
        if spec is None:
            monkeypatch.delenv(faults.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(faults.ENV_VAR, spec)
        faults.reset()

    yield arm
    arm(None)


def _server(cuda, **over):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig(**SMALL))
    eng = dt.init_inference(model, params=model.init_params(seed=0),
                            dtype="fp32", device=cuda,
                            enable_cuda_graph=True)
    return dt.ServingEngine(eng, dt.ServingConfig(**dict(SCFG, **over)))


def _serve(srv, seed, n=4, new=6):
    rs = np.random.RandomState(seed)
    rids = [srv.submit(rs.randint(0, 512, int(rs.randint(5, 90))),
                       max_new_tokens=new) for _ in range(n)]
    srv.run(max_steps=500)
    return [srv.poll(r) for r in rids]


def _check_pool(srv):
    assert all(r.done for r in srv._requests.values())
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["unified", "two_program"])
def test_slow_step_trips_a_replayed_step_and_serving_resumes(cuda, fault,
                                                             mixed):
    srv = _server(cuda, mixed_step=mixed, step_watchdog_s=0.5,
                  prefill_chunk_tokens=32)
    for seed in (0, 1):   # capture every shape, then replay them
        assert all(o.state == "finished" for o in _serve(srv, seed))
    graphs = len(srv._graphs)
    assert graphs
    fault("slow_step:seconds=1.5:fails=1")
    outs = _serve(srv, 2)
    fault(None)
    assert srv.metrics.watchdog_trips == 1
    assert "step_watchdog" in {o.finish_reason for o in outs}
    if srv._wedged is not None:
        srv._wedged.join(5)
    assert all(o.state == "finished" for o in _serve(srv, 3))
    _check_pool(srv)
    assert len(srv._graphs) == graphs
    assert srv.perf.recompile_total == 0


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["unified", "two_program"])
def test_chaos_storm_changes_no_captured_graph(cuda, fault, monkeypatch,
                                               mixed):
    srv = _server(cuda, mixed_step=mixed, step_watchdog_s=2.0,
                  prefill_chunk_tokens=32)
    _serve(srv, 0)
    _serve(srv, 1)
    before = (len(srv._graphs), dict(srv.compile_counts),
              [(r["name"], r["compiles"]) for r in srv.perf.programs.table()])
    monkeypatch.setenv("DS_FAULT_SEED", "11")
    fault("flaky_prefill:p=0.3,corrupt_logits:p=0.2,"
          "slow_step:p=0.25:seconds=0.01")
    outs = _serve(srv, 4, n=12)
    fault(None)
    assert {o.state for o in outs} <= {"finished", "failed"}
    assert "failed" in {o.state for o in outs}
    assert all(o.state == "finished" for o in _serve(srv, 5))
    _check_pool(srv)
    assert (len(srv._graphs), dict(srv.compile_counts),
            [(r["name"], r["compiles"])
             for r in srv.perf.programs.table()]) == before
    assert srv.perf.recompile_total == 0


def _spin_cycles(seconds):
    """``torch.cuda._sleep`` cycles that spin the card for about
    ``seconds`` (calibrated on a short spin)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10**6)     # wake the clocks
    start.record()
    torch.cuda._sleep(10**8)
    end.record()
    end.synchronize()
    return int(10**8 * seconds * 1e3 / start.elapsed_time(end))


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["unified", "two_program"])
def test_a_hung_device_trips_the_watchdog_and_serving_resumes(cuda, mixed):
    """A warm step whose device work outlasts the budget: a spin kernel of
    about 2 s on the engine's stream ahead of the replay (0.5 s budget).
    The read-back's event is still pending at the deadline, so the step
    trips once and its requests fail; while the event is pending the
    engine skips device work; once it completes, serving resumes on the
    same graphs, no page leaked, and a request served before the hang
    gives the same tokens again."""
    srv = _server(cuda, mixed_step=mixed, step_watchdog_s=0.5,
                  prefill_chunk_tokens=32)
    for seed in (0, 1):   # capture every shape, then replay them
        assert all(o.state == "finished" for o in _serve(srv, seed))
    want = [(o.state, o.tokens) for o in _serve(srv, 3)]
    before = (len(srv._graphs), dict(srv.compile_counts),
              [(r["name"], r["compiles"]) for r in srv.perf.programs.table()])
    cycles = _spin_cycles(2.0)
    inner, hung = srv._run_or_replay, []

    def hang(key, forward):
        if not hung:
            hung.append(key)
            torch.cuda._sleep(cycles)
        return inner(key, forward)

    srv._run_or_replay = hang
    rs = np.random.RandomState(2)
    rids = [srv.submit(rs.randint(0, 512, 40), max_new_tokens=6)
            for _ in range(2)]
    steps = 0
    while not srv.metrics.watchdog_trips:
        srv.step()
        steps += 1
        assert steps < 50
    srv._run_or_replay = inner
    assert hung and hung[0] in srv._warm
    assert srv._wedged is not None and not srv._wedged.readback.ready()
    skips = srv.metrics.watchdog_skips
    srv.step()
    assert srv.metrics.watchdog_skips == skips + 1
    assert srv._wedged.join(30)
    srv.run(max_steps=500)
    assert "step_watchdog" in {srv.poll(r).finish_reason for r in rids}
    assert srv.metrics.watchdog_trips == 1
    assert [(o.state, o.tokens) for o in _serve(srv, 3)] == want
    _check_pool(srv)
    assert (len(srv._graphs), dict(srv.compile_counts),
            [(r["name"], r["compiles"])
             for r in srv.perf.programs.table()]) == before
    assert srv.perf.recompile_total == 0


def test_guarded_steps_run_on_the_callers_thread_and_stream(cuda, fault):
    """Under the watchdog, every step's device work (the fill, the replay,
    the read-back) runs on the calling thread and its current
    (non-default) stream, as an unguarded step's does, a step with a fired
    chaos stall too; the tokens equal an unguarded engine's on the same
    weights."""
    import threading

    plain = _server(cuda)
    want = [(o.state, o.tokens) for o in _serve(plain, 7)]
    srv = _server(cuda, step_watchdog_s=5.0)
    seen = []
    inner = srv._mixed_step

    def spy(width, arrays):
        seen.append((threading.get_ident(),
                     torch.cuda.current_stream().cuda_stream))
        return inner(width, arrays)

    srv._mixed_step = spy
    side = torch.cuda.Stream()
    me = threading.get_ident()
    # step 3 is warm: step 0 ran eagerly and captured the width
    fault("slow_step:seconds=0.01:fails=1:step=3")
    with torch.cuda.stream(side):
        got = [(o.state, o.tokens) for o in _serve(srv, 7)]
        torch.cuda.synchronize()
    assert got == want
    assert len(seen) > len(srv._warm)     # warm steps ran guarded
    assert all(s == (me, side.cuda_stream) for s in seen)
    assert srv.metrics.watchdog_trips == 0
    _check_pool(srv)
