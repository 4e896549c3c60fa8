"""The port's serving robustness against the JAX engine's, under chaos.

Every scenario of the JAX chaos suite (``tests/unit/serving/test_chaos.py``)
runs under the same ``DS_FAULT`` spec through a JAX and a port engine
built on the same flax params (tiny Llama, fp32, greedy), on the unified
step and on the two-program engine: the terminal states, finish reasons,
tokens, watchdog trips, logit quarantines and failed requests must be
equal, and each side must keep the chaos invariant — every request
terminal, zero leaked pages, a consistent pool, and a fresh request
served afterwards. Both packages read one ``DS_FAULT`` and one
``DS_FAULT_SEED``, so a probabilistic spec fires at the same probes on
both sides.

Scenarios that do not need a real stall run on a virtual clock (the
engines' and the fault injector's ``time``), so deadlines and stalls are
judged on the same virtual seconds on both sides and the outcome does not
depend on how fast either package runs on this machine. The watchdog
scenarios stall for real. The SLO verdicts are held to the JAX engine's
on crafted requests and on served traffic.
"""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu as jds
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.inference.serving import engine as jax_engine_mod
from deepspeed_tpu.inference.serving import scheduler as jax_sched_mod
from deepspeed_tpu.inference.serving.scheduler import Request as JaxRequest
from deepspeed_tpu.inference.serving.scheduler import \
    RequestState as JaxState
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.utils import fault_injection as jax_faults
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.inference.serving import engine as engine_mod
from deepspeed_tpu_torch.inference.serving import scheduler as sched_mod
from deepspeed_tpu_torch.inference.serving.scheduler import Request, \
    RequestState
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.utils import fault_injection as faults

pytestmark = [pytest.mark.serving, pytest.mark.chaos]

#: a chaos drill that needs more steps than this to drain has wedged
MAX_DRAIN_STEPS = 400

#: the JAX chaos suite's engine: 2 slots, 16 pages of 8, a 0.4 s budget
SCFG = dict(max_batch_size=2, block_size=8, num_blocks=16, max_model_len=32,
            step_watchdog_s=0.4)

#: each package's fault injector and the modules whose clock it shares
SIDES = {"jax": (jax_faults, (jax_engine_mod, jax_sched_mod)),
         "port": (faults, (engine_mod, sched_mod))}


@pytest.fixture(scope="module")
def weights():
    model = JaxLlama(JaxConfig.tiny(remat=False))
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))["params"]
    return model, params


def _pair(weights, **over):
    model, params = weights
    jeng = jds.init_inference(model, params=params, dtype="fp32")
    cfg = LlamaConfig.tiny()
    teng = dt.init_inference(
        LlamaForCausalLM(cfg),
        params=flax_to_torch_state_dict(jax.device_get(params), cfg),
        dtype="fp32", device="cpu")
    kw = dict(SCFG, **over)
    return {"jax": JaxServingEngine(jeng, JaxServingConfig(**kw)),
            "port": dt.ServingEngine(teng, dt.ServingConfig(**kw))}


#: the step kinds: the unified step, and the two-program engine with the
#: monolithic prefill and with 8-token chunks
KINDS = {"unified": dict(mixed_step=True),
         "two_program": dict(mixed_step=False),
         "two_program_chunked": dict(mixed_step=False,
                                     prefill_chunk_tokens=8)}


@pytest.fixture(scope="module", params=sorted(KINDS))
def engines(request, weights):
    """One JAX and one port engine per step kind, shared by the
    scenarios in order (as the JAX suite shares one), so both see the
    same step numbers; each is warmed first (the first forward is exempt
    from the watchdog)."""
    pair = _pair(weights, **KINDS[request.param])
    for srv in pair.values():
        rid = srv.submit([3, 5, 7], max_new_tokens=2)
        _drain(srv)
        assert srv.poll(rid).state == "finished"
    return pair


class VirtualClock:
    """``time`` for the engines, schedulers and fault injectors: a stall
    or a sleep moves it, nothing else does."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        return self.now

    time = monotonic = perf_counter

    def sleep(self, s):
        self.now += max(0.0, s)

    @staticmethod
    def strftime(*a):
        return time.strftime(*a)


def _drain(srv):
    steps = 0
    while srv.has_work():
        srv.step()
        steps += 1
        assert steps < MAX_DRAIN_STEPS, "engine wedged under chaos"


def _assert_invariant(srv):
    assert all(r.done for r in srv._requests.values()), \
        {rid: r.state.value for rid, r in srv._requests.items() if not r.done}
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0, "leaked pages"


def _prompts(seed, n, lo=3, hi=9):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 256, int(rs.randint(lo, hi))) for _ in range(n)]


COUNTERS = ("watchdog_trips", "logit_quarantines", "requests_failed",
            "requests_timeout")


def _chaos(engines, monkeypatch, spec, body, virtual=True):
    """Run ``body(srv)`` (returns its rids) on each engine under ``spec``,
    then drain and hold the chaos invariant, and serve a fresh request.
    Returns, by side, the requests' (state, reason, tokens) and the
    counters' deltas; asserts the two sides equal."""
    out = {}
    for side, srv in engines.items():
        fi, clocked = SIDES[side]
        with monkeypatch.context() as mp:
            if virtual:
                clock = VirtualClock()
                for mod in clocked + (fi,):
                    mp.setattr(mod, "time", clock)
            mp.setenv(faults.ENV_VAR, spec)
            fi.reset()
            before = {c: getattr(srv.metrics, c) for c in COUNTERS}
            rids = body(srv)
            _drain(srv)
            mp.delenv(faults.ENV_VAR)
            fi.reset()
            _drain(srv)
            _assert_invariant(srv)
            fresh = srv.submit([2, 4, 6], max_new_tokens=2)
            _drain(srv)
            assert srv.poll(fresh).state == "finished"
            _assert_invariant(srv)
        res = [srv.poll(r) for r in rids]
        out[side] = ([(o.state, o.finish_reason, o.tokens) for o in res],
                     {c: getattr(srv.metrics, c) - before[c]
                      for c in COUNTERS})
    assert out["port"] == out["jax"]
    return out["port"]


def test_slow_step_watchdog_fails_step_and_keeps_serving(engines,
                                                         monkeypatch):
    """A wedged step (slow_step past the watchdog budget) fails the
    step's requests — not the engine."""
    def body(srv):
        rids = [srv.submit(p, max_new_tokens=6) for p in _prompts(11, 2)]
        t0 = time.perf_counter()
        _drain(srv)
        assert time.perf_counter() - t0 < 5.0  # bounded, not wedged
        return rids

    res, counts = _chaos(engines, monkeypatch,
                         "slow_step:seconds=1.2:fails=1", body,
                         virtual=False)
    assert counts["watchdog_trips"] == 1
    # the step's decode rows fail; a request still mid-prefill on the
    # two-program engine is not in the step and finishes
    reasons = [r for _, r, _ in res]
    assert "step_watchdog" in reasons
    assert set(reasons) <= {"step_watchdog", "length"}


def test_wedged_step_does_not_stack_threads(engines, monkeypatch):
    """While the abandoned step still runs, later steps skip device work
    instead of starting more watchdog threads; serving resumes after."""
    import threading

    def body(srv):
        r1 = srv.submit(_prompts(37, 1)[0], max_new_tokens=4)
        _drain(srv)  # trips at ~0.4 s; the abandoned thread sleeps on
        assert srv.poll(r1).finish_reason == "step_watchdog"
        assert srv._wedged is not None and srv._wedged.is_alive()
        skips = srv.metrics.watchdog_skips
        threads = threading.active_count()
        r2 = srv.submit(_prompts(41, 1)[0], max_new_tokens=3)
        _drain(srv)
        assert srv.poll(r2).state == "finished"
        assert srv.metrics.watchdog_skips > skips
        assert threading.active_count() <= threads
        return [r1, r2]

    _chaos(engines, monkeypatch, "slow_step:seconds=1.0:fails=1", body,
           virtual=False)


def test_slow_step_within_budget_only_slows(engines, monkeypatch):
    def body(srv):
        return [srv.submit(p, max_new_tokens=4) for p in _prompts(13, 2)]

    res, _ = _chaos(engines, monkeypatch, "slow_step:seconds=0.05:fails=3",
                    body)
    assert all(s == "finished" for s, _, _ in res)


def test_corrupt_logits_quarantines_offender_not_batch(engines,
                                                       monkeypatch):
    def body(srv):
        return [srv.submit(_prompts(s, 1)[0], max_new_tokens=6)
                for s in (17, 19)]

    res, counts = _chaos(engines, monkeypatch,
                         "corrupt_logits:fails=1:slot=0", body)
    assert counts["logit_quarantines"] == 1
    assert sorted((s, r) for s, r, _ in res) == [
        ("failed", "corrupt_logits"), ("finished", "length")]


@pytest.mark.parametrize("tag", ["serving_step", "serving_prefill"])
def test_corrupt_logits_by_tag(engines, monkeypatch, tag):
    """Each corrupt_logits vocabulary alone: a decode row's logits or a
    prefill's."""
    def body(srv):
        return [srv.submit(p, max_new_tokens=5) for p in _prompts(43, 3)]

    res, counts = _chaos(engines, monkeypatch,
                         f"corrupt_logits:fails=1:tag={tag}", body)
    # the monolithic prefill has no corrupt_logits point (as in JAX)
    port = engines["port"]
    hit = int(tag == "serving_step" or port._mixed or port._chunk > 0)
    assert counts["logit_quarantines"] == hit
    assert [r for _, r, _ in res].count("corrupt_logits") == hit


def test_slow_chunk_watchdog_fails_prefill_and_keeps_serving(engines,
                                                             monkeypatch):
    """slow_chunk past the budget on a step that carries prefill work:
    the unified step fails every packed request, the chunked two-program
    engine the chunk's request (and skips the step's decode); the
    monolithic prefill has no such point."""
    def body(srv):
        return [srv.submit(p, max_new_tokens=4) for p in _prompts(47, 2)]

    res, counts = _chaos(engines, monkeypatch,
                         "slow_chunk:seconds=1.0:fails=1", body,
                         virtual=False)
    port = engines["port"]
    assert counts["watchdog_trips"] == int(port._mixed or port._chunk > 0)


def test_flaky_prefill_fails_request_keeps_serving(engines, monkeypatch):
    def body(srv):
        return [srv.submit(p, max_new_tokens=4) for p in _prompts(23, 2)]

    res, counts = _chaos(engines, monkeypatch, "flaky_prefill:fails=1", body)
    assert res[0][:2] == ("failed", "prefill_error:RuntimeError")
    assert res[1][0] == "finished"
    assert counts["requests_failed"] == 1


def test_probabilistic_chaos_storm_all_terminal_no_leaks(engines,
                                                         monkeypatch):
    """Probabilistic variants of every serving fault at once under one
    DS_FAULT_SEED: the same probes fire on both sides, and chaos changes
    no program — the compile counts, the captured graphs and the program
    table are the same after the storm as before it."""
    monkeypatch.setenv("DS_FAULT_SEED", "7")
    def programs(srv):
        # the JAX engine has no captured graphs: its compile counts say it
        return dict(srv.compile_counts), len(getattr(srv, "_graphs", ()))

    before = {side: programs(srv) for side, srv in engines.items()}
    port = engines["port"]
    table = [(r["name"], r["compiles"]) for r in port.perf.programs.table()]

    def body(srv):
        return [srv.submit(p, max_new_tokens=4,
                           deadline_s=None if i % 3 else 10.0)
                for i, p in enumerate(_prompts(29, 10))]

    res, counts = _chaos(engines, monkeypatch,
                         "flaky_prefill:p=0.3,corrupt_logits:p=0.15,"
                         "slow_step:p=0.25:seconds=0.02", body)
    states = {s for s, _, _ in res}
    assert states <= {"finished", "failed", "timeout"}
    assert "finished" in states and "failed" in states
    assert counts["logit_quarantines"] > 0
    for side, srv in engines.items():
        assert programs(srv) == before[side]
    assert [(r["name"], r["compiles"])
            for r in port.perf.programs.table()] == table
    assert port.perf.recompile_total == 0


def test_queue_survives_storm_behind_deadlines(engines, monkeypatch):
    """Requests queued behind a storm with tight deadlines shed cleanly
    (TIMEOUT) instead of wedging the queue — the same ones on both
    sides, on the virtual clock."""
    monkeypatch.setenv("DS_FAULT_SEED", "3")

    def body(srv):
        return [srv.submit(p, max_new_tokens=6, deadline_s=0.4)
                for p in _prompts(31, 6)]

    res, counts = _chaos(engines, monkeypatch,
                         "slow_step:p=0.5:seconds=0.12", body)
    assert {s for s, _, _ in res} <= {"finished", "timeout", "failed"}
    assert counts["requests_timeout"] > 0


def test_fault_streams_replay_per_engine(monkeypatch):
    """DS_FAULT_SEED streams: a named stream fires the JAX package's
    sequence whatever the probe interleaving."""
    monkeypatch.setenv(faults.ENV_VAR,
                       "slow_step:p=0.5:seconds=0:tag=serving_step")
    monkeypatch.setenv("DS_FAULT_SEED", "13")
    streams = ("replica:r0", "replica:r1")
    seqs = {}
    for name, fi in (("jax", jax_faults), ("port", faults)):
        fi.reset()
        seqs[name] = {s: [fi.get_fault("slow_step", tag="serving_step",
                                       stream=s) is not None
                          for _ in range(12)] for s in streams}
        fi.reset()
    faults.reset()
    interleaved = {s: [] for s in streams}
    for i in range(12):
        for s in (streams if i % 2 else reversed(streams)):
            interleaved[s].append(faults.get_fault(
                "slow_step", tag="serving_step", stream=s) is not None)
    faults.reset()
    assert seqs["port"] == seqs["jax"] == interleaved
    assert interleaved[streams[0]] != interleaved[streams[1]]


def test_chaos_never_recaptured(engines):
    """Runs last for each engine kind: every drill rode the same programs
    (faults are data or host-side, never new shapes) and the sentinel
    stayed silent."""
    port = engines["port"]
    if port._mixed:
        assert port.compile_counts == {"mixed_step": 1}
    assert port.perf.recompile_total == 0
    assert all(r["compiles"] == 1 and r["recompiles"] == 0
               for r in port.perf.programs.table())
    assert engines["jax"].perf.recompile_total == 0


# ---------------------------------------------------------------------------
# SLO verdicts
# ---------------------------------------------------------------------------

def _crafted(pkg):
    """(state, first token after, finish after, tokens) requests: finished
    fast and slow, timed out before and after a first token, failed,
    cancelled, and a one-token finish (no TPOT)."""
    R, S = (JaxRequest, JaxState) if pkg == "jax" else (Request, RequestState)
    cases = [("FINISHED", 0.01, 0.05, 5), ("FINISHED", 0.4, 2.0, 9),
             ("FINISHED", 0.02, 1.5, 4), ("FINISHED", 0.3, 0.3, 1),
             ("TIMEOUT", None, None, 0), ("TIMEOUT", 0.1, None, 3),
             ("FAILED", 0.1, 0.2, 2), ("CANCELLED", None, None, 0)]
    out = []
    for state, first, finish, n in cases:
        req = R(prompt=[1, 2, 3], max_new_tokens=16)
        req.submit_time = 100.0
        req.state = getattr(S, state)
        req.first_token_time = None if first is None else 100.0 + first
        req.finish_time = None if finish is None else 100.0 + finish
        req.tokens = list(range(n))
        out.append(req)
    return out


@pytest.mark.parametrize("ttft,tpot", [(0.0, 0.0), (None, None),
                                       (float("inf"), float("inf")),
                                       (0.05, 0.1), (0.2, 0.01)])
def test_slo_verdicts_match_jax(ttft, tpot):
    got = {}
    for pkg, eng, cfg in (("jax", JaxServingEngine, JaxServingConfig),
                          ("port", dt.ServingEngine, dt.ServingConfig)):
        judge = SimpleNamespace(config=cfg(ttft_slo_s=ttft, tpot_slo_s=tpot))
        got[pkg] = [eng._judge_slo(judge, r) for r in _crafted(pkg)]
    assert got["port"] == got["jax"]
    assert {"shed", "failed"} <= set(got["port"])


@pytest.mark.parametrize("mixed", [True, False],
                         ids=["unified", "two_program"])
@pytest.mark.parametrize("slo", [0.0, float("inf")], ids=["zero", "inf"])
def test_served_slo_verdicts_match_jax(weights, mixed, slo):
    """Traffic with a cancel and a flaky prefill under TTFT and TPOT SLOs
    of 0 (every finish misses) and infinity (every finish is good): the
    verdict counts equal the JAX engine's, sum to the terminal requests,
    and ride the terminal request spans."""
    pair = _pair(weights, mixed_step=mixed, step_watchdog_s=0.0,
                 ttft_slo_s=slo, tpot_slo_s=slo, trace=True)
    got = {}
    for side, srv in pair.items():
        fi = SIDES[side][0]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(faults.ENV_VAR, "flaky_prefill:fails=1")
            fi.reset()
            rids = [srv.submit(p, max_new_tokens=3)
                    for p in _prompts(5, 5)]
            srv.cancel(rids[-1])
            _drain(srv)
            fi.reset()
        m = srv.metrics
        got[side] = {v: getattr(m, f"slo_{v}") for v in
                     ("good", "ttft_miss", "tpot_miss", "shed", "failed")}
        assert sum(got[side].values()) == len(rids)
    assert got["port"] == got["jax"]
    spans = [e["args"]["slo"] for e in pair["port"].tracer.events()
             if e["name"] == "request"]
    assert len(spans) == len(rids)
    assert got["port"]["good" if slo else "ttft_miss"] == 3
