"""Speculative decoding in the port's serving engine against the JAX
engine's (``tests/unit/serving/test_speculative.py``).

The drafter is the JAX package's prompt-lookup drafter copied: it must
propose the same drafts on any history and refuse the same n-gram bounds.
The engine is held to the JAX engine on the same weights (tiny Llama,
fp32, greedy, the flax params through the weight bridge), both stepped in
lockstep on the same traffic: identical tokens, finish reasons and
preemptions, identical ``spec_*`` counters, and the same per-request draft
cap (``spec_k``) after every step. With speculation the port must also
serve exactly what it serves without it, and every run ends with zero
pages in use and a consistent pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import deepspeed_tpu as jds
from deepspeed_tpu.inference.serving import (
    PromptLookupDrafter as JaxPromptLookupDrafter)
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.inference.serving.speculative import (
    Drafter, PromptLookupDrafter)
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving

#: the counters both engines must agree on after every run
SPEC_COUNTERS = ("spec_drafted", "spec_accepted", "spec_committed",
                 "spec_verify_rows", "spec_pages_dropped", "spec_steps",
                 "preemptions", "steps")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops gain nothing from intra-op threads, which only
    contend for the cores with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    return jeng, teng


class _OracleDrafter(Drafter):
    """Replays a known continuation per prompt: every draft is accepted."""

    kind = "oracle"

    def __init__(self, table):
        self.table = sorted(table.items(), key=lambda kv: -len(kv[0]))

    def draft(self, history, k):
        h = list(history)
        for p, toks in self.table:
            if h[:len(p)] == list(p):
                done = len(h) - len(p)
                return list(toks[done:done + k])
        return []


class _WrongDrafter(Drafter):
    """Always-rejected drafts: every verify row rolls everything back."""

    kind = "wrong"

    def __init__(self, token):
        self.token = token

    def draft(self, history, k):
        return [self.token] * k


def _run(srv, prompts, new, eos):
    rids = [srv.submit(p, max_new_tokens=n, eos_token_id=eos)
            for p, n in zip(prompts, new)]
    return rids, [srv._requests[r] for r in rids]


def _serve(engines, prompts, new, eos=None, jax_too=True, **kw):
    """Serve the same requests on a JAX and a port engine with the same
    ``ServingConfig`` fields, stepping both in lockstep. Asserts equal
    outputs, counters and ``spec_k`` trajectories, and a drained,
    consistent pool on each side; returns the port's outputs and engine.
    ``jax_too=False`` serves on the port alone (the plain runs speculation
    is held to: the plain engines' parity is tests/test_torch_serving.py's)."""
    jeng, teng = engines
    srvs = {"port": dt.ServingEngine(teng, dt.ServingConfig(**kw))}
    if jax_too:
        srvs["jax"] = JaxServingEngine(jeng, JaxServingConfig(**kw))
    reqs = {side: _run(srv, prompts, new, eos)
            for side, srv in srvs.items()}
    traj = {side: [] for side in srvs}
    while any(srv.has_work() for srv in srvs.values()):
        for side, srv in srvs.items():
            if srv.has_work():
                srv.step()
            traj[side].append([r.spec_k for r in reqs[side][1]])
    outs = {}
    for side, srv in srvs.items():
        res = {rid: srv.poll(rid) for rid in reqs[side][0]}
        outs[side] = [(o.state, o.finish_reason, o.tokens, o.preemptions)
                      for o in res.values()]
        srv.block_pool.check_consistent()
        assert srv.block_pool.used_count == 0, (side, "leaked pages")
    if jax_too:
        assert outs["port"] == outs["jax"]
        assert traj["port"] == traj["jax"], "spec_k trajectories differ"
        jm, tm = srvs["jax"].metrics, srvs["port"].metrics
        assert {c: getattr(tm, c) for c in SPEC_COUNTERS} == \
            {c: getattr(jm, c) for c in SPEC_COUNTERS}
    return outs["port"], srvs["port"]


# ---------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------

@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(history=st.lists(st.integers(0, 5), max_size=40),
       k=st.integers(0, 9), max_ngram=st.integers(1, 5),
       min_ngram=st.integers(1, 5))
def test_prompt_lookup_drafter_equals_jax(history, k, max_ngram, min_ngram):
    """Small alphabets make n-grams repeat; every draft, and every refusal
    of the n-gram bounds, is the JAX drafter's."""
    if min_ngram > max_ngram:
        with pytest.raises(ValueError, match="min_ngram <= max_ngram"):
            PromptLookupDrafter(max_ngram, min_ngram)
        with pytest.raises(ValueError, match="min_ngram <= max_ngram"):
            JaxPromptLookupDrafter(max_ngram, min_ngram)
        return
    want = JaxPromptLookupDrafter(max_ngram, min_ngram).draft(history, k)
    got = PromptLookupDrafter(max_ngram, min_ngram).draft(history, k)
    assert got == want
    assert len(got) <= k


@pytest.mark.parametrize("history,k,want", [
    ([1, 7, 8, 9, 4, 5, 7, 8, 9], 2, [4, 5]),
    ([1, 7, 8, 9, 4, 5, 7, 8, 9], 1, [4]),
    ([9, 1, 2, 9, 3, 4, 9], 3, [3, 4, 9]),
    ([9, 5, 9, 6, 9], 2, [6, 9]),
    ([1, 2, 3, 4, 5], 4, []),
    ([], 4, []), ([1], 4, []), ([1, 1, 1], 0, [])])
def test_prompt_lookup_drafter_cases(history, k, want):
    """The JAX suite's cases: trailing n-gram match, k truncation, unigram
    fallback, newest occurrence first, no repeat, degenerate inputs."""
    assert PromptLookupDrafter(3, 1).draft(history, k) == want
    assert JaxPromptLookupDrafter(3, 1).draft(history, k) == want


@pytest.mark.parametrize("over,exc,match", [
    ({"spec_tokens": -1}, ValueError, "spec_tokens"),
    ({"spec_tokens": 4, "do_sample": True}, ValueError, "greedy"),
    ({"spec_tokens": 4, "mixed_step": False}, ValueError, "mixed"),
    ({"spec_tokens": 4, "spec_ngram": 0}, ValueError, "min_ngram")])
def test_speculation_config_validation_matches_jax(engines, over, exc,
                                                   match):
    jeng, teng = engines
    kw = dict(max_batch_size=2, block_size=8, num_blocks=16,
              max_model_len=64, **over)
    with pytest.raises(exc, match=match):
        JaxServingEngine(jeng, JaxServingConfig(**kw))
    with pytest.raises(exc, match=match):
        dt.ServingEngine(teng, dt.ServingConfig(**kw))


def test_drafter_built_from_the_config(engines):
    """spec_ngram sizes the default drafter; a given drafter is used as is,
    and speculation off builds none."""
    _, teng = engines
    kw = dict(max_batch_size=2, block_size=8, num_blocks=16,
              max_model_len=64)
    srv = dt.ServingEngine(teng, dt.ServingConfig(spec_tokens=3,
                                                  spec_ngram=2, **kw))
    assert isinstance(srv._drafter, PromptLookupDrafter)
    assert (srv._drafter.max_ngram, srv._drafter.min_ngram) == (2, 1)
    wrong = _WrongDrafter(1)
    srv = dt.ServingEngine(teng, dt.ServingConfig(spec_tokens=3,
                                                  drafter=wrong, **kw))
    assert srv._drafter is wrong
    assert dt.ServingEngine(teng, dt.ServingConfig(
        drafter=wrong, **kw))._drafter is None


# ---------------------------------------------------------------------
# greedy token identity
# ---------------------------------------------------------------------

def _identity_traffic(seed):
    rs = np.random.RandomState(seed)
    prefix = rs.randint(1, 256, 16)
    prompts = [np.concatenate([prefix, rs.randint(1, 256, int(t))])
               for t in (3, 6, 2)]
    prompts += [rs.randint(1, 256, int(n)) for n in (5, 19, 11, 8)]
    return prompts, [14, 10, 16, 12, 18, 10, 15]


#: shared prefixes (cache hits) and a pool small enough to preempt while
#: speculating
IDENTITY = dict(max_batch_size=3, block_size=8, num_blocks=11,
                max_model_len=128, prefix_cache=True,
                prefill_chunk_tokens=8, prefill_token_budget=16)


@pytest.mark.parametrize("seed", [17, 19])
def test_randomized_traffic_identical_to_jax_and_to_plain(engines, seed):
    """Randomized mixed traffic with prompt-lookup drafting: the port with
    speculation serves what the JAX engine with speculation serves (tokens,
    reasons, preemptions, spec counters, spec_k after every step) and what
    the port without it serves, also with an EOS picked from the plain run
    so that it fires mid-stream; one width, no recompile."""
    prompts, new = _identity_traffic(seed)
    plain, srv_p = _serve(engines, prompts, new, jax_too=False, **IDENTITY)
    eos = plain[4][2][3]
    plain_eos, _ = _serve(engines, prompts, new, eos=eos, jax_too=False,
                          **IDENTITY)
    spec, srv_s = _serve(engines, prompts, new, spec_tokens=6, **IDENTITY)
    spec_eos, _ = _serve(engines, prompts, new, eos=eos, spec_tokens=6,
                         **IDENTITY)
    assert [o[:3] for o in spec] == [o[:3] for o in plain]
    assert [o[:3] for o in spec_eos] == [o[:3] for o in plain_eos]
    assert any(reason == "eos" for _, reason, _, _ in spec_eos)
    assert srv_s.metrics.preemptions > 0, "pool sized to force preemption"
    assert srv_s.metrics.spec_drafted > 0, "traffic never drafted"
    assert srv_s.metrics.spec_verify_rows > 0
    assert srv_s.compile_counts == {"mixed_step": 1}
    assert srv_s.perf.recompile_total == 0
    assert srv_p.metrics.spec_drafted == 0


def test_oracle_drafts_all_accepted_k_plus_one_a_verify(engines):
    """A drafter that is always right: every draft accepted, more than two
    tokens per verify row, under half the plain engine's steps, and the
    adaptive cap grown back to spec_tokens — as in the JAX engine."""
    rs = np.random.RandomState(23)
    prompts = [rs.randint(1, 256, int(n)) for n in (9, 14, 6)]
    new = [24, 24, 24]
    kw = dict(max_batch_size=3, block_size=8, num_blocks=64,
              max_model_len=128, prefix_cache=True)
    plain, srv_p = _serve(engines, prompts, new, jax_too=False, **kw)
    oracle = _OracleDrafter({tuple(int(t) for t in p): toks
                             for p, (_, _, toks, _) in zip(prompts, plain)})
    spec, srv = _serve(engines, prompts, new, spec_tokens=6, drafter=oracle,
                       **kw)
    assert spec == plain
    m = srv.metrics
    assert m.spec_accept_rate == 1.0
    assert m.spec_tokens_per_verify > 2.0
    assert m.steps < srv_p.metrics.steps / 2
    assert all(r.spec_k == 6 for r in srv._requests.values())


def test_wrong_drafts_roll_back_and_shrink_the_cap_as_jax(engines):
    """Always-rejected drafts: the bonus token is the plain prediction, so
    the output is the plain engine's; whole rejected pages are dropped and
    the cap shrinks to 1 on the JAX engine's trajectory."""
    rs = np.random.RandomState(29)
    prompts = [rs.randint(1, 254, int(n)) for n in (7, 12)]
    new = [20, 20]
    kw = dict(max_batch_size=2, block_size=4, num_blocks=64,
              max_model_len=128, prefix_cache=True)
    plain, _ = _serve(engines, prompts, new, jax_too=False, **kw)
    spec, srv = _serve(engines, prompts, new, spec_tokens=8,
                       drafter=_WrongDrafter(255), **kw)
    assert spec == plain
    m = srv.metrics
    assert m.spec_drafted > 0 and m.spec_accept_rate < 0.2
    assert all(r.spec_k == 1 for r in srv._requests.values())
    assert m.spec_pages_dropped > 0


def test_rejected_draft_pages_never_enter_the_content_index(engines):
    """Every key in the prefix cache's index chains over tokens some
    request committed: a page that held rejected drafts is never
    indexed."""
    rs = np.random.RandomState(31)
    prompts = [rs.randint(1, 254, int(n)) for n in (9, 6)]
    _, srv = _serve(engines, prompts, [22, 18], spec_tokens=8,
                    drafter=_WrongDrafter(255), max_batch_size=2,
                    block_size=4, num_blocks=64, max_model_len=128,
                    prefix_cache=True)
    assert srv.metrics.spec_drafted > 0
    pool = srv.block_pool
    allowed = set()
    for req in srv._requests.values():
        allowed.update(pool.prefix_block_hashes(req.resume_tokens))
    assert set(pool._hash_to_block) <= allowed


def test_speculation_degrades_under_prefill_pressure(engines):
    """An 8-token budget with long prompts chunking through it: verify
    rows spend only what the grants leave, every request finishes, and
    the output is the plain engine's and the JAX engine's."""
    rs = np.random.RandomState(37)
    prompts = [rs.randint(1, 256, int(n)) for n in (50, 8, 60, 6)]
    new = [10, 16, 8, 14]
    kw = dict(max_batch_size=4, block_size=8, num_blocks=64,
              max_model_len=128, prefix_cache=True,
              prefill_chunk_tokens=8, prefill_token_budget=8)
    plain, _ = _serve(engines, prompts, new, jax_too=False, **kw)
    spec, srv = _serve(engines, prompts, new, spec_tokens=8, **kw)
    assert spec == plain
    assert all(s == "finished" for s, _, _, _ in spec)
    assert srv.compile_counts == {"mixed_step": 1}


def test_bucketed_widths_with_speculation_run_no_new_width(engines):
    """mixed_step_buckets with verify rows: every step runs at a width of
    the bucket set (the tracer's spans), compile_counts stays within it,
    and the tokens are the JAX engine's and the plain engine's."""
    rs = np.random.RandomState(43)
    prompts = [rs.randint(1, 256, int(n)) for n in (10, 7)]
    new = [18, 22]
    kw = dict(max_batch_size=2, block_size=8, num_blocks=48,
              max_model_len=128, prefix_cache=True, mixed_step_buckets=True)
    plain, _ = _serve(engines, prompts, new, jax_too=False, **kw)
    spec, srv = _serve(engines, prompts, new, spec_tokens=6, trace=True,
                       **kw)
    assert spec == plain
    widths = {e["args"]["width"] for e in srv.tracer.events()
              if e["name"] == "mixed_step"}
    assert widths <= set(srv.mixed_step_widths)
    assert any(e["args"]["verify_tokens"] for e in srv.tracer.events()
               if e["name"] == "mixed_step")
    assert srv.compile_counts["mixed_step"] <= len(srv.mixed_step_widths)
    assert srv.perf.recompile_total == 0


def test_speculation_status_matches_jax(engines):
    jeng, teng = engines
    rs = np.random.RandomState(47)
    prompt = rs.randint(1, 256, 10)
    kw = dict(spec_tokens=4, max_batch_size=2, block_size=8, num_blocks=32,
              max_model_len=64)
    _, srv = _serve(engines, [prompt], [16], **kw)
    jsrv = JaxServingEngine(jeng, JaxServingConfig(**kw))
    jsrv.submit(prompt, max_new_tokens=16)
    jsrv.run()
    st_ = srv.speculation_status()
    assert st_ == jsrv.speculation_status()
    assert st_["enabled"] and st_["drafter"] == "prompt_lookup"
    assert st_["drafted"] == srv.metrics.spec_drafted > 0
    off = dict(kw, spec_tokens=0)
    assert dt.ServingEngine(teng, dt.ServingConfig(**off)) \
        .speculation_status() == \
        JaxServingEngine(jeng, JaxServingConfig(**off)).speculation_status()
