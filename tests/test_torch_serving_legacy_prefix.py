"""The port's two-program serving engine with the prefix cache, page
defragmentation and copy-on-write, and its static (graph-ready) forwards,
against the JAX ServingEngine.

The cases, weights and helpers are ``test_torch_serving_legacy.py``'s (a
file of its own so that pytest-xdist's ``--dist loadfile`` runs the two
halves on two workers): the same seeded traffic and weights, fp32 and
greedy sampling; tokens, terminal states, finish reasons, preemptions and
the prefix counters equal to the JAX engine's; every run ends with zero
pages in use and a consistent pool.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.models import LlamaForCausalLM
from test_torch_serving_legacy import (BASE, CASES, PREFIX_CASES,  # noqa: F401
                                       _check_drained, _engines, _serve,
                                       _shared_prefix_phases, weights)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mixed", [False, True],
                         ids=["two_program", "unified"])
@pytest.mark.parametrize("case", sorted(PREFIX_CASES))
def test_prefix_cache_matches_jax(weights, case, mixed):
    """Shared-prefix traffic and a multi-turn replay with the prefix cache
    on, in both engines of the port, against the JAX engine of the same
    kind and against the port without the cache."""
    spec = PREFIX_CASES[case]
    jeng, teng = _engines(weights, **spec.get("inference", {}))
    rs = np.random.RandomState(11)
    seed, phases = _shared_prefix_phases(rs, spec.get("new", 6))
    kw = dict(BASE, mixed_step=mixed, **spec["serving"])
    jsrv = JaxServingEngine(jeng, JaxServingConfig(prefix_cache=True, **kw))
    tsrv = dt.ServingEngine(teng, dt.ServingConfig(prefix_cache=True, **kw))
    want = _serve(jsrv, phases)
    got = _serve(tsrv, phases)
    # multi-turn: the seed's prompt + its answer + a new turn hits pages
    # that DECODE filled
    turn = [[(seed + got[0][2] + list(rs.randint(1, 256, 4)), 5)]]
    want += _serve(jsrv, turn)
    got += _serve(tsrv, turn)
    assert got == want
    assert all(state == "finished" for state, _, _, _ in got)
    jm, tm = jsrv.metrics, tsrv.metrics
    assert (tm.prefix_hits, tm.cached_prefill_tokens, tm.cow_copies,
            tm.preemptions, tm.prefill_tokens_computed) == \
        (jm.prefix_hits, jm.cached_prefill_tokens, jm.cow_copies,
         jm.preemptions, jm.prefill_tokens_computed)
    assert tm.prefix_hits >= 4 and tm.cached_prefill_tokens >= 4 * 24
    assert tm.prefill_tokens == \
        tm.prefill_tokens_computed + tm.cached_prefill_tokens
    assert tsrv.block_pool.evictions == jsrv.block_pool.evictions
    if case == "prefix_preemption":
        assert tsrv.block_pool.evictions > 0 and tm.preemptions > 0
    _check_drained(tsrv)
    assert tsrv.block_pool.cached_count == jsrv.block_pool.cached_count > 0, \
        "a warm LRU, not a leak"
    # the cache changes what is computed, never what is generated
    plain = dt.ServingEngine(teng, dt.ServingConfig(**kw))
    assert [g[:3] for g in got] == [p[:3] for p in _serve(plain,
                                                          phases + turn)]
    assert tsrv.block_pool.drop_cached() == tm.blocks_cached
    assert tsrv.block_pool.free_count == tsrv.block_pool.num_blocks


@pytest.mark.parametrize("mixed", [False, True],
                         ids=["two_program", "unified"])
def test_defrag_mid_run_moves_pages_and_changes_no_token(weights, mixed):
    """Compaction with residents mid-prefill and mid-decode and a warm
    LRU: pages move on the device, tables and the content index follow,
    and the tokens equal the JAX engine's (defragmented at the same step)
    and an undisturbed run's."""
    jeng, teng = _engines(weights)
    rs = np.random.RandomState(13)
    seed, phases = _shared_prefix_phases(rs)
    kw = dict(BASE, mixed_step=mixed, prefix_cache=True,
              prefill_chunk_tokens=8, prefill_token_budget=16)

    def run(srv, defrag):
        _serve(srv, phases[:1])            # leaves a warm LRU behind
        # a one-token request takes the lowest blank page and returns it
        # at once: a hole below the pages of the requests behind it
        srv.submit([5, 6, 7], max_new_tokens=1)
        rids = [srv.submit(p, max_new_tokens=n) for p, n in phases[1][:3]]
        moved = []
        for step in range(400):
            if not srv.has_work():
                break
            if defrag and step in (1, 2, 3, 9):
                moved.append(srv.defrag())
            srv.step()
        return [(srv.poll(r).state, srv.poll(r).tokens) for r in rids], moved

    tsrv = dt.ServingEngine(teng, dt.ServingConfig(**kw))
    got, moved = run(tsrv, True)
    want, jmoved = run(JaxServingEngine(jeng, JaxServingConfig(**kw)), True)
    assert got == want and moved == jmoved and max(moved) > 0
    assert got == run(dt.ServingEngine(teng, dt.ServingConfig(**kw)),
                      False)[0]
    assert all(state == "finished" for state, _ in got)
    _check_drained(tsrv)
    live = tsrv.block_pool.cached_count
    assert tsrv.defrag() >= 0 and tsrv.block_pool.cached_count == live
    tsrv.block_pool.check_consistent()


def test_shared_page_is_copied_before_an_append(weights):
    """Copy-on-write in the engine: a page another owner still references
    is forked and copied on the device before the chunk that would append
    into it; the shared page keeps its content and its other owner."""
    _, teng = _engines(weights)
    srv = dt.ServingEngine(teng, dt.ServingConfig(
        mixed_step=False, prefix_cache=True, prefill_chunk_tokens=8, **BASE))
    rid = srv.submit(list(range(1, 21)), max_new_tokens=4)
    srv.step()
    srv.step()                                   # two chunks of 8 are in
    req = srv._requests[rid]
    assert req.prefill_done == 16
    shared = req.blocks[2]
    srv.block_pool.acquire([shared], "someone-else")
    srv.pool["k"][:, shared] = 7.0
    srv.step()              # the last chunk and a decode append into page 2
    assert srv.metrics.cow_copies == 1 and req.blocks[2] != shared
    assert torch.all(srv.pool["k"][:, shared] == 7.0), "never mutated"
    assert torch.all(srv.pool["k"][:, req.blocks[2], :, 5:] == 7.0), \
        "the fork carries the page's content"
    assert not torch.any(srv.pool["k"][:, req.blocks[2], :, :5] == 7.0)
    assert srv.block_pool.ref_count(shared) == 1
    srv.run()
    srv.block_pool.free([shared], "someone-else")
    _check_drained(srv)


GRAPH_CASES = {
    "chunked": (CASES["chunked"], False),
    "monolithic_flash": (CASES["monolithic_flash"], False),
    "preemption": (CASES["preemption"], False),
    "prefix_preemption": (PREFIX_CASES["prefix_preemption"], True),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_static_forwards_serve_the_jax_tokens(weights, case):
    """The two-program engine with ``enable_cuda_graph`` (its decode,
    chunk and monolithic forwards over static index buffers; on the CPU
    nothing is captured) serves the JAX two-program engine's tokens, and
    its own without the flag, with the prefix cache and through
    preemptions; the forward counts are the same and no page leaks."""
    spec, cached = GRAPH_CASES[case]
    rs = np.random.RandomState(19)
    if cached:
        _, phases = _shared_prefix_phases(rs, spec.get("new", 6))
    else:
        phases = spec["traffic"](rs)
    kw = dict(BASE, mixed_step=False, prefix_cache=cached, **spec["serving"])
    jeng, teng = _engines(weights, spec.get("model"),
                          **spec.get("inference", {}))
    geng = dt.init_inference(
        LlamaForCausalLM(teng.module.config),
        params=teng.module.state_dict(), dtype="fp32", device="cpu",
        enable_cuda_graph=True, **spec.get("inference", {}))
    want = _serve(JaxServingEngine(jeng, JaxServingConfig(**kw)), phases)
    runs = {}
    for name, eng in (("plain", teng), ("static", geng)):
        srv = dt.ServingEngine(eng, dt.ServingConfig(**kw))
        runs[name] = (_serve(srv, phases), srv.decode_calls,
                      srv.prefill_chunk_calls, srv.prefill_calls,
                      srv.metrics.preemptions, srv.metrics.prefix_hits)
        _check_drained(srv)
        assert not srv._graphs, "nothing is captured on the CPU"
        assert srv._legacy_static
    assert runs["static"] == runs["plain"]
    assert runs["static"][0] == want
    if "preemption" in case:
        assert runs["static"][4] > 0
    if cached:
        assert runs["static"][5] > 0
