"""The port's two-program serving engine and its prefix cache against the
JAX ServingEngine.

Same seeded traffic, same weights (through the weight bridge), fp32 and
greedy sampling. For every case the port's ``mixed_step=False`` engine must
be token-identical, with identical terminal states, finish reasons and
preemption counts, to the JAX engine with ``mixed_step=False`` and to the
port's own unified engine; with the prefix cache the hit, cached-token and
copy-on-write counters must equal the JAX engine's; every run ends with
zero pages in use and a consistent pool. With the inference config's
``enable_cuda_graph`` the two-program engine runs its forwards over
static buffers (captured only on a CUDA device) and must serve the same
tokens as without it and as the JAX engine. The model-level test holds the
three paged branches of the port's Llama (from-empty prefill, chunk,
decode) against the JAX model's logits at 1e-4 (fp32; the int8 pool's
codes are the same in both, so the same tolerance holds). The prefix
cache, defragmentation, copy-on-write and static-forward cases are in
``test_torch_serving_legacy_prefix.py`` (a file of its own so that
pytest-xdist's ``--dist loadfile`` runs the two halves on two workers).
"""

import dataclasses

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
from deepspeed_tpu.models.layers import paged_cache_index as jax_paged_index
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.models import layers as layers_mod
from deepspeed_tpu_torch.models.layers import paged_cache_index
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(max_batch_size=4, block_size=8, num_blocks=48, max_model_len=96)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig.tiny(remat=False)
    params = jax.jit(JaxLlama(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.device_get(params)


def _engines(weights, model_over=None, **inference_kw):
    """A JAX and a port inference engine on the same weights."""
    over = model_over or {}
    jeng = jds.init_inference(JaxLlama(JaxConfig.tiny(remat=False, **over)),
                              params=weights, dtype="fp32", **inference_kw)
    cfg = LlamaConfig.tiny(**over)
    teng = dt.init_inference(
        LlamaForCausalLM(cfg), params=flax_to_torch_state_dict(weights, cfg),
        dtype="fp32", device="cpu", **inference_kw)
    return jeng, teng


def _serve(srv, phases):
    """Submit each phase's requests together and drain before the next
    (pages index as chunks land, so a later phase can hit an earlier
    one's pages)."""
    out = []
    for phase in phases:
        rids = [srv.submit(p, max_new_tokens=n) for p, n in phase]
        res = srv.run()
        out += [(res[r].state, res[r].finish_reason, res[r].tokens,
                 res[r].preemptions) for r in rids]
    return out


def _shared_prefix_phases(rs, new=6):
    """A seed request, then a batch sharing its 24-token prefix (one of
    them the identical prompt), then a multi-turn replay: the seed's
    prompt plus its answer plus a new turn."""
    prefix = list(rs.randint(1, 256, 24))
    seed = prefix + list(rs.randint(1, 256, 5))
    batch = [(prefix + list(rs.randint(1, 256, n)), new) for n in (3, 9, 17)]
    return seed, [[(seed, 8)], batch + [(seed, 4)]]


def _mixed_lens(rs):
    return [[(list(rs.randint(1, 256, n)), m) for n, m in
             ((3, 5), (18, 9), (11, 4), (33, 7), (7, 6), (40, 8), (25, 5))]]


CASES = {
    # chunked prefill of 1..5 chunks, more requests than slots
    "chunked": dict(serving=dict(prefill_chunk_tokens=8,
                                 prefill_token_budget=16),
                    traffic=_mixed_lens),
    # one chunk per step, chunk no multiple of the page
    "chunk_budget_one": dict(serving=dict(prefill_chunk_tokens=12),
                             traffic=_mixed_lens),
    # the monolithic prefill, padded to powers of two from 8
    "monolithic": dict(serving={}, traffic=_mixed_lens),
    "monolithic_flash": dict(serving={}, traffic=_mixed_lens,
                             model=dict(prefill_flash_from_empty=True)),
    "monolithic_bucket32": dict(serving=dict(prefill_bucket_min=32),
                                traffic=_mixed_lens),
    # 10 pages for 4 slots of up to 6 pages each: decoders must preempt
    "preemption": dict(serving=dict(prefill_chunk_tokens=8,
                                    prefill_token_budget=16, num_blocks=10),
                       traffic=lambda rs: [[
                           (list(rs.randint(1, 256, n)), 12)
                           for n in (17, 21, 14, 19)]]),
    "int8_pool": dict(serving=dict(prefill_chunk_tokens=8,
                                   prefill_token_budget=16),
                      traffic=_mixed_lens,
                      inference=dict(kv_cache_int8=True)),
    "int8_pool_monolithic": dict(serving={}, traffic=_mixed_lens,
                                 inference=dict(kv_cache_int8=True)),
    "window": dict(serving=dict(prefill_chunk_tokens=8,
                                prefill_token_budget=16),
                   traffic=_mixed_lens, model=dict(sliding_window=12)),
    "window_monolithic_flash": dict(
        serving={}, traffic=_mixed_lens,
        model=dict(sliding_window=12, prefill_flash_from_empty=True)),
}

PREFIX_CASES = {
    "shared_prefix": dict(serving=dict(prefill_chunk_tokens=8,
                                       prefill_token_budget=16)),
    # the chunk derived from the page size (4 * block_size)
    "derived_chunk": dict(serving={}),
    # 10 pages and long answers: the warm LRU must be evicted and
    # decoders preempted (their hashed pages park on the LRU)
    "prefix_preemption": dict(serving=dict(prefill_chunk_tokens=8,
                                           prefill_token_budget=16,
                                           num_blocks=10), new=20),
    "prefix_int8": dict(serving=dict(prefill_chunk_tokens=8,
                                     prefill_token_budget=16),
                        inference=dict(kv_cache_int8=True)),
}


def _check_drained(srv):
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0, "leaked pages"


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_program_engine_matches_jax_and_unified(weights, case):
    spec = CASES[case]
    jeng, teng = _engines(weights, spec.get("model"),
                          **spec.get("inference", {}))
    phases = spec["traffic"](np.random.RandomState(7))
    kw = dict(BASE, **spec["serving"])
    jsrv = JaxServingEngine(jeng, JaxServingConfig(mixed_step=False, **kw))
    tsrv = dt.ServingEngine(teng, dt.ServingConfig(mixed_step=False, **kw))
    usrv = dt.ServingEngine(teng, dt.ServingConfig(**kw))
    want = _serve(jsrv, phases)
    got = _serve(tsrv, phases)
    assert got == want
    assert all(state == "finished" for state, _, _, _ in got)
    assert tsrv.metrics.preemptions == jsrv.metrics.preemptions
    if case == "preemption":
        assert tsrv.metrics.preemptions > 0, "pool sized to force preemption"
        # the unified engine packs differently, so it preempts at other
        # steps: its tokens match, its preemption counts need not
        assert [g[:3] for g in got] == [u[:3] for u in _serve(usrv, phases)]
    else:
        assert got == _serve(usrv, phases)
    chunked = bool(spec["serving"].get("prefill_chunk_tokens"))
    assert (tsrv.prefill_chunk_calls > 0) == chunked
    assert (tsrv.prefill_calls > 0) == (not chunked)
    assert tsrv.decode_calls > 0 and tsrv.compile_counts == {}
    for srv in (tsrv, usrv):
        _check_drained(srv)


def test_sampling_is_seeded_in_the_two_program_engine(weights):
    """``do_sample`` draws from the engine's seeded generator over all
    slots of the decode forward: two engines with one seed agree, and
    every request finishes with its token budget."""
    _, teng = _engines(weights)
    rs = np.random.RandomState(17)
    phases = [[(list(rs.randint(1, 256, n)), 6) for n in (5, 19, 11)]]
    kw = dict(BASE, mixed_step=False, prefill_chunk_tokens=8, do_sample=True,
              temperature=0.8, top_k=20, seed=3)
    a = _serve(dt.ServingEngine(teng, dt.ServingConfig(**kw)), phases)
    b = _serve(dt.ServingEngine(teng, dt.ServingConfig(**kw)), phases)
    assert a == b and all(len(t) == 6 and s == "finished"
                          for s, _, t, _ in a)


def test_two_program_engine_goes_through_the_kernel_wrappers(weights,
                                                             monkeypatch):
    """One K7b call per layer per chunk, one K7a call per layer per decode
    step, over all slots (idle slots ride as sentinel rows), none of K6;
    with the flash flag one masked K1 call per layer per monolithic
    prefill. The wrappers take their plain versions for CPU tensors."""
    _, teng = _engines(weights)
    layers = teng.module.config.num_hidden_layers
    calls = {"decode": [], "chunk": [], "ragged": [], "flash": []}

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls[name].append(args[0].shape)
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(layers_mod, "paged_decode_attention",
                        spy("decode", layers_mod.paged_decode_attention))
    monkeypatch.setattr(layers_mod, "paged_prefill_attention",
                        spy("chunk", layers_mod.paged_prefill_attention))
    monkeypatch.setattr(layers_mod, "ragged_paged_attention",
                        spy("ragged", layers_mod.ragged_paged_attention))
    monkeypatch.setattr(layers_mod, "flash_prefill_from_empty",
                        spy("flash", layers_mod.flash_prefill_from_empty))
    rs = np.random.RandomState(3)
    phases = [[(list(rs.randint(1, 256, n)), 4) for n in (9, 30)]]
    srv = dt.ServingEngine(teng, dt.ServingConfig(
        mixed_step=False, prefill_chunk_tokens=8, **BASE))
    _serve(srv, phases)
    assert len(calls["chunk"]) == layers * srv.prefill_chunk_calls > 0
    assert len(calls["decode"]) == layers * srv.decode_calls > 0
    assert {tuple(s) for s in calls["decode"]} == {(4, 4, 16)}, "all slots"
    assert {tuple(s) for s in calls["chunk"]} == {(1, 8, 4, 16)}
    assert not calls["ragged"] and not calls["flash"]
    feng = dt.init_inference(
        LlamaForCausalLM(dataclasses.replace(
            teng.module.config, prefill_flash_from_empty=True)),
        params=teng.module.state_dict(), dtype="fp32", device="cpu")
    fsrv = dt.ServingEngine(feng, dt.ServingConfig(mixed_step=False, **BASE))
    _serve(fsrv, phases)
    assert len(calls["flash"]) == layers * fsrv.prefill_calls == layers * 2
    assert {tuple(s)[1] for s in calls["flash"]} == {16, 32}, "pow2 buckets"


@pytest.mark.parametrize("int8", [False, True], ids=["fp32_pool", "int8_pool"])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_paged_branches_match_jax_logits(weights, int8, flash):
    """The three paged branches of the model against the JAX model on one
    pool: a from-empty prefill of two padded rows, a chunk behind it, and
    a decode over all rows with an idle sentinel row. Logits at real
    positions within 1e-4 (fp32 math; int8 pools hold the same codes)."""
    over = dict(prefill_flash_from_empty=flash)
    jcfg = JaxConfig.tiny(remat=False, **over)
    jmodel = JaxLlama(jcfg)
    cfg = LlamaConfig.tiny(**over)
    tmodel = LlamaForCausalLM(cfg)
    tmodel.load_state_dict(flax_to_torch_state_dict(weights, cfg),
                           assign=True)
    N, bs, nb = 12, 8, 4
    jpool = jmodel.init_paged_cache(N, bs, dtype=jnp.int8 if int8
                                    else jnp.float32)
    tpool = tmodel.init_paged_cache(N, bs, dtype=torch.int8 if int8
                                    else torch.float32)
    rs = np.random.RandomState(21)
    tables = np.full((3, nb), N, np.int32)
    tables[0, :3] = [5, 2, 9]
    tables[1, :2] = [7, 1]

    def both(ids, rows, append_pos, clen, chunk_start=None):
        nonlocal jpool
        kw = {} if chunk_start is None else {"chunk_start": chunk_start}
        jl, jpool = jmodel.apply(
            {"params": weights}, jnp.asarray(ids), cache=jpool,
            cache_index=jax_paged_index(tables[rows], append_pos, clen, **kw))
        with torch.no_grad():
            tl, _ = tmodel(torch.from_numpy(ids).long(), cache=tpool,
                           cache_index=paged_cache_index(
                               tables[rows], append_pos, clen, **kw))
        return np.asarray(jl), tl.numpy()

    # from-empty prefill: rows of 11 and 6 tokens padded to 16
    lens = np.array([11, 6])
    ids = rs.randint(1, 256, (2, 16)).astype(np.int32)
    ar = np.arange(16)[None]
    pos = np.where(ar < lens[:, None], ar, -1)
    jl, tl = both(ids, [0, 1], pos, lens)
    for b, L in enumerate(lens):
        np.testing.assert_allclose(tl[b, :L], jl[b, :L], rtol=1e-4, atol=1e-4)
    # a chunk of 5 (padded to 8) behind row 0's 11 tokens
    ids = rs.randint(1, 256, (1, 8)).astype(np.int32)
    pos = np.where(np.arange(8)[None] < 5, 11 + np.arange(8)[None], -1)
    jl, tl = both(ids, [0], pos, np.array([16]), chunk_start=np.array([11]))
    np.testing.assert_allclose(tl[0, :5], jl[0, :5], rtol=1e-4, atol=1e-4)
    # decode over three slots: rows 0 and 1 live, row 2 an idle sentinel
    seq = np.array([16, 6, 0])
    ids = rs.randint(1, 256, (3, 1)).astype(np.int32)
    before = {n: t.clone() for n, t in tpool.items()}
    jl, tl = both(ids, [0, 1, 2], seq[:, None], seq + 1)
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=1e-4, atol=1e-4)
    assert np.isfinite(tl).all()
    # the idle row appended nothing: only pages 9 (row 0) and 7 (row 1)
    # changed, and the pools agree
    changed = {int(p) for n in ("k", "v") for p in
               (tpool[n] != before[n]).flatten(2).any(-1).any(0).nonzero()}
    assert changed == {9, 7}
    for name in tpool:
        np.testing.assert_allclose(tpool[name].numpy().astype(np.float32),
                                   np.asarray(jpool[name], np.float32),
                                   rtol=1e-5, atol=1e-5)
