"""The port's host KV tier against the JAX package's
(``tests/unit/serving/test_kv_tiers.py``).

``HostTier`` is pure host Python in both packages: the same random
sequences of puts, gets, evictions and device drops must leave both tiers
with the same entries in the same order, the same probation segment and
the same ``stats()``. The block-pool scenarios (demotion into probation,
a match that continues into the host tier, ``drop_cached``, the
consistency check) run on each package's classes and compare what they
observed. The engine scenarios run a JAX and a port engine on the same
weights (tiny Llama, fp32, greedy) through the same traffic: the tokens,
finish reasons and tier counters must be equal, the promoted pool pages
equal to their demoted payloads bit for bit and within ``PAGE_TOL`` of
the JAX engine's, and every scenario ends with zero pages leaked and no
host entry stranded. An unlanded copy is simulated by
patching the engines' "has it landed" test (``_landed`` in the port,
``_tree_ready`` in the JAX engine). The watchdog scenarios run the port
on a virtual clock (its watchdog judges ``perf_counter`` deadlines) and
the JAX engine on the real one, with a 1 s budget and stalls of 2 s, so
that nothing but the stall comes near the budget while other test
processes load the machine.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as jds
from deepspeed_tpu.inference.serving import ServingConfig as JaxServingConfig
from deepspeed_tpu.inference.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.inference.serving import block_pool as jax_pool
from deepspeed_tpu.inference.serving import engine as jax_engine_mod
from deepspeed_tpu.inference.serving import kv_tiers as jax_tiers
from deepspeed_tpu.models import LlamaConfig as JaxConfig
from deepspeed_tpu.models import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.utils import fault_injection as jax_faults
import deepspeed_tpu_torch as dt
from deepspeed_tpu_torch.checkpoint.from_flax import flax_to_torch_state_dict
from deepspeed_tpu_torch.inference.serving import block_pool as port_pool
from deepspeed_tpu_torch.inference.serving import engine as engine_mod
from deepspeed_tpu_torch.inference.serving import kv_tiers as port_tiers
from deepspeed_tpu_torch.inference.serving import scheduler as sched_mod
from deepspeed_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.utils import fault_injection as faults
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.serving

#: a tiered engine that needs more steps than this to drain has wedged
MAX_DRAIN_STEPS = 400


# ---------------------------------------------------------------------------
# the tier alone
# ---------------------------------------------------------------------------


class _Key:
    """ChainKey stand-in: hashable by identity, with a ``prev`` link."""

    def __init__(self, name, prev=None):
        self.name, self.prev = name, prev

    def __repr__(self):
        return f"_Key({self.name})"


def _np_page(n=8):
    return {"k": np.zeros((2, 1, n), np.float32)}


def _torch_page(n=8):
    return {"k": torch.zeros((2, 1, n))}


SIDES = {"jax": (jax_tiers.HostTier, _np_page),
         "port": (port_tiers.HostTier, _torch_page)}


def _tier_state(tier):
    return (tier.keys(), list(tier._probation), tier.stats(),
            tier._probation_bytes)


@pytest.mark.parametrize("seed", range(8))
def test_host_tier_equals_jax_on_random_sequences(seed):
    """Random puts (sizes and probation drawn), gets, consuming evictions,
    capacity evictions and device drops over keys forming chains, with a
    changing set of device-live keys: after every operation both tiers
    return the same value and hold the same entries in the same LRU and
    probation order with the same stats, and ``check`` agrees."""
    rs = np.random.RandomState(seed)
    unit = 2 * 8 * 4
    budgets = [dict(max_blocks=int(rs.randint(2, 7))),
               dict(max_bytes=int(rs.randint(3, 9)) * unit),
               dict(max_blocks=int(rs.randint(2, 7)),
                    max_bytes=int(rs.randint(4, 9)) * unit)]
    budget = budgets[seed % 3]
    live = set()
    tiers = {side: cls(device_live=lambda k: k in live, **budget)
             for side, (cls, _) in SIDES.items()}
    keys = []
    for i in range(24):
        prev = keys[rs.randint(len(keys))] if keys and rs.rand() < 0.7 \
            else None
        keys.append(_Key(f"k{i}", prev))
    for _ in range(300):
        op = rs.randint(6)
        key = keys[rs.randint(len(keys))]
        out = dict.fromkeys(SIDES)
        if op in (0, 1):
            n = int(rs.choice([8, 8, 8, 16, 40]))
            probation = bool(rs.rand() < 0.5)
            for side, (_, page) in SIDES.items():
                out[side] = tiers[side].put(key, page(n),
                                            probation=probation)
        elif op == 2:
            for side in SIDES:
                out[side] = tiers[side].get(key) is not None
        elif op == 3:
            for side in SIDES:
                out[side] = tiers[side].evict(key)
        elif op == 4:
            for side in SIDES:
                out[side] = tiers[side]._evict(key, count_eviction=True)
        else:
            (live.add if rs.rand() < 0.5 else live.discard)(key)
            if key not in live:
                for side in SIDES:
                    out[side] = tiers[side].on_device_drop(key)
        assert out["port"] == out["jax"]
        assert _tier_state(tiers["port"]) == _tier_state(tiers["jax"])
        errs = {}
        for side, tier in tiers.items():
            try:
                tier.check()
                errs[side] = None
            except RuntimeError as e:
                errs[side] = str(e)
        assert errs["port"] == errs["jax"]


@pytest.mark.parametrize("kw", [{}, {"max_blocks": -1},
                                {"max_blocks": 4, "max_bytes": 0}])
def test_host_tier_capacity_validation_matches_jax(kw):
    for cls, _ in SIDES.values():
        with pytest.raises(ValueError):
            cls(**kw)


def test_host_tier_probation_policy_as_jax():
    """The JAX suite's probation scenario on both tiers: probation pays
    for capacity first, a hit promotes, a probation newcomer never evicts
    a protected entry (blocks and bytes)."""
    out = {}
    for side, (cls, page) in SIDES.items():
        t = cls(max_blocks=2)
        prot, p1, p2 = _Key("prot"), _Key("p1"), _Key("p2")
        t.put(prot, page())
        t.put(p1, page(), probation=True)
        t.put(p2, page(), probation=True)
        assert t.contains(prot) and t.contains(p2) and not t.contains(p1)
        assert t.get(p2) is not None
        churn = [t.put(_Key(f"c{i}"), page(), probation=True)
                 for i in range(4)]
        assert churn == [False] * 4 and t.probation_rejected == 4
        t.put(_Key("prot2"), page())
        unit = port_tiers.payload_nbytes(page())
        t3 = cls(max_bytes=3 * unit)
        pa, pb, q1 = _Key("pa"), _Key("pb"), _Key("q1")
        t3.put(pa, page())
        t3.put(pb, page())
        t3.put(q1, page(), probation=True)
        big = t3.put(_Key("big"), page(16), probation=True)
        q2 = t3.put(_Key("q2"), page(), probation=True)
        t.check()
        t3.check()
        out[side] = ([k.name for k in t.keys()], t.stats(), big, q2,
                     [k.name for k in t3.keys()], t3.stats())
    assert out["port"] == out["jax"]
    assert out["port"][2] is False and out["port"][3] is True


# ---------------------------------------------------------------------------
# the block pool with a tier attached
# ---------------------------------------------------------------------------


POOLS = {"jax": (jax_pool, jax_tiers, _np_page),
         "port": (port_pool, port_tiers, _torch_page)}


def _chain(key):
    out = []
    while key is not None:
        out.append(tuple(int(t) for t in key.tokens))
        key = key.prev
    return tuple(reversed(out))


def _tier_sig(tier):
    return [(_chain(k), k in tier._probation) for k in tier.keys()]


def _demotion_scenario(pool_mod, tier_mod, page):
    pool = pool_mod.BlockPool(6, 4)
    tier = tier_mod.HostTier(max_blocks=3)
    pool.attach_host_tier(tier, lambda bids: [page() for _ in bids])
    tok_a = list(range(1, 5))
    ha = pool.prefix_block_hashes(tok_a)
    [ba] = pool.allocate(1, "w")
    pool.commit_hash(ba, ha[0])
    pool.free([ba], "w")
    m = pool.match_prefix(tok_a + [9], ha)
    pool.acquire(m, "r2")
    pool.free(m, "r2")
    for i in range(3):
        tok = [100 + 4 * i + j for j in range(4)]
        [b] = pool.allocate(1, f"s{i}")
        pool.commit_hash(b, pool.prefix_block_hashes(tok)[0])
        pool.free([b], f"s{i}")
    bb = pool.allocate(6, "churn")
    trace = [_tier_sig(tier), pool.demotions, tier.stats()]
    pool.free(bb, "churn")
    pool.check_consistent()
    [nb] = pool.allocate(1, "c")
    assert tier.get(ha[0]) is not None
    pool.commit_hash(nb, ha[0])
    trace.append((tier.contains(ha[0]), tier.promotions))
    pool.free([nb], "c")
    pool.allocate(6, "churn2")
    trace += [_tier_sig(tier), tier.stats()]
    pool.check_consistent()
    # a three-block chain demoted whole, matched across tiers
    pool2 = pool_mod.BlockPool(4, 4)
    tier2 = tier_mod.HostTier(max_blocks=16)
    pool2.attach_host_tier(tier2, lambda bids: [page() for _ in bids])
    tokens = list(range(1, 13))
    hashes = pool2.prefix_block_hashes(tokens)
    blocks = pool2.allocate(3, "a")
    for bid, h in zip(blocks, hashes):
        pool2.commit_hash(bid, h)
    pool2.free(blocks, "a")
    pool2.free(pool2.allocate(4, "b"), "b")
    trace += [pool2.demotions, len(tier2),
              pool2.match_prefix(tokens, hashes),
              # the at-least-one-computed-token cap holds across tiers
              [_chain(h) for h in pool2.host_match_keys(len(tokens) + 1,
                                                        hashes, 0)],
              len(pool2.host_match_keys(len(tokens), hashes, 0))]
    pool2.check_consistent()
    [nb] = pool2.allocate(1, "c")
    pool2.commit_hash(nb, hashes[0])
    trace += [tier2.contains(hashes[0]), tier2.contains(hashes[1]),
              tier2.promotions]
    pool2.check_consistent()
    return trace


def test_pool_demotion_probation_and_cross_tier_match():
    """Pages that never served a match demote into probation, a matched
    page demotes protected; a demoted chain is matched across tiers under
    the at-least-one-token cap; a device commit consumes its host entry
    (and re-demotes protected). The same trace on both packages."""
    want = _demotion_scenario(*POOLS["jax"])
    got = _demotion_scenario(*POOLS["port"])
    assert got == want
    assert got[1] > 0 and got[-3:] == [False, True, 1]
    # the matched page demoted protected, the single-use ones probation
    assert sorted(p for _, p in got[0]) == [False, True, True]


def _drop_cached_scenario(pool_mod, tier_mod, page):
    pool = pool_mod.BlockPool(4, 4)
    tier = tier_mod.HostTier(max_blocks=16)
    pool.attach_host_tier(tier, lambda bids: [page() for _ in bids])
    blocks = pool.allocate(2, "a")
    for bid, h in zip(blocks, pool.prefix_block_hashes(list(range(1, 9)))):
        pool.commit_hash(bid, h)
    pool.free(blocks, "a")
    pool.allocate(3, "b")              # one page demotes
    demoted = (len(tier), pool.demotions)
    dropped = pool.drop_cached()
    pool.check_consistent()
    return demoted, dropped, len(tier), pool.demotions


def test_drop_cached_clears_both_tiers_without_demoting():
    """A replica kill's cold restart: the still-cached device page drops
    without demoting and the host tier empties, as in JAX."""
    want = _drop_cached_scenario(*POOLS["jax"])
    got = _drop_cached_scenario(*POOLS["port"])
    assert got == want == ((1, 1), 1, 0, 1)


def _plant(tier, key, page):
    tier._lru[key] = page()
    tier._nbytes[key] = port_tiers.payload_nbytes(page())
    tier._canon[key] = key
    tier.bytes += port_tiers.payload_nbytes(page())


@pytest.mark.parametrize("side", sorted(POOLS))
def test_check_consistent_catches_dual_residency_and_stranding(side):
    pool_mod, tier_mod, page = POOLS[side]
    pool = pool_mod.BlockPool(4, 4)
    tier = tier_mod.HostTier(max_blocks=16)
    pool.attach_host_tier(tier, lambda bids: [page() for _ in bids])
    hashes = pool.prefix_block_hashes(list(range(1, 9)))
    blocks = pool.allocate(2, "a")
    for bid, h in zip(blocks, hashes):
        pool.commit_hash(bid, h)
    pool.check_consistent()
    _plant(tier, hashes[0], page)      # live on the device AND the host
    with pytest.raises(pool_mod.BlockPoolError, match="BOTH tiers"):
        pool.check_consistent()
    tier._evict(hashes[0], count_eviction=False)
    pool.free(blocks, "a")
    pool.check_consistent()
    orphan = pool.prefix_block_hashes(list(range(50, 62)))
    _plant(tier, orphan[1], page)      # its chain parent is in neither tier
    tier._link(orphan[1])
    with pytest.raises(pool_mod.BlockPoolError, match="stranded"):
        pool.check_consistent()


def test_fetch_and_insert_round_trip_bit_for_bit():
    """A demotion wave's payloads are copies of the pages (own storage,
    one page each, every pool tensor of an int8 pool), and folding them
    back lands them bit for bit without rebinding a pool tensor."""
    from deepspeed_tpu_torch.models.layers import init_paged_kv_cache

    g = torch.Generator().manual_seed(0)
    pool = init_paged_kv_cache(8, 4, 2, 16, n_layers=3, dtype=torch.int8)
    for t in pool.values():
        t.copy_(torch.randint(-100, 100, t.shape, generator=g))
    want = {n: t[:, [5, 2, 6]].clone() for n, t in pool.items()}
    pages = port_tiers.fetch_paged_blocks(pool, [5, 2, 6])
    assert [sorted(p) for p in pages] == [sorted(pool)] * 3
    for p in pages:
        for n, t in p.items():
            assert t.shape == (3, 1) + pool[n].shape[2:]
            assert t.untyped_storage().nbytes() == t.nbytes
    ptrs = {n: t.data_ptr() for n, t in pool.items()}
    for t in pool.values():
        t.zero_()
    leaves, event = port_tiers.upload_paged_blocks(pages, torch.device("cpu"))
    assert event is None
    port_tiers.insert_paged_block(pool, [1, 3, 0], leaves)
    for n, t in pool.items():
        assert torch.equal(t[:, [1, 3, 0]], want[n])
        assert t.data_ptr() == ptrs[n]
    assert sum(port_tiers.payload_nbytes(p) for p in pages) == \
        sum(t.nbytes for t in want.values())


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


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


#: the JAX suite's shared tiered engine: a 24-page device pool behind a
#: host tier big enough that churn demotes instead of destroying
TIER = dict(max_batch_size=4, block_size=8, num_blocks=24, max_model_len=64,
            prefix_cache=True, prefill_chunk_tokens=16, host_cache_blocks=96)


def _pair(engines, **kw):
    jeng, teng = engines
    return {"jax": JaxServingEngine(jeng, JaxServingConfig(**kw)),
            "port": dt.ServingEngine(teng, dt.ServingConfig(**kw))}


@pytest.fixture(scope="module")
def tiered(engines):
    """One tiered engine per package, shared by the scenarios in order."""
    return _pair(engines, **TIER)


COUNTERS = ("kv_host_hits", "kv_host_misses", "kv_host_hit_tokens",
            "kv_pages_demoted", "kv_pages_promoted", "kv_promote_cancelled",
            "prefix_hits", "preemptions", "logit_quarantines",
            "watchdog_trips", "requests_failed", "promote_queue_depth")


def _drain(srv):
    steps = 0
    while srv.has_work():
        srv.step()
        steps += 1
        assert steps < MAX_DRAIN_STEPS, "tiered engine wedged"


def _one(srv, prompt, n=6):
    rid = srv.submit(prompt, max_new_tokens=n)
    _drain(srv)
    out = srv.poll(rid)
    srv.forget(rid)
    return out.state, out.finish_reason, out.tokens


def _churn(srv, rs, n=5):
    """Unrelated traffic that rolls the device LRU over: demotions (five
    requests of six pages push a 24-page pool's oldest cached pages
    out)."""
    for _ in range(n):
        assert _one(srv, rs.randint(1, 256, 40), 4)[0] == "finished"


def _invariant(srv):
    srv.block_pool.check_consistent()
    assert srv.block_pool.used_count == 0, "leaked pages"
    if srv.config.mixed_step:
        assert srv.compile_counts == {"mixed_step": 1}, srv.compile_counts
    assert srv.perf.recompile_total == 0


def _both(pair, body):
    """Run ``body(srv)`` on each engine; assert equal results, equal tier
    counters and tier stats, and the invariant (pages, consistency across
    both tiers, one width) on each side. Returns the port's result."""
    out = {}
    for side, srv in pair.items():
        res = body(srv)
        _invariant(srv)
        out[side] = (res, {c: getattr(srv.metrics, c) for c in COUNTERS},
                     srv.host_tier.stats() if srv.host_tier else None)
    assert out["port"] == out["jax"]
    return out["port"][0]


def _reference(engine, prompt, n):
    out = engine.generate(torch.as_tensor(np.asarray(prompt))[None],
                          max_new_tokens=n, do_sample=False)
    return [int(t) for t in out[0]]


def _stuck(monkeypatch, on):
    """Copies that never land (``on``) or land at once."""
    monkeypatch.setattr(jax_engine_mod, "_tree_ready", lambda tree: not on)
    monkeypatch.setattr(engine_mod, "_landed", lambda event: not on)


def _as_np(t):
    return t.double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.float64)


#: promoted pages against the JAX engine's: each side's pages hold what its
#: own fp32 forward appended, and the two forwards differ by a few ulps
#: (2.4e-6 measured on these pages; the port's own payloads fold back bit
#: for bit)
PAGE_TOL = 1e-5


def test_host_hit_identical_to_jax_promoted_pages_as_jax(tiered, engines):
    """A prefix demoted to the host tier is matched there, promoted and
    served: the same tokens as uncached generate and as the JAX engine,
    the same tier counters and tier table. Right after the fold the
    promoted pool pages equal the payloads they were demoted as, bit for
    bit on each side, and the port's are within PAGE_TOL of the JAX
    engine's."""
    rs = {side: np.random.RandomState(3) for side in tiered}
    pages = {}

    def body(srv):
        side = "jax" if isinstance(srv, JaxServingEngine) else "port"
        r = rs[side]
        prefix = r.randint(1, 256, 32)        # 4 full blocks
        first = _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))
        _churn(srv, r)
        assert srv.block_pool.demotions > 0 and len(srv.host_tier) > 0
        hits0 = srv.metrics.kv_host_hits
        p2 = np.concatenate([prefix, r.randint(1, 256, 8)])
        keys = srv.block_pool.prefix_block_hashes([int(t) for t in p2])[:4]
        keys = [srv.block_pool.canonical_key(h) for h in keys]
        payloads = [srv.host_tier._lru[h] for h in keys]
        rid = srv.submit(p2, max_new_tokens=6)
        srv.step()                            # admits and folds
        req = srv._requests[rid]
        assert req.host_prefix_len == 32 and req.promote_pending == 0
        pages[side] = {n: _as_np(t)[:, req.blocks[:4]]
                       for n, t in srv.pool.items()}
        for n, got in pages[side].items():
            want = np.concatenate([_as_np(p[n]) for p in payloads], axis=1)
            assert np.array_equal(got, want), (side, n)
        _drain(srv)
        out = srv.poll(rid)
        srv.forget(rid)
        assert srv.metrics.kv_host_hits == hits0 + 1
        assert srv.metrics.promote_hist.count >= 1
        return first, (out.state, out.finish_reason, out.tokens), \
            list(p2)

    first, second, p2 = _both(tiered, body)
    assert second[0] == "finished"
    assert second[2] == _reference(engines[1], p2, 6)
    for n, want in pages["jax"].items():
        np.testing.assert_allclose(pages["port"][n], want, rtol=0,
                                   atol=PAGE_TOL)
    # the tier table too, but for the host's promotion wait times
    status = {side: {k: v for k, v in srv.tier_status().items()
                     if not k.startswith("promote_wait")}
              for side, srv in tiered.items()}
    assert status["port"] == status["jax"]


def test_unlanded_promotion_blocks_only_its_own_grants(tiered, monkeypatch):
    """While its copy has not landed a request gets no prefill grant, and
    a companion request keeps decoding: the step never waits on a copy."""
    rs = {side: np.random.RandomState(7) for side in tiered}

    def body(srv):
        r = rs["jax" if isinstance(srv, JaxServingEngine) else "port"]
        prefix = r.randint(1, 256, 32)
        _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))
        _churn(srv, r)
        _stuck(monkeypatch, True)
        rid = srv.submit(np.concatenate([prefix, r.randint(1, 256, 8)]),
                         max_new_tokens=4)
        other = srv.submit(r.randint(1, 256, 8), max_new_tokens=32)
        for _ in range(6):
            srv.step()
        req = srv._requests[rid]
        blocked = (req.promote_pending, req.prefill_done == req.prefix_len,
                   srv.metrics.promote_queue_depth,
                   len(srv._requests[other].tokens))
        _stuck(monkeypatch, False)
        _drain(srv)
        outs = [srv.forget(x) for x in (rid, other)]
        return blocked, [(o.state, o.tokens) for o in outs]

    blocked, outs = _both(tiered, body)
    assert blocked[0] > 0 and blocked[1] and blocked[2] > 0
    assert blocked[3] >= 4
    assert [s for s, _ in outs] == ["finished", "finished"]


def test_cancel_mid_promotion_drops_entries_keeps_host_copy(tiered,
                                                           monkeypatch):
    rs = {side: np.random.RandomState(11) for side in tiered}

    def body(srv):
        r = rs["jax" if isinstance(srv, JaxServingEngine) else "port"]
        prefix = r.randint(1, 256, 32)
        _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))
        _churn(srv, r)
        _stuck(monkeypatch, True)
        rid = srv.submit(np.concatenate([prefix, r.randint(1, 256, 8)]),
                         max_new_tokens=4)
        other = srv.submit(r.randint(1, 256, 8), max_new_tokens=32)
        srv.step()
        pending = srv._requests[rid].promote_pending
        host_keys = set(srv.host_tier.keys())
        cancelled0 = srv.metrics.kv_promote_cancelled
        srv.cancel(rid)
        srv.step()                             # the pump drops the entries
        dropped = (srv.metrics.kv_promote_cancelled - cancelled0,
                   srv.metrics.promote_queue_depth,
                   set(srv.host_tier.keys()) == host_keys)
        _stuck(monkeypatch, False)
        _drain(srv)
        srv.forget(other)
        srv.forget(rid)
        hits0 = srv.metrics.kv_host_hits
        replay = _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))
        return pending, dropped, replay, srv.metrics.kv_host_hits - hits0

    pending, dropped, replay, hits = _both(tiered, body)
    assert pending > 0 and dropped[0] > 0 and dropped[1] == 0 and dropped[2]
    assert replay[0] == "finished" and hits == 1


def test_defrag_remaps_inflight_promotions(tiered, monkeypatch):
    rs = {side: np.random.RandomState(29) for side in tiered}

    def body(srv):
        r = rs["jax" if isinstance(srv, JaxServingEngine) else "port"]
        prefix = r.randint(1, 256, 32)
        p = np.concatenate([prefix, r.randint(1, 256, 8)])
        ref = _one(srv, p)[2]
        _churn(srv, r)
        _stuck(monkeypatch, True)
        rid = srv.submit(np.concatenate([prefix, r.randint(1, 256, 8)]),
                         max_new_tokens=4)
        other = srv.submit(r.randint(1, 256, 8), max_new_tokens=32)
        srv.step()
        assert srv._requests[rid].promote_pending > 0
        moved = srv.defrag()
        _stuck(monkeypatch, False)
        _drain(srv)
        out = srv.poll(rid)
        preempted = srv._requests[rid].preemptions
        srv.forget(rid)
        srv.forget(other)
        return (moved, out.state, out.tokens, preempted,
                _one(srv, p, 6)[2][:4] == ref[:4])

    moved, state, _, preempted, same = _both(tiered, body)
    assert state == "finished" and preempted == 0 and same


def test_corrupt_promote_quarantined_before_reindex(tiered, engines,
                                                    monkeypatch):
    """``corrupt_promote``: the poisoned page NaNs the first suffix chunk,
    the logit guard fails that request before any promoted page is
    indexed, and the retry host-hits the clean copies."""
    rs = {side: np.random.RandomState(13) for side in tiered}

    def body(srv):
        r = rs["jax" if isinstance(srv, JaxServingEngine) else "port"]
        prefix = r.randint(1, 256, 32)
        _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))
        _churn(srv, r)
        p = np.concatenate([prefix, r.randint(1, 256, 8)])
        with monkeypatch.context() as mp:
            mp.setenv(faults.ENV_VAR,
                      "corrupt_promote:fails=1:tag=serving_tier")
            faults.reset()
            jax_faults.reset()
            failed = _one(srv, p, 4)
        faults.reset()
        jax_faults.reset()
        hashes = srv.block_pool.prefix_block_hashes([int(t) for t in p])
        indexed = [srv.block_pool.lookup(h) for h in hashes]
        _invariant(srv)
        return failed, indexed, _one(srv, p, 4), list(p)

    failed, indexed, retry, p = _both(tiered, body)
    assert failed[:2] == ("failed", "corrupt_logits")
    assert indexed == [None] * len(indexed)
    assert retry[0] == "finished"
    assert retry[2] == _reference(engines[1], p, 4)


def _sync_body(seed):
    def body(srv):
        r = np.random.RandomState(seed)
        prefix = r.randint(1, 256, 32)
        _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))
        _churn(srv, r)
        out = _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))
        assert srv.metrics.kv_pages_promoted >= 4
        return out
    return body


def test_sync_promote_token_identical(engines):
    """``sync_promote`` folds at admission and serves what the JAX engine
    with it serves, and what the port's asynchronous engine serves."""
    synced = _both(_pair(engines, sync_promote=True, **TIER), _sync_body(17))
    srv = dt.ServingEngine(engines[1], dt.ServingConfig(**TIER))
    assert _sync_body(17)(srv) == synced
    _invariant(srv)


def test_two_program_engine_host_hits_as_jax(engines):
    """The tier on the port's two-program engine: its chunked prefill
    waits for the fold too, and it serves the JAX engine's tokens and
    counters."""
    pair = _pair(engines, mixed_step=False, **TIER)
    rs = {side: np.random.RandomState(5) for side in pair}

    def body(srv):
        r = rs["jax" if isinstance(srv, JaxServingEngine) else "port"]
        prefix = r.randint(1, 256, 32)
        outs = [_one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]))]
        _churn(srv, r)
        outs.append(_one(srv, np.concatenate([prefix,
                                              r.randint(1, 256, 8)])))
        return outs

    jsrv, tsrv = pair["jax"], pair["port"]
    outs = _both(pair, body)
    assert all(o[0] == "finished" for o in outs)
    assert tsrv.metrics.kv_host_hits == jsrv.metrics.kv_host_hits >= 1


@pytest.mark.parametrize("over", [{}, {"mixed_step": False}])
def test_host_tier_requires_prefix_cache(engines, over):
    jeng, teng = engines
    for make, cfg in ((JaxServingEngine, JaxServingConfig),
                      (dt.ServingEngine, dt.ServingConfig)):
        eng = jeng if make is JaxServingEngine else teng
        with pytest.raises(ValueError, match="prefix_cache"):
            make(eng, cfg(host_cache_blocks=8, **over))


# ---------------------------------------------------------------------------
# the watchdog over the fold
# ---------------------------------------------------------------------------


class VirtualClock:
    """``time`` for the port's engine, scheduler and fault injector: a
    stall or a sleep moves it, nothing else does."""

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


#: the watchdog engines: 2 slots, 16 pages, a 1 s budget (real seconds for
#: the JAX engine, virtual ones for the port)
WATCHDOG = dict(max_batch_size=2, block_size=8, num_blocks=16,
                max_model_len=48, prefix_cache=True, prefill_chunk_tokens=16,
                host_cache_blocks=64, step_watchdog_s=1.0)


def _chaos_pair(engines, monkeypatch):
    pair = _pair(engines, **WATCHDOG)
    clock = VirtualClock()
    for mod in (engine_mod, sched_mod, faults):
        monkeypatch.setattr(mod, "time", clock)
    return pair, clock


def _arm(monkeypatch, spec):
    if spec is None:
        monkeypatch.delenv(faults.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(faults.ENV_VAR, spec)
    faults.reset()
    jax_faults.reset()


def test_slow_promote_bounded_by_the_watchdog(engines, monkeypatch):
    """``slow_promote`` past the budget on a warm fold: the fold's request
    fails (``step_watchdog``), the engine skips device work until the
    stall ends and then serves on — zero leaks, nothing stranded, the
    outcome the JAX engine's. On the port's virtual clock the drain is
    bounded by the stall, not by the machine's speed."""
    pair, clock = _chaos_pair(engines, monkeypatch)
    rs = {side: np.random.RandomState(19) for side in pair}

    def warm_hit(srv, r):
        prefix = r.randint(1, 256, 24)
        _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]), 2)
        for _ in range(6):
            _one(srv, r.randint(1, 256, 32), 2)
        return _one(srv, np.concatenate([prefix, r.randint(1, 256, 8)]), 2)

    def body(srv):
        r = rs["jax" if isinstance(srv, JaxServingEngine) else "port"]
        first = warm_hit(srv, r)
        assert srv.metrics.kv_pages_promoted > 0
        _arm(monkeypatch, "slow_promote:seconds=2.0:fails=1:tag=serving_tier")
        trips0 = srv.metrics.watchdog_trips
        t0 = clock.now
        tripped = warm_hit(srv, r)
        took = clock.now - t0
        trips = srv.metrics.watchdog_trips - trips0
        _arm(monkeypatch, None)
        _drain(srv)
        if not isinstance(srv, JaxServingEngine):
            assert took < 10.0, took
        return first, tripped, trips, warm_hit(srv, r)

    first, tripped, trips, after = _both(pair, body)
    assert first[0] == "finished" and after[0] == "finished"
    assert tripped[:2] == ("failed", "step_watchdog") and trips == 1


@pytest.mark.chaos
def test_tier_chaos_storm_ends_as_jax(engines, monkeypatch):
    """The JAX suite's storm: probabilistic slow_promote and
    corrupt_promote over host-hitting tenants. Every request terminal, no
    page leaked, no host entry stranded, no promotion left queued, one
    width — and the same outcomes as the JAX engine after every spec."""
    pair, _ = _chaos_pair(engines, monkeypatch)
    rs = {side: np.random.RandomState(23) for side in pair}
    tenants = {side: [r.randint(1, 256, 24) for _ in range(3)]
               for side, r in rs.items()}

    def wave(srv, n):
        side = "jax" if isinstance(srv, JaxServingEngine) else "port"
        r = rs[side]
        rids = [srv.submit(np.concatenate([tenants[side][i % 3],
                                           r.randint(1, 256, 8)]),
                           max_new_tokens=2) for i in range(n)]
        _drain(srv)
        return [(o.state, o.finish_reason, o.tokens)
                for o in (srv.forget(x) for x in rids)]

    def body(srv):
        outs = [wave(srv, 6)] + [wave(srv, 2) for _ in range(4)]
        for spec in ("slow_promote:seconds=1.5:p=0.3:tag=serving_tier",
                     "corrupt_promote:p=0.5:tag=serving_tier",
                     "slow_promote:seconds=1.5:fails=1:tag=serving_tier,"
                     "corrupt_promote:fails=1:tag=serving_tier"):
            _arm(monkeypatch, spec)
            out = wave(srv, 8)
            _arm(monkeypatch, None)
            assert all(s in ("finished", "failed") for s, _, _ in out), out
            _invariant(srv)
            assert srv.metrics.promote_queue_depth == 0
            outs.append(out)
        outs.append(wave(srv, 4))
        assert all(s == "finished" for s, _, _ in outs[-1])
        return outs

    _both(pair, body)


@pytest.mark.chaos
def test_tier_chaos_storm_with_host_hits_ends_as_jax(engines, monkeypatch):
    """The same storm where it bites: each tenant request follows unrelated
    traffic that rolls the 16-page pool over, so the tenants' prefixes come
    back from the host tier and the promotion faults fire (counted on both
    sides, and equal). Every request terminal, no page leaked, none
    stranded, no promotion left queued, one width, and the same outcomes,
    trips and quarantines as the JAX engine."""
    pair, _ = _chaos_pair(engines, monkeypatch)
    rs = {side: np.random.RandomState(31) for side in pair}
    tenants = {side: [r.randint(1, 256, 24) for _ in range(3)]
               for side, r in rs.items()}
    fired = {"jax": [], "port": []}
    listeners = {"jax": lambda name, ctx: fired["jax"].append(name),
                 "port": lambda name, ctx: fired["port"].append(name)}
    jax_faults.add_listener(listeners["jax"])
    faults.add_listener(listeners["port"])

    def wave(srv, n):
        side = "jax" if isinstance(srv, JaxServingEngine) else "port"
        r = rs[side]
        outs = []
        for i in range(n):
            rids = [srv.submit(np.concatenate([tenants[side][i % 3],
                                               r.randint(1, 256, 8)]),
                               max_new_tokens=2),
                    srv.submit(r.randint(1, 256, 40), max_new_tokens=2)]
            _drain(srv)
            outs += [(o.state, o.finish_reason, o.tokens)
                     for o in (srv.forget(x) for x in rids)]
        return outs

    def body(srv):
        outs = [wave(srv, 3)]
        for spec in ("slow_promote:seconds=2.0:p=0.3:tag=serving_tier",
                     "corrupt_promote:p=0.5:tag=serving_tier"):
            _arm(monkeypatch, spec)
            out = wave(srv, 6)
            _arm(monkeypatch, None)
            assert all(s in ("finished", "failed") for s, _, _ in out), out
            _invariant(srv)
            assert srv.metrics.promote_queue_depth == 0
            outs.append(out)
        outs.append(wave(srv, 3))
        assert all(s == "finished" for s, _, _ in outs[-1])
        return outs

    try:
        outs = _both(pair, body)
    finally:
        jax_faults.remove_listener(listeners["jax"])
        faults.remove_listener(listeners["port"])
    assert fired["port"] == fired["jax"]
    assert {"slow_promote", "corrupt_promote"} <= set(fired["port"])
    reasons = {reason for wave_out in outs for _, reason, _ in wave_out}
    assert {"step_watchdog", "corrupt_logits"} <= reasons, reasons
    assert pair["port"].metrics.kv_host_hits > 6
