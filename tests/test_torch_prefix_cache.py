"""The port's block pool and scheduler with the prefix cache, against the
JAX package's.

Both are pure host Python, so every scenario runs twice, once on each
package's classes, and returns a trace of what it observed (page ids,
reference counts, matches, charges, evictions): the scenario asserts the
pool's properties as it goes (reference counts, copy-on-write never
touching the shared page, LRU order, the chained match and its cap, long
chains, key interning, admission charges, random shared cycles that never
leak, defrag), and the test asserts that the port's trace equals the JAX
package's. The last test drives both schedulers through the same random
sequence of submits, admissions, chunk commits, decode growth, preemptions
and finishes and compares page ids, hits and evictions step by step.
"""

import types

import numpy as np
import pytest

from deepspeed_tpu.inference.serving import block_pool as jax_pool
from deepspeed_tpu.inference.serving import scheduler as jax_sched
from deepspeed_tpu_torch.inference.serving import block_pool as port_pool
from deepspeed_tpu_torch.inference.serving import scheduler as port_sched


def _ns(pool_mod, sched_mod):
    return types.SimpleNamespace(
        BlockPool=pool_mod.BlockPool, BlockPoolError=pool_mod.BlockPoolError,
        ChainKey=pool_mod.ChainKey, chain_hash=pool_mod.chain_hash,
        Request=sched_mod.Request, Scheduler=sched_mod.Scheduler,
        RequestState=sched_mod.RequestState)


PORT = _ns(port_pool, port_sched)
JAX = _ns(jax_pool, jax_sched)


def refcounts_shared_pages_and_release_order(m):
    pool = m.BlockPool(8, 4)
    a = pool.allocate(2, "a")
    pool.commit_hash(a[0], 111)
    pool.acquire([a[0]], "b")          # b shares a's first page
    assert pool.ref_count(a[0]) == 2 and pool.is_shared(a[0])
    assert pool.used_count == 2
    pool.free([a[0]], "b")             # b lets go: still referenced by a
    assert pool.ref_count(a[0]) == 1 and not pool.is_shared(a[0])
    pool.free(a, "a")                  # hashed page -> cached, other -> blank
    assert pool.used_count == 0 and pool.cached_count == 1
    pool.check_consistent()
    with pytest.raises(m.BlockPoolError, match="double free"):
        pool.free([a[0]], "a")         # a refcount can never go negative
    pool.check_consistent()
    return a, pool.free_count, pool.indexed_count


def acquire_dead_or_duplicate_reference_raises(m):
    pool = m.BlockPool(4, 4)
    a = pool.allocate(1, "a")
    with pytest.raises(m.BlockPoolError, match="already references"):
        pool.acquire(a, "a")
    pool.free(a, "a")                  # unhashed -> blank, not cached
    with pytest.raises(m.BlockPoolError, match="dead block"):
        pool.acquire(a, "b")
    pool.check_consistent()
    return a, pool.cached_count


def cow_never_mutates_shared_page_accounting(m):
    pool = m.BlockPool(8, 4)
    a = pool.allocate(1, "a")
    pool.commit_hash(a[0], 42)
    pool.acquire(a, "b")
    new = pool.cow(a[0], "b")
    assert new != a[0]
    assert pool.ref_count(a[0]) == 1 and pool.owner_of(a[0]) == "a"
    assert pool.ref_count(new) == 1 and pool.owner_of(new) == "b"
    assert pool.lookup(42) == a[0]     # the shared page stays indexed
    pool.check_consistent()
    assert pool.cow(new, "b") == new   # exclusive page: no copy needed
    with pytest.raises(m.BlockPoolError, match="not held"):
        pool.cow(a[0], "intruder")
    return a, new


def eviction_lru_order_and_never_drops_referenced(m):
    pool = m.BlockPool(4, 4)
    a = pool.allocate(2, "a")          # referenced: structurally safe
    b = pool.allocate(2, "b")
    pool.commit_hash(b[0], 100)
    pool.commit_hash(b[1], 101)
    pool.free(b, "b")                  # both parked on the cached LRU
    assert pool.cached_count == 2 and pool.free_count == 2
    [c] = pool.allocate(1, "c")        # the oldest cached page is evicted
    assert pool.evictions == 1
    assert pool.lookup(100) is None and pool.lookup(101) == b[1]
    d = pool.allocate(1, "d")
    with pytest.raises(m.BlockPoolError, match="exhausted"):
        pool.allocate(1, "e")          # referenced pages never evict
    assert all(pool.ref_count(bid) == 1 for bid in a)
    pool.check_consistent()
    return a, b, c, d, pool.evictions


def match_prefix_chained_and_capped(m):
    pool = m.BlockPool(8, 4)
    tokens = list(range(1, 13))        # 3 full blocks
    hashes = pool.prefix_block_hashes(tokens)
    assert len(hashes) == 3
    blocks = pool.allocate(3, "a")
    for bid, h in zip(blocks, hashes):
        pool.commit_hash(bid, h)
    pool.free(blocks, "a")
    # the cap leaves the LAST block uncached so one token is computed
    assert pool.match_prefix(tokens) == blocks[:2]
    assert pool.match_prefix(tokens + [99]) == blocks[:3]
    diverged = tokens[:4] + [77] + tokens[5:]
    assert pool.match_prefix(diverged) == blocks[:1]
    assert pool.uncached_suffix_blocks(tokens + [99]) == 1
    pool.check_consistent()
    return blocks, pool.match_prefix(tokens[:9])


def chain_key_long_chain_no_recursion_and_exact_equality(m):
    def build(tokens, bs=16):
        out, prev = [], None
        for i in range(len(tokens) // bs):
            prev = m.chain_hash(prev, tokens[i * bs:(i + 1) * bs])
            out.append(prev)
        return out

    tokens = list(range(3000 * 16))
    a, b = build(tokens), build(tokens)
    assert a[-1] == b[-1]              # a deep true match, no recursion
    assert hash(a[-1]) == hash(b[-1])
    diverged = list(tokens)
    diverged[5] += 1
    c = build(diverged)
    assert a[-1] != c[-1] and a[0] != c[0]
    assert a[10] == b[10] and {a[-1]: 1}[b[-1]] == 1
    return len(a), a[0].tokens, a[7].prev.tokens


def prefix_block_hashes_interns_against_the_index(m):
    pool = m.BlockPool(8, 4)
    tokens = list(range(1, 13))
    committed = pool.prefix_block_hashes(tokens)
    blocks = pool.allocate(3, "a")
    for bid, h in zip(blocks, committed):
        pool.commit_hash(bid, h)
    rebuilt = pool.prefix_block_hashes(tokens)
    assert all(f is s for f, s in zip(rebuilt, committed))
    diverged = pool.prefix_block_hashes(tokens[:4] + [77] + tokens[5:])
    assert diverged[0] is committed[0]
    assert diverged[1] is not committed[1] and diverged[1] != committed[1]
    cold = pool.prefix_block_hashes([101, 102, 103, 104])
    assert pool.canonical_key(cold[0]) is cold[0]
    return blocks, [k.tokens for k in diverged]


def admission_charges_dedup_pinned_across_sharers(m):
    pool = m.BlockPool(32, 8)
    sched = m.Scheduler(4, pool, 32, prefix_cache=True)
    prefix = list(range(1, 25))                  # 3 full blocks
    blocks = pool.allocate(3, "seed")
    for bid, h in zip(blocks, pool.prefix_block_hashes(prefix)):
        pool.commit_hash(bid, h)
    pool.free(blocks, "seed")                    # 3 pages idle on the LRU
    reqs = [m.Request(prompt=prefix + [100 + i], max_new_tokens=2)
            for i in range(4)]
    for r in reqs:
        sched.submit(r)
    charges, newcomer = sched.admission_charges(
        newcomer_len=len(prefix) + 1,
        newcomer_hashes=pool.prefix_block_hashes(prefix + [99]))
    # the first sharer pays 3 pinned + 1 suffix, the rest 1 suffix each
    assert charges[reqs[0].rid] == 4
    assert all(charges[r.rid] == 1 for r in reqs[1:])
    assert newcomer == 1 and sched.queued_block_demand() == 7
    return [charges[r.rid] for r in reqs], newcomer


def property_shared_cycles_never_leak_never_negative(m):
    rs = np.random.RandomState(0)
    pool = m.BlockPool(24, 4)
    live, trace, hashed = {}, [], 0
    for step in range(800):
        r = rs.rand()
        if live and r < 0.35:
            owner = rs.choice(sorted(live))
            pool.free(live.pop(owner), owner)
        elif live and r < 0.50:        # share a random live page
            owner = rs.choice(sorted(live))
            donor = live[owner]
            bid = donor[rs.randint(len(donor))]
            new_owner = f"s{step}"
            if new_owner not in live:
                pool.acquire([bid], new_owner)
                live[new_owner] = [bid]
        elif live and r < 0.60:        # cow a shared page
            owner = rs.choice(sorted(live))
            bid = live[owner][0]
            if pool.is_shared(bid) and pool.can_allocate(1):
                others = pool.ref_count(bid) - 1
                new = pool.cow(bid, owner)
                live[owner][0] = new
                assert pool.ref_count(bid) == others
                trace.append(("cow", bid, new))
        else:
            n = int(rs.randint(1, 4))
            owner = f"r{step}"
            if pool.can_allocate(n):
                live[owner] = pool.allocate(n, owner)
                trace.append(("alloc", tuple(live[owner]), pool.evictions))
                if rs.rand() < 0.5:    # index some pages: cached on free
                    pool.commit_hash(live[owner][0], ("key", step, hashed))
                    hashed += 1
        pool.check_consistent()
        for bids in live.values():
            assert all(pool.ref_count(bid) >= 1 for bid in set(bids))
    for owner, bids in live.items():
        pool.free(bids, owner)
    pool.check_consistent()
    assert pool.used_count == 0
    return trace, pool.cached_count, pool.evictions


def defrag_remaps_refs_cache_and_hash_index(m):
    pool = m.BlockPool(16, 4)
    a = pool.allocate(3, "a")
    b = pool.allocate(2, "b")
    c = pool.allocate(2, "c")
    pool.commit_hash(b[0], 7)
    pool.commit_hash(c[1], 8)
    pool.acquire([b[0]], "a")          # a shared page crosses the defrag
    pool.free(a, "a")                  # holes at the low end
    pool.free(c, "c")                  # one cached page, one blank
    mapping, src = pool.defrag_plan()
    pool.check_consistent()
    nb0 = mapping[b[0]]
    assert pool.ref_count(nb0) == 2 and pool.lookup(7) == nb0
    assert pool.lookup(8) == mapping[c[1]] and pool.cached_count == 1
    assert all(src[new] == old for old, new in mapping.items())
    assert sorted(mapping.values()) == list(range(len(mapping)))
    return sorted(mapping.items()), src, pool.allocate(2, "d")


def drop_cached_blanks_the_warm_pages(m):
    pool = m.BlockPool(6, 4)
    a = pool.allocate(3, "a")
    for i, bid in enumerate(a):
        pool.commit_hash(bid, 50 + i)
    pool.acquire(a[:1], "b")
    pool.free(a, "a")                  # two cached, one still referenced
    assert pool.cached_count == 2 and pool.drop_cached() == 2
    assert pool.lookup(51) is None and pool.lookup(50) == a[0]
    pool.check_consistent()
    pool.free(a[:1], "b")
    return pool.cached_count, pool.free_count, pool.indexed_count


SCENARIOS = [refcounts_shared_pages_and_release_order,
             acquire_dead_or_duplicate_reference_raises,
             cow_never_mutates_shared_page_accounting,
             eviction_lru_order_and_never_drops_referenced,
             match_prefix_chained_and_capped,
             chain_key_long_chain_no_recursion_and_exact_equality,
             prefix_block_hashes_interns_against_the_index,
             admission_charges_dedup_pinned_across_sharers,
             property_shared_cycles_never_leak_never_negative,
             defrag_remaps_refs_cache_and_hash_index,
             drop_cached_blanks_the_warm_pages]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_pool_property_holds_and_matches_jax(scenario):
    assert scenario(PORT) == scenario(JAX)


def _drive(m, seed, num_blocks, steps=400):
    """A scheduler under random traffic with shared prefixes. Mimics what
    the engine does around it: commits the hashes of pages a chunk or a
    decode step filled, grows decode pages (preempting when dry), finishes
    requests. Returns what it saw at every step."""
    rs = np.random.RandomState(seed)
    bs = 4
    pool = m.BlockPool(num_blocks, bs)
    sched = m.Scheduler(3, pool, 16, prefix_cache=True)
    prefixes = [list(rs.randint(1, 50, n)) for n in (8, 12, 5)]
    trace, made = [], 0

    def commit(req):
        full = req.seq_len // bs
        toks = req.resume_tokens
        while len(req.block_hashes) < full:
            j = len(req.block_hashes)
            req.block_hashes.append(pool.canonical_key(m.chain_hash(
                req.block_hashes[j - 1] if j else None,
                toks[j * bs:(j + 1) * bs])))
        for i in range(req.committed_blocks, full):
            pool.commit_hash(req.blocks[i], req.block_hashes[i])
        req.committed_blocks = max(req.committed_blocks, full)

    for step in range(steps):
        r = rs.rand()
        if r < 0.25 and sched.queue_depth < 4:
            prompt = prefixes[rs.randint(3)] + list(
                rs.randint(50, 90, rs.randint(1, 9)))
            req = m.Request(prompt=prompt, rid=f"q{made}",
                            max_new_tokens=int(rs.randint(2, 10)))
            made += 1
            sched.submit(req)
        elif r < 0.45:
            req = sched.admit_next()
            if req is not None:
                trace.append(("admit", req.rid, tuple(req.blocks),
                              req.prefix_len, pool.evictions))
        else:
            for _, req in list(sched.active()):
                if req.state is not m.RequestState.RUNNING:
                    continue
                if req.prefilling:
                    n = min(6, req.prefill_target - req.prefill_done)
                    req.prefill_done += n
                    req.seq_len = req.prefill_done
                    commit(req)
                    if not req.prefilling:
                        req.tokens.append(int(rs.randint(90, 99)))
                    continue
                while not sched.ensure_decode_headroom(req):
                    victim = sched.preempt_victim(exclude=req)
                    if victim is None:
                        sched.fail(req, "kv_pool_exhausted")
                        break
                    sched.preempt(victim)
                    trace.append(("preempt", victim.rid))
                if req.done:
                    continue
                req.seq_len += 1
                commit(req)
                req.tokens.append(int(rs.randint(90, 99)))
                if len(req.tokens) >= req.max_new_tokens:
                    sched.finish(req, "length")
        pool.check_consistent()
        trace.append((pool.used_count, pool.cached_count, pool.evictions,
                      sched.queue_depth))
    for _, req in list(sched.active()):
        sched.cancel(req)
    pool.check_consistent()
    assert pool.used_count == 0, "leaked pages"
    return trace


@pytest.mark.parametrize("seed,num_blocks", [(0, 24), (1, 12), (2, 9),
                                             (3, 16), (4, 10)])
def test_scheduler_and_pool_match_jax_under_random_traffic(seed, num_blocks):
    """Same operation sequence, same page ids, prefix hits, preemptions
    and evictions as the JAX scheduler and pool; hits and evictions do
    occur."""
    got = _drive(PORT, seed, num_blocks)
    assert got == _drive(JAX, seed, num_blocks)
    admits = [t for t in got if t[0] == "admit"]
    assert any(t[3] > 0 for t in admits), "no prefix hit in the run"
    if num_blocks <= 12:
        assert got[-1][2] > 0, "no eviction in a small pool"


def test_preempt_parks_hashed_pages_and_resume_rematches():
    """Preemption with the prefix cache: the victim's committed pages park
    on the LRU, its keys are rebuilt over prompt + generated tokens, and
    re-admission matches them back, capped to leave one token."""
    pool = port_pool.BlockPool(8, 4)
    sched = port_sched.Scheduler(2, pool, 8, prefix_cache=True)
    req = port_sched.Request(prompt=list(range(1, 10)), max_new_tokens=8)
    sched.submit(req)
    assert sched.admit_next() is req and req.prefix_len == 0
    first = list(req.blocks)
    req.prefill_done = req.seq_len = 9
    for i in range(2):
        pool.commit_hash(req.blocks[i], req.block_hashes[i])
    req.tokens += [70, 71, 72]
    sched.preempt(req)
    assert pool.used_count == 0 and pool.cached_count == 2
    assert len(req.block_hashes) == 3 and req.committed_blocks == 0
    assert sched.admit_next() is req
    assert req.blocks[:2] == first[:2] and req.prefix_len == 8
    assert req.prefill_done == 8 and req.prefill_target == 12
    pool.check_consistent()
    sched.finish(req, "length")
    assert pool.used_count == 0 and pool.cached_count == 2
