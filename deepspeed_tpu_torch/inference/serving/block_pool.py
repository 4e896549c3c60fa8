"""Host-side accounting for the paged KV-cache block pool.

Counterpart of ``deepspeed_tpu/inference/serving/block_pool.py``, host
KV tier included: with :meth:`BlockPool.attach_host_tier` eviction
demotes pages into ``kv_tiers.HostTier`` (probation for pages that never
served a match), admission's prefix match continues into the host index
(:meth:`BlockPool.host_match_keys`), a device commit consumes the host
entry, and :meth:`BlockPool.check_consistent` holds both tiers.

The device arrays (``models/layers.py init_paged_kv_cache``) are a flat pool
of ``num_blocks`` pages; this class owns WHICH page belongs to WHICH request.
Every page is always in exactly one of three places — the blank free list,
the content-addressed cached LRU, or the reference map — and every
transition is validated, so leaks and double-frees are structural errors
(raised immediately), not silent capacity rot. The serving scheduler
invariant tests drive random admit/finish/preempt cycles against exactly
these checks.

Prefix caching (vLLM "automatic prefix caching" lineage):

- **References, not owners.** A page may back the SAME tokens for several
  sequences at once; ``_refs[bid]`` is the set of request ids holding it.
  Appends into a page with more than one reference are forbidden — the
  engine copies-on-write first (:meth:`cow`).
- **Content addressing.** FULL pages (``block_size`` tokens, never partial
  ones) are indexed by a content KEY chained over the prefix:
  ``k_i = (k_{i-1}, tokens[i*bs:(i+1)*bs])`` — equal keys mean equal token
  prefixes (compared by value, so hash collisions cannot alias), and
  :meth:`match_prefix` returns pages whose KV can be reused verbatim.
- **Lazy free + LRU eviction.** Releasing the last reference to a HASHED
  page parks it on a cached LRU instead of blanking it; a later request
  with the same prefix revives it (:meth:`acquire`) and skips that
  prefill compute. Allocation evicts the least-recently-used cached pages
  only when the blank list runs dry — referenced pages are structurally
  un-evictable.
"""

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Set


class BlockPoolError(RuntimeError):
    """A block-accounting invariant was violated (double-free, foreign free,
    allocation beyond capacity, negative refcount)."""


class ChainKey:
    """Content key of one FULL block, chained on the previous block's key
    so equal keys imply equal token PREFIXES, not just equal blocks.

    Deliberately NOT a bare numeric digest: equality compares the actual
    token content (recursing up the chain, with an identity fast path), so
    a hash collision between different prefixes can never serve the wrong
    KV. The digest IS precomputed and cached though — Python re-hashes
    nested tuples on every dict op, which would make the per-submit
    admission scans quadratic in prefix length; here hashing one key is
    O(block_size) once, O(1) thereafter. Chains share structure (each key
    references the previous), so memory is O(block_size) per indexed
    page. In-process only; never persisted. (Tests may use any hashable
    stand-in as an index key — the pool treats keys opaquely.)"""

    __slots__ = ("prev", "tokens", "_h")

    def __init__(self, prev: Optional["ChainKey"], tokens: tuple):
        self.prev = prev
        self.tokens = tokens
        self._h = hash((prev._h if prev is not None else 0x5EED, tokens))

    def __hash__(self) -> int:
        return self._h

    def __eq__(self, other) -> bool:
        # iterative chain walk — a recursive prev == prev would blow the
        # interpreter stack on long-context prompts (~1000+ blocks) and
        # cost O(depth) per TRUE match; the identity fast path makes
        # repeat lookups of the same interned chain O(1)
        a, b = self, other
        while a is not b:
            if not (isinstance(a, ChainKey) and isinstance(b, ChainKey)):
                return False
            if a._h != b._h or a.tokens != b.tokens:
                return False
            a, b = a.prev, b.prev
            if a is None or b is None:
                return a is b
        return True

    def __repr__(self) -> str:
        return f"ChainKey({self._h:#x}, {len(self.tokens)} tok)"


def chain_hash(prev: Optional[ChainKey], tokens: Sequence[int]) -> ChainKey:
    """Build the :class:`ChainKey` of one FULL block (``prev=None`` for
    the first block of a prefix)."""
    return ChainKey(prev, tuple(int(t) for t in tokens))


class BlockPool:
    def __init__(self, num_blocks: int, block_size: int, tracer=None):
        if num_blocks < 1 or block_size < 1:
            raise ValueError("num_blocks and block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        #: optional span/event sink (monitor.tracing.Tracer); None = free.
        #: The pool only emits rare structural events (prefix evictions),
        #: never per-token ones.
        self.tracer = tracer
        # popping from the tail keeps allocation ascending-ish (cosmetic)
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        #: request ids holding each referenced page (len == refcount >= 1)
        self._refs: Dict[int, Set[str]] = {}
        #: refcount-0 pages kept warm for reuse, least-recently-used first
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        #: content index over FULL pages: chained content key <-> page id
        self._hash_to_block: Dict[ChainKey, int] = {}
        self._block_hash: Dict[int, ChainKey] = {}
        #: monotone counter: cached pages reclaimed to back new allocations
        self.evictions = 0
        #: optional spill tier (kv_tiers.HostTier) + the callable that
        #: reads one device page host-side — installed together via
        #: :meth:`attach_host_tier`; None = evictions destroy (seed
        #: behavior). The pool stays torch-free: all device I/O lives in
        #: the reader/tier the engine provides.
        self.host_tier = None
        self.page_reader = None
        #: monotone counter: evicted pages demoted into the host tier
        #: (chain preserved) instead of destroyed
        self.demotions = 0
        #: pages that ever SERVED a prefix match (revived off the cached
        #: LRU or shared by a second owner via :meth:`acquire`, or
        #: promoted up from the host tier). The demotion admission
        #: policy keys on this: a page never matched — the single-use
        #: tail of a finished request — demotes into the host tier's
        #: PROBATION segment (evicted first) instead of polluting the
        #: protected LRU, so recovery re-warm churn cannot thrash the
        #: prefixes the tier exists to keep
        self._matched: Set[int] = set()

    # -- capacity ------------------------------------------------------

    @property
    def sentinel(self) -> int:
        """Block-table entry meaning "unallocated": one past the pool, so
        appends routed there fall out of bounds and are dropped."""
        return self.num_blocks

    def blocks_for_tokens(self, num_tokens: int) -> int:
        """Pages needed to hold ``num_tokens`` positions (>= 1)."""
        return max(1, -(-num_tokens // self.block_size))

    @property
    def free_count(self) -> int:
        """Allocatable pages: blank + cached (cached evict on demand)."""
        return len(self._free) + len(self._cached)

    @property
    def used_count(self) -> int:
        """Pages holding at least one live reference."""
        return len(self._refs)

    @property
    def cached_count(self) -> int:
        """Unreferenced pages kept warm in the prefix cache."""
        return len(self._cached)

    @property
    def indexed_count(self) -> int:
        """Live content-indexed pages (referenced + cached) — the size of
        the prefix index a fleet router's affinity probe searches."""
        return len(self._block_hash)

    def occupancy(self) -> float:
        return self.used_count / self.num_blocks

    def can_allocate(self, n: int) -> bool:
        return n <= self.free_count

    def ref_count(self, bid: int) -> int:
        return len(self._refs.get(bid, ()))

    def is_shared(self, bid: int) -> bool:
        return self.ref_count(bid) > 1

    def owner_of(self, bid: int) -> Optional[str]:
        """One of the page's reference holders (None when unreferenced).
        With sharing a page has several; use :meth:`ref_count`."""
        refs = self._refs.get(bid)
        return min(refs) if refs else None

    # -- transitions ---------------------------------------------------

    def allocate(self, n: int, owner: str) -> List[int]:
        """Hand ``owner`` n exclusive (refcount-1) pages, evicting the
        least-recently-used cached pages when the blank list runs dry."""
        if n < 0:
            raise ValueError(f"allocate({n})")
        if n > self.free_count:
            raise BlockPoolError(
                f"pool exhausted: want {n} blocks, {self.free_count} "
                f"allocatable ({len(self._free)} blank + "
                f"{len(self._cached)} cached)")
        if len(self._free) < n:
            # one batched eviction wave: with a host tier attached the
            # whole wave's demotion fetch is ONE device round-trip
            self._evict_cached(n - len(self._free))
        out = [self._free.pop() for _ in range(n)]
        for bid in out:
            self._refs[bid] = {owner}
        return out

    def attach_host_tier(self, tier, page_reader) -> None:
        """Wire a spill tier behind the eviction path: ``_evict_one``
        becomes demotion (page copied host-side via ``page_reader``,
        chain preserved in the tier's content index), ``commit_hash``
        consumes host entries the moment their content re-enters the
        device index (single-residency), and ``check_consistent``
        extends across both tiers. ``page_reader(bids)`` returns the
        host payloads of a LIST of device pages in one batched read
        (``kv_tiers.fetch_paged_blocks``)."""
        self.host_tier = tier
        self.page_reader = page_reader
        # chain-coverage oracle: "is this key live in the DEVICE index?"
        # (the other half of the tier's no-stranded-pages invariant)
        tier.device_live = lambda h: self.lookup(h) is not None

    def _evict_one(self, spill: bool = True) -> None:
        self._evict_cached(1, spill=spill)

    def _evict_cached(self, k: int, spill: bool = True) -> None:
        """Reclaim the ``k`` least-recently-used cached pages. Only
        refcount-0 pages live in ``_cached``, so a referenced page can
        never be evicted — structurally, not by policy. With a host tier
        attached the wave DEMOTES: every page's content is copied
        host-side in ONE batched ``page_reader`` read (one device
        round-trip per wave, not per page) and its chain key survives in
        the host content index, so a later identical prefix still hits
        (and promotes) instead of recomputing. LRU order is preserved
        tier-to-tier: the oldest device page becomes the oldest host
        entry. ``spill=False`` (drop_cached) destroys as before."""
        batch = []
        for _ in range(k):
            bid, _ = self._cached.popitem(last=False)
            h = self._block_hash.pop(bid, None)
            if h is not None and self._hash_to_block.get(h) == bid:
                del self._hash_to_block[h]
            else:
                h = None
            batch.append((bid, h))
        spillable = [] if not (spill and self.host_tier is not None
                               and self.page_reader is not None) else \
            [(bid, h) for bid, h in batch if h is not None]
        demoted: Set[int] = set()
        if spillable:
            payloads = self.page_reader([bid for bid, _ in spillable])
            for (bid, h), payload in zip(spillable, payloads):
                # demotion admission policy: pages that never served a
                # prefix match (single-use tails) go to the PROBATION
                # segment — the tier evicts those first, so churn can
                # never thrash the proven-reusable protected entries
                if self.host_tier.put(h, payload,
                                      probation=bid not in self._matched):
                    demoted.add(bid)
                    self.demotions += 1
        for bid, h in batch:
            if h is not None and bid not in demoted and \
                    self.host_tier is not None:
                # the key left the device index WITHOUT reaching the
                # host: host children it covered must cascade (no
                # stranded entries behind a chain gap)
                self.host_tier.on_device_drop(h)
            self._free.append(bid)
            self._matched.discard(bid)  # blanked: the id will be reused
            self.evictions += 1
            if self.tracer is not None and self.tracer.enabled:
                name = "kv_demote" if bid in demoted else "prefix_evict"
                self.tracer.instant(name, cat="pool",
                                    args={"block": bid,
                                          "cached": len(self._cached)})

    def drop_cached(self) -> int:
        """Evict EVERY refcount-0 cached page (and its index entries) back
        to the blank list — WITHOUT demoting — and clear the host tier;
        returns the device count. Models the cold restart of a killed
        fleet replica: a dead process's warm KV does not survive its
        memory — device HBM and host RAM alike — so the router's kill
        drill must not leave either tier an index a real restart would
        never have (a revived replica re-warms from traffic)."""
        if self.host_tier is not None:
            # host first: the spill-free device evictions below then have
            # no children left to cascade onto (and no counter noise)
            self.host_tier.clear()
        n = 0
        while self._cached:
            self._evict_one(spill=False)
            n += 1
        return n

    def free(self, block_ids: List[int], owner: str) -> None:
        """Release ``owner``'s references. A page whose last reference
        drops is parked on the cached LRU when content-indexed (a later
        identical prefix revives it) or blanked otherwise. Double frees
        and foreign frees raise before anything mutates."""
        seen = set()
        for bid in block_ids:
            refs = self._refs.get(bid)
            if refs is None or bid in seen:
                raise BlockPoolError(f"double free of block {bid} ({owner})")
            if owner not in refs:
                raise BlockPoolError(
                    f"block {bid} owned by {sorted(refs)!r}, freed by "
                    f"{owner!r}")
            seen.add(bid)
        for bid in block_ids:
            refs = self._refs[bid]
            refs.discard(owner)
            if refs:
                continue  # other sequences still reference this page
            del self._refs[bid]
            if bid in self._block_hash:
                self._cached[bid] = None
                self._cached.move_to_end(bid)
            else:
                self._free.append(bid)
                self._matched.discard(bid)  # blanked: id will be reused

    def acquire(self, block_ids: List[int], owner: str) -> None:
        """Add ``owner`` references to live pages (referenced or cached);
        cached pages are revived off the LRU. The prefix-cache hit path."""
        for bid in block_ids:
            refs = self._refs.get(bid)
            if refs is None and bid not in self._cached:
                raise BlockPoolError(
                    f"acquire of dead block {bid} by {owner!r}")
            if refs is not None and owner in refs:
                raise BlockPoolError(
                    f"{owner!r} already references block {bid}")
        for bid in block_ids:
            self._cached.pop(bid, None)
            self._refs.setdefault(bid, set()).add(owner)
            # this page just served a prefix hit (revived or shared):
            # it has PROVEN reuse value, so a later demotion protects it
            self._matched.add(bid)

    def cow(self, bid: int, owner: str) -> int:
        """Copy-on-write: detach ``owner`` from a SHARED page onto a fresh
        exclusive one and return the new page id (the caller must copy the
        device-side page contents and rewrite its block table). A page
        referenced only by ``owner`` is returned unchanged — no copy
        needed. The new page carries no content hash (its content is about
        to diverge)."""
        refs = self._refs.get(bid)
        if refs is None or owner not in refs:
            raise BlockPoolError(f"cow of block {bid} not held by {owner!r}")
        if len(refs) == 1:
            return bid
        [new] = self.allocate(1, owner)
        refs.discard(owner)
        return new

    # -- content index (prefix caching) --------------------------------

    def prefix_block_hashes(self, tokens: Sequence[int]) -> List[ChainKey]:
        """Chained content keys of every FULL block of ``tokens`` (partial
        tail excluded — only immutable, completely-written pages are
        shareable). Keys are interned against the content index as the
        chain is built (:meth:`canonical_key`), so on a cache hit every
        later dict op terminates at the identity fast path instead of
        re-comparing token content all the way up the chain."""
        bs = self.block_size
        out: List = []
        prev = None
        for i in range(len(tokens) // bs):
            prev = self.canonical_key(
                chain_hash(prev, tokens[i * bs:(i + 1) * bs]))
            out.append(prev)
        return out

    def canonical_key(self, k: ChainKey) -> ChainKey:
        """The stored key object equal to ``k`` — from the device index
        or, on a miss, the HOST tier's intern table — or ``k`` itself
        when neither holds it. Chains built on the returned key share
        structure with the stored chain, so ``__eq__`` walks between
        them stop at depth 1 (identity) instead of O(depth) token
        compares — without this, a fully-cached k-block prompt (device
        OR host resident) pays O(k^2 * block_size) comparisons per
        admission scan."""
        bid = self._hash_to_block.get(k)
        if bid is None:
            if self.host_tier is not None:
                stored = self.host_tier.canonical(k)
                if stored is not None:
                    return stored
            return k
        stored = self._block_hash.get(bid)
        return stored if stored == k else k

    def commit_hash(self, bid: int, h: ChainKey) -> None:
        """Content-index a fully-written, referenced page. First writer
        wins: when ``h`` already names a live page the newcomer stays
        unindexed (a content duplicate that blanks on release). With a
        host tier attached, indexing ``h`` CONSUMES any host entry under
        the same key — the single-residency rule: a promoted (or simply
        recomputed) page live in the device index must not also sit on
        the host LRU. Commit runs AFTER the engine's logit guard passed
        the chunk that covers the page, so a corrupted promotion is
        quarantined before its host copy is ever consumed."""
        if bid not in self._refs:
            raise BlockPoolError(f"commit_hash on unreferenced block {bid}")
        if bid in self._block_hash:
            return  # already indexed (preemption replay)
        existing = self._hash_to_block.get(h)
        if existing is not None and (existing in self._refs
                                     or existing in self._cached):
            return
        self._hash_to_block[h] = bid
        self._block_hash[bid] = h
        if self.host_tier is not None and self.host_tier.evict(h):
            # the device copy replaced a host entry: this content WAS
            # matched (the host hit is what brought it back up), so a
            # later re-demotion keeps its protected status
            self._matched.add(bid)

    def lookup(self, h: ChainKey) -> Optional[int]:
        """Live page id for a chained hash, or None."""
        bid = self._hash_to_block.get(h)
        if bid is None or (bid not in self._refs and bid not in self._cached):
            return None
        return bid

    def _device_match_blocks(self, n_tokens: int,
                             hashes: List[ChainKey]) -> List[int]:
        """THE device-index prefix walk: longest run of live pages from
        the chain head, capped so at least one token stays uncached."""
        max_full = (n_tokens - 1) // self.block_size
        out: List[int] = []
        for h in hashes[:max_full]:
            bid = self.lookup(h)
            if bid is None:
                break
            out.append(bid)
        return out

    def match_prefix(self, tokens: Sequence[int],
                     hashes: Optional[List[ChainKey]] = None) -> List[int]:
        """Longest run of live cached pages covering a PREFIX of
        ``tokens``, capped so at least one token is left uncached (the
        model must compute logits for something to sample from). Returns
        page ids in order; does NOT take references — pair with
        :meth:`acquire`. Pass precomputed ``hashes``
        (``prefix_block_hashes``) to skip rehashing — admission-gate
        callers that scan the whole queue per submit must."""
        if hashes is None:
            hashes = self.prefix_block_hashes(tokens)
        return self._device_match_blocks(len(tokens), hashes)

    def host_match_keys(self, n_tokens: int, hashes: List[ChainKey],
                        start: int) -> List[ChainKey]:
        """Continue a device prefix match into the HOST tier: the longest
        contiguous run of host-resident keys from chain position
        ``start`` (the device-matched block count), under the same
        at-least-one-token-computed cap as :meth:`match_prefix`. Returns
        the matched keys in chain order — the admission path captures
        their payloads and schedules async promotion. Empty without a
        tier."""
        if self.host_tier is None:
            return []
        max_full = (n_tokens - 1) // self.block_size
        out: List[ChainKey] = []
        for h in hashes[start:max_full]:
            if not self.host_tier.contains(h):
                break
            out.append(h)
        return out

    def uncached_suffix_blocks(self, tokens: Sequence[int],
                               hashes: Optional[List[ChainKey]] = None
                               ) -> int:
        """Pages a request would NEWLY allocate at admission right now:
        total pages for ``tokens`` minus its live cached prefix. NOTE:
        the KV-headroom gates charge :meth:`admission_charge_len` (this
        plus the cached pages admission would PIN), not this."""
        return self.blocks_for_tokens(len(tokens)) - len(
            self.match_prefix(tokens, hashes))

    def admission_charge_len(self, n_tokens: int, hashes: List[ChainKey],
                             pinned_seen: Optional[Set[int]] = None) -> int:
        """Headroom-gate charge for one request: the pages its admission
        would take OUT of the allocatable pool. That is its uncached
        suffix PLUS any matched pages currently sitting refcount-0 on the
        cached LRU — admission pins those (un-evictable while referenced),
        which consumes exactly as much future headroom as a fresh
        allocation. Matched pages already referenced by running requests
        are counted in ``used_count`` and charged to nobody twice.

        ``pinned_seen`` threads a shared set through a multi-request gate
        scan: a cached page is pinned ONCE no matter how many queued
        sharers match it, so only the first request in the scan pays for
        it (without this, N same-prefix arrivals — the exact workload the
        cache serves — would overstate demand N-fold and spuriously
        reject). Consumes the request's memoized block keys and token
        COUNT, so the per-submit scan never materializes token lists."""
        max_full = (n_tokens - 1) // self.block_size
        matched = pinned = 0
        for h in hashes[:max_full]:
            bid = self.lookup(h)
            if bid is None:
                break
            matched += 1
            if bid in self._cached:
                if pinned_seen is None:
                    pinned += 1
                elif bid not in pinned_seen:
                    pinned_seen.add(bid)
                    pinned += 1
        return self.blocks_for_tokens(n_tokens) - matched + pinned

    # -- invariants ----------------------------------------------------

    def check_consistent(self) -> None:
        """Every page in exactly one place (blank / cached / referenced),
        refcounts positive, content index bijective over live hashed
        pages; raises on any accounting leak."""
        free = set(self._free)
        cached = set(self._cached)
        used = set(self._refs)
        if len(free) != len(self._free):
            raise BlockPoolError("free list holds duplicates")
        for a, b, name in ((free, used, "free+owned"),
                           (free, cached, "free+cached"),
                           (cached, used, "cached+owned")):
            if a & b:
                raise BlockPoolError(f"blocks both {name}: {sorted(a & b)}")
        if len(free) + len(cached) + len(used) != self.num_blocks:
            missing = set(range(self.num_blocks)) - free - cached - used
            raise BlockPoolError(f"leaked blocks: {sorted(missing)}")
        for bid, refs in self._refs.items():
            if not refs:
                raise BlockPoolError(
                    f"block {bid} has an empty reference set (refcount 0 "
                    f"entry lingering)")
        for bid in cached:
            if bid not in self._block_hash:
                raise BlockPoolError(
                    f"cached block {bid} has no content hash (stranded: "
                    f"unreachable by any prefix match)")
        for bid, h in self._block_hash.items():
            if bid not in used and bid not in cached:
                raise BlockPoolError(f"hash entry for dead block {bid}")
            if self._hash_to_block.get(h) != bid:
                # a block may legitimately lose the index race only by
                # never being entered; _block_hash is only set on entry
                raise BlockPoolError(
                    f"hash index mismatch for block {bid}")
        if self.host_tier is not None:
            # cross-tier invariants: single residency (a key live in the
            # device index never also on the host LRU) plus the tier's
            # own accounting + no-stranded-entry checks
            for h in self.host_tier.keys():
                bid = self._hash_to_block.get(h)
                if bid is not None and (bid in used or bid in cached):
                    raise BlockPoolError(
                        f"key resident in BOTH tiers: device block {bid} "
                        f"and a host entry ({h!r})")
            try:
                self.host_tier.check()
            except RuntimeError as e:
                raise BlockPoolError(f"host tier inconsistent: {e}")

    # -- defrag --------------------------------------------------------

    def defrag_plan(self):
        """Compute a compaction: live pages (referenced AND cached) move to
        the lowest ids.

        Returns ``(mapping, src)`` — ``mapping`` is ``{old_id: new_id}`` for
        every live page (callers rewrite block tables with it), and
        ``src`` is a length-``num_blocks`` gather index such that
        ``new_pool = old_pool[src]`` realizes the move on the device arrays
        (untouched positions gather themselves). Accounting — references,
        the cached LRU, and the content index — is updated here; the
        caller MUST apply both device-side effects.
        """
        allocated = sorted(set(self._refs) | set(self._cached))
        mapping = {old: new for new, old in enumerate(allocated)}
        src = list(range(self.num_blocks))
        for old, new in mapping.items():
            src[new] = old
        # rebuild accounting in compacted form (LRU order preserved)
        self._refs = {mapping[old]: refs for old, refs in self._refs.items()}
        self._cached = OrderedDict((mapping[old], None)
                                   for old in self._cached)
        self._matched = {mapping[old] for old in self._matched
                         if old in mapping}
        self._block_hash = {mapping[old]: h
                            for old, h in self._block_hash.items()}
        self._hash_to_block = {h: mapping[old]
                               for h, old in self._hash_to_block.items()}
        self._free = list(range(self.num_blocks - 1, len(allocated) - 1, -1))
        return mapping, src
