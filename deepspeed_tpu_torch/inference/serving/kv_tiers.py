"""Tiered KV cache: the host-RAM spill tier behind the BlockPool.

Counterpart of ``deepspeed_tpu/inference/serving/kv_tiers.py``. Eviction
becomes **demotion**: the device page is copied host-side and its
:class:`~.block_pool.ChainKey` chain survives in a host content index, so
admission's longest-prefix match extends across tiers. Pages matched on
the host are **promoted**: their payloads are copied to the device on a
side stream (from pinned memory, behind a CUDA event) and the engine
folds them into the pool in place once the copy has landed, between
steps, while the request's suffix prefill waits and everyone else steps.

Tier discipline (the invariants ``BlockPool.check_consistent`` extends
across tiers):

- **single residency** — a chain key indexed LIVE on the device never
  also lives on the host LRU: ``commit_hash`` consumes the host entry
  the moment the promoted (or recomputed) page enters the device index;
- **no stranded host pages** — every host entry's chain parent is
  device-live or host-live (capacity evictions cascade onto children the
  lost parent orphans), and the tier's byte/LRU accounting is exact;
- **promotion is re-startable** — a host entry is only consumed on
  device-index commit, which happens AFTER the engine's logit guard has
  passed the first suffix chunk. A promotion corrupted in transit
  (``DS_FAULT=corrupt_promote:tag=serving_tier``) quarantines its
  request before anything is re-indexed; the clean host copy survives
  for the retry.

A payload is one page of every pool tensor (``k``, ``v`` and, for an int8
pool, ``k_scale`` and ``v_scale``), each a CPU tensor ``[L, 1, ...]``
with storage of its own: pinned when the pool is on a CUDA device, so
its copy back to the card is asynchronous.
"""

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import torch


class KVTier:
    """Protocol of one spill tier keyed by content chain keys. A tier
    stores page PAYLOADS (a dict mirroring the device pool's tensors,
    one page wide) and owns its own capacity policy. ``HostTier`` is the
    pinned-host-RAM instance; an NVMe tier implements the same four
    verbs over files + an aio queue without touching the pool or the
    scheduler."""

    def put(self, key, payload) -> bool:          # pragma: no cover
        raise NotImplementedError

    def get(self, key):                           # pragma: no cover
        raise NotImplementedError

    def contains(self, key) -> bool:              # pragma: no cover
        raise NotImplementedError

    def evict(self, key) -> bool:                 # pragma: no cover
        raise NotImplementedError


def payload_nbytes(payload) -> int:
    """Total bytes of one page payload (sum over the pool tensors)."""
    return sum(int(leaf.nbytes) for leaf in payload.values())


def fetch_paged_blocks(pool, bids: List[int]) -> List[Dict[str, torch.Tensor]]:
    """Read SEVERAL device pages host-side: ONE gather per pool tensor,
    then one copy per page into a host buffer of its own (pinned on a
    CUDA device), and one wait for the wave. Returns a per-page payload
    list, each tensor ``[L, 1, ...]``. Demotion batches here: an admission
    that rolls k pages off the device LRU pays one device round-trip, not
    k. Each page lands in its OWN buffer: a view into the wave's buffer
    would keep the whole k-page buffer alive for as long as any single
    entry lives, silently breaking the tier's byte budget. The gather
    runs on the pool's stream, after the step that last wrote the
    pages."""
    ref = next(iter(pool.values()))
    dev = ref.device
    idx = torch.as_tensor(bids, dtype=torch.long, device=dev)
    pinned = dev.type == "cuda"
    out: List[Dict[str, torch.Tensor]] = [{} for _ in bids]
    for name, t in pool.items():
        # page-major, so each page is one contiguous run to copy out
        wave = t.index_select(1, idx).transpose(0, 1).contiguous()
        for i, page in enumerate(wave):
            host = torch.empty(page.shape, dtype=t.dtype, pin_memory=pinned)
            host.copy_(page, non_blocking=pinned)
            out[i][name] = host.unsqueeze(1)
    if pinned:
        torch.cuda.current_stream(dev).synchronize()
    return out


def upload_paged_blocks(payloads: List[Dict[str, torch.Tensor]], device,
                        stream=None) -> Tuple[Dict[str, torch.Tensor], Any]:
    """Start the copy of ``k`` page payloads to ``device``: one device
    buffer per pool tensor, each page's host buffer copied into its own
    slice. On a CUDA device the copies run on ``stream`` (non-blocking
    from pinned memory) after the work already queued on the current
    stream, and a CUDA event is recorded behind them. Returns the leaves
    as ``[L, k, ...]`` views and that event (None on the CPU, where the
    copy has happened on return)."""
    names = list(payloads[0])
    if device.type != "cuda":
        return {n: torch.cat([p[n] for p in payloads], dim=1).to(device)
                for n in names}, None
    bufs = {}
    for n in names:
        ref = payloads[0][n]
        bufs[n] = torch.empty((len(payloads), ref.shape[0]) +
                              tuple(ref.shape[2:]), dtype=ref.dtype,
                              device=device)
    # the buffers come from the current stream's memory: the copies wait
    # for what that stream has queued, and the allocator keeps each
    # buffer until the side stream is done with it
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for n, buf in bufs.items():
            for j, p in enumerate(payloads):
                buf[j].copy_(p[n][:, 0], non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    for buf in bufs.values():
        buf.record_stream(stream)
    return {n: b.transpose(0, 1) for n, b in bufs.items()}, event


def insert_paged_block(pool, dst_ids, leaves) -> None:
    """Fold promoted pages into the device pool IN PLACE:
    ``pool[:, dst_ids] = leaves`` across every pool tensor (``dst_ids``
    shape [W], leaves [L, W, ...]). ``index_copy_`` keeps every pool
    tensor's storage, so captured CUDA graphs that read the pool stay
    valid: promotion never recaptures a step."""
    dst = torch.as_tensor(dst_ids, dtype=torch.long,
                          device=next(iter(pool.values())).device)
    for name, t in pool.items():
        t.index_copy_(1, dst, leaves[name])


class HostTier(KVTier):
    """Pinned-host-RAM KV page pool keyed by the same content-addressed
    :class:`~.block_pool.ChainKey` chains as the device index.

    LRU with a block-count and/or byte budget. Payloads are host tensor
    copies of whole pages; entries share no storage with the device pool,
    so a host entry stays valid while a promotion of it is in flight and
    a replica kill drops the whole tier with the process
    (:meth:`clear`).

    Chain hygiene: entries are linked parent->children via
    ``key.prev``. Evicting a key for capacity CASCADES onto host
    children whose parent is then covered by neither tier — matching
    stops at the first gap, so an uncovered child could never be served
    again and keeping it would be exactly the "stranded host page" the
    consistency check forbids. ``device_live`` (installed by the
    BlockPool) answers "is this key live in the device index?" for that
    coverage test. Keys are treated opaquely otherwise (tests may use
    any hashable stand-in; ``prev`` is read via ``getattr``)."""

    def __init__(self, max_blocks: int = 0,
                 max_bytes: Optional[int] = None,
                 device_live: Optional[Callable[[Any], bool]] = None,
                 tracer=None):
        if max_blocks < 0:
            raise ValueError("max_blocks must be >= 0 (0 = unbounded)")
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive (None = unbounded)")
        if not max_blocks and max_bytes is None:
            raise ValueError("HostTier needs a capacity: max_blocks, "
                             "max_bytes, or both")
        self.max_blocks = max_blocks
        self.max_bytes = max_bytes
        #: "is this key live in the device content index?" — the other
        #: half of chain coverage; BlockPool installs it at wiring time
        self.device_live: Callable[[Any], bool] = device_live or \
            (lambda k: False)
        self.tracer = tracer
        self._lru: "OrderedDict[Any, Any]" = OrderedDict()
        self._nbytes: Dict[Any, int] = {}
        #: PROBATION segment (segmented LRU): entries demoted from pages
        #: that never served a prefix match — the single-use tails of
        #: finished requests. They still hit (and a hit PROMOTES them to
        #: the protected segment), but capacity evictions take probation
        #: first, oldest first — so recovery re-warm churn and one-shot
        #: traffic can never thrash the proven-reusable entries this
        #: tier exists to keep. Insertion order == probation LRU order
        #: (a probation entry's only recency event is the promoting hit)
        self._probation: "OrderedDict[Any, None]" = OrderedDict()
        #: bytes held by the probation segment, maintained incrementally
        #: at every insert/promote/drop (the admission pre-check reads
        #: it per demoted page — summing the segment there would make
        #: an eviction wave O(|probation|) per page)
        self._probation_bytes = 0
        #: key -> the SAME key object: the intern table behind
        #: :meth:`canonical` (dicts cannot hand back their stored key)
        self._canon: Dict[Any, Any] = {}
        #: parent key -> host child keys (chain links inside the tier)
        self._kids: Dict[Any, Set[Any]] = {}
        self.bytes = 0
        # monotone counters (the tier table / metrics rows)
        self.demotions = 0     # pages accepted from the device LRU
        self.promotions = 0    # entries consumed by a device-index commit
        self.evictions = 0     # entries dropped for capacity (+ cascades)
        self.rejected = 0      # put() refused (page larger than budget)
        #: probation demotions refused because admitting them would have
        #: evicted a PROTECTED entry (tier full of proven-reusable
        #: pages, no probation entry to pay) — the admission policy's
        #: own effectiveness counter
        self.probation_rejected = 0

    # -- introspection -------------------------------------------------

    def __len__(self) -> int:
        return len(self._lru)

    def keys(self) -> List[Any]:
        return list(self._lru)

    def contains(self, key) -> bool:
        """Peek (no LRU touch): admission and the fleet affinity probe
        test reachability without committing to anything."""
        return key in self._lru

    def canonical(self, key):
        """The STORED key object equal to ``key`` (None when absent).
        ``BlockPool.canonical_key`` interns request chains against this
        exactly as it does against the device index: without it a
        request whose k-block prefix is host-resident would pay a full
        O(depth) ChainKey chain walk on EVERY tier dict op (the
        identity fast path never fires on fresh key objects) — the
        quadratic admission blowup interning exists to prevent."""
        return self._canon.get(key)

    # -- transitions ---------------------------------------------------

    def _link(self, key) -> None:
        prev = getattr(key, "prev", None)
        if prev is not None:
            self._kids.setdefault(prev, set()).add(key)

    def _unlink(self, key) -> None:
        prev = getattr(key, "prev", None)
        if prev is not None:
            kids = self._kids.get(prev)
            if kids is not None:
                kids.discard(key)
                if not kids:
                    del self._kids[prev]

    def put(self, key, payload, probation: bool = False) -> bool:
        """Demote one page into the tier. Returns False only when the
        page alone exceeds the whole byte budget (the caller then treats
        the eviction as a plain drop and cascades). Re-demoting a key
        refreshes its recency and payload. ``probation`` files the
        entry in the evict-first segment (a page that never served a
        prefix match); a key already protected NEVER demotes back to
        probation, and a re-put with ``probation=False`` promotes."""
        nb = payload_nbytes(payload)
        if self.max_bytes is not None and nb > self.max_bytes:
            self.rejected += 1
            return False
        if probation and key not in self._lru and \
                self._would_overflow(nb):
            # a probation newcomer never evicts a PROTECTED entry: it
            # is admitted only when evicting PROBATION entries alone
            # can make room (both budgets — a large page must fit in
            # the bytes the probation segment can reclaim, not just
            # find a probation victim to start on). Otherwise the
            # single-use page is simply not admitted — this is the
            # whole demotion-admission policy: churn bounded to the
            # probation segment, protected entries structurally
            # un-thrashable by one-shot traffic
            fits_blocks = not self.max_blocks or \
                len(self._lru) - len(self._probation) + 1 <= self.max_blocks
            fits_bytes = self.max_bytes is None or \
                self.bytes - self._probation_bytes + nb <= self.max_bytes
            if not (fits_blocks and fits_bytes):
                self.probation_rejected += 1
                return False
        if key in self._lru:
            old = self._nbytes[key]
            self.bytes -= old
            if key in self._probation:
                self._probation_bytes -= old
                if not probation:
                    del self._probation[key]
            self._lru[key] = payload
            self._lru.move_to_end(key)
        else:
            self._lru[key] = payload
            self._canon[key] = key
            self._link(key)
            if probation:
                self._probation[key] = None
        self._nbytes[key] = nb
        self.bytes += nb
        if key in self._probation:
            self._probation_bytes += nb
        self.demotions += 1
        self._shrink(protect=key)
        return True

    def get(self, key):
        """Payload for a host-matched key (None when absent), refreshing
        its recency. The payload reference stays valid even if the entry
        is later evicted — promotion captures it here, so an LRU race
        can never corrupt an in-flight transfer. A hit on a PROBATION
        entry promotes it to the protected segment: the match it just
        served is exactly the reuse evidence probation was waiting
        for."""
        payload = self._lru.get(key)
        if payload is not None:
            self._lru.move_to_end(key)
            if key in self._probation:
                del self._probation[key]
                self._probation_bytes -= self._nbytes[key]
        return payload

    def evict(self, key) -> bool:
        """Drop one entry because the device index now holds its content
        (promotion consumed it, or a recompute re-created it — the
        single-residency rule either way); cascades onto host children
        left with no covered parent. Returns False when absent
        (idempotent)."""
        out = self._evict(key, count_eviction=False)
        if out:
            self.promotions += 1
        return out

    def _evict(self, key, count_eviction: bool) -> bool:
        if key not in self._lru:
            return False
        self._drop_one(key, count_eviction)
        self._cascade(key)
        return True

    def _drop_one(self, key, count_eviction: bool) -> None:
        nb = self._nbytes.pop(key)
        self.bytes -= nb
        del self._lru[key]
        if key in self._probation:
            del self._probation[key]
            self._probation_bytes -= nb
        del self._canon[key]
        self._unlink(key)
        if count_eviction:
            self.evictions += 1
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant("host_tier_evict", cat="pool",
                                args={"entries": len(self._lru)})

    def _cascade(self, parent) -> None:
        """After ``parent`` left the tier: host children whose chain is
        now covered by neither tier are unreachable forever (matching
        stops at the gap) — drop them too, transitively, so no entry is
        ever stranded. Iterative worklist: a 3000-block chain (a
        ~48k-token prompt) must cascade without touching the recursion
        limit."""
        work = [parent]
        while work:
            gone = work.pop()
            if self.device_live(gone):
                continue  # chain still covered through the device index
            for child in list(self._kids.get(gone, ())):
                if child in self._lru:
                    self._drop_one(child, count_eviction=True)
                    work.append(child)

    def on_device_drop(self, key) -> None:
        """The device index lost ``key`` WITHOUT demoting it here (spill
        disabled for that eviction, or :meth:`put` rejected the page):
        host children it covered must cascade."""
        if key not in self._lru:
            self._cascade(key)

    def _shrink(self, protect=None) -> None:
        while self._lru and self._over_budget() and \
                (len(self._lru) > 1 or next(iter(self._lru)) is not protect):
            oldest = self._victim(protect)
            if oldest is None:
                return
            self._evict(oldest, count_eviction=True)

    def _victim(self, protect=None):
        """Capacity-eviction order (segmented LRU): oldest PROBATION
        entry first — single-use pages pay for churn — then the oldest
        protected entry; never the page being inserted."""
        for key in self._probation:
            if key is not protect:
                return key
        for key in self._lru:
            if key is not protect:
                return key
        return None

    def _over_budget(self) -> bool:
        if self.max_blocks and len(self._lru) > self.max_blocks:
            return True
        return self.max_bytes is not None and self.bytes > self.max_bytes

    def _would_overflow(self, nb: int) -> bool:
        """Would admitting one more ``nb``-byte entry push past either
        budget? (The probation admission pre-check.)"""
        if self.max_blocks and len(self._lru) + 1 > self.max_blocks:
            return True
        return self.max_bytes is not None and self.bytes + nb > self.max_bytes

    def clear(self) -> int:
        """Drop EVERY entry — host memory dies with the process, so a
        replica kill clears this tier along with the device LRU (a
        revived replica re-warms from traffic, never resurrects pre-kill
        pages). Returns the count."""
        n = len(self._lru)
        self._lru.clear()
        self._probation.clear()
        self._probation_bytes = 0
        self._nbytes.clear()
        self._canon.clear()
        self._kids.clear()
        self.bytes = 0
        return n

    # -- invariants ----------------------------------------------------

    def check(self, device_live: Optional[Callable[[Any], bool]] = None
              ) -> None:
        """Tier-internal consistency: byte accounting exact, chain links
        bijective with entries, and NO stranded entry (every host key's
        parent is host-live or device-live). Raises RuntimeError on any
        violation — called by ``BlockPool.check_consistent``."""
        live = device_live or self.device_live
        if set(self._lru) != set(self._nbytes) or \
                set(self._lru) != set(self._canon):
            raise RuntimeError("host tier LRU / byte accounting diverged")
        if set(self._probation) - set(self._lru):
            raise RuntimeError("host tier probation entry outside the LRU")
        if self.bytes != sum(self._nbytes.values()):
            raise RuntimeError(
                f"host tier byte gauge {self.bytes} != "
                f"{sum(self._nbytes.values())} (sum of entries)")
        if self._probation_bytes != \
                sum(self._nbytes[k] for k in self._probation):
            raise RuntimeError(
                f"host tier probation byte gauge {self._probation_bytes} "
                f"!= {sum(self._nbytes[k] for k in self._probation)} "
                f"(sum of probation entries)")
        for parent, kids in self._kids.items():
            for child in kids:
                if child not in self._lru:
                    raise RuntimeError(
                        f"host tier chain link to dead entry {child!r}")
        for key in self._lru:
            prev = getattr(key, "prev", None)
            if prev is None:
                continue
            if prev not in self._lru and not live(prev):
                raise RuntimeError(
                    f"stranded host page {key!r}: chain parent in "
                    f"neither tier (unreachable by any prefix match)")

    def stats(self) -> Dict[str, Any]:
        """One tier-table row (CLI reports, /statusz, bench artifacts)."""
        return {
            "tier": "host",
            "capacity_blocks": self.max_blocks or None,
            "capacity_bytes": self.max_bytes,
            "blocks": len(self._lru),
            "probation_blocks": len(self._probation),
            "bytes": self.bytes,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "evictions": self.evictions,
            "rejected": self.rejected,
            "probation_rejected": self.probation_rejected,
        }
