"""Continuous-batching scheduler: FIFO admission, slot recycling, preemption.

Counterpart of ``deepspeed_tpu/inference/serving/scheduler.py`` without
the fleet's fields (``recovered``, ``admit_log``): the host-tier
promotion state and the speculative-decoding counters are here.

Pure host-side bookkeeping (no torch): which request sits in which decode
slot, which pool pages it owns, and who gets evicted when the pool runs
dry. The serving engine (``engine.py``) owns the device programs and calls
into this state machine once per step.

Policy, in the vLLM lineage the paged pool comes from:

- **FIFO admission**: only the queue HEAD is considered; if it does not fit
  (no slot, or not enough free pages for its prompt) nothing behind it is
  admitted either — head-of-line blocking is what keeps admission FIFO.
- **Slot recycling**: a sequence that finishes (EOS / token budget) frees
  its slot and pages the same step, so the next step can admit from queue.
- **Preemption-with-requeue**: when a RUNNING sequence needs one more page
  and the pool is dry, the lowest-priority (then most-recently-admitted)
  other sequence is evicted: its pages are freed and it returns to the
  FRONT of the queue carrying ``prompt + generated`` so re-admission
  re-prefills and resumes exactly where it stopped (recompute-style
  preemption — no KV swapping).
- **Deadlines + terminal discipline**: queued requests past deadline are
  shed at the admission gate (terminal ``TIMEOUT``); every terminal
  transition (finish/fail/timeout/cancel) funnels through ``_release`` so
  pages ALWAYS return to the pool — the chaos-suite invariant.
"""

import enum
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ...monitor.tracing import NULL_TRACER, Tracer
from ...utils.logging import logger
from .block_pool import BlockPool, ChainKey


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    FAILED = "failed"
    TIMEOUT = "timeout"       # deadline expired (queued or mid-decode)
    CANCELLED = "cancelled"   # caller cancel() / load shed / drain


#: every request ends in exactly one of these — the chaos-suite invariant
TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.FAILED,
                             RequestState.TIMEOUT, RequestState.CANCELLED})


class RejectedError(RuntimeError):
    """Admission control refused a submit (queue full / KV headroom /
    draining). ``reason`` carries the machine-readable cause."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


_rid_counter = itertools.count()


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    #: larger = more important; shedding and preemption take the smallest
    #: priority first (ties: newest admitted / newest submitted)
    priority: int = 0
    #: absolute ``time.perf_counter()`` stamp; None = no deadline
    deadline: Optional[float] = None
    rid: str = field(default_factory=lambda: f"req-{next(_rid_counter)}")
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = field(default_factory=list)   # generated so far
    slot: Optional[int] = None
    blocks: List[int] = field(default_factory=list)
    seq_len: int = 0          # tokens whose KV sits in the pool
    #: tokens served from the prefix cache at the LATEST admission (their
    #: KV was never recomputed); block-aligned by construction. Includes
    #: host-tier hits (their KV streams up instead of recomputing)
    prefix_len: int = 0
    #: tokens of ``prefix_len`` matched in the HOST tier at the latest
    #: admission (block-aligned; the tail of the cached prefix)
    host_prefix_len: int = 0
    #: host-tier admission hits awaiting promotion scheduling:
    #: ``(block_idx, chain_key, payload)`` per matched block — the
    #: scheduler (torch-free) captures the payload references; the ENGINE
    #: consumes this list right after admission, starts the payloads'
    #: copy to the device onto its promotion queue and clears it
    host_hits: List[tuple] = field(default_factory=list)
    #: scheduled promotions that have not folded into the device pool
    #: yet. While nonzero the request receives NO prefill grants — its
    #: suffix chunks would attend pages whose KV is still in flight —
    #: but the PACKED step never waits: everyone else plans and
    #: dispatches as usual (the "blocks only that request's next grant"
    #: rule)
    promote_pending: int = 0
    #: resume tokens whose KV is in the pool so far — between admission and
    #: the last prefill chunk this trails ``prefill_target`` and the
    #: request sits in a slot WITHOUT decoding (chunked prefill)
    prefill_done: int = 0
    #: len(resume_tokens) FROZEN at admission — the prefill finish line.
    #: (resume_tokens itself grows as decode appends generated tokens, so
    #: comparing against it live would make a decoding request look
    #: perpetually mid-prefill)
    prefill_target: int = 0
    #: chained content KEYS (block_pool.ChainKey) of the full blocks of
    #: resume_tokens, set at submit/preempt and extended as generated
    #: tokens fill further blocks
    block_hashes: List[ChainKey] = field(default_factory=list)
    #: watermark over ``blocks``: pages [0, committed_blocks) are already
    #: content-indexed (commit is idempotent; this keeps it O(1) per step)
    committed_blocks: int = 0
    submit_time: float = field(default_factory=time.perf_counter)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    finish_reason: Optional[str] = None
    #: SLO verdict stamped at the terminal transition (engine.py judges;
    #: one of metrics.SLO_VERDICTS) — rides the terminal "request" span
    slo_verdict: Optional[str] = None
    preemptions: int = 0
    admit_order: int = -1     # monotone stamp set at admission (victim pick)
    #: latest admission stamp (perf_counter seconds; None while queued)
    admit_time: Optional[float] = None
    # -- speculative decoding (engine.py drives; see serving/speculative.py)
    #: adaptive per-request draft-length cap: -1 = unset (the engine
    #: seeds it from ``ServingConfig.spec_tokens`` on first use), then
    #: grown on full accepts and halved on full rejects so a resident
    #: whose drafter keeps missing stops paying verify tokens for nothing
    spec_k: int = -1
    #: EXPONENTIALLY-DECAYED draft/accept counters (the engine decays
    #: both before each verify commit, so their ratio is the RECENT
    #: accept rate — a request whose stream turns predictable must not
    #: stay gated by misses from fifty tokens ago). Engine-wide totals
    #: live in ServingMetrics; these exist only for the adaptive cap.
    spec_drafted: float = 0.0
    spec_accepted: float = 0.0
    # -- tracing: the request's current lifecycle phase -----------------
    # phases partition submit -> terminal into contiguous, non-overlapping
    # spans (queue | prefill | decode); every transition emits the span it
    # closes, so a trace reconstructs exactly where a request's latency
    # went. Preemption re-opens "queue"; TTFT = queue + prefill.
    phase: str = "queue"
    phase_start: float = 0.0

    def __post_init__(self):
        self.phase_start = self.submit_time

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    @property
    def prefilling(self) -> bool:
        """RUNNING but still owed prefill chunks: holds a slot and pages
        yet must not decode until its whole (resume-)prompt is in the
        pool."""
        return self.state is RequestState.RUNNING and \
            self.prefill_done < self.prefill_target

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline

    @property
    def resume_tokens(self) -> List[int]:
        """What a (re-)prefill replays: the prompt plus everything already
        generated — recompute-style preemption resumes exactly here."""
        return self.prompt + self.tokens

    @property
    def resume_len(self) -> int:
        """len(resume_tokens) without materializing the concat — the
        admission gates scan the whole queue per submit and only need
        lengths + the memoized block keys."""
        return len(self.prompt) + len(self.tokens)

    @property
    def remaining_new(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


class Scheduler:
    def __init__(self, num_slots: int, pool: BlockPool,
                 max_blocks_per_seq: int, prefix_cache: bool = False,
                 tracer: Optional[Tracer] = None):
        self.num_slots = num_slots
        self.pool = pool
        self.max_blocks_per_seq = max_blocks_per_seq
        #: content-addressed KV reuse: admission matches each prompt's
        #: longest cached prefix and acquires those pages instead of
        #: recomputing them
        self.prefix_cache = prefix_cache
        #: span sink for the per-request timeline (NULL_TRACER = free).
        #: Identity check, not truthiness — an EMPTY tracer is len() 0
        #: and would falsely read as "no tracer"
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * num_slots
        self._admit_stamp = itertools.count()
        #: requests ``admit_next``/``expire_queued`` moved to TIMEOUT this
        #: step; the engine drains it for metrics/accounting
        self.reaped: List[Request] = []
        #: called once per terminal transition, AFTER the request's final
        #: state/reason/finish_time are set and BEFORE the terminal span
        #: is emitted — the engine hangs SLO attribution here (setting
        #: ``req.slo_verdict`` so the span carries it). Every terminal
        #: path funnels through ``_release``, so the hook cannot miss a
        #: request, including gate-side sheds the engine never touches.
        self.on_terminal: Optional[Callable[[Request], None]] = None

    # -- tracing: phase transitions ------------------------------------

    def _phase(self, req: Request, new_phase: str,
               now: Optional[float] = None) -> None:
        """Close the request's current phase (emitting its span) and open
        ``new_phase``. Phase spans are contiguous by construction: each
        starts exactly where the previous ended, so a request's phases
        tile submit -> terminal with no gaps and no overlap."""
        now = time.perf_counter() if now is None else now
        if self.tracer.enabled:
            self.tracer.complete(f"phase:{req.phase}", req.phase_start, now,
                                 cat="request", args={"rid": req.rid})
        req.phase = new_phase
        req.phase_start = now

    def note_decoding(self, req: Request) -> None:
        """The engine sampled a token for this request: if it was still in
        its prefill phase (first token after THIS admission — the original
        one or a post-preemption resume), prefill ends here and decode
        begins. For the first-ever token that boundary IS the TTFT split:
        TTFT = queue + prefill by construction."""
        if req.phase == "prefill":
            self._phase(req, "decode")

    # -- introspection -------------------------------------------------

    def active(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return None

    # -- admission (FIFO) ----------------------------------------------

    def submit(self, req: Request) -> None:
        need = self.pool.blocks_for_tokens(len(req.prompt) + req.max_new_tokens)
        if need > min(self.max_blocks_per_seq, self.pool.num_blocks):
            raise ValueError(
                f"request {req.rid} needs {need} KV blocks at its length "
                f"cap; the pool serves at most "
                f"{min(self.max_blocks_per_seq, self.pool.num_blocks)} per "
                f"sequence (raise num_blocks/max_model_len)")
        if self.prefix_cache and not req.block_hashes:
            # hash ONCE per lifetime-segment (submit and preempt, when
            # resume_tokens changes) — the headroom gate rescans the whole
            # queue per submit, and rehashing every queued prompt there
            # would make admission O(queue x prompt_len). The engine's
            # submit already sets the keys; this covers direct scheduler
            # users
            req.block_hashes = self.pool.prefix_block_hashes(
                req.resume_tokens)
        self.queue.append(req)

    def admission_charges(self, newcomer_len: Optional[int] = None,
                          newcomer_hashes: Optional[List[ChainKey]] = None,
                          exclude=()):
        """Per-request KV-headroom charges for the whole queue (plus an
        optional not-yet-queued newcomer), as ``({rid: blocks}, newcomer)``.

        With the prefix cache on each charge is the request's
        admission_charge_len — uncached suffix + cached pages it would
        newly PIN — with one ``pinned_seen`` set threaded through the
        whole scan, so a page shared by N queued sharers is charged once,
        not N times. ``exclude`` drops requests (by rid) from the scan:
        the engine's displacement loop re-runs the scan without its
        victims rather than subtracting their charges — a shared pin
        charged to a shed victim would otherwise be credited even though
        a SURVIVING sharer still pins that page."""
        pinned: set = set()
        charges = {}
        for r in self.queue:
            if r.rid in exclude:
                continue
            charges[r.rid] = self.pool.admission_charge_len(
                r.resume_len, r.block_hashes, pinned) if self.prefix_cache \
                else self.pool.blocks_for_tokens(r.resume_len)
        newcomer = None
        if newcomer_len is not None:
            newcomer = self.pool.admission_charge_len(
                newcomer_len, newcomer_hashes, pinned) if self.prefix_cache \
                else self.pool.blocks_for_tokens(newcomer_len)
        return charges, newcomer

    def queued_block_demand(self) -> int:
        """Prefill pages the queue would NEWLY claim if admitted right now
        — the KV-headroom admission signal (sum of
        :meth:`admission_charges`)."""
        charges, _ = self.admission_charges()
        return sum(charges.values())

    def expire_queued(self, now: Optional[float] = None) -> List[Request]:
        """Shed every queued request past its deadline (any position, not
        just the head): terminal TIMEOUT, no pages to return (queued
        requests never own pages). Returns the shed requests and also
        stages them on ``self.reaped``."""
        now = time.perf_counter() if now is None else now
        shed = [r for r in self.queue if r.expired(now)]
        for req in shed:
            self.queue.remove(req)
            self._release(req, RequestState.TIMEOUT, "deadline")
            self.reaped.append(req)
        return shed

    def admit_next(self, now: Optional[float] = None) -> Optional[Request]:
        """Admit the queue HEAD if a slot and its prefill pages are free;
        None otherwise (nothing behind the head is considered — FIFO).
        Heads already past their deadline are shed (TIMEOUT, staged on
        ``self.reaped``) rather than admitted — expiry is enforced at the
        admission gate, so a deadline is honored even if the engine never
        ran a dedicated expiry sweep."""
        now = time.perf_counter() if now is None else now
        while self.queue and self.queue[0].expired(now):
            req = self.queue.popleft()
            self._release(req, RequestState.TIMEOUT, "deadline")
            self.reaped.append(req)
        if not self.queue:
            return None
        slot = self._free_slot()
        if slot is None:
            return None
        req = self.queue[0]
        tokens = req.resume_tokens
        need_total = self.pool.blocks_for_tokens(len(tokens))
        matched: List[int] = []
        if self.prefix_cache:
            # longest cached prefix (full blocks, chained content keys —
            # computed once at submit/preempt — at least one token left to
            # compute); acquire BEFORE the headroom check so the matched
            # pages cannot be evicted from under us — on a failed admit
            # they are released straight back to cached
            matched = self.pool.match_prefix(tokens, req.block_hashes)
            if matched:
                self.pool.acquire(matched, req.rid)
        if not self.pool.can_allocate(need_total - len(matched)):
            if matched:
                self.pool.free(matched, req.rid)
            return None
        host_keys: List[Tuple[ChainKey, dict]] = []
        if self.prefix_cache and self.pool.host_tier is not None:
            # extend the match into the HOST tier (contiguous from the
            # device boundary). Payloads are captured NOW — a host LRU
            # eviction between here and the promotion fold can then
            # never lose content admission already promised. These
            # blocks charge device headroom like fresh allocations
            # (they come out of the allocate() below) until promoted —
            # the admission-charge rule the headroom gate also applies.
            for h in self.pool.host_match_keys(len(tokens),
                                               req.block_hashes,
                                               len(matched)):
                payload = self.pool.host_tier.get(h)
                if payload is None:
                    break  # raced an eviction: the run ends here
                host_keys.append((h, payload))
        self.queue.popleft()
        req.blocks = matched + self.pool.allocate(need_total - len(matched),
                                                  req.rid)
        bs = self.pool.block_size
        req.prefix_len = (len(matched) + len(host_keys)) * bs
        req.host_prefix_len = len(host_keys) * bs
        req.host_hits = [(len(matched) + j, h, payload)
                         for j, (h, payload) in enumerate(host_keys)]
        req.promote_pending = len(host_keys)
        req.prefill_done = req.prefix_len
        req.prefill_target = len(tokens)
        req.seq_len = req.prefix_len
        req.slot = slot
        req.state = RequestState.RUNNING
        req.admit_order = next(self._admit_stamp)
        req.admit_time = time.perf_counter()
        # queue phase ends, prefill begins — the queue_wait share of TTFT
        # is this span
        self._phase(req, "prefill", now=req.admit_time)
        if self.tracer.enabled:
            self.tracer.instant("admit", cat="sched",
                                args={"rid": req.rid,
                                      "prefix_tokens": req.prefix_len,
                                      "host_tokens": req.host_prefix_len,
                                      "queue_depth": len(self.queue)})
        self.slots[slot] = req
        return req

    # -- mixed-step prefill packing ------------------------------------

    def plan_prefill_grants(self, budget: int, chunk: int
                            ) -> "Dict[str, int]":
        """Split this step's prefill token ``budget`` across mid-prefill
        residents: round-robin ``chunk``-sized grants in admission order
        until the budget is gone or nobody is owed tokens. Grants to one
        request are CONTIGUOUS prompt tokens, so several rounds simply
        extend its packed segment — the unified mixed step packs each
        ``{rid: tokens}`` entry as one ragged row. Pure planning: no
        request state changes here (the engine commits after the packed
        dispatch lands)."""
        grants: Dict[str, int] = {}
        if budget <= 0 or chunk <= 0:
            return grants
        # promotion-blocked residents are skipped, not waited for: their
        # next suffix chunk would attend host-matched pages whose KV is
        # still streaming up, so granting them would poison attention —
        # withholding THEIR grant is the only cost an unlanded promotion
        # may impose; the packed step itself never blocks on a transfer
        pending = sorted((r for _, r in self.active()
                          if r.prefilling and not r.promote_pending),
                         key=lambda r: r.admit_order)
        while budget > 0:
            progressed = False
            for req in pending:
                if budget <= 0:
                    break
                owed = (req.prefill_target - req.prefill_done
                        - grants.get(req.rid, 0))
                n = min(chunk, budget, owed)
                if n <= 0:
                    continue
                grants[req.rid] = grants.get(req.rid, 0) + n
                budget -= n
                progressed = True
            if not progressed:
                break
        return grants

    # -- decode-time page growth / preemption --------------------------

    def ensure_decode_headroom(self, req: Request, lookahead: int = 0
                               ) -> bool:
        """Make sure the pages holding positions ``seq_len .. seq_len +
        lookahead`` exist (the next step appends there: one token for a
        plain decode row, ``1 + k`` for a verify row carrying ``k``
        drafted tokens). False = pool dry, caller must preempt — or, on
        the speculative path, first drop the drafts and retry with
        ``lookahead=0`` so speculation degrades before anyone is
        evicted."""
        need_idx = (req.seq_len + lookahead) // self.pool.block_size
        while len(req.blocks) <= need_idx:
            if not self.pool.can_allocate(1):
                return False
            req.blocks.extend(self.pool.allocate(1, req.rid))
        return True

    def preempt_victim(self, exclude: Request) -> Optional[Request]:
        """Lowest-priority running request other than ``exclude``; within a
        priority, the most recently admitted (graceful degradation sheds
        cheap/new work first)."""
        candidates = [r for _, r in self.active() if r is not exclude]
        if not candidates:
            return None
        return max(candidates, key=lambda r: (-r.priority, r.admit_order))

    def displaceable(self, below_priority: int) -> List[Request]:
        """Queued requests a higher-priority submit may displace, in shed
        order: strictly lower priority than the newcomer, lowest priority
        first, newest submission within a tier. THE one definition of the
        load-shedding policy — admission gates consume this list as a dry
        run and commit via ``cancel``."""
        return sorted((r for r in self.queue if r.priority < below_priority),
                      key=lambda r: (r.priority, -r.submit_time))

    def preempt(self, req: Request) -> None:
        """Evict: free pages + slot, requeue at the FRONT carrying progress.
        With the prefix cache on, the freed pages whose content was hashed
        park on the cached LRU — re-admission matches them back and the
        "recompute-style" resume recomputes almost nothing."""
        self.pool.free(req.blocks, req.rid)
        self.slots[req.slot] = None
        req.blocks = []
        req.slot = None
        req.seq_len = 0
        req.prefix_len = 0
        req.host_prefix_len = 0
        # in-flight promotions die with the admission segment: the pages
        # they target just returned to the pool, so the engine's pump
        # drops their queue entries (validity = this request's CURRENT
        # admission stamp + block ids); re-admission re-matches the host
        # tier, whose entries were not consumed (commit never ran)
        req.host_hits = []
        req.promote_pending = 0
        req.prefill_done = 0
        req.prefill_target = 0
        req.committed_blocks = 0
        if self.prefix_cache:
            # resume_tokens changed (generated tokens fold into the
            # replayed prompt): re-key the full blocks once, here
            req.block_hashes = self.pool.prefix_block_hashes(
                req.resume_tokens)
        req.state = RequestState.QUEUED
        req.preemptions += 1
        # back to the queue: whatever phase was open (prefill or decode)
        # closes here and a new queue span begins
        self._phase(req, "queue")
        if self.tracer.enabled:
            self.tracer.instant("preempt", cat="sched",
                                args={"rid": req.rid,
                                      "preemptions": req.preemptions})
        self.queue.appendleft(req)

    # -- completion (every terminal transition funnels through _release,
    # so "pages always return to the pool" is enforced in ONE place) ----

    def _release(self, req: Request, state: RequestState, reason: str) -> None:
        if req.state is RequestState.QUEUED and req in self.queue:
            # a terminal request must never sit in the deque: admit_next
            # would silently resurrect it to RUNNING later (the "in queue"
            # check covers callers that already popped it themselves)
            self.queue.remove(req)
        if req.slot is not None:
            self.pool.free(req.blocks, req.rid)
            self.slots[req.slot] = None
            req.blocks = []
            req.slot = None
        req.state = state
        req.finish_reason = reason
        req.finish_time = time.perf_counter()
        if self.on_terminal is not None:
            # SLO attribution runs before the span below so the verdict
            # rides it; a broken hook must not leak pages or wedge the
            # release path — the pages are already back in the pool
            try:
                self.on_terminal(req)
            except Exception as e:
                logger.error(f"scheduler on_terminal hook failed for "
                             f"{req.rid}: {type(e).__name__}: {e}")
        # terminal: close the open phase and emit the request's umbrella
        # span (submit -> terminal) — the timeline-completeness contract:
        # EVERY terminal request has a request span whose phases tile it
        self._phase(req, "terminal", now=req.finish_time)
        if self.tracer.enabled:
            args = {"rid": req.rid, "state": state.value, "reason": reason,
                    "prompt_tokens": len(req.prompt),
                    "generated": len(req.tokens),
                    "preemptions": req.preemptions,
                    "ttft_s": None if req.ttft is None
                    else round(req.ttft, 6)}
            if req.slo_verdict is not None:
                args["slo"] = req.slo_verdict
            self.tracer.complete("request", req.submit_time,
                                 req.finish_time, cat="request", args=args)

    def finish(self, req: Request, reason: str) -> None:
        self._release(req, RequestState.FINISHED, reason)

    def fail(self, req: Request, reason: str) -> None:
        self._release(req, RequestState.FAILED, reason)

    def timeout(self, req: Request, reason: str = "deadline") -> None:
        self._release(req, RequestState.TIMEOUT, reason)

    def cancel(self, req: Request, reason: str = "cancelled") -> None:
        """Terminal CANCELLED from ANY live state: queued requests leave
        the queue, running ones release slot + pages."""
        self._release(req, RequestState.CANCELLED, reason)
