"""Continuous-batching serving engine over a paged KV-cache pool.

Counterpart of ``deepspeed_tpu/inference/serving/engine.py`` with its
unified MIXED step: each :meth:`ServingEngine.step` packs one decode token
per running resident plus this step's budgeted prefill chunks into one
flat token batch of fixed width (``max_batch_size - 1 + budget``), and
raggedness (segment offsets/lengths, chunk starts, context lengths, block
tables) rides as data. The model appends every packed token's KV into the
pool through its row's block table and attends decode rows and chunk rows
with the same ragged paged attention kernel.

Per step:

1. **deadlines** — queued requests past deadline are shed, running ones
   end ``TIMEOUT`` with their pages returned;
2. **admit** — FIFO queue head(s) get a slot + pages (brownout caps their
   token budget); their prompt starts consuming the prefill budget;
3. **grow/preempt** — every decoding resident gets a page for the token
   this step appends; when the pool is dry the lowest-priority, most
   recently admitted sequence goes back to the queue front;
4. **mixed step** — one forward over the packed batch; decode rows
   harvest their token, a final chunk harvests token one, NaN/Inf logits
   quarantine their request (never the batch), and finished sequences
   release slot and pages the same step.

The pool lives on the engine's device and is updated in place. Knobs of
the JAX engine that this slice does not implement raise
``NotImplementedError`` naming the slice that brings them.
"""

import dataclasses
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ...models.layers import harvest_packed_logits, paged_cache_index
from ...monitor.tracing import Tracer
from ...utils.logging import log_dist
from ..engine import InferenceEngine, _sample_logits
from .block_pool import BlockPool
from .metrics import ServingMetrics
from .scheduler import RejectedError, Request, RequestState, Scheduler

#: ServingConfig knobs of the JAX engine that later slices bring, with the
#: value that means "off" and the slice (ROADMAP.md Queue 1) that adds them
_DEFERRED = {
    "mixed_step": (True, "the legacy two-program engine"),
    "mixed_step_buckets": (False, "the CUDA-graph step widths"),
    "prefix_cache": (False, "the prefix cache with copy-on-write"),
    "spec_tokens": (0, "speculative decoding"),
    "host_cache_blocks": (0, "the host KV tier"),
    "step_watchdog_s": (0.0, "the step watchdog and fault injection"),
}


@dataclasses.dataclass
class ServingConfig:
    """Knobs of the serving layer (the inference config keeps model-level
    ones: dtype, ``kv_cache_int8``)."""

    #: decode slots: rows of the packed step
    max_batch_size: int = 8
    #: tokens per KV page
    block_size: int = 16
    #: pages in the shared pool (total KV capacity = num_blocks * block_size)
    num_blocks: int = 256
    #: per-sequence cap on prompt + generated tokens; also fixes the block
    #: table width (max_model_len / block_size)
    max_model_len: int = 512
    # sampling
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    #: seeds the engine's torch.Generator (sampling draws)
    seed: int = 0
    #: per-row per-round granularity of prefill budget packing (0 = 4 *
    #: block_size); a row may take several rounds in one step
    prefill_chunk_tokens: int = 0
    #: prompt tokens per step; also sizes the packed batch
    #: (max_batch_size - 1 + budget). 0 = one chunk's worth per step
    prefill_token_budget: int = 0
    # -- overload control ---------------------------------------------
    #: queued requests beyond this are rejected (0 = unbounded); a
    #: higher-priority submit displaces the lowest-priority queued request
    max_queue_depth: int = 0
    #: KV-headroom admission gate: keep at least this many pool blocks
    #: clear of committed demand (None disables the gate)
    kv_headroom_blocks: Optional[int] = None
    #: deadline applied to submits that do not pass their own (seconds)
    default_deadline_s: Optional[float] = None
    #: brownout auto-engages when pool occupancy reaches this fraction
    brownout_occupancy: Optional[float] = None
    #: token budget cap applied to admissions while browned out
    brownout_max_new_tokens: int = 8
    #: quarantine requests whose logits go NaN/Inf instead of emitting
    #: garbage tokens
    logit_guard: bool = True
    # -- tracing -------------------------------------------------------
    #: record span timelines into a bounded ring (ServingEngine.tracer)
    trace: bool = False
    trace_capacity: int = 8192
    # -- knobs later slices implement (see _DEFERRED) ------------------
    mixed_step: bool = True
    mixed_step_buckets: bool = False
    prefix_cache: bool = False
    spec_tokens: int = 0
    host_cache_blocks: int = 0
    step_watchdog_s: float = 0.0

    def __post_init__(self):
        for name, (off, slice_name) in _DEFERRED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"ServingConfig.{name}={getattr(self, name)!r} arrives "
                    f"with the {slice_name} slice of the port "
                    f"(ROADMAP.md Queue 1)")


@dataclasses.dataclass
class RequestOutput:
    rid: str
    state: str
    prompt: List[int]
    tokens: List[int]
    finish_reason: Optional[str]
    ttft_s: Optional[float]
    preemptions: int


class ServingEngine:
    """Continuous-batching front end. Construct from an
    :class:`InferenceEngine` (or via :func:`init_serving`); drive with
    :meth:`submit` / :meth:`poll` / :meth:`stream` / :meth:`run`."""

    def __init__(self, engine: InferenceEngine,
                 config: Optional[ServingConfig] = None):
        if not isinstance(engine, InferenceEngine):
            raise TypeError("ServingEngine wraps an InferenceEngine; use "
                            "init_serving(...) to build both")
        self.engine = engine
        self.config = cfg = config or ServingConfig()
        self.device = engine.device
        if cfg.max_model_len % cfg.block_size:
            raise ValueError("max_model_len must be a multiple of block_size")
        if cfg.prefill_chunk_tokens < 0 or cfg.prefill_token_budget < 0:
            raise ValueError(
                "prefill_chunk_tokens and prefill_token_budget must be "
                ">= 0 (0 = default)")
        chunk = cfg.prefill_chunk_tokens or 4 * cfg.block_size
        self._chunk = min(chunk, cfg.max_model_len)
        self._chunk_budget = cfg.prefill_token_budget or self._chunk
        # packed token capacity: every slot may decode (1 token each) OR,
        # with a slot mid-prefill, max_batch_size - 1 decoders plus the
        # whole prefill budget
        self._mixed_tokens = max(cfg.max_batch_size,
                                 cfg.max_batch_size - 1 + self._chunk_budget)

        self.tracer = Tracer(capacity=cfg.trace_capacity, enabled=cfg.trace)
        self.nb_max = cfg.max_model_len // cfg.block_size
        self.block_pool = BlockPool(cfg.num_blocks, cfg.block_size)
        self.sched = Scheduler(cfg.max_batch_size, self.block_pool,
                               self.nb_max, tracer=self.tracer)
        self.metrics = ServingMetrics(blocks_total=cfg.num_blocks)

        kv_dtype = torch.int8 if engine.config.kv_cache_int8 \
            else engine.compute_dtype
        self.pool = engine.module.init_paged_cache(
            cfg.num_blocks, cfg.block_size, dtype=kv_dtype,
            device=self.device)

        B = cfg.max_batch_size
        self._tables = np.full((B, self.nb_max), self.block_pool.sentinel,
                               np.int32)
        self._last_tok = np.zeros((B,), np.int32)
        self._requests: Dict[str, Request] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._step_no = 0
        self._draining = False
        #: manual brownout override: None = automatic (occupancy), else forced
        self._brownout_forced: Optional[bool] = None
        #: the packed step has one fixed shape, so it is "built" once
        self.compile_counts = {"mixed_step": 0}
        log_dist(f"ServingEngine: slots={B}, pool={cfg.num_blocks}x"
                 f"{cfg.block_size} ({kv_dtype}), max_len="
                 f"{cfg.max_model_len}, device={self.device}", ranks=[0])

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int = 16,
               eos_token_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: int = 0) -> str:
        """Enqueue a request; returns its id (admission is FIFO within a
        priority). Raises :class:`RejectedError` when admission control
        refuses the request (queue full / KV headroom / draining) — use
        :meth:`try_submit` for a non-raising variant. ``deadline_s`` is a
        total-latency budget from now; a request still queued or decoding
        past it ends in terminal ``TIMEOUT``."""
        prompt = [int(t) for t in np.asarray(prompt_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        # coerce every caller-supplied field up front: a malformed argument
        # must raise before the admission gates shed displacement victims
        max_new_tokens = int(max_new_tokens)
        priority = int(priority)
        if deadline_s is not None:
            deadline_s = float(deadline_s)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) + max_new_tokens > self.config.max_model_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_model_len={self.config.max_model_len}")
        need_cap = self.block_pool.blocks_for_tokens(
            len(prompt) + max_new_tokens)
        if need_cap > min(self.nb_max, self.block_pool.num_blocks):
            raise ValueError(
                f"request needs {need_cap} KV blocks at its length cap; "
                f"the pool serves at most "
                f"{min(self.nb_max, self.block_pool.num_blocks)} per "
                f"sequence (raise num_blocks/max_model_len)")
        cfg = self.config
        tr = self.tracer
        if self._draining:
            self.metrics.requests_rejected += 1
            if tr.enabled:
                tr.instant("reject", cat="sched", args={"reason": "draining"})
            raise RejectedError("draining", "engine is draining; "
                                "no new admissions")
        # Both admission gates honor priority displacement: a newcomer that
        # outranks queued work sheds it (lowest priority first, newest
        # within a tier) rather than being rejected. Victims are selected
        # as a DRY RUN and only cancelled once the newcomer passes every
        # gate — a reject must never destroy queued work.
        victims: List[Request] = []
        displaceable = self.sched.displaceable(priority)
        if cfg.kv_headroom_blocks is not None:
            budget = self.block_pool.num_blocks - cfg.kv_headroom_blocks
            it = iter(displaceable)
            while True:
                charges, newcomer = self.sched.admission_charges(
                    newcomer_len=len(prompt),
                    exclude={v.rid for v in victims})
                demand = (self.block_pool.used_count
                          + sum(charges.values()) + newcomer)
                if demand <= budget:
                    break
                v = next(it, None)
                if v is None:
                    break
                victims.append(v)
            if demand > budget:
                self.metrics.requests_rejected += 1
                if tr.enabled:
                    tr.instant("reject", cat="sched",
                               args={"reason": "kv_headroom",
                                     "demand": int(demand),
                                     "budget": int(budget)})
                raise RejectedError(
                    "kv_headroom", f"committed KV demand {demand} "
                    f"blocks exceeds admission budget {budget} "
                    f"(pool {self.block_pool.num_blocks} - headroom "
                    f"{cfg.kv_headroom_blocks})")
        if cfg.max_queue_depth and \
                self.sched.queue_depth - len(victims) >= cfg.max_queue_depth:
            extra = next((v for v in displaceable if v not in victims), None)
            if extra is None:
                self.metrics.requests_rejected += 1
                if tr.enabled:
                    tr.instant("reject", cat="sched",
                               args={"reason": "queue_full",
                                     "depth": self.sched.queue_depth})
                raise RejectedError(
                    "queue_full", f"queue depth {self.sched.queue_depth} at "
                    f"cap {cfg.max_queue_depth}")
            victims.append(extra)
        for v in victims:
            if tr.enabled:
                tr.instant("displace", cat="sched",
                           args={"victim": v.rid, "priority": priority})
            self.sched.cancel(v, "shed_overload")
            self.metrics.requests_shed += 1
        if deadline_s is None:
            deadline_s = cfg.default_deadline_s
        deadline = None if deadline_s is None \
            else time.perf_counter() + float(deadline_s)
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id, priority=priority,
                      deadline=deadline)
        if not self.sched.has_work():
            # traffic resuming after a drain (or first ever): re-anchor the
            # throughput window
            self.metrics.on_traffic_resume()
        self.sched.submit(req)
        self._requests[req.rid] = req
        self.metrics.requests_submitted += 1
        if tr.enabled:
            tr.instant("submit", cat="sched",
                       args={"rid": req.rid, "prompt_tokens": len(prompt),
                             "queue_depth": self.sched.queue_depth,
                             "priority": priority})
        return req.rid

    def try_submit(self, prompt_ids, max_new_tokens: int = 16,
                   eos_token_id: Optional[int] = None,
                   deadline_s: Optional[float] = None,
                   priority: int = 0) -> Optional[str]:
        """Backpressure-friendly submit: None instead of RejectedError when
        admission control sheds the request (malformed requests still raise
        ValueError)."""
        try:
            return self.submit(prompt_ids, max_new_tokens=max_new_tokens,
                               eos_token_id=eos_token_id,
                               deadline_s=deadline_s, priority=priority)
        except RejectedError:
            return None

    def cancel(self, rid: str, reason: str = "cancelled") -> bool:
        """Cancel a request in any live state: queued requests leave the
        queue, running ones release slot + pages the same call. Returns
        False when the request already reached a terminal state."""
        req = self._requests[rid]
        if req.done:
            return False
        slot = req.slot
        self.sched.cancel(req, reason)
        if slot is not None:
            self._clear_slot_arrays(slot)
        self.metrics.requests_cancelled += 1
        return True

    def begin_drain(self) -> None:
        """Stop admitting (submits now raise ``RejectedError("draining")``)
        and shed everything still queued, without stepping."""
        self._draining = True
        for req in list(self.sched.queue):
            self.sched.cancel(req, "drained")
            self.metrics.requests_shed += 1

    def drain(self, max_steps: Optional[int] = None) -> Dict[str, "RequestOutput"]:
        """Graceful shutdown: stop admitting, shed the queue, and step until
        every resident finishes. ``resume_admission()`` reopens."""
        self.begin_drain()
        steps = 0
        # has_work(), not "slots occupied": a resident preempted mid-drain
        # sits in the queue between steps and must still finish
        while self.sched.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {rid: self.poll(rid) for rid in self._requests}

    def resume_admission(self) -> None:
        """Reopen admission after :meth:`drain`."""
        self._draining = False

    def set_brownout(self, on: Optional[bool]) -> None:
        """Force brownout on/off; ``None`` returns to automatic
        (occupancy-triggered via ``brownout_occupancy``)."""
        self._brownout_forced = on

    @property
    def brownout(self) -> bool:
        if self._brownout_forced is not None:
            return self._brownout_forced
        thr = self.config.brownout_occupancy
        return thr is not None and self.block_pool.occupancy() >= thr

    def poll(self, rid: str) -> RequestOutput:
        """Non-blocking status + tokens-so-far for a request."""
        req = self._requests[rid]
        return RequestOutput(rid=req.rid, state=req.state.value,
                             prompt=list(req.prompt), tokens=list(req.tokens),
                             finish_reason=req.finish_reason,
                             ttft_s=req.ttft, preemptions=req.preemptions)

    def stream(self, rid: str) -> Iterator[int]:
        """Yield a request's tokens as they are produced, driving the step
        loop while the request is unfinished."""
        req = self._requests[rid]
        sent = 0
        while True:
            while sent < len(req.tokens):
                yield req.tokens[sent]
                sent += 1
            if req.done:
                return
            self.step()

    def run(self, max_steps: Optional[int] = None) -> Dict[str, RequestOutput]:
        """Drain everything submitted so far; returns all retained outputs."""
        steps = 0
        while self.sched.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {rid: self.poll(rid) for rid in self._requests}

    def forget(self, rid: str) -> RequestOutput:
        """Release a request's retained state (cancelling it first if it is
        still live, so its slot and pages return to the pool). Returns the
        final output."""
        req = self._requests[rid]
        if not req.done:
            self.cancel(rid, "forgotten")
        out = self.poll(rid)
        del self._requests[rid]
        return out

    def has_work(self) -> bool:
        return self.sched.has_work()

    # ------------------------------------------------------------------
    # one scheduler step
    # ------------------------------------------------------------------

    def step(self) -> None:
        """Shed expired requests, admit from the queue, then run one packed
        mixed step over every running resident."""
        t0 = time.perf_counter()
        now = time.perf_counter()
        self.sched.expire_queued(now)
        for slot, req in list(self.sched.active()):
            if req.state is RequestState.RUNNING and req.expired(now):
                self.sched.timeout(req, "deadline")
                self._clear_slot_arrays(slot)
                self.metrics.requests_timeout += 1
        brownout = self.brownout
        while True:
            req = self.sched.admit_next()
            if req is None:
                break
            if brownout:
                capped = len(req.tokens) + self.config.brownout_max_new_tokens
                if capped < req.max_new_tokens:
                    req.max_new_tokens = capped
                    self.metrics.brownout_admissions += 1
            # the request's table row is live from admission: its packed
            # segments carry their own query_len, so an un-granted row is
            # inert
            self._write_table_row(req)
        self._account_reaped()
        self._step_mixed(t0, brownout)

    def _finish_step_bookkeeping(self, t0: float, brownout: bool) -> None:
        if self.tracer.enabled:
            self.tracer.complete("step", t0, time.perf_counter(),
                                 cat="engine", args={"step": self._step_no})
        self._step_no += 1
        m = self.metrics
        m.steps += 1
        m.record_step(time.perf_counter() - t0)
        m.queue_depth = self.sched.queue_depth
        m.active_seqs = len(self.sched.active())
        m.blocks_used = self.block_pool.used_count
        prefilling = [r for _, r in self.sched.active() if r.prefilling]
        m.prefill_waiting = len(prefilling)
        m.prefill_queue_age_s = 0.0 if not prefilling else \
            time.perf_counter() - min(r.submit_time for r in prefilling)
        m.brownout_active = brownout

    def _grow_decode_pages(self) -> None:
        """Guarantee every decoding resident a page for the token this step
        appends, preempting (lowest priority, newest first) when the pool
        runs dry."""
        for _, req in list(self.sched.active()):
            if req.state is not RequestState.RUNNING or req.prefilling:
                continue  # preempted below while growing an earlier slot
            while not self.sched.ensure_decode_headroom(req):
                victim = self.sched.preempt_victim(exclude=req)
                if victim is None:
                    # nobody left to evict: the pool cannot hold even one
                    # sequence at this length — a sizing error, not traffic
                    slot = req.slot
                    self.sched.fail(req, "kv_pool_exhausted")
                    self._clear_slot_arrays(slot)
                    self.metrics.requests_failed += 1
                    break
                self._preempt(victim)
            else:
                self._write_table_row(req)  # growth may have added a page
                continue
            break

    def _step_mixed(self, t0: float, brownout: bool) -> None:
        """Pack one decode token per running resident plus this step's
        budgeted prefill chunks into one ragged token batch, run the mixed
        step, and harvest per row."""
        cfg = self.config
        # page growth for the decoders first (it may preempt), then the
        # prefill grants: round-robin chunk-sized shares of the budget
        # across the surviving mid-prefill residents (admission order)
        self._grow_decode_pages()
        grants = self.sched.plan_prefill_grants(self._chunk_budget,
                                                self._chunk)
        for _, req in self.sched.active():
            if req.prefilling and req.rid in grants:
                self._write_table_row(req)

        # pack segments slot-ascending: decode rows are 1 token, granted
        # prefill rows up to their grant, everything else is inert
        R, T = cfg.max_batch_size, self._mixed_tokens
        ids = np.zeros((1, T), np.int32)
        pos = np.full((1, T), -1, np.int32)
        trow = np.full((1, T), -1, np.int32)
        row_start = np.zeros((R,), np.int32)
        row_len = np.zeros((R,), np.int32)
        row_cs = np.zeros((R,), np.int32)
        row_cl = np.zeros((R,), np.int32)
        decodes, prefills = [], []
        cursor = 0
        for slot, req in self.sched.active():
            if req.state is not RequestState.RUNNING:
                continue
            if req.prefilling:
                n = grants.get(req.rid, 0)
                if not n:
                    continue
                start = req.prefill_done
                ids[0, cursor:cursor + n] = \
                    req.resume_tokens[start:start + n]
                pos[0, cursor:cursor + n] = np.arange(start, start + n)
                prefills.append((slot, req, n,
                                 start + n >= req.prefill_target))
            else:
                n, start = 1, req.seq_len
                ids[0, cursor] = self._last_tok[slot]
                pos[0, cursor] = start
                decodes.append((slot, req))
            trow[0, cursor:cursor + n] = slot
            row_start[slot], row_len[slot] = cursor, n
            row_cs[slot], row_cl[slot] = start, start + n
            cursor += n
        if cursor > T:
            raise RuntimeError(f"packed {cursor} tokens into a {T}-token step")
        if cursor == 0:
            self._finish_step_bookkeeping(t0, brownout)
            return

        t_dev = time.perf_counter()
        toks, bad = self._mixed_step(ids, trow, pos, row_start, row_len,
                                     row_cs, row_cl)
        t_end = time.perf_counter()
        if self.tracer.enabled:
            self.tracer.complete("mixed_step", t_dev, t_end, cat="engine",
                                 args={"step": self._step_no,
                                       "decode_tokens": len(decodes),
                                       "prefill_tokens": cursor - len(decodes),
                                       "width": T,
                                       "rows": len(decodes) + len(prefills)})
        step_no = self._step_no
        for slot, req, n, final in prefills:
            req.prefill_done += n
            req.seq_len = req.prefill_done
            self.metrics.prefill_tokens += n
            self.metrics.prefill_tokens_computed += n
            self.metrics.window_tokens += n
            if cfg.logit_guard and bad[slot]:
                self._quarantine(slot, req, step_no, where="prefill")
                continue
            if final:
                # last chunk: token one (TTFT ends here) is the row's last
                # packed position; the slot decodes from the next step
                self._harvest(req, int(toks[row_start[slot] + n - 1]))
        for slot, req in decodes:
            if cfg.logit_guard and bad[slot]:
                self._quarantine(slot, req, step_no, where="decode")
                continue
            req.seq_len += 1
            self._harvest(req, int(toks[row_start[slot]]))
        self._finish_step_bookkeeping(t0, brownout)

    def _mixed_step(self, ids, token_rows, append_pos, row_start, row_len,
                    chunk_start, context_len):
        """The packed forward: appends every packed token's KV into the
        pool (in place), samples every packed position, and flags rows with
        a NaN/Inf logit. Returns host ``(tokens [T], bad [R])``."""
        self.compile_counts["mixed_step"] = 1
        dev = self.device
        idx = paged_cache_index(self._tables, append_pos, context_len,
                                chunk_start=chunk_start,
                                token_rows=token_rows,
                                query_start=row_start, query_len=row_len,
                                device=dev)
        cfg = self.config
        with torch.inference_mode():
            ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
            logits, self.pool = self.engine.module(ids_t, cache=self.pool,
                                                   cache_index=idx)
            lg, bad = harvest_packed_logits(logits, idx["token_rows"],
                                            cfg.max_batch_size)
            tok = _sample_logits(lg, self._gen, cfg.do_sample,
                                 cfg.temperature, cfg.top_k, cfg.top_p)
        return tok.cpu().numpy(), bad.cpu().numpy()

    def _quarantine(self, slot: int, req: Request, step_no: int,
                    where: str) -> None:
        """NaN/Inf logits on one packed row: quarantine THAT request
        (terminal FAILED, pages returned), never the batch."""
        if self.tracer.enabled:
            self.tracer.instant("quarantine", cat="engine",
                                args={"rid": req.rid, "slot": slot,
                                      "step": step_no, "where": where})
        self.sched.fail(req, "corrupt_logits")
        self._clear_slot_arrays(slot)
        self.metrics.logit_quarantines += 1
        self.metrics.requests_failed += 1

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _account_reaped(self) -> None:
        """Count the requests the scheduler shed at the admission gate
        (deadline-expired while queued) this step."""
        if self.sched.reaped:
            self.metrics.requests_timeout += len(self.sched.reaped)
            self.sched.reaped.clear()

    def _write_table_row(self, req: Request) -> None:
        row = np.full((self.nb_max,), self.block_pool.sentinel, np.int32)
        row[:len(req.blocks)] = req.blocks
        self._tables[req.slot] = row

    def _clear_slot_arrays(self, slot: Optional[int]) -> None:
        if slot is None:
            return
        self._tables[slot] = self.block_pool.sentinel
        self._last_tok[slot] = 0

    def _harvest(self, req: Request, token: int) -> None:
        """Account one sampled token; recycle the slot the step a sequence
        finishes (EOS or token budget)."""
        req.tokens.append(token)
        self._last_tok[req.slot] = token
        self.metrics.tokens_generated += 1
        self.metrics.window_tokens += 1
        first = req.first_token_time is None
        if first:
            req.first_token_time = time.perf_counter()
            self.metrics.record_ttft(req.ttft)
        # prefill phase -> decode phase on the first token of this admission
        self.sched.note_decoding(req)
        if first and self.tracer.enabled:
            self.tracer.instant("first_token", cat="request",
                                args={"rid": req.rid,
                                      "ttft_s": round(req.ttft, 6)})
        if req.eos_token_id is not None and token == req.eos_token_id:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")

    def _finish(self, req: Request, reason: str) -> None:
        slot = req.slot
        self.sched.finish(req, reason)
        self._clear_slot_arrays(slot)
        self.metrics.requests_completed += 1

    def _preempt(self, req: Request) -> None:
        slot = req.slot
        self.sched.preempt(req)
        self._clear_slot_arrays(slot)
        self.metrics.preemptions += 1


def init_serving(model=None, config=None, serving_config=None,
                 **kwargs) -> ServingEngine:
    """Build an :class:`InferenceEngine` (same surface as
    ``init_inference``) and wrap it for serving."""
    from ..engine import init_inference

    engine = init_inference(model, config=config, **kwargs)
    return ServingEngine(engine, config=serving_config)
