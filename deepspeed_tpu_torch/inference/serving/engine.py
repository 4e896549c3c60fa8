"""Continuous-batching serving engine over a paged KV-cache pool.

Counterpart of ``deepspeed_tpu/inference/serving/engine.py``. By default
it runs the unified MIXED step: each :meth:`ServingEngine.step` packs one
decode token per running resident plus this step's budgeted prefill chunks
into one flat token batch of fixed width (``max_batch_size - 1 + budget``),
and raggedness (segment offsets/lengths, chunk starts, context lengths,
block tables) rides as data. The model appends every packed token's KV
into the pool through its row's block table and attends decode rows and
chunk rows with the same ragged paged attention kernel (K6).

``ServingConfig(mixed_step=False)`` is the two-program engine the unified
step replaced, kept for comparison: the prefill half of a step runs up to
``prefill_token_budget`` prompt tokens as ``[1, chunk]`` forwards that
attend the pool (kernel K7b), or, with chunking off, each admitted prompt
as one monolithic forward padded to a power of two (the masked flash
kernel when the model's ``prefill_flash_from_empty`` is set); then one
decode forward over ALL slots (kernel K7a), where idle and mid-prefill
slots ride as sentinel rows that read and append nothing. Its forwards
run over static index buffers (one set for the decode, one for the
chunk, one per monolithic bucket); with the inference config's
``enable_cuda_graph`` on a CUDA device each of those shapes is one CUDA
graph, captured after its first forward and replayed after that.

``prefix_cache=True`` works in both: full pages are content-indexed as
they fill, admission reuses each prompt's longest cached prefix, shared
pages are copied on write before any append, and a page's hash commits
only after the logit guard passed the tokens that fill it.

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

Fault recovery, as in the JAX engine: a prefill that raises fails its own
request (``prefill_error:<type>``) and everyone else rides the step; with
``step_watchdog_s`` a warm step (every width's or kind's first forward is
exempt: it runs eagerly and is captured) is awaited against the budget —
its read-back on a CUDA event, its fired chaos stalls by their end time —
and a step past the budget fails its requests (``step_watchdog``) while
the engine skips device work until the abandoned step ends (a kernel
cannot be cancelled; the engine only stops waiting for it). ``DS_FAULT``
chaos points (``stall``, ``slow_step``, ``slow_chunk``, ``corrupt_logits``,
``flaky_prefill``; see ``utils/fault_injection.py``) drill all of it;
``corrupt_logits`` rides as data, so no drill changes a captured graph.
Every terminal request gets an SLO verdict (``ttft_slo_s`` / ``tpot_slo_s``), ``trace_dir`` arms a flight
recorder that dumps on each trip, quarantine and fault, and ``perf``
(``monitor/perf.py``) registers every forward's program and turns the step
wall times into MFU/MBU on the card's own peaks.

Speculative decoding (``spec_tokens``, the unified step only): a
decoding resident's drafts (``speculative.PromptLookupDrafter`` by
default) ride its packed row as a verify segment of ``1 + k`` tokens, the
step's argmax at each of them is the model's prediction after it, the
longest confirmed prefix and the model's bonus token commit, and the
rejected KV is rolled back by rewinding ``seq_len`` (whole rejected pages
are freed). Verify rows spend only the packed step's leftover capacity.

The host KV tier (``host_cache_blocks`` / ``host_cache_bytes``, with
``prefix_cache``, both engines): evicted prefix pages are demoted into
``kv_tiers.HostTier`` (pinned host memory) and admission's prefix match
continues there. Matched host pages are copied back on a side stream and
folded into the pool in place (``index_copy_``) once their copy has
landed, between steps and under the watchdog; until then only their own
request waits for its prefill grants. ``sync_promote`` folds at admission
instead, waiting for the copy.

The pool lives on the engine's device and is updated in place: its
tensors are never rebound, so captured graphs stay valid through
copy-on-write, defrag and promotion.
"""

import dataclasses
import math
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ...models.layers import (PackedIndexBuffers, StaticIndexBuffers,
                              copy_paged_blocks, harvest_packed_logits)
from ...monitor.perf import (PerfAccounting, estimate_decode_step_bytes,
                             estimate_decode_step_flops, fingerprint,
                             param_bytes, transformer_flops_per_token)
from ...monitor.tracing import FlightRecorder, Tracer, dump_seq
from ...utils import fault_injection
from ...utils.logging import log_dist
from ..engine import InferenceEngine, _sample_logits, next_pow2
from .block_pool import BlockPool, BlockPoolError, chain_hash
from .kv_tiers import (HostTier, fetch_paged_blocks, insert_paged_block,
                       upload_paged_blocks)
from .metrics import ServingMetrics
from .scheduler import RejectedError, Request, RequestState, Scheduler
from .speculative import PromptLookupDrafter


class StepWatchdogTimeout(RuntimeError):
    """A serving step exceeded ``step_watchdog_s`` wall-clock."""


@dataclasses.dataclass
class _Promotion:
    """One in-flight host->device promotion: a request's WHOLE matched
    host prefix as one copy to the device (``leaves``, ``[L, k, ...]`` per
    pool tensor, landed when ``event`` completes; None on the CPU), plus
    enough identity to validate the fold targets — the request's CURRENT
    admission segment and the exact page ids it was granted (a
    preempted/terminal request's pages are back in the pool and may
    already belong to someone else). ``width`` is the page count's power
    of two: as in the JAX engine, the first fold of each width is exempt
    from the watchdog."""
    req: Request
    block_idxs: List[int]
    dst_bids: List[int]
    leaves: Dict[str, torch.Tensor]
    event: Any
    width: int
    admit_order: int
    t_sched: float


def _landed(event) -> bool:
    """Has a promotion's copy to the device completed? (No event: the
    copy was synchronous.)"""
    return event is None or event.query()


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
    #: True: the unified packed step (one forward per step). False: the
    #: two-program engine (chunked or monolithic prefill forwards, then a
    #: decode forward over all slots), kept for comparison
    mixed_step: bool = True
    #: smallest prefill bucket: the two-program engine's monolithic
    #: prefill pads prompt lengths up to powers of two from here
    prefill_bucket_min: int = 8
    #: content-addressed KV reuse: full pages are indexed by a key chained
    #: over the token prefix; admission reuses each prompt's longest
    #: cached prefix (copy-on-write on divergence) and prefills only the
    #: suffix; unreferenced pages stay warm and are evicted LRU. Implies
    #: chunked prefill (the from-empty monolithic prefill cannot attend a
    #: cached prefix)
    prefix_cache: bool = False
    #: prefill chunk length in tokens. Unified step: the per-row per-round
    #: granularity of budget packing (0 = 4 * block_size; a row may take
    #: several rounds in one step). Two-program engine: the ``[1, chunk]``
    #: shape of a chunked-prefill forward (0 = monolithic bucketed
    #: prefill, or 4 * block_size with ``prefix_cache``)
    prefill_chunk_tokens: int = 0
    #: prompt tokens per step; on the unified step it also sizes the
    #: packed batch (max_batch_size - 1 + budget). 0 = one chunk's worth
    prefill_token_budget: int = 0
    #: bucketed packed widths for the unified step: instead of every step
    #: paying the full ``max_batch_size - 1 + budget`` packed width, the
    #: step runs at the narrowest of a bounded set (powers of two from
    #: ``max_batch_size`` up to the full width, then the full width) that
    #: holds its packed tokens, so decode-only steps stop computing padding.
    #: ``compile_counts["mixed_step"]`` counts the widths run (at most
    #: ``len(mixed_step_widths)``); with the inference config's
    #: ``enable_cuda_graph`` each width is its own captured graph. Needs
    #: ``mixed_step=True``
    mixed_step_buckets: bool = False
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
    #: wall-clock budget of a warm step (seconds): past it the step's
    #: requests fail (``step_watchdog``) and serving continues (0 = no
    #: watchdog)
    step_watchdog_s: float = 0.0
    # -- SLO attribution -----------------------------------------------
    #: time-to-first-token budget (seconds): a finished request past it
    #: is judged ``ttft_miss`` (None = no TTFT SLO)
    ttft_slo_s: Optional[float] = None
    #: mean inter-token budget (seconds) after the first token (None = no
    #: TPOT SLO)
    tpot_slo_s: Optional[float] = None
    # -- tracing / flight recorder -------------------------------------
    #: record span timelines into a bounded ring (ServingEngine.tracer)
    trace: bool = False
    trace_capacity: int = 8192
    #: directory for trace dumps and flight-recorder post-mortems; setting
    #: it implies ``trace`` (watchdog trips, logit quarantines and DS_FAULT
    #: firings then each dump the last trace events + a metrics snapshot)
    trace_dir: Optional[str] = None
    #: trace events included in each flight-recorder dump
    flight_events: int = 512
    #: write the serving counters to ``init_serving``'s ``monitor`` every
    #: N steps (0 = never)
    monitor_every: int = 1
    # -- speculative decoding (serving/speculative.py) ------------------
    #: max drafted tokens per resident per step (0 = speculation off). A
    #: speculating resident packs a VERIFY row (``query_len = k + 1``)
    #: instead of its one-token decode row, in the same packed step, and
    #: commits up to ``k + 1`` tokens when the model's greedy predictions
    #: confirm the drafts. Verify rows spend the packed step's LEFTOVER
    #: capacity only: prefill grants and the one guaranteed decode token
    #: per resident always outrank them. Requires the unified step and
    #: greedy sampling (``do_sample=False``)
    spec_tokens: int = 0
    #: longest n-gram the default prompt-lookup drafter matches against
    #: the resident's own prompt + generated history (it falls back to
    #: shorter n-grams down to 1; no match = no draft = plain decode)
    spec_ngram: int = 3
    #: pluggable drafter (``serving.speculative.Drafter``); None with
    #: ``spec_tokens > 0`` builds the model-free
    #: :class:`~.speculative.PromptLookupDrafter`. The engine never
    #: mutates it, so one instance may serve several engines
    drafter: Optional[Any] = None
    # -- tiered KV cache (serving/kv_tiers.py) --------------------------
    #: host-RAM spill tier capacity in KV pages (0 = no tier). With a
    #: tier, pool evictions DEMOTE (page copied host-side, content chain
    #: preserved) instead of destroying, admission's longest-prefix match
    #: extends into the host index, and matched host pages stream back
    #: up asynchronously while the rest of the batch keeps stepping.
    #: Requires ``prefix_cache``
    host_cache_blocks: int = 0
    #: host-tier byte budget (None = unbounded; combines with the block
    #: cap — whichever is hit first evicts the tier's own LRU)
    host_cache_bytes: Optional[int] = None
    #: fold every promotion at admission, waiting for its copy, instead of
    #: folding it once landed — the A/B control of the promotion overlap
    sync_promote: bool = False

    def __post_init__(self):
        if self.monitor_every < 0:
            raise ValueError("monitor_every must be >= 0 (0 = never)")


def _sleep_until(t: float) -> None:
    """Sleep until ``perf_counter`` reaches ``t`` (which may be infinite)."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(1.0, left))


class _DeviceDone:
    """Work just queued on the current CUDA stream, awaited on ``event``
    recorded behind it (None on the CPU: nothing to wait for), so the
    caller can wait for it against a deadline (:meth:`wait_until`) and
    give up on a device that does not finish. A promotion's fold is one;
    a forward's read-back (:class:`_ReadBack`) adds its result."""

    def __init__(self, event=None):
        self._event = event
        if event is not None:
            event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait_until(self, deadline: float = math.inf) -> bool:
        """Spin on the event until it completes (True) or the
        ``perf_counter`` ``deadline`` passes (False). (A spin wakes as
        soon as a blocking ``.cpu()`` does; ``Event.synchronize`` woke
        later on the card.)"""
        while not self.ready():
            if time.perf_counter() >= deadline:
                return False
        return True

    def result(self):
        self.wait_until()
        return None


class _ReadBack(_DeviceDone):
    """A forward's ``[n + R]`` int32 output (tokens, then flags) on its way
    to the host. On the card it is copied asynchronously into a pinned
    buffer of its size behind a CUDA event (the pair made once in
    ``buffers``); on the CPU the output is already there."""

    def __init__(self, out: torch.Tensor, n: int, buffers: Dict[int, tuple]):
        self.n = n
        self._host = out
        if out.device.type != "cuda":
            super().__init__()
            return
        pair = buffers.get(out.numel())
        if pair is None:
            pair = buffers[out.numel()] = (torch.empty(
                out.shape, dtype=out.dtype, pin_memory=True),
                torch.cuda.Event())
        self._host, event = pair
        self._host.copy_(out, non_blocking=True)
        super().__init__(event)

    def result(self):
        """Host ``(tokens [n], bad)``, once the copy has completed (the
        pinned buffer is reused by the next read-back of its size)."""
        self.wait_until()
        res = self._host.numpy().copy()
        return res[:self.n], res[self.n:] != 0


class _InFlight:
    """An abandoned (watchdog-tripped) step: the ``perf_counter`` time its
    fired chaos stalls end, and its device work. It is alive while either
    runs."""

    def __init__(self, stall_end: float, readback: _ReadBack):
        self.stall_end = stall_end
        self.readback = readback

    def is_alive(self) -> bool:
        return time.perf_counter() < self.stall_end or \
            not self.readback.ready()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait up to ``timeout`` s for both; True when the step ended."""
        deadline = time.perf_counter() + (math.inf if timeout is None
                                          else timeout)
        _sleep_until(min(self.stall_end, deadline))
        return time.perf_counter() >= self.stall_end and \
            self.readback.wait_until(deadline)


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
                 config: Optional[ServingConfig] = None, monitor=None):
        if not isinstance(engine, InferenceEngine):
            raise TypeError("ServingEngine wraps an InferenceEngine; use "
                            "init_serving(...) to build both")
        if not hasattr(engine.module, "init_paged_cache"):
            # the generic transformer has no paged cache, in either package
            raise TypeError(
                f"{type(engine.module).__name__} has no init_paged_cache: "
                "paged serving supports the Llama and GPT-2 families")
        self.engine = engine
        #: receives ``metrics.to_events(step)`` through its
        #: ``write_events`` every ``config.monitor_every`` steps
        self.monitor = monitor
        self.config = cfg = config or ServingConfig()
        self.device = engine.device
        if cfg.max_model_len % cfg.block_size:
            raise ValueError("max_model_len must be a multiple of block_size")
        positions = engine.module.max_positions
        if positions is not None and cfg.max_model_len > positions:
            # a learned position table (GPT-2) has no row past its end
            raise ValueError(
                f"max_model_len={cfg.max_model_len} exceeds the model's "
                f"{positions} positions")
        if cfg.prefill_chunk_tokens < 0 or cfg.prefill_token_budget < 0:
            raise ValueError(
                "prefill_chunk_tokens and prefill_token_budget must be "
                ">= 0 (0 = default)")
        # chunk length (unified: the budget-packing granularity;
        # two-program: the chunked-prefill shape, 0 = monolithic bucketed
        # prefill) and the per-step prefill token budget: derived, never
        # written back into the caller's config
        self._mixed = bool(cfg.mixed_step)
        chunk = cfg.prefill_chunk_tokens
        if chunk <= 0 and (self._mixed or cfg.prefix_cache):
            chunk = 4 * cfg.block_size
        self._chunk = min(chunk, cfg.max_model_len) if chunk > 0 else 0
        self._chunk_budget = cfg.prefill_token_budget or self._chunk
        # packed token capacity: every slot may decode (1 token each) OR,
        # with a slot mid-prefill, max_batch_size - 1 decoders plus the
        # whole prefill budget
        self._mixed_tokens = max(cfg.max_batch_size,
                                 cfg.max_batch_size - 1 + self._chunk_budget)
        # speculative decoding: the drafter (the verify rows are packed
        # segments of the unified step, judged on greedy predictions)
        if cfg.spec_tokens < 0:
            raise ValueError("spec_tokens must be >= 0 (0 = off)")
        self._drafter = None
        if cfg.spec_tokens > 0:
            if not self._mixed:
                raise ValueError(
                    "speculative decoding needs the unified mixed step "
                    "(mixed_step=True): verify rows are packed ragged "
                    "segments of the one packed step")
            if cfg.do_sample:
                raise ValueError(
                    "speculative decoding requires greedy sampling "
                    "(do_sample=False): the accept rule compares the "
                    "target model's argmax predictions against the "
                    "drafts token for token")
            self._drafter = cfg.drafter if cfg.drafter is not None \
                else PromptLookupDrafter(cfg.spec_ngram)
        # packed widths: the full capacity, or with mixed_step_buckets the
        # powers of two from next_pow2(max_batch_size) below it, then it
        self._bucket_widths: Optional[List[int]] = None
        if cfg.mixed_step_buckets:
            if not self._mixed:
                raise ValueError("mixed_step_buckets needs mixed_step=True")
            ws: List[int] = []
            w = next_pow2(max(1, cfg.max_batch_size))
            while w < self._mixed_tokens:
                ws.append(w)
                w *= 2
            ws.append(self._mixed_tokens)
            self._bucket_widths = ws
        # the adaptive draft cap trades draft length for a narrower step,
        # so it engages where width costs: bucketed widths, or (the JAX
        # engine's rule, kept as written) the Pallas decode attention the
        # config names; elsewhere a rejected draft fills padding the step
        # computes anyway
        self._spec_adaptive = self._bucket_widths is not None or getattr(
            engine.module.config, "decode_attention_impl", None) == "pallas"
        # both engines run over static buffers; with enable_cuda_graph on
        # a CUDA device each shape (a packed width; the two-program
        # engine's decode, chunk and monolithic buckets) is captured as
        # one CUDA graph (its first forward runs eagerly, then is
        # captured; later forwards replay), all in the inference engine's
        # memory pool
        self._graphed = bool(engine.config.enable_cuda_graph)
        self._static = PackedIndexBuffers(
            cfg.max_batch_size, cfg.max_model_len // cfg.block_size,
            self._mixed_tokens, self.device) if self._mixed else None
        #: the two-program engine's buffers, by forward kind
        self._legacy_static: Dict[tuple, StaticIndexBuffers] = {}
        self._graphs: Dict[Any, Any] = {}
        #: forward keys (a packed width; the two-program engine's kinds)
        #: whose first forward has run: it ran eagerly (and, graphed, was
        #: captured) and was exempt from the watchdog (the first-beat
        #: rule); later forwards of a key are judged
        self._warm = set()

        self.tracer = Tracer(capacity=cfg.trace_capacity,
                             enabled=bool(cfg.trace or cfg.trace_dir))
        self.nb_max = cfg.max_model_len // cfg.block_size
        self.block_pool = BlockPool(cfg.num_blocks, cfg.block_size,
                                    tracer=self.tracer)
        self.sched = Scheduler(cfg.max_batch_size, self.block_pool,
                               self.nb_max, prefix_cache=cfg.prefix_cache,
                               tracer=self.tracer)
        self.metrics = ServingMetrics(blocks_total=cfg.num_blocks)
        #: SLO attribution: every terminal transition funnels through the
        #: scheduler's release, which calls this hook before emitting the
        #: terminal span
        self.sched.on_terminal = self._slo_on_terminal
        #: program registry + recompile sentinel, hand cost estimates and
        #: the MFU/MBU gauges on the card's own peaks
        self.perf = PerfAccounting(tracer=self.tracer,
                                   metrics=self.metrics.registry,
                                   scope="serving", device=self.device)
        #: post-mortem capture: armed iff trace_dir is set — watchdog
        #: trips, logit quarantines and DS_FAULT firings each dump the
        #: last trace events + a metrics snapshot there
        self.flight: Optional[FlightRecorder] = None
        if cfg.trace_dir:
            self.flight = FlightRecorder(cfg.trace_dir, self.tracer,
                                         metrics_fn=self.metrics.snapshot,
                                         last_n=cfg.flight_events)
            self.flight.arm_faults()
        #: name of this engine's probabilistic DS_FAULT stream (None =
        #: the process-global stream)
        self.fault_stream: Optional[str] = None
        #: the abandoned (watchdog-tripped) step that may still run
        #: (step() skips device work while it lives, so work never
        #: stacks), and the pinned buffers read-backs land in, by size
        self._wedged: Optional[_InFlight] = None
        self._host_bufs: Dict[int, tuple] = {}

        kv_dtype = torch.int8 if engine.config.kv_cache_int8 \
            else engine.compute_dtype
        self._kv_bytes_per_elem = torch.empty((), dtype=kv_dtype
                                              ).element_size()
        self.pool = engine.module.init_paged_cache(
            cfg.num_blocks, cfg.block_size, dtype=kv_dtype,
            device=self.device)

        # the host KV tier behind the pool's LRU
        self.host_tier: Optional[HostTier] = None
        if cfg.host_cache_blocks or cfg.host_cache_bytes is not None:
            if cfg.host_cache_blocks < 0:
                raise ValueError("host_cache_blocks must be >= 0")
            if not cfg.prefix_cache:
                raise ValueError(
                    "the host KV tier extends the prefix cache "
                    "(demoted pages are matched by content chain): set "
                    "prefix_cache=True with host_cache_blocks/bytes")
            self.host_tier = HostTier(max_blocks=cfg.host_cache_blocks,
                                      max_bytes=cfg.host_cache_bytes,
                                      tracer=self.tracer)
            # a whole eviction wave is ONE gather per pool tensor
            self.block_pool.attach_host_tier(
                self.host_tier,
                lambda bids: fetch_paged_blocks(self.pool, bids))
        #: in-flight promotions (copies to the device not yet folded into
        #: the pool), the stream their copies run on, and the page widths
        #: whose first fold already ran (later folds are watchdog-judged)
        self._promote_q: List[_Promotion] = []
        self._promote_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" and self.host_tier is not None \
            else None
        self._promote_warm = set()

        B = cfg.max_batch_size
        self._tables = np.full((B, self.nb_max), self.block_pool.sentinel,
                               np.int32)
        #: tokens in the pool per decoding slot (0 for idle and mid-prefill
        #: slots): the two-program engine's decode reads it for every slot
        self._seq_lens = np.zeros((B,), np.int32)
        self._last_tok = np.zeros((B,), np.int32)
        self._requests: Dict[str, Request] = {}
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._step_no = 0
        #: forwards the two-program engine has run, by kind
        self.decode_calls = 0
        self.prefill_chunk_calls = 0
        self.prefill_calls = 0
        self._draining = False
        #: manual brownout override: None = automatic (occupancy), else forced
        self._brownout_forced: Optional[bool] = None
        #: the packed step's widths run so far (one without
        #: mixed_step_buckets); the two-program engine's plain methods have
        #: nothing to count
        self.compile_counts = {"mixed_step": 0} if self._mixed else {}
        log_dist(f"ServingEngine: slots={B}, pool={cfg.num_blocks}x"
                 f"{cfg.block_size} ({kv_dtype}), max_len="
                 f"{cfg.max_model_len}, device={self.device}"
                 + (f", spec={self._drafter.kind} k<={cfg.spec_tokens}"
                    if self._drafter is not None else ""), ranks=[0])

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
        # hash the newcomer's full blocks ONCE: the headroom gate and the
        # Request both consume these keys
        prompt_hashes = self.block_pool.prefix_block_hashes(prompt) \
            if cfg.prefix_cache else None
        if cfg.kv_headroom_blocks is not None:
            budget = self.block_pool.num_blocks - cfg.kv_headroom_blocks
            it = iter(displaceable)
            while True:
                charges, newcomer = self.sched.admission_charges(
                    newcomer_len=len(prompt),
                    newcomer_hashes=prompt_hashes,
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
                      deadline=deadline, block_hashes=prompt_hashes or [])
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

    # -- SLO attribution ------------------------------------------------

    def _judge_slo(self, req: Request) -> str:
        """One verdict per terminal request (metrics.SLO_VERDICTS):

        - ``shed``      — cancelled (caller cancel, load shed, drain,
                          displacement): the engine chose not to serve it;
        - ``failed``    — engine-side failure (watchdog, quarantine,
                          prefill error, pool exhaustion);
        - ``ttft_miss`` — finished past the TTFT SLO, or timed out before
                          producing a first token;
        - ``tpot_miss`` — finished with mean inter-token latency past the
                          TPOT SLO, or timed out mid-decode;
        - ``good``      — finished inside both budgets (trivially, when
                          no SLO is configured).
        """
        cfg = self.config
        if req.state is RequestState.CANCELLED:
            return "shed"
        if req.state is RequestState.FAILED:
            return "failed"
        if req.state is RequestState.TIMEOUT:
            # a deadline blown before the first token is a TTFT story; one
            # blown mid-decode is a decode-rate story
            return "ttft_miss" if req.first_token_time is None \
                else "tpot_miss"
        if cfg.ttft_slo_s is not None and req.ttft is not None \
                and req.ttft > cfg.ttft_slo_s:
            return "ttft_miss"
        if cfg.tpot_slo_s is not None and len(req.tokens) > 1 \
                and req.first_token_time is not None \
                and req.finish_time is not None:
            tpot = (req.finish_time - req.first_token_time) \
                / (len(req.tokens) - 1)
            if tpot > cfg.tpot_slo_s:
                return "tpot_miss"
        return "good"

    def _slo_on_terminal(self, req: Request) -> None:
        verdict = self._judge_slo(req)
        req.slo_verdict = verdict
        self.metrics.note_slo(
            verdict,
            goodput_tokens=len(req.tokens) if verdict == "good" else 0)

    # -- tracing / post-mortem -----------------------------------------

    def _flight(self, trigger: str, **detail) -> None:
        """Flight-recorder dump (no-op unless ``trace_dir`` armed one)."""
        if self.flight is not None:
            self.flight.record(trigger, detail)

    def dump_trace(self, path: Optional[str] = None) -> str:
        """Write the trace ring as Chrome-trace/Perfetto JSON. Default
        path: ``<trace_dir>/trace_serving_<stamp>.json``."""
        if path is None:
            if not self.config.trace_dir:
                raise ValueError("dump_trace() needs a path when "
                                 "ServingConfig.trace_dir is unset")
            path = os.path.join(
                self.config.trace_dir,
                f"trace_serving_{time.strftime('%Y%m%d-%H%M%S')}"
                f"_{dump_seq():04d}_{os.getpid()}.json")
        return self.tracer.dump(path)

    def perf_summary(self) -> Dict[str, Any]:
        """Performance-accounting block for reports and measurement
        artifacts: the card's peaks (None on the CPU), its memory
        watermarks, the program table (fingerprints, compile/recompile
        counts, cost estimates) and the latest utilization values."""
        out = self.perf.summary()
        out["compile_counts"] = dict(self.compile_counts)
        return out

    def defrag(self) -> int:
        """Compact live pages (referenced and cached) to the low end of
        the pool, moving their contents on the device and rewriting the
        block tables. Returns the number of pages that moved."""
        mapping, src = self.block_pool.defrag_plan()
        moved = sum(1 for old, new in mapping.items() if old != new)
        # in-flight promotions target pages by id: remapped with the block
        # tables, or the pump would drop them as stale and leave their
        # requests waiting for a promotion that never comes
        for e in self._promote_q:
            e.dst_bids = [mapping[b] for b in e.dst_bids]
        if moved:
            idx = torch.as_tensor(src, dtype=torch.long, device=self.device)
            for t in self.pool.values():
                t.copy_(t[:, idx])     # the gather is a copy: no aliasing
        for _, req in self.sched.active():
            req.blocks = [mapping[b] for b in req.blocks]
            if self._mixed or not req.prefilling:
                # the two-program engine keeps a sentinel decode row for a
                # mid-prefill resident until its last chunk lands
                self._write_table_row(req)
        return moved

    # -- the host KV tier: promotion ------------------------------------

    def _skip_step_if_wedged(self, t0: float, brownout: bool) -> bool:
        """A watchdog trip earlier in this very step (a wedged promotion
        fold) leaves the device busy: skip the device half of the step
        (the step-top gate covers trips of earlier steps). True = the
        caller returns (bookkeeping done, latency unrecorded)."""
        w = self._wedged
        if w is None or not w.is_alive():
            return False
        self.metrics.watchdog_skips += 1
        self._finish_step_bookkeeping(t0, brownout, record_latency=False)
        return True

    def _promotions_only(self) -> bool:
        """True when promotion folds are the only path to progress this
        step: promotions are in flight and every running resident is a
        promotion-blocked prefiller. Waiting for the copy is then free —
        the step would run nothing — and saves the blocked request a
        whole step of TTFT. With any other runnable work the step never
        waits on a copy."""
        if not self._promote_q:
            return False
        for _, r in self.sched.active():
            if r.state is not RequestState.RUNNING:
                continue
            if not r.prefilling or not r.promote_pending:
                return False
        return True

    def _schedule_promotions(self, req: Request) -> None:
        """Start the copy to the device of every host-tier page admission
        matched for ``req``: one device buffer per pool tensor, filled on
        the promotion stream behind a CUDA event, and the entry joins the
        promotion queue; :meth:`_pump_promotions` folds it into the pool
        once the copy has landed. The host entry itself is consumed only
        when the page's hash COMMITS into the device index (after the
        logit guard passed the first suffix chunk), so a corrupted or
        abandoned promotion never destroys the clean host copy."""
        hits, req.host_hits = req.host_hits, []
        if not hits:
            return
        # chaos point: DS_FAULT=corrupt_promote:tag=serving_tier poisons
        # ONE promoted page's payload in transit (float tensors -> NaN, on
        # a copy: the tier's entry stays clean). The logit guard must
        # quarantine the request on its first suffix chunk, before the
        # page's hash is indexed again
        corrupt = fault_injection.maybe_flag(
            "corrupt_promote", tag="serving_tier", step=self._step_no,
            stream=self.fault_stream, detail={"rids": [req.rid]}) is not None
        payloads = [p for _, _, p in hits]
        if corrupt:
            payloads[0] = {n: torch.full_like(t, math.nan)
                           if t.is_floating_point() else t
                           for n, t in payloads[0].items()}
        leaves, event = upload_paged_blocks(payloads, self.device,
                                            self._promote_stream)
        idxs = [i for i, _, _ in hits]
        self._promote_q.append(_Promotion(
            req=req, block_idxs=idxs, dst_bids=[req.blocks[i] for i in idxs],
            leaves=leaves, event=event, width=next_pow2(len(hits)),
            admit_order=req.admit_order, t_sched=time.perf_counter()))
        if self.tracer.enabled:
            self.tracer.instant("kv_promote_start", cat="pool",
                                args={"rid": req.rid, "pages": len(hits)})
        if self.config.sync_promote:
            # the A/B control: wait for the copy and fold at admission —
            # the promotion's latency lands squarely in TTFT
            self._pump_promotions(wait=True)

    def _pump_promotions(self, wait: bool = False) -> None:
        """Fold every LANDED promotion into the pool, in place. Entries
        whose request left its admission segment (preempted / terminal)
        are dropped — their target pages are back in the pool and may
        belong to someone else; the host entries they would have consumed
        survive for the retry. A copy still in flight stays queued and
        blocks only its own request's grants (the scheduler's
        ``promote_pending`` gate). ``wait=True`` folds everything now: the
        fold waits for the copy on the device, and the host for the fold.
        The fold runs through :meth:`_run_device`: on the caller's thread,
        awaited on its event under the step watchdog, with the
        ``slow_promote`` chaos stall inside (``DS_FAULT=slow_promote``)."""
        w = self._wedged
        if w is not None and w.is_alive():
            return  # device wedged: queued copies wait it out
        q, self._promote_q = self._promote_q, []
        if not q:
            return
        m = self.metrics
        tr = self.tracer
        still: List[_Promotion] = []
        for i, e in enumerate(q):
            req = e.req
            if not (req.state is RequestState.RUNNING
                    and req.admit_order == e.admit_order
                    and req.promote_pending > 0
                    and all(idx < len(req.blocks)
                            and req.blocks[idx] == bid
                            for idx, bid in zip(e.block_idxs, e.dst_bids))):
                m.kv_promote_cancelled += len(e.block_idxs)
                if tr.enabled:
                    tr.instant("kv_promote_cancel", cat="pool",
                               args={"rid": req.rid,
                                     "pages": len(e.block_idxs)})
                if req.state is RequestState.RUNNING and \
                        req.admit_order == e.admit_order:
                    # the request still expects this promotion but its
                    # pages no longer line up (defrag remaps the queue, so
                    # nothing should reach here): preempt-requeue it
                    # rather than hold its slot forever; re-admission
                    # re-matches both tiers
                    self._preempt(req)
                continue
            if not wait and not _landed(e.event):
                still.append(e)
                continue
            step_no = self._step_no

            def fold(e=e):
                if e.event is not None:
                    torch.cuda.current_stream(self.device).wait_event(
                        e.event)
                insert_paged_block(self.pool, e.dst_bids, e.leaves)
                return _DeviceDone(torch.cuda.Event()
                                   if self.device.type == "cuda" else None)

            try:
                self._run_device(e.width in self._promote_warm, fold,
                                 [("slow_promote", "serving_tier")],
                                 [req.rid])
            except StepWatchdogTimeout as exc:
                self._trip(exc, [(req.slot, req)], step_no,
                           where="kv_promote")
                # device wedged: nothing else may touch it — the rest
                # waits in the queue (the step-top gate takes over)
                still.extend(q[i + 1:])
                break
            self._promote_warm.add(e.width)
            req.promote_pending -= len(e.block_idxs)
            m.kv_pages_promoted += len(e.block_idxs)
            now = time.perf_counter()
            m.promote_hist.observe(now - e.t_sched)
            if tr.enabled:
                tr.complete("kv_promote", e.t_sched, now, cat="pool",
                            args={"rid": req.rid,
                                  "pages": len(e.block_idxs)})
        self._promote_q.extend(still)

    def speculation_status(self) -> Dict[str, Any]:
        """Speculative-decoding status for reports: drafter kind,
        configured cap, and the acceptance numbers. ``enabled`` False when
        speculation is off."""
        m = self.metrics
        return {
            "enabled": self._drafter is not None,
            "drafter": self._drafter.kind if self._drafter is not None
            else None,
            "spec_tokens": self.config.spec_tokens,
            "drafted": m.spec_drafted,
            "accepted": m.spec_accepted,
            "accept_rate": round(m.spec_accept_rate, 4),
            "tokens_per_verify": round(m.spec_tokens_per_verify, 4),
            "pages_dropped": m.spec_pages_dropped,
        }

    def tier_status(self) -> Dict[str, Any]:
        """Tier table for reports: per-tier capacity and occupancy, the
        movement counters and the promotion wait percentiles. ``enabled``
        False without a host tier."""
        if self.host_tier is None:
            return {"enabled": False}
        m = self.metrics
        hist = m.promote_hist
        return {
            "enabled": True,
            "tiers": [
                {"tier": "device", "capacity_blocks": self.config.num_blocks,
                 "blocks": self.block_pool.used_count
                 + self.block_pool.cached_count,
                 "indexed_blocks": self.block_pool.indexed_count,
                 "evictions": self.block_pool.evictions,
                 "demotions": self.block_pool.demotions},
                self.host_tier.stats(),
            ],
            "host_hits": m.kv_host_hits,
            "host_misses": m.kv_host_misses,
            "host_hit_tokens": m.kv_host_hit_tokens,
            "host_hit_rate": round(m.host_hit_rate, 4),
            "pages_promoted": m.kv_pages_promoted,
            "promote_cancelled": m.kv_promote_cancelled,
            "promote_queue_depth": len(self._promote_q),
            "promote_wait_p50_s": hist.percentile(0.5)
            if hist.count else None,
            "promote_wait_p95_s": hist.percentile(0.95)
            if hist.count else None,
        }

    @property
    def mixed_step_tokens(self) -> int:
        """Packed token capacity of the unified step (0 on the two-program
        engine)."""
        return self._mixed_tokens if self._mixed else 0

    @property
    def mixed_step_widths(self) -> List[int]:
        """Packed widths the unified step may run at: the full capacity
        alone by default, the bounded bucket set with
        ``mixed_step_buckets`` (``compile_counts["mixed_step"]`` is bounded
        by its length); empty on the two-program engine."""
        if not self._mixed:
            return []
        return list(self._bucket_widths) if self._bucket_widths is not None \
            else [self._mixed_tokens]

    @property
    def prefill_chunk_tokens(self) -> int:
        """The effective prefill chunk length (0 = the two-program
        engine's monolithic prefill); it may differ from the config field,
        which is never mutated."""
        return self._chunk

    # ------------------------------------------------------------------
    # one scheduler step
    # ------------------------------------------------------------------

    def step(self) -> None:
        """Shed expired requests, admit from the queue, then run the
        device half: one packed mixed step, or the two-program engine's
        prefill forwards and its decode over all slots."""
        # chaos point: DS_FAULT=stall:tag=serving_step wedges the caller
        # here; a bounded stall must leave the queue drainable
        fault_injection.maybe_stall("stall", tag="serving_step",
                                    step=self._step_no,
                                    stream=self.fault_stream)
        t0 = time.perf_counter()
        now = time.perf_counter()
        self.sched.expire_queued(now)
        for slot, req in list(self.sched.active()):
            if req.state is RequestState.RUNNING and req.expired(now):
                self.sched.timeout(req, "deadline")
                self._clear_slot_arrays(slot)
                self.metrics.requests_timeout += 1
        # wedged-device gate, BEFORE any device work: while an abandoned
        # (watchdog-tripped) step still runs, nothing may fill the static
        # buffers, admit or dispatch — the abandoned step still appends
        # into its failed requests' pages, which nobody may take until it
        # ends. Host work above (deadline shedding) still ran; the sleep
        # keeps drive loops from spinning
        if self._wedged is not None:
            if self._wedged.is_alive():
                self.metrics.watchdog_skips += 1
                if self.tracer.enabled:
                    self.tracer.instant("watchdog_skip", cat="engine",
                                        args={"step": self._step_no})
                time.sleep(min(0.05, self.config.step_watchdog_s))
                self._account_reaped()
                # no record_step: a skipped step's sleep would read as a
                # healthy step latency mid-outage
                self._finish_step_bookkeeping(t0, self.brownout,
                                              record_latency=False)
                return
            self._wedged = None
        # fold landed promotions before admission and grant planning: a
        # copy that arrived since the last step unblocks its request's
        # grants this very step
        self._pump_promotions()
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
            if req.prefix_len:
                # prefix-cache hit: these tokens are served without being
                # recomputed (their pages were acquired, not refilled)
                self.metrics.prefix_hits += 1
                self.metrics.cached_prefill_tokens += req.prefix_len
                self.metrics.prefill_tokens += req.prefix_len
            if self.host_tier is not None:
                if req.host_prefix_len:
                    self.metrics.kv_host_hits += 1
                    self.metrics.kv_host_hit_tokens += req.host_prefix_len
                else:
                    self.metrics.kv_host_misses += 1
            if req.host_hits:
                # host-matched pages: start their copy to the device now,
                # so it overlaps what the step does; the request's own
                # suffix grants wait only on the fold
                self._schedule_promotions(req)
            if self._mixed:
                # the request's table row is live from admission: its
                # packed segments carry their own query_len, so an
                # un-granted row is inert
                self._write_table_row(req)
            elif not self._chunk:
                try:
                    self._prefill(req)
                except BlockPoolError:
                    raise  # accounting invariant broken — never swallow
                except Exception as e:
                    self._fail_prefill(req, e)
            # chunked two-program prefill runs below, under the budget;
            # the slot keeps a sentinel decode row until its last chunk
        self._account_reaped()
        # second pump: a promotion this step's admission scheduled may
        # have landed already. When promotion folds are the only way
        # anyone can progress, waiting for the copy is free (the step
        # would pack nothing), so the fold waits instead of burning an
        # empty step of TTFT
        self._pump_promotions(wait=self._promotions_only())
        if self._mixed:
            self._step_mixed(t0, brownout)
            return
        if self._skip_step_if_wedged(t0, brownout):
            return
        if self._chunk:
            self._run_prefill_chunks()
        self._grow_decode_pages()
        self._decode_step()
        self._finish_step_bookkeeping(t0, brownout)

    def _finish_step_bookkeeping(self, t0: float, brownout: bool,
                                 record_latency: bool = True) -> None:
        if self.tracer.enabled:
            self.tracer.complete("step", t0, time.perf_counter(),
                                 cat="engine", args={"step": self._step_no})
        self._step_no += 1
        m = self.metrics
        m.steps += 1
        if record_latency:
            m.record_step(time.perf_counter() - t0)
        m.queue_depth = self.sched.queue_depth
        m.active_seqs = len(self.sched.active())
        m.blocks_used = self.block_pool.used_count
        m.blocks_cached = self.block_pool.cached_count
        m.prefix_evictions = self.block_pool.evictions
        prefilling = [r for _, r in self.sched.active() if r.prefilling]
        m.prefill_waiting = len(prefilling)
        m.prefill_queue_age_s = 0.0 if not prefilling else \
            time.perf_counter() - min(r.submit_time for r in prefilling)
        m.brownout_active = brownout
        if self.host_tier is not None:
            m.kv_pages_demoted = self.block_pool.demotions
            m.kv_host_blocks = len(self.host_tier)
            m.kv_host_bytes = self.host_tier.bytes
            m.promote_queue_depth = len(self._promote_q)
        m.recompiles = self.perf.recompile_total
        m.hbm_bytes_in_use, m.hbm_peak_bytes = self.perf.memory_watermarks()
        if self.monitor is not None and self.config.monitor_every and \
                self._step_no % self.config.monitor_every == 0:
            self.monitor.write_events(m.to_events(self._step_no))

    def _grow_decode_pages(self, spec_plan: Optional[Dict[str, List[int]]]
                           = None) -> None:
        """Guarantee every decoding resident pages for the tokens this step
        appends — one for a plain decode row, ``1 + k`` positions for a
        verify row carrying ``k`` drafts — preempting (lowest priority,
        newest first) when the pool runs dry; shared append targets are
        copied on write. Draft pages degrade FIRST: when the pool cannot
        grow a resident's lookahead, its drafts are dropped (plain decode
        this step) before anyone is evicted."""
        bs = self.block_pool.block_size
        for _, req in list(self.sched.active()):
            if req.state is not RequestState.RUNNING or req.prefilling:
                continue  # preempted below while growing an earlier slot
            k = len(spec_plan.get(req.rid, ())) if spec_plan else 0
            if k and not self.sched.ensure_decode_headroom(req, lookahead=k):
                spec_plan.pop(req.rid, None)
                k = 0
                # pages the partial lookahead growth allocated go back at
                # once (the rollback helper keeps the next append's page)
                self._drop_trailing_pages(req)
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
                # this step appends at seq_len .. seq_len + k: never into a
                # page other sequences still reference
                for idx in range(req.seq_len // bs,
                                 (req.seq_len + k) // bs + 1):
                    self._ensure_exclusive(req, idx)
                self._write_table_row(req)  # growth may have added a page
                continue
            break

    def _plan_speculation(self, grants: Dict[str, int]
                          ) -> Dict[str, List[int]]:
        """Draft tokens per decoding resident (``{rid: drafts}``) for this
        step's verify rows, sized to the packed step's LEFTOVER capacity:
        every decode row's guaranteed token and every prefill grant are
        reserved first, so speculation degrades to plain decode under
        prefill pressure instead of starving admissions. The per-request
        adaptive cap (``req.spec_k``) keeps adversarial traffic from
        paying verify tokens for drafts that never land; a drafter with
        nothing to propose skips the row."""
        if self._drafter is None:
            return {}
        cfg = self.config
        decoders = [r for _, r in self.sched.active()
                    if r.state is RequestState.RUNNING and not r.prefilling]
        plan: Dict[str, List[int]] = {}
        if not decoders:
            return plan
        slack = self._mixed_tokens - len(decoders) - sum(grants.values())
        for req in decoders:  # slot-ascending (the packing order)
            if slack <= 0:
                break
            if req.spec_k < 0:
                req.spec_k = cfg.spec_tokens
            # a verify row commits up to k + 1 tokens and appends KV
            # through seq_len + k: capped by the token budget and the
            # length cap as well as the slack and, where width costs, the
            # adaptive cap
            cap = req.spec_k if self._spec_adaptive else cfg.spec_tokens
            k = min(cap, slack, req.remaining_new - 1,
                    cfg.max_model_len - 1 - req.seq_len)
            if k <= 0:
                continue
            drafts = self._drafter.draft(req.resume_tokens, k)
            if not drafts:
                continue
            drafts = [int(t) for t in drafts[:k]]
            plan[req.rid] = drafts
            slack -= len(drafts)
        return plan

    def _drop_trailing_pages(self, req: Request) -> int:
        """Free every pool page past the one the NEXT append targets — the
        page-drop half of speculative rollback. Pages holding only
        rejected draft KV were never content-indexed (hashes commit from
        the accepted ``seq_len`` watermark only), so freeing them blanks
        them; the partly rejected page at ``seq_len // bs`` is kept and
        overwritten by the next append."""
        keep = req.seq_len // self.block_pool.block_size + 1
        if len(req.blocks) <= keep:
            return 0
        drop = req.blocks[keep:]
        del req.blocks[keep:]
        self.block_pool.free(drop, req.rid)
        self._write_table_row(req)
        self.metrics.spec_pages_dropped += len(drop)
        return len(drop)

    def _commit_verify_row(self, slot: int, req: Request,
                           drafts: List[int], preds: List[int]) -> int:
        """Greedy accept-prefix over one verify row: ``preds[j]`` is the
        model's prediction AFTER the row's j-th packed token, so draft
        ``j`` is accepted iff every earlier draft was and ``preds[j] ==
        drafts[j]``. Commits the accepted drafts plus the model's bonus
        token, rewinds ``seq_len`` past exactly the accepted KV (rejected
        appends beyond it are never read and are overwritten later), drops
        whole rejected pages, and adapts the request's draft cap. Returns
        the number of committed tokens."""
        k = len(drafts)
        a = 0
        while a < k and drafts[a] == preds[a]:
            a += 1
        commit = drafts[:a] + [preds[a]]
        # an accepted EOS ends the stream where plain decoding would have
        if req.eos_token_id is not None and req.eos_token_id in commit:
            commit = commit[:commit.index(req.eos_token_id) + 1]
        commit = commit[:req.remaining_new]
        m = self.metrics
        m.spec_drafted += k
        m.spec_accepted += a
        m.spec_committed += len(commit)
        m.spec_verify_rows += 1
        # decay-then-add: the request's counters follow its RECENT accept
        # rate, so the gate below releases as soon as the stream turns
        # predictable
        req.spec_drafted = req.spec_drafted * 0.75 + k
        req.spec_accepted = req.spec_accepted * 0.75 + a
        # AIMD on the accept length: a fully confirmed draft doubles the
        # cap, any miss shrinks it to just past what landed (floor 1, so
        # the request keeps probing)
        if a == k:
            req.spec_k = min(self.config.spec_tokens, max(req.spec_k * 2, 2))
        else:
            req.spec_k = max(1, min(req.spec_k, a + 1))
        # chronic-miss gate: a recent accept rate under 1/3 (once enough
        # recent drafts exist) clamps the request to a 1-token probe
        if req.spec_drafted >= 8 and \
                req.spec_accepted * 3 < req.spec_drafted:
            req.spec_k = 1
        # the row appended positions seq_len .. seq_len + k; the accepted
        # ones stay, the rest are rolled back (a commit ending on the
        # bonus token leaves its KV to the next step's append)
        req.seq_len += len(commit)
        self._seq_lens[slot] = req.seq_len
        self._drop_trailing_pages(req)
        # every committed token goes through the one harvest path; EOS and
        # the length cap can only trigger on the last one (the truncations
        # above), so the hash commit between runs on a live request
        for t in commit[:-1]:
            self._harvest(req, t)
        self._commit_full_blocks(req)
        self._harvest(req, commit[-1])
        return len(commit)

    def _step_mixed(self, t0: float, brownout: bool) -> None:
        """Pack one decode token per running resident (``1 + k`` for a
        speculating one: its drafts ride the row as a verify segment) plus
        this step's budgeted prefill chunks into one ragged token batch,
        run the mixed step, and harvest per row."""
        cfg = self.config
        if self._skip_step_if_wedged(t0, brownout):
            return
        # prefill grants (round-robin chunk-sized shares of the budget
        # across mid-prefill residents, admission order), speculation over
        # what they leave, then page growth sized to each row's appends
        # (drafts dropped before anyone is evicted); then the grants again,
        # since growth may have preempted a grantee (the total can only
        # shrink, so the speculation plan still fits)
        grants = self.sched.plan_prefill_grants(self._chunk_budget,
                                                self._chunk)
        spec_plan = self._plan_speculation(grants)
        self._grow_decode_pages(spec_plan)
        grants = self.sched.plan_prefill_grants(self._chunk_budget,
                                                self._chunk)
        bs = self.block_pool.block_size
        for _, req in list(self.sched.active()):
            if not req.prefilling or req.rid not in grants:
                continue
            try:
                # chaos point: DS_FAULT=flaky_prefill fails ITS request
                # host-side, before it is packed — everyone else still
                # rides this step
                fault_injection.maybe_fail(
                    "flaky_prefill", exc=RuntimeError, tag="serving_prefill",
                    step=self._step_no, stream=self.fault_stream,
                    detail={"rids": [req.rid]})
            except RuntimeError as e:
                grants.pop(req.rid)
                self._fail_prefill(req, e)
                continue
            # copy-on-write every chunk-spanned page another sequence
            # still references, before this step's appends
            start, n = req.prefill_done, grants[req.rid]
            for idx in range(start // bs, (start + n - 1) // bs + 1):
                self._ensure_exclusive(req, idx)
            self._write_table_row(req)

        # pack segments slot-ascending: decode rows are 1 token (1 + k for
        # a verify row: the last token and its drafts, starting at
        # seq_len), granted prefill rows up to their grant, everything
        # else is inert
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
                drafts = spec_plan.get(req.rid) or []
                n, start = 1 + len(drafts), req.seq_len
                ids[0, cursor] = self._last_tok[slot]
                ids[0, cursor + 1:cursor + n] = drafts
                pos[0, cursor:cursor + n] = np.arange(start, start + n)
                decodes.append((slot, req, drafts))
            trow[0, cursor:cursor + n] = slot
            row_start[slot], row_len[slot] = cursor, n
            row_cs[slot], row_cl[slot] = start, start + n
            cursor += n
        if cursor > T:
            raise RuntimeError(f"packed {cursor} tokens into a {T}-token step")
        if cursor == 0:
            self._finish_step_bookkeeping(t0, brownout)
            return

        # corrupt_logits chaos, both tags, as DATA (no recapture): the
        # serving_step vocabulary pins a decode slot (slot=N, falling back
        # to the first decode row on a bad or absent pin), serving_prefill
        # flags the first packed chunk. Each tag is probed only when a
        # matching row is packed, so a bounded (fails=N) spec spends its
        # budget on a step it can poison
        corrupt = np.zeros((R,), np.int32)
        if decodes:
            fspec = fault_injection.maybe_flag(
                "corrupt_logits", tag="serving_step", step=self._step_no,
                stream=self.fault_stream,
                detail={"rids": [r.rid for _, r, _ in decodes]})
            if fspec is not None:
                corrupt[self._pin_slot(fspec, [s for s, _, _ in decodes])] = 1
        if prefills and fault_injection.maybe_flag(
                "corrupt_logits", tag="serving_prefill", step=self._step_no,
                stream=self.fault_stream,
                detail={"rids": [prefills[0][1].rid]}) is not None:
            corrupt[prefills[0][0]] = 1

        # the packed width: the full capacity, or the narrowest bucket that
        # holds this step's packed tokens
        W = T if self._bucket_widths is None else \
            next(w for w in self._bucket_widths if w >= cursor)
        step_no = self._step_no
        packed = [(s, r) for s, r, _ in decodes] + \
            [(s, r) for s, r, _, _ in prefills]
        rids = [r.rid for _, r in packed]
        # the step's arrays (the buffers hold the full capacity; the step
        # reads the first W tokens)
        arrays = dict(ids=ids, token_rows=trow, append_pos=pos,
                      block_tables=self._tables,
                      query_start=row_start, query_len=row_len,
                      chunk_start=row_cs, context_len=row_cl,
                      corrupt=corrupt)
        name = self._mixed_name(W)
        self._observe(name, **dict(arrays, ids=ids[:, :W],
                                   token_rows=trow[:, :W],
                                   append_pos=pos[:, :W]))
        self.perf.capture_cost(name, lambda: self._mixed_cost_estimate(W))
        # chaos points INSIDE the guarded region; slow_chunk is probed
        # only when prefill rows are packed (the corrupt probes' rule)
        stalls = [("slow_step", "serving_step")]
        if prefills:
            stalls.append(("slow_chunk", "serving_prefill"))

        t_dev = time.perf_counter()
        try:
            (toks, bad), was_warm = self._run_device(
                W in self._warm, lambda: self._mixed_step(W, arrays), stalls,
                rids)
        except StepWatchdogTimeout as e:
            self._trip(e, packed, step_no)
            self._finish_step_bookkeeping(t0, brownout)
            return
        t_end = time.perf_counter()
        n_drafted = sum(len(d) for _, _, d in decodes)
        if self.tracer.enabled:
            self.tracer.complete("mixed_step", t_dev, t_end, cat="engine",
                                 args={"step": step_no,
                                       "decode_tokens": len(decodes),
                                       "verify_tokens": n_drafted,
                                       "prefill_tokens": cursor - len(decodes)
                                       - n_drafted,
                                       "width": W,
                                       "rows": len(packed)})
        committed = 0
        for slot, req, n, final in prefills:
            req.prefill_done += n
            req.seq_len = req.prefill_done
            self.metrics.prefill_tokens += n
            self.metrics.prefill_tokens_computed += n
            self.metrics.window_tokens += n
            committed += n
            # guard every chunk, and BEFORE content-indexing: poisoned KV
            # must never park on the prefix cache's LRU
            if cfg.logit_guard and bad[slot]:
                self._quarantine(slot, req, step_no, where="prefill")
                continue
            self._commit_full_blocks(req)
            if final:
                # last chunk: token one (TTFT ends here) is the row's last
                # packed position; the slot decodes from the next step
                self._harvest(req, int(toks[row_start[slot] + n - 1]))
                committed += 1
        had_verify = False
        for slot, req, drafts in decodes:
            if cfg.logit_guard and bad[slot]:
                # one poisoned position anywhere in the row (drafts
                # included) fails its request; nothing of the row commits
                self._quarantine(slot, req, step_no, where="decode")
                continue
            if drafts:
                # verify row: greedy accept-prefix over its k + 1
                # predictions, rollback past the accepted KV
                preds = [int(toks[row_start[slot] + j])
                         for j in range(len(drafts) + 1)]
                committed += self._commit_verify_row(slot, req, drafts,
                                                     preds)
                had_verify = True
                continue
            req.seq_len += 1
            # a generated token may have just filled a page: index it so
            # identical continuations (multi-turn replays) reuse it
            self._commit_full_blocks(req)
            self._harvest(req, int(toks[row_start[slot]]))
            committed += 1
        if had_verify:
            self.metrics.spec_steps += 1
        if was_warm:
            # the first-beat rule for the gauges too: a width's first step
            # carries its capture. Tokens are what the step committed:
            # rejected draft positions are the overhead speculation pays
            # (spec_drafted / spec_accepted), not throughput
            self._note_mixed_perf(t_end - t_dev, tokens=committed, width=W)
        self._finish_step_bookkeeping(t0, brownout)

    def _mixed_step(self, width, arrays):
        """The packed forward at ``width`` packed tokens: appends every
        packed token's KV into the pool (in place), samples every packed
        position, and flags rows with a NaN/Inf logit (or flagged by
        ``arrays["corrupt"]``). Returns the :class:`_ReadBack` of
        ``(tokens [width], bad [R])``.

        The step runs over static buffers: its arrays go to the device in
        one copy, the device work (:meth:`_packed_forward`) reads them
        there, and the tokens and flags come back in one read. With
        ``enable_cuda_graph`` on a CUDA device a width's first step runs
        eagerly and is then captured as a CUDA graph, which every later
        step at that width replays. Greedy tokens are taken inside that
        work; sampled ones after it, from the harvested logits with the
        engine's generator."""
        self._static.fill(**arrays)
        out = self._run_or_replay(width, lambda: self._packed_forward(width))
        self.compile_counts["mixed_step"] = len(self._warm)
        return self._read_back(out, width)

    def _run_or_replay(self, key, forward):
        """A forward's device work: the replay of ``key``'s captured graph,
        or ``forward()`` run eagerly and then, with ``enable_cuda_graph``
        on a CUDA device, captured under ``key``."""
        graph = self._graphs.get(key)
        if graph is not None:
            graph[0].replay()
            return graph[1]
        out = forward()
        if self._graphed and self.device.type == "cuda":
            self._graphs[key] = self.engine.capture(forward)
        self._warm.add(key)
        return out

    def _run_device(self, warm, launch, stalls, rids):
        """One device call: the chaos stalls ``stalls`` (``(name, tag)``
        points, probed in order, naming ``rids``) and ``launch()`` (the
        fill, the forward or graph replay, and the :class:`_ReadBack`; or
        a promotion's fold and its :class:`_DeviceDone`), then its host
        result. Returns that and ``warm``.

        The work is launched, then the step waits out its fired stalls
        and its CUDA event. Under ``step_watchdog_s`` a ``warm`` call
        waits only until the budget's deadline (a key's first forward
        runs eagerly and is captured, and is exempt: the first-beat rule);
        a step whose stalls end, or whose read-back completes, past the
        deadline is abandoned (``_wedged``: step() keeps off the device
        until its stalls and device work end — a kernel cannot be
        cancelled, the engine only stops waiting for it) and
        :class:`StepWatchdogTimeout` raised, and the caller fails the
        step's requests and keeps serving. On the CPU the forward has run
        by the time ``launch()`` returns, so only its stalls are judged."""
        step_no = self._step_no
        budget = self.config.step_watchdog_s
        start = time.perf_counter()
        deadline = start + budget if warm and budget > 0 else math.inf
        stall_end = start
        for name, tag in stalls:
            ctx = dict(tag=tag, step=step_no, stream=self.fault_stream)
            spec = fault_injection.fire(name, ctx, {"rids": rids})
            if spec is not None:
                stall_end += fault_injection.stall_seconds(name, spec, ctx)
        readback = launch()
        _sleep_until(min(stall_end, deadline))
        if stall_end <= deadline and readback.wait_until(deadline):
            return readback.result(), warm
        self._wedged = _InFlight(stall_end, readback)
        raise StepWatchdogTimeout(
            f"serving step exceeded {budget:.3f}s wall-clock "
            f"(step {step_no})")

    def _trip(self, e: StepWatchdogTimeout, packed, step_no: int,
              **where) -> None:
        """A watchdog trip: every request of the abandoned step fails
        (``step_watchdog``, slot and pages returned) and the flight
        recorder dumps, naming them."""
        log_dist(f"serving: step watchdog tripped: {e}", ranks=[0])
        self.metrics.watchdog_trips += 1
        rids = [r.rid for _, r in packed]
        if self.tracer.enabled:
            self.tracer.instant("watchdog_trip", cat="engine",
                                args={"step": step_no, "rids": rids,
                                      **where})
        for slot, req in packed:
            self.sched.fail(req, "step_watchdog")
            self._clear_slot_arrays(slot)
            self.metrics.requests_failed += 1
        self._flight("watchdog_trip", step=step_no, rids=rids,
                     budget_s=self.config.step_watchdog_s, **where)

    @staticmethod
    def _pin_slot(spec, slots: List[int]) -> int:
        """The slot a corrupt_logits firing poisons: its ``slot=N`` pin
        when that slot is among ``slots``, else the first of them — an
        injection point must never crash the loop it is drilling."""
        try:
            pin = int(spec.params["slot"])
        except (KeyError, ValueError):
            return slots[0]
        return pin if pin in slots else slots[0]

    def _read_back(self, out, n: int) -> _ReadBack:
        """The :class:`_ReadBack` of ``(tokens [n], bad)`` from a forward's
        device output: greedy tokens come with it; sampled ones are drawn
        here, outside any graph, from its logits with the engine's
        generator (a NaN row is flagged and never harvested; it is zeroed
        for the draw)."""
        cfg = self.config
        if cfg.do_sample:
            lg, bad = out
            with torch.inference_mode():
                tok = _sample_logits(torch.nan_to_num(lg), self._gen, True,
                                     cfg.temperature, cfg.top_k, cfg.top_p)
                out = torch.cat([tok.int(), bad.int()])
        return _ReadBack(out, n, self._host_bufs)

    def _packed_forward(self, width):
        """The packed step's device work at ``width`` over the static
        buffers: the forward (the pool appended in place), the harvest
        (with the step's corrupt flags), and for greedy decoding the
        tokens; returns ``[width + R]`` int32 (tokens, then the NaN flags)
        or, when sampling, ``(logits [width, V], flags [R])``."""
        ids, idx = self._static.index(width)
        with torch.inference_mode():
            logits, _ = self.engine.module(ids.long(), cache=self.pool,
                                           cache_index=idx)
            lg, bad = harvest_packed_logits(
                logits, idx["token_rows"], self.config.max_batch_size,
                corrupt=self._static.views["corrupt"])
            if self.config.do_sample:
                return lg, bad
            return torch.cat([lg.argmax(dim=-1).int(), bad.int()])

    # -- performance accounting ----------------------------------------

    def _observe(self, name: str, **arrays) -> None:
        """One dispatch of program ``name`` for the recompile sentinel: its
        arrays' specs beside the params' and the pool's (memoized on their
        identity: both keep one object for the engine's life)."""
        fp = fingerprint(**arrays)
        fp["params"] = self.perf.cached_spec("params", self.engine.module)
        fp["pool"] = self.perf.cached_spec("pool", self.pool)
        self.perf.programs.observe_call(name, fp)

    def _mixed_name(self, width: int) -> str:
        """Program name of the packed step at ``width``: one name by
        default, one per bucket with ``mixed_step_buckets`` (each width is
        its own captured graph, so dispatching across widths never reads
        as a recompile)."""
        return "mixed_step" if self._bucket_widths is None \
            else f"mixed_step[{width}]"

    def _mixed_cost_estimate(self, width: int):
        """The packed step's cost: every packed position (padding
        included) against the table-width context, and the params read
        once plus every row's table-width KV walk (the JAX engine's
        estimate)."""
        mcfg = self.engine.module.config
        B, ctx = self.config.max_batch_size, self.config.max_model_len
        return {"flops": width * transformer_flops_per_token(mcfg, ctx),
                "bytes_accessed": estimate_decode_step_bytes(
                    mcfg, B, ctx, param_bytes(self.engine.module),
                    kv_bytes_per_elem=self._kv_bytes_per_elem)}

    def _decode_cost_estimate(self):
        """The two-program decode's cost: every slot against the
        table-width context."""
        mcfg = self.engine.module.config
        B, ctx = self.config.max_batch_size, self.config.max_model_len
        return {"flops": estimate_decode_step_flops(mcfg, B, ctx),
                "bytes_accessed": estimate_decode_step_bytes(
                    mcfg, B, ctx, param_bytes(self.engine.module),
                    kv_bytes_per_elem=self._kv_bytes_per_elem)}

    def _note_mixed_perf(self, dt_s: float, tokens: int, width: int) -> None:
        """Per-step utilization of the packed step over its wall time
        (fill, forward or replay, read-back: what a user waits for)."""
        vals = self.perf.on_program_step(self._mixed_name(width), dt_s,
                                         tokens=tokens)
        m = self.metrics
        m.mixed_flops_per_step = vals["flops_per_step"]
        m.mixed_bytes_per_step = vals["bytes_per_step"]
        m.mixed_mfu = vals["mfu"]
        m.mixed_mbu = vals["mbu"]
        m.mixed_tokens_per_sec_per_chip = vals["tokens_per_sec_per_chip"]

    def _note_decode_perf(self, dt_s: float, tokens: int) -> None:
        """Per-step utilization of the two-program decode over its wall
        time; decode is bandwidth-bound, so MBU and tokens/s are the
        honest gauges."""
        vals = self.perf.on_program_step("decode", dt_s, tokens=tokens)
        m = self.metrics
        m.decode_flops_per_step = vals["flops_per_step"]
        m.decode_bytes_per_step = vals["bytes_per_step"]
        m.decode_mfu = vals["mfu"]
        m.decode_mbu = vals["mbu"]
        m.decode_tokens_per_sec_per_chip = vals["tokens_per_sec_per_chip"]

    # ------------------------------------------------------------------
    # the two-program engine (mixed_step=False)
    # ------------------------------------------------------------------

    def _forward_last(self, kind: tuple, **arrays):
        """One model forward of the two-program engine over the static
        buffers of ``kind`` (``("decode",)``, ``("chunk",)`` or
        ``("prefill", Tb)``): ``arrays`` are the step's ``ids [B, T]``, the
        paged bundle's fields (the pool is appended in place), for a
        prefill each row's sampled position ``last_pos [B]`` (a decode
        samples its one position) and, for a decode or a chunk, the
        ``corrupt [B]`` chaos flags. They go to the device in one copy;
        with ``enable_cuda_graph`` on a CUDA device a kind's first forward
        runs eagerly and is then captured, and later forwards replay it.
        Greedy tokens are taken inside that work, sampled ones after it
        with the engine's generator. Returns the :class:`_ReadBack` of
        ``(tokens [B], bad [B])``, ``bad`` flagging rows whose sampled
        logits hold a NaN/Inf."""
        static = self._legacy_static.get(kind)
        if static is None:
            static = self._legacy_static[kind] = StaticIndexBuffers(
                {n: np.shape(a) for n, a in arrays.items()}, self.device)
        static.fill(**arrays)
        return self._read_back(self._run_or_replay(
            kind, lambda: self._legacy_forward(static)),
            static.views["ids"].shape[0])

    def _legacy_forward(self, static: StaticIndexBuffers):
        """A two-program forward's device work over its static buffers:
        the forward, each row's sampled logits and their NaN flags (set
        too where ``corrupt`` flags the row), and for greedy decoding the
        tokens; returns ``[B + B]`` int32 (tokens, then the flags) or,
        when sampling, ``(logits [B, V], flags [B])``."""
        v = static.views
        idx = {n: v[n] for n in ("block_tables", "append_pos",
                                 "context_len", "chunk_start") if n in v}
        with torch.inference_mode():
            logits, _ = self.engine.module(v["ids"].long(), cache=self.pool,
                                           cache_index=idx)
            if "last_pos" in v:
                last = logits[torch.arange(logits.shape[0],
                                           device=logits.device),
                              v["last_pos"].long()]
            else:
                last = logits[:, 0]
            bad = ~torch.isfinite(last).all(dim=-1)
            if "corrupt" in v:
                bad |= v["corrupt"] != 0
            if self.config.do_sample:
                return last, bad
            return torch.cat([last.argmax(dim=-1).int(), bad.int()])

    def _legacy_dispatch(self, kind: tuple, name: str, estimate, stalls,
                         rids, **arrays):
        """One two-program forward of ``kind`` over ``arrays``, observed as
        program ``name`` (its cost from ``estimate``), through
        :meth:`_run_device` with the chaos ``stalls``. Returns ``((tokens,
        bad), the wall time, whether the kind was warm)``."""
        self._observe(name, **arrays)
        self.perf.capture_cost(name, estimate)
        t = time.perf_counter()
        out, warm = self._run_device(
            kind in self._warm, lambda: self._forward_last(kind, **arrays),
            stalls, rids)
        return out, time.perf_counter() - t, warm

    def _fail_prefill(self, req: Request, e: Exception) -> None:
        """A failing prefill (flaky_prefill chaos, an error on one
        pathological prompt, ...) fails ITS request; the engine keeps
        serving everyone else."""
        log_dist(f"serving: prefill failed for {req.rid}: "
                 f"{type(e).__name__}: {e}", ranks=[0])
        slot = req.slot
        self.sched.fail(req, f"prefill_error:{type(e).__name__}")
        self._clear_slot_arrays(slot)
        self.metrics.requests_failed += 1

    def _prefill(self, req: Request) -> None:
        """The monolithic prefill: the admitted request's (resume-)prompt
        as one forward padded to a power of two, which appends its KV into
        its pages and samples token one. It attends the fresh K/V only, so
        it needs a from-empty sequence and never runs with the prefix
        cache on. The pads (``append_pos = -1``) are what the key mask of
        the from-empty attention hides. It is never watchdog-judged (as in
        the JAX engine)."""
        # chaos point: DS_FAULT=flaky_prefill raises here; step() fails the
        # request and keeps serving
        fault_injection.maybe_fail("flaky_prefill", exc=RuntimeError,
                                   tag="serving_prefill", step=self._step_no,
                                   stream=self.fault_stream,
                                   detail={"rids": [req.rid]})
        tokens = req.resume_tokens
        L = len(tokens)
        Tb = next_pow2(max(L, self.config.prefill_bucket_min))
        self._write_table_row(req)
        ids = np.zeros((1, Tb), np.int32)
        ids[0, :L] = tokens
        ar = np.arange(Tb)[None, :]
        arrays = dict(ids=ids, block_tables=self._tables[req.slot][None],
                      append_pos=np.where(ar < L, ar, -1), context_len=[L],
                      last_pos=[L - 1])
        name = f"prefill[{Tb}]"
        self._observe(name, **{k: np.asarray(a) for k, a in arrays.items()})
        mcfg = self.engine.module.config
        self.perf.capture_cost(name, lambda: {
            "flops": Tb * transformer_flops_per_token(mcfg, Tb)})
        tr = self.tracer
        t_pf = time.perf_counter()
        tok, bad = self._forward_last(("prefill", Tb), **arrays).result()
        if tr.enabled:
            tr.complete("prefill", t_pf, time.perf_counter(), cat="engine",
                        args={"rid": req.rid, "tokens": L, "bucket": Tb})
        self.prefill_calls += 1
        req.seq_len = L
        req.prefill_done = L
        self._seq_lens[req.slot] = L
        self.metrics.prefill_tokens += L
        self.metrics.prefill_tokens_computed += L
        self.metrics.window_tokens += L
        if self.config.logit_guard and bool(bad[0]):
            self._quarantine(req.slot, req, self._step_no, where="prefill")
            return
        self._harvest(req, int(tok[0]))

    def _run_prefill_chunks(self) -> None:
        """Spend this step's prefill token budget: round-robin one chunk at
        a time across mid-prefill residents (admission order) until the
        budget is gone or nobody is owed prefill. The decode always runs
        after: the budget is what bounds prefill's share of the step. A
        chunk that raises fails its request; one past the watchdog budget
        fails its request and ends the step's prefill half."""
        budget = self._chunk_budget
        while budget > 0:
            # promotion-blocked residents are skipped (their next chunk
            # would attend host pages still in flight), as in the unified
            # step's grant planner
            pending = sorted((r for _, r in self.sched.active()
                              if r.prefilling and not r.promote_pending),
                             key=lambda r: r.admit_order)
            if not pending:
                return
            progressed = False
            for req in pending:
                if budget <= 0:
                    return
                n = min(self._chunk, budget,
                        req.prefill_target - req.prefill_done)
                if n <= 0:
                    continue
                try:
                    self._prefill_chunk(req, n)
                except BlockPoolError:
                    raise  # accounting invariant broken — never swallow
                except StepWatchdogTimeout as e:
                    # the chunk wedged: fail ITS request and stop
                    # dispatching; the decode below and the next steps
                    # skip device work until the abandoned call ends
                    self._trip(e, [(req.slot, req)], self._step_no,
                               where="chunked_prefill")
                    return
                except Exception as e:
                    self._fail_prefill(req, e)
                    continue
                budget -= n
                progressed = True
            if not progressed:
                return

    def _prefill_chunk(self, req: Request, n: int) -> None:
        """Run ``n`` prompt tokens (<= the chunk length) as one ``[1,
        chunk]`` forward that attends the pool: the cached prefix and the
        earlier chunks live only there. The chunk's offset, valid length
        and table ride as data. The final chunk samples token one (TTFT)
        and activates the slot for the decode step."""
        fault_injection.maybe_fail("flaky_prefill", exc=RuntimeError,
                                   tag="serving_prefill", step=self._step_no,
                                   stream=self.fault_stream,
                                   detail={"rids": [req.rid]})
        # chaos point: poison this chunk's logits as DATA (no recapture) —
        # the guard must quarantine the request BEFORE its pages are
        # content-indexed
        corrupt = fault_injection.maybe_flag(
            "corrupt_logits", tag="serving_prefill", step=self._step_no,
            stream=self.fault_stream,
            detail={"rids": [req.rid]}) is not None
        tokens = req.resume_tokens
        start = req.prefill_done
        bs = self.block_pool.block_size
        # copy-on-write any target page another sequence still references
        for idx in range(start // bs, (start + n - 1) // bs + 1):
            self._ensure_exclusive(req, idx)
        ids = np.zeros((1, self._chunk), np.int32)
        ids[0, :n] = tokens[start:start + n]
        ar = np.arange(self._chunk)[None, :]
        arrays = dict(ids=ids, block_tables=self._table_row(req),
                      append_pos=np.where(ar < n, start + ar, -1),
                      context_len=np.array([start + n]),
                      chunk_start=np.array([start]),
                      last_pos=np.array([n - 1]),
                      corrupt=np.array([int(corrupt)]))
        mcfg = self.engine.module.config
        # chaos point INSIDE the guarded region: slow_chunk
        (tok, bad), dt, warm = self._legacy_dispatch(
            ("chunk",), "chunked_prefill", lambda: {
                "flops": self._chunk * transformer_flops_per_token(
                    mcfg, self.config.max_model_len)},
            [("slow_chunk", "serving_prefill")], [req.rid], **arrays)
        if warm:
            self.perf.on_program_step("chunked_prefill", dt, tokens=n)
        if self.tracer.enabled:
            t_end = time.perf_counter()
            self.tracer.complete("prefill_chunk", t_end - dt, t_end,
                                 cat="engine",
                                 args={"rid": req.rid, "start": start,
                                       "tokens": n})
        self.prefill_chunk_calls += 1
        req.prefill_done = start + n
        req.seq_len = start + n
        self.metrics.prefill_tokens += n
        self.metrics.prefill_tokens_computed += n
        self.metrics.window_tokens += n
        # guard every chunk (its last position attends everything before
        # it) and BEFORE content-indexing: a quarantined request's pages
        # must blank on release, never park on the LRU
        if self.config.logit_guard and bool(bad[0]):
            self._quarantine(req.slot, req, self._step_no,
                             where="prefill_chunk")
            return
        self._commit_full_blocks(req)
        if req.prefill_done < req.prefill_target:
            return  # mid-prompt: no token sampled, the slot stays idle
        self._write_table_row(req)
        self._seq_lens[req.slot] = req.seq_len
        self._harvest(req, int(tok[0]))

    def _decode_step(self) -> None:
        """The decode forward over ALL slots: every decoding resident
        appends its last token at ``seq_len`` and attends ``seq_len + 1``
        keys. Idle and mid-prefill slots carry a sentinel table row and
        ``seq_len`` 0: their append is dropped, they read no allocated
        page, and their output is never harvested."""
        active = [(s, r) for s, r in self.sched.active()
                  if r.state is RequestState.RUNNING and not r.prefilling]
        w = self._wedged
        if active and w is not None and w.is_alive():
            # a prefill chunk tripped the watchdog THIS step: nothing else
            # may touch the device until the abandoned call ends (the
            # step-top gate covers trips of earlier steps)
            self.metrics.watchdog_skips += 1
            return
        if not active:
            return
        corrupt = np.zeros((self.config.max_batch_size,), np.int32)
        rids = [r.rid for _, r in active]
        spec = fault_injection.maybe_flag("corrupt_logits",
                                          tag="serving_step",
                                          step=self._step_no,
                                          stream=self.fault_stream,
                                          detail={"rids": rids})
        if spec is not None:
            # poison ONE slot's logits; the guard must quarantine that
            # request, not the batch
            corrupt[self._pin_slot(spec, [s for s, _ in active])] = 1
        step_no = self._step_no
        arrays = dict(ids=self._last_tok[:, None],
                      block_tables=self._tables,
                      append_pos=self._seq_lens[:, None],
                      context_len=self._seq_lens + 1, corrupt=corrupt)

        try:
            # chaos point INSIDE the guarded region: a slow or wedged step
            # is exactly what the watchdog exists for
            (toks, bad), dt, warm = self._legacy_dispatch(
                ("decode",), "decode", self._decode_cost_estimate,
                [("slow_step", "serving_step")], rids, **arrays)
        except StepWatchdogTimeout as e:
            self._trip(e, active, step_no)
            return
        if self.tracer.enabled:
            t_end = time.perf_counter()
            self.tracer.complete("decode_step", t_end - dt, t_end,
                                 cat="engine",
                                 args={"step": step_no,
                                       "active": len(active)})
        if warm:
            # the first-beat rule for the gauges too
            self._note_decode_perf(dt, tokens=len(active))
        self.decode_calls += 1
        for slot, req in active:
            if self.config.logit_guard and bad[slot]:
                self._quarantine(slot, req, step_no, where="decode")
                continue
            req.seq_len += 1
            self._seq_lens[slot] = req.seq_len
            # a generated token may have just filled a page: index it so
            # identical continuations (multi-turn replays) reuse it
            self._commit_full_blocks(req)
            self._harvest(req, int(toks[slot]))

    # ------------------------------------------------------------------
    # prefix cache: copy-on-write and hash commits (both engines)
    # ------------------------------------------------------------------

    def _ensure_exclusive(self, req: Request, block_idx: int) -> None:
        """Copy-on-write guard for append paths: the page at ``block_idx``
        of the request's table must be referenced only by this request
        before anything scatters into it. Shared pages are forked
        (``BlockPool.cow``) and copied on the device, before this step's
        appends on the same stream; the table is rewritten by the
        caller."""
        if block_idx >= len(req.blocks):
            return  # page not allocated yet (growth allocates exclusively)
        bid = req.blocks[block_idx]
        if not self.block_pool.is_shared(bid):
            return
        new = self.block_pool.cow(bid, req.rid)
        copy_paged_blocks(self.pool, [bid], [new])
        req.blocks[block_idx] = new
        self.metrics.cow_copies += 1
        if self.tracer.enabled:
            self.tracer.instant("cow", cat="pool",
                                args={"rid": req.rid, "src": bid,
                                      "dst": new})

    def _commit_full_blocks(self, req: Request) -> None:
        """Content-index every COMPLETELY written page of this sequence
        (key chained over the prefix) so later identical prompts reuse it.
        Cheap and idempotent: already-indexed pages return at once. The
        callers run it only after the logit guard passed."""
        if not self.config.prefix_cache:
            return
        bs = self.block_pool.block_size
        full = req.seq_len // bs
        tokens = None
        while len(req.block_hashes) < full:
            # generated tokens filled pages past the admission-time keys
            j = len(req.block_hashes)
            if tokens is None:
                tokens = req.resume_tokens
            prev = req.block_hashes[j - 1] if j else None
            req.block_hashes.append(self.block_pool.canonical_key(
                chain_hash(prev, tokens[j * bs:(j + 1) * bs])))
        for idx in range(req.committed_blocks, full):
            self.block_pool.commit_hash(req.blocks[idx],
                                        req.block_hashes[idx])
        req.committed_blocks = max(req.committed_blocks, full)

    def _quarantine(self, slot: int, req: Request, step_no: int,
                    where: str) -> None:
        """NaN/Inf logits on one packed row: quarantine THAT request
        (terminal FAILED, pages returned, flight dump), never the batch."""
        if self.tracer.enabled:
            self.tracer.instant("quarantine", cat="engine",
                                args={"rid": req.rid, "slot": slot,
                                      "step": step_no, "where": where})
        self.sched.fail(req, "corrupt_logits")
        self._clear_slot_arrays(slot)
        self.metrics.logit_quarantines += 1
        self.metrics.requests_failed += 1
        self._flight("logit_quarantine", rid=req.rid, slot=slot,
                     step=step_no, where=where)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _account_reaped(self) -> None:
        """Count the requests the scheduler shed at the admission gate
        (deadline-expired while queued) this step."""
        if self.sched.reaped:
            self.metrics.requests_timeout += len(self.sched.reaped)
            self.sched.reaped.clear()

    def _table_row(self, req: Request) -> np.ndarray:
        """``[1, nb_max]``: the request's pages, then the sentinel."""
        row = np.full((1, self.nb_max), self.block_pool.sentinel, np.int32)
        row[0, :len(req.blocks)] = req.blocks
        return row

    def _write_table_row(self, req: Request) -> None:
        self._tables[req.slot] = self._table_row(req)[0]

    def _clear_slot_arrays(self, slot: Optional[int]) -> None:
        if slot is None:
            return
        self._tables[slot] = self.block_pool.sentinel
        self._seq_lens[slot] = 0
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


def init_serving(model=None, config=None, serving_config=None, monitor=None,
                 **kwargs) -> ServingEngine:
    """Build an :class:`InferenceEngine` (same surface as
    ``init_inference``) and wrap it for serving. ``monitor`` (anything
    with ``write_events``) receives the serving counters every
    ``serving_config.monitor_every`` steps."""
    from ..engine import init_inference

    engine = init_inference(model, config=config, **kwargs)
    return ServingEngine(engine, config=serving_config, monitor=monitor)
