"""Serving counters, exported through the existing ``monitor/`` backends.

The engine updates one ``ServingMetrics`` per step; ``to_events`` renders
the snapshot as the ``(tag, value, step)`` tuples every monitor backend
(TensorBoard / W&B / CSV) already consumes — no backend changes needed.

Latency distributions ride the unified registry's **log-bucket
histograms** (``monitor/registry.py``): the old 4096-sample windows
biased p95 toward recent traffic and forgot bursts outright; the
histograms are O(1) memory under sustained traffic and their quantiles
cover the whole run. ``snapshot()`` keys are unchanged
(``ttft_p50_s``/``ttft_p95_s``/``step_p50_s``/``step_p95_s``) so monitor
wiring and ``ds_bench`` artifacts keep parsing; p99 keys are new.
"""

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from ...monitor.registry import Histogram, MetricsRegistry

#: every terminal request gets exactly one SLO verdict (engine.py judges
#: at the terminal transition; ``shed`` covers cancels/sheds/drains,
#: ``failed`` covers engine-side failures — neither burns the latency SLO
#: budget, both burn the availability story, so both count as "not good"
#: in the burn rate)
SLO_VERDICTS = ("good", "ttft_miss", "tpot_miss", "shed", "failed")

#: terminal requests the rolling burn-rate gauge looks back over — long
#: enough to smooth one bad batch, short enough that a recovered engine's
#: gauge actually recovers
SLO_WINDOW = 256


def _percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over raw samples (kept for the bench
    harnesses that collect their own per-request lists)."""
    if not values:
        return None
    xs = sorted(values)
    idx = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[idx]


@dataclass
class ServingMetrics:
    blocks_total: int = 0
    # monotone counters
    requests_submitted: int = 0
    requests_completed: int = 0
    requests_failed: int = 0
    #: overload-control counters — the observability half of the resilience
    #: contract (shed = load shedding + drain, rejected = admission control)
    requests_timeout: int = 0
    requests_cancelled: int = 0
    requests_shed: int = 0
    requests_rejected: int = 0
    watchdog_trips: int = 0
    #: steps whose decode was skipped because the previously-abandoned
    #: (watchdog-tripped) step was still wedged in device compute
    watchdog_skips: int = 0
    logit_quarantines: int = 0
    brownout_admissions: int = 0
    preemptions: int = 0
    #: prompt tokens SERVED into request contexts (cached + recomputed):
    #: the user-visible prefill volume
    prefill_tokens: int = 0
    #: prompt tokens that actually ran through the model — cache hits are
    #: excluded here, so compute throughput can never be inflated by
    #: serving the same prefix twice
    prefill_tokens_computed: int = 0
    #: prompt tokens served from the prefix cache WITHOUT recompute
    cached_prefill_tokens: int = 0
    #: admissions that matched a non-empty cached prefix
    prefix_hits: int = 0
    #: copy-on-write page forks (appends routed off shared pages)
    cow_copies: int = 0
    # -- tiered KV (kv_tiers.HostTier behind the BlockPool) -------------
    #: admissions whose prefix match extended into the HOST tier (>=1
    #: host-resident block scheduled for promotion)
    kv_host_hits: int = 0
    #: tier-enabled admissions whose match ended at the device boundary
    #: (nothing promotable on the host) — hits + misses = probed
    #: admissions, the denominator of the host-tier usefulness story
    kv_host_misses: int = 0
    #: prompt tokens served from HOST-tier pages (a subset of
    #: ``cached_prefill_tokens`` — host hits are cache hits whose KV
    #: streams up instead of recomputing)
    kv_host_hit_tokens: int = 0
    #: pages demoted device -> host (evictions that preserved the chain)
    kv_pages_demoted: int = 0
    #: promotions folded into the device pool (host -> device)
    kv_pages_promoted: int = 0
    #: scheduled promotions dropped before folding (their request was
    #: preempted / cancelled / failed while the transfer was in flight)
    kv_promote_cancelled: int = 0
    # gauges (overwritten each step while a tier is attached)
    #: host-tier entries / bytes right now
    kv_host_blocks: int = 0
    kv_host_bytes: int = 0
    #: promotions still in flight (scheduled, not yet folded)
    promote_queue_depth: int = 0
    tokens_generated: int = 0
    # -- speculative decoding (the verify rows of the mixed step) -------
    #: draft tokens packed into verify rows (accepted or not — the
    #: denominator of the accept rate, and the honest measure of the
    #: extra verify work speculation buys its speedup with)
    spec_drafted: int = 0
    #: draft tokens the target model's greedy predictions confirmed
    #: (each one is a generated token that skipped its own dispatch)
    spec_accepted: int = 0
    #: tokens committed by verify rows (accepted drafts + the bonus
    #: token every verify row yields) — the numerator of
    #: ``spec_tokens_per_verify``
    spec_committed: int = 0
    #: verify rows committed (one per speculating resident per step —
    #: the honest denominator: dividing by steps would inflate the
    #: gauge with batch occupancy)
    spec_verify_rows: int = 0
    #: steps that packed at least one verify row
    spec_steps: int = 0
    #: pool pages dropped by speculative rollback (whole pages past the
    #: accepted prefix, returned through the reference sets)
    spec_pages_dropped: int = 0
    steps: int = 0
    # gauges (overwritten each step)
    queue_depth: int = 0
    active_seqs: int = 0
    blocks_used: int = 0
    #: refcount-0 pages kept warm in the prefix cache (reclaimable)
    blocks_cached: int = 0
    #: cached pages reclaimed to back new allocations (pool monotone)
    prefix_evictions: int = 0
    #: residents still owed prefill tokens this step (the unified step's
    #: packed-budget backlog; formerly ``chunked_prefill_waiting`` — the
    #: sentinel-row framing died with the two-program engine)
    prefill_waiting: int = 0
    #: age (s) of the OLDEST request still owed prefill tokens — it
    #: climbing means the per-step prefill token budget is starving long
    #: prompts (formerly ``chunked_prefill_queue_age_s``)
    prefill_queue_age_s: float = 0.0
    brownout_active: bool = False
    # -- performance accounting (monitor/perf.py; engine-written each
    # step). None = not yet captured, or the value needs a device peak /
    # allocator stats the backend does not expose (CPU) — absent from the
    # snapshot rather than a fake zero.
    #: per-call FLOPs of the resident decode step (cost model or estimate)
    decode_flops_per_step: Optional[float] = None
    #: per-call bytes-accessed of the resident decode step
    decode_bytes_per_step: Optional[float] = None
    #: model FLOPs utilization of the decode step (needs a known peak)
    decode_mfu: Optional[float] = None
    #: model BANDWIDTH utilization — decode is bandwidth-bound, this is
    #: the honest hardware-efficiency gauge for serving
    decode_mbu: Optional[float] = None
    decode_tokens_per_sec_per_chip: Optional[float] = None
    #: unified mixed step (the default engine's ONE resident program):
    #: per-call cost + utilization — decode_* above are written only by
    #: the legacy two-program engine
    mixed_flops_per_step: Optional[float] = None
    mixed_bytes_per_step: Optional[float] = None
    mixed_mfu: Optional[float] = None
    #: model BANDWIDTH utilization of the mixed step — still the honest
    #: serving gauge (the step is dominated by the param + KV read)
    mixed_mbu: Optional[float] = None
    #: packed tokens (decode + computed prefill) per second per chip
    mixed_tokens_per_sec_per_chip: Optional[float] = None
    # -- SLO / goodput accounting (engine.py judges each request at its
    # terminal transition against the ServingConfig SLO block) ----------
    slo_good: int = 0
    slo_ttft_miss: int = 0
    slo_tpot_miss: int = 0
    slo_shed: int = 0
    slo_failed: int = 0
    #: generated tokens of requests that MET their SLO — the numerator of
    #: goodput (a replica can post a huge tokens/sec while every request
    #: blows its latency budget; goodput cannot)
    goodput_tokens: int = 0
    #: goodput tokens inside the current throughput window (re-anchored
    #: with it on traffic resume)
    window_goodput_tokens: int = 0
    #: recompile-sentinel alarms: resident programs whose argument
    #: fingerprint changed (each one names the offender in the trace)
    recompiles: int = 0
    #: device memory watermarks summed over local devices
    hbm_bytes_in_use: Optional[int] = None
    hbm_peak_bytes: Optional[int] = None
    #: the unified registry backing the latency histograms; shared with
    #: anything else that wants to register serving-scoped metrics
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    # throughput window: re-anchored whenever traffic resumes after a
    # drain, so tokens/sec reflects the CURRENT serving rate instead of
    # decaying across idle gaps
    window_start: float = field(default_factory=time.perf_counter)
    window_tokens: int = 0

    def __post_init__(self):
        # fixed log buckets spanning 10us..1h of latency; O(1) memory
        # under unbounded traffic, quantile error bounded by the 1.1
        # growth factor (~5%)
        self.ttft_hist: Histogram = self.registry.histogram(
            "ttft_s", lo=1e-5, hi=4e3)
        self.step_hist: Histogram = self.registry.histogram(
            "step_s", lo=1e-5, hi=4e3)
        #: schedule -> fold latency of host-tier promotions (the number
        #: the "promotion hidden behind suffix prefill" claim is judged
        #: on); rides the registry so /metrics exports the buckets
        self.promote_hist: Histogram = self.registry.histogram(
            "kv_promote_wait_s", lo=1e-6, hi=4e3)
        #: rolling SLO window: 1 per non-good terminal, 0 per good — the
        #: burn-rate gauge is its mean (bounded memory, recovers as good
        #: traffic pushes bad verdicts out). The /metrics scrape thread
        #: reads it mid-append, so readers take one list() snapshot
        self.slo_window: Deque[int] = deque(maxlen=SLO_WINDOW)  # dslint: guarded-by=snapshot

    def record_ttft(self, x: float) -> None:
        self.ttft_hist.observe(x)

    def record_step(self, x: float) -> None:
        self.step_hist.observe(x)

    def note_slo(self, verdict: str, goodput_tokens: int = 0) -> None:
        """Fold one terminal request's SLO verdict in: per-verdict
        counters (field + ``slo_requests{verdict=}`` in the registry),
        the rolling burn-rate window, and the goodput numerator."""
        if verdict not in SLO_VERDICTS:
            raise ValueError(f"unknown SLO verdict {verdict!r} "
                             f"(want one of {SLO_VERDICTS})")
        setattr(self, f"slo_{verdict}",
                getattr(self, f"slo_{verdict}") + 1)
        self.registry.counter("slo_requests", verdict=verdict).inc()
        self.slo_window.append(0 if verdict == "good" else 1)
        if goodput_tokens:
            self.goodput_tokens += goodput_tokens
            self.window_goodput_tokens += goodput_tokens

    def on_traffic_resume(self) -> None:
        self.window_start = time.perf_counter()
        self.window_tokens = 0
        self.window_goodput_tokens = 0

    @property
    def occupancy(self) -> float:
        return self.blocks_used / self.blocks_total if self.blocks_total else 0.0

    @property
    def tokens_per_sec(self) -> float:
        """COMPUTE throughput: generated tokens + recomputed prefill
        tokens per second. Prefix-cache hits are deliberately excluded —
        they are served, not computed, and counting them would let a
        prefix-heavy benchmark inflate its throughput artifact."""
        dt = time.perf_counter() - self.window_start
        return self.window_tokens / dt if dt > 0 else 0.0

    @property
    def served_tokens(self) -> int:
        """Everything that entered request contexts: generated + prefill
        (INCLUDING cache hits — the user-visible volume)."""
        return self.tokens_generated + self.prefill_tokens

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of served prefill tokens that came from the cache."""
        return self.cached_prefill_tokens / self.prefill_tokens \
            if self.prefill_tokens else 0.0

    @property
    def host_hit_rate(self) -> float:
        """Fraction of served prefill tokens that came from the HOST
        tier specifically — the tier's own contribution on top of the
        device cache (0 with the tier off or never hit)."""
        return self.kv_host_hit_tokens / self.prefill_tokens \
            if self.prefill_tokens else 0.0

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of drafted tokens the target model confirmed; 0 with
        no drafts yet (an engine that never speculates reports 0, not a
        fake 1)."""
        return self.spec_accepted / self.spec_drafted \
            if self.spec_drafted else 0.0

    @property
    def spec_tokens_per_verify(self) -> float:
        """Tokens committed per VERIFY ROW (accepted drafts + bonus;
        1.0 means that row did exactly what plain decode would have).
        Per row, not per step — dividing by steps would fold batch
        occupancy into the gauge (8 residents all rejecting everything
        would read as 8.0 'per step' while being exactly plain
        decode)."""
        return self.spec_committed / self.spec_verify_rows \
            if self.spec_verify_rows else 0.0

    @property
    def goodput_tokens_per_sec(self) -> float:
        """Generated-token throughput counting ONLY requests that met
        their SLO (same window discipline as ``tokens_per_sec``): the
        number a fleet's capacity planning should believe."""
        dt = time.perf_counter() - self.window_start
        return self.window_goodput_tokens / dt if dt > 0 else 0.0

    @property
    def slo_burn_rate(self) -> float:
        """Fraction of the last ``SLO_WINDOW`` terminal requests that
        did NOT meet their SLO (misses + sheds + failures). 0 with no
        terminals yet — an idle replica is not burning budget."""
        # ONE point-in-time copy: this runs on the /metrics scrape
        # thread while the engine appends verdicts — summing the live
        # deque and then len()-ing it again reads two different windows
        # (a burn rate over a denominator the numerator never saw).
        # Retry the copy itself: a deque iterator raises RuntimeError on
        # ANY concurrent mutation (maxlen rotation included), and the
        # list() walk can be preempted mid-allocation; verdict appends
        # per scrape are finite, so this converges immediately
        while True:
            try:
                window = list(self.slo_window)
                break
            except RuntimeError:
                continue
        if not window:
            return 0.0
        return sum(window) / len(window)

    def snapshot(self) -> Dict[str, float]:
        out = {
            "queue_depth": float(self.queue_depth),
            "active_seqs": float(self.active_seqs),
            "kv_blocks_used": float(self.blocks_used),
            "kv_block_occupancy": self.occupancy,
            "tokens_per_sec": self.tokens_per_sec,
            "tokens_generated": float(self.tokens_generated),
            "served_tokens": float(self.served_tokens),
            "prefill_tokens": float(self.prefill_tokens),
            "prefill_tokens_computed": float(self.prefill_tokens_computed),
            "cached_prefill_tokens": float(self.cached_prefill_tokens),
            "prefix_hit_rate": self.prefix_hit_rate,
            "prefix_hits": float(self.prefix_hits),
            "prefix_evictions": float(self.prefix_evictions),
            "kv_blocks_cached": float(self.blocks_cached),
            "cow_copies": float(self.cow_copies),
            "kv_host_hits": float(self.kv_host_hits),
            "kv_host_misses": float(self.kv_host_misses),
            "kv_host_hit_tokens": float(self.kv_host_hit_tokens),
            "host_hit_rate": self.host_hit_rate,
            "kv_pages_demoted": float(self.kv_pages_demoted),
            "kv_pages_promoted": float(self.kv_pages_promoted),
            "kv_promote_cancelled": float(self.kv_promote_cancelled),
            "kv_host_blocks": float(self.kv_host_blocks),
            "kv_host_bytes": float(self.kv_host_bytes),
            "promote_queue_depth": float(self.promote_queue_depth),
            "prefill_waiting": float(self.prefill_waiting),
            "prefill_queue_age_s": self.prefill_queue_age_s,
            "requests_submitted": float(self.requests_submitted),
            "requests_completed": float(self.requests_completed),
            "requests_failed": float(self.requests_failed),
            "requests_timeout": float(self.requests_timeout),
            "requests_cancelled": float(self.requests_cancelled),
            "requests_shed": float(self.requests_shed),
            "requests_rejected": float(self.requests_rejected),
            "watchdog_trips": float(self.watchdog_trips),
            "watchdog_skips": float(self.watchdog_skips),
            "logit_quarantines": float(self.logit_quarantines),
            "brownout_admissions": float(self.brownout_admissions),
            "brownout_active": float(self.brownout_active),
            "preemptions": float(self.preemptions),
            "steps": float(self.steps),
            "recompiles": float(self.recompiles),
            "slo_good": float(self.slo_good),
            "slo_ttft_miss": float(self.slo_ttft_miss),
            "slo_tpot_miss": float(self.slo_tpot_miss),
            "slo_shed": float(self.slo_shed),
            "slo_failed": float(self.slo_failed),
            "goodput_tokens": float(self.goodput_tokens),
            "goodput_tokens_per_sec": self.goodput_tokens_per_sec,
            "slo_burn_rate": self.slo_burn_rate,
            "spec_drafted": float(self.spec_drafted),
            "spec_accepted": float(self.spec_accepted),
            "spec_accept_rate": self.spec_accept_rate,
            "spec_tokens_per_verify": self.spec_tokens_per_verify,
            "spec_steps": float(self.spec_steps),
            "spec_pages_dropped": float(self.spec_pages_dropped),
        }
        for key in ("decode_flops_per_step", "decode_bytes_per_step",
                    "decode_mfu", "decode_mbu",
                    "decode_tokens_per_sec_per_chip",
                    "mixed_flops_per_step", "mixed_bytes_per_step",
                    "mixed_mfu", "mixed_mbu",
                    "mixed_tokens_per_sec_per_chip",
                    "hbm_bytes_in_use", "hbm_peak_bytes"):
            v = getattr(self, key)
            if v is not None:
                out[key] = float(v)
        if self.ttft_hist.count:
            out["ttft_p50_s"] = self.ttft_hist.percentile(0.5)
            out["ttft_p95_s"] = self.ttft_hist.percentile(0.95)
            out["ttft_p99_s"] = self.ttft_hist.percentile(0.99)
        if self.step_hist.count:
            out["step_p50_s"] = self.step_hist.percentile(0.5)
            out["step_p95_s"] = self.step_hist.percentile(0.95)
            out["step_p99_s"] = self.step_hist.percentile(0.99)
        if self.promote_hist.count:
            out["kv_promote_wait_p50_s"] = self.promote_hist.percentile(0.5)
            out["kv_promote_wait_p95_s"] = self.promote_hist.percentile(0.95)
        return out

    def to_events(self, step: int):
        """Render as monitor events (``monitor/registry.py`` Event tuples)."""
        from ...monitor.registry import events_from_scalars

        return events_from_scalars(self.snapshot(), step, prefix="serving/")
