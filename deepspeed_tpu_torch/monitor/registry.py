"""Unified metrics registry: counters, gauges, log-bucketed histograms.

One small primitive set that ``ServingMetrics`` rides, replacing ad-hoc
bounded sample lists with **fixed-bucket log histograms**: O(num_buckets) memory under unbounded traffic and O(1)
per observation, with quantiles whose relative error is bounded by the
bucket growth factor (default 1.1 → ≤ ~5% around the geometric bucket
midpoint). The old 4096-sample windows biased p95 toward recent traffic
and forgot bursts entirely; a histogram forgets nothing.

Label support is flat and cheap: ``registry.counter("requests",
state="shed")`` keys the metric as ``requests{state=shed}`` — exactly the
string the snapshot sees.

Thread-safety: increments are single ``int``/``float`` attribute updates
under the GIL (the same discipline the serving counters already rely on);
``snapshot()`` reads are approximate under concurrent writers, which is
the normal contract for monitoring counters.
"""

import math
import threading
from typing import Any, Dict, List, Optional, Tuple

Event = Tuple[str, float, int]


def events_from_scalars(scalars, step: int, prefix: str = "") -> List[Event]:
    """Render a ``{name: value}`` dict as ``(tag, value, step)`` monitor
    events (None values are skipped)."""
    return [(prefix + name, float(value), step)
            for name, value in sorted(scalars.items()) if value is not None]


class Counter:
    """Monotone counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Log-bucketed histogram with O(1)-memory quantiles.

    Bucket 0 is the underflow bucket ``[0, lo)``; bucket ``i >= 1`` covers
    ``[lo * growth**(i-1), lo * growth**i)``; the last bucket absorbs
    overflow. ``percentile`` walks the cumulative counts (nearest-rank,
    the same convention as the old ``_percentile`` on raw samples) and
    returns the geometric midpoint of the landing bucket, clamped into
    the observed ``[min, max]`` so extreme quantiles never leave the data
    range.
    """

    __slots__ = ("lo", "hi", "growth", "_log_g", "counts", "count", "sum",
                 "min", "max")

    def __init__(self, lo: float = 1e-6, hi: float = 1e5,
                 growth: float = 1.1):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.lo = lo
        self.hi = hi
        self.growth = growth
        self._log_g = math.log(growth)
        nb = 1 + int(math.ceil(math.log(hi / lo) / self._log_g)) + 1
        self.counts = [0] * nb
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if x < self.lo:
            idx = 0
        else:
            idx = min(len(self.counts) - 1,
                      1 + int(math.log(x / self.lo) / self._log_g))
        self.counts[idx] += 1

    def _bucket_value(self, idx: int) -> float:
        if idx == 0:
            # underflow: the observed minimum is the best representative
            return self.min if self.min != math.inf else 0.0
        b_lo = self.lo * self.growth ** (idx - 1)
        return b_lo * math.sqrt(self.growth)  # geometric midpoint

    def percentile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile over the buckets; None when empty."""
        if self.count == 0:
            return None
        rank = min(self.count, int(round(q * (self.count - 1))) + 1)
        cum = 0
        for idx, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                return min(self.max, max(self.min, self._bucket_value(idx)))
        return self.max  # unreachable; counts always sum to count

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Get-or-create registry of named (optionally labeled) metrics.

    ``snapshot()`` renders everything as one flat ``{name: float}`` dict —
    histograms contribute ``<name>_p50/_p95/_p99/_mean/_max/_count`` — the
    exact shape :func:`events_from_scalars` consumes.
    """

    def __init__(self):
        self._lock = threading.Lock()
        #: labeled metrics arrive at runtime while the scrape thread
        #: renders /metrics; get-or-create and snapshot both lock
        self._metrics: Dict[str, Any] = {}  # guarded by _lock

    def _get(self, name: str, labels: Dict[str, Any], factory, kind):
        key = _key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = factory()
        if not isinstance(m, kind):
            raise TypeError(f"metric {key!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge, Gauge)

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 1e5,
                  growth: float = 1.1, **labels) -> Histogram:
        h = self._get(name, labels,
                      lambda: Histogram(lo=lo, hi=hi, growth=growth),
                      Histogram)
        if (h.lo, h.hi, h.growth) != (lo, hi, growth):
            # a kind clash raises in _get; a silently-ignored bucket
            # layout would mis-bin the second caller's observations
            raise ValueError(
                f"histogram {_key(name, labels)!r} already registered "
                f"with (lo={h.lo}, hi={h.hi}, growth={h.growth}); "
                f"conflicting (lo={lo}, hi={hi}, growth={growth})")
        return h

    def items(self):
        # a point-in-time LIST, not a live view: the admin server's
        # /metrics renderer iterates from its own thread while the
        # engine may be get-or-creating metrics — iterating a live dict
        # view across an insert raises RuntimeError
        with self._lock:
            return list(self._metrics.items())

    def snapshot(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, m in sorted(self.items()):
            if isinstance(m, Histogram):
                out[f"{key}_count"] = float(m.count)
                if m.count:
                    out[f"{key}_p50"] = m.percentile(0.50)
                    out[f"{key}_p95"] = m.percentile(0.95)
                    out[f"{key}_p99"] = m.percentile(0.99)
                    out[f"{key}_mean"] = m.mean
                    out[f"{key}_max"] = m.max
            else:
                out[key] = float(m.value)
        return out

    def to_events(self, step: int, prefix: str = "") -> List[Event]:
        return events_from_scalars(self.snapshot(), step, prefix=prefix)
