"""Structured tracing over a bounded ring buffer (the observability spine).

A :class:`Tracer` is a low-overhead, thread-safe span/event recorder over a
**bounded ring buffer**: unbounded traffic costs O(capacity) memory, the
newest events win, and every timestamp comes from the monotonic
``time.perf_counter`` clock (the same clock the serving scheduler stamps
``submit_time``/``deadline`` with, so spans and deadlines line up exactly).
Export is Chrome-trace JSON — load a dump straight into Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Cost discipline: a disabled tracer does no work — ``span()`` returns a
shared singleton context manager and ``instant``/``complete`` return before
touching the ring, so hot loops guard emission with one attribute check
(``if tracer.enabled: ...``) and pay **zero allocations** when tracing is
off. The serving step follows that pattern.
"""

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer's
    ``span()`` — one singleton, zero per-call allocation."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tracer.complete(self._name, self._t0, time.perf_counter(),
                              cat=self._cat, args=self._args)
        return False


class Tracer:
    """Thread-safe span/event recorder over a bounded ring buffer.

    - ``instant(name)`` — point event;
    - ``complete(name, start_s, end_s)`` — span with explicit monotonic
      endpoints (the pattern the hot paths use: measure with two
      ``perf_counter()`` reads, emit once, allocate nothing when disabled);
    - ``span(name)`` — context-manager sugar over ``complete``;
    - ``events()`` / ``to_chrome()`` / ``dump(path)`` — ring snapshot and
      Chrome-trace/Perfetto JSON export.

    Timestamps are ``perf_counter`` microseconds; append order is the ring
    order (the lock covers both the ring write and, for instants, the
    timestamp capture, so ``events()`` is monotone in append time).
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        if capacity < 1:
            raise ValueError("tracer capacity must be >= 1")
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: List[Optional[Dict[str, Any]]] = [None] * capacity  # guarded by _lock
        #: monotone: total events ever appended
        self._count = 0  # guarded by _lock

    # -- emission ------------------------------------------------------

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._ring[self._count % self.capacity] = ev
            self._count += 1

    def instant(self, name: str, cat: str = "",
                args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "ts": 0.0, "tid": threading.get_ident()
              & 0x7FFFFFFF, "cat": cat, "s": "t"}
        if args:
            ev["args"] = args
        with self._lock:
            # ts captured under the lock so ring order == time order
            ev["ts"] = time.perf_counter() * 1e6
            self._ring[self._count % self.capacity] = ev
            self._count += 1

    def complete(self, name: str, start_s: float, end_s: float,
                 cat: str = "", args: Optional[Dict[str, Any]] = None) -> None:
        """Record a complete span from two ``perf_counter()`` readings."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "ts": start_s * 1e6,
              "dur": max(0.0, (end_s - start_s) * 1e6),
              "tid": threading.get_ident() & 0x7FFFFFFF, "cat": cat}
        if args:
            ev["args"] = args
        self._append(ev)

    def span(self, name: str, cat: str = "",
             args: Optional[Dict[str, Any]] = None):
        """Context manager recording a complete span; a disabled tracer
        returns one shared no-op singleton (no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    # -- inspection / export -------------------------------------------

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around (bounded-memory proof)."""
        with self._lock:
            return max(0, self._count - self.capacity)

    def __len__(self) -> int:
        with self._lock:
            return min(self._count, self.capacity)

    def events(self) -> List[Dict[str, Any]]:
        """Ring snapshot, oldest kept event first."""
        with self._lock:
            n = self._count
            if n <= self.capacity:
                return [e for e in self._ring[:n]]
            start = n % self.capacity
            return self._ring[start:] + self._ring[:start]

    def clear(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._count = 0

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome-trace JSON object (Perfetto-loadable)."""
        pid = os.getpid()
        events = []
        for ev in self.events():
            ev = dict(ev)
            ev["pid"] = pid
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "deepspeed_tpu_torch.monitor.tracing",
                              "dropped_events": self.dropped}}

    def dump(self, path: str) -> str:
        """Write the Chrome-trace JSON to ``path`` (dirs created)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


#: shared disabled tracer — the default wiring target when tracing is off,
#: so call sites never need a None check
NULL_TRACER = Tracer(capacity=1, enabled=False)
