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

The :class:`FlightRecorder` is the post-mortem half: incident triggers
(watchdog trips, logit quarantines, ``DS_FAULT`` firings) dump the last N
trace events plus a full metrics snapshot to a timestamped JSONL file
under a configurable directory, in the JAX package's format, so one
reader takes both packages' dumps. Dumps never raise: a failing
post-mortem must not take down the engine it is documenting.
"""

import itertools
import json
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from ..utils.logging import logger

#: Chrome-trace phases this tracer emits: complete spans and instants
EVENT_PHASES = ("X", "i")


def validate_event(ev: Any) -> Optional[str]:
    """One event against the trace schema; returns a problem description
    (None = valid). THE schema definition — ``tools/trace_view.py`` and the
    tests both call this, so the contract cannot fork."""
    if not isinstance(ev, dict):
        return f"event is {type(ev).__name__}, expected object"
    name = ev.get("name")
    if not isinstance(name, str) or not name:
        return "missing/empty 'name' (must be a non-empty string)"
    ph = ev.get("ph")
    if ph not in EVENT_PHASES:
        return f"'ph' is {ph!r}, expected one of {list(EVENT_PHASES)}"
    ts = ev.get("ts")
    if not isinstance(ts, (int, float)) or ts < 0:
        return f"'ts' is {ts!r}, expected a non-negative number (us)"
    if ph == "X":
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)) or dur < 0:
            return f"'dur' is {dur!r}, required >= 0 for a complete span"
    if not isinstance(ev.get("tid", 0), int):
        return f"'tid' is {ev.get('tid')!r}, expected an int"
    if not isinstance(ev.get("pid", 0), int):
        return f"'pid' is {ev.get('pid')!r}, expected an int"
    cat = ev.get("cat", "")
    if not isinstance(cat, str):
        return f"'cat' is {cat!r}, expected a string"
    args = ev.get("args", {})
    if not isinstance(args, dict):
        return f"'args' is {type(args).__name__}, expected an object"
    return None


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


#: dump sequence shared by ALL recorder instances in the process: two
#: recorders pointed at the same dir (training + serving engines in one
#: process) dumping the same trigger within the same second must never
#: collide on a filename — os.replace would silently discard the first
#: post-mortem
_dump_seq = itertools.count(1)


def dump_seq() -> int:
    """Next value of the process-global dump sequence — any filename
    that embeds a second-resolution timestamp must also embed this, or
    two dumps in the same second silently overwrite each other."""
    return next(_dump_seq)

#: fault-arming is EXCLUSIVE per output directory: a DS_FAULT firing is a
#: process-global event, so two recorders sharing one dir (an env-armed
#: global recorder next to an engine's own) must produce ONE post-mortem
#: per firing, not one per recorder. Weak refs: holding an armed-dir slot
#: never keeps a dropped engine alive.
_arm_lock = threading.Lock()
_fault_armed_dirs: Dict[str, "weakref.ref[FlightRecorder]"] = {}  # guarded by _arm_lock


class FlightRecorder:
    """Post-mortem capture: on an incident trigger, dump the last N trace
    events plus a full metrics snapshot to a timestamped JSONL file.

    File format (one incident per file, ``flight_<trigger>_<stamp>.jsonl``):
    line 1 is the header record (``kind=flight_recorder``, trigger, detail,
    wall time, metrics snapshot, dropped-event count); every following line
    is one trace event (schema of :func:`validate_event`).

    ``record()`` NEVER raises — a failing dump logs and returns None.
    ``arm_faults()`` subscribes to ``fault_injection`` so every DS_FAULT
    firing leaves a dump; ``disarm()`` unsubscribes.
    """

    def __init__(self, out_dir: str, tracer: Tracer,
                 metrics_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 last_n: int = 512):
        self.out_dir = out_dir
        self.tracer = tracer
        self.metrics_fn = metrics_fn
        self.last_n = last_n
        self.dumps: List[str] = []  # paths written (newest last)
        self._fault_cb: Optional[Callable[[str, Dict[str, Any]], None]] = None

    def record(self, trigger: str, detail: Optional[Dict[str, Any]] = None
               ) -> Optional[str]:
        """Dump one incident; returns the path (None on I/O failure —
        never raises: the post-mortem must not kill the patient)."""
        try:
            trigger_slug = "".join(c if c.isalnum() or c in "-_" else "_"
                                   for c in trigger) or "incident"
            metrics: Dict[str, Any] = {}
            if self.metrics_fn is not None:
                try:
                    metrics = dict(self.metrics_fn())
                except Exception as e:  # metrics must not block the dump
                    metrics = {"_metrics_error": repr(e)}
            events = self.tracer.events()[-self.last_n:]
            seq = dump_seq()  # process-global: filenames never collide
            stamp = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(
                self.out_dir, f"flight_{trigger_slug}_{stamp}_{seq:04d}"
                              f"_{os.getpid()}.jsonl")
            os.makedirs(self.out_dir, exist_ok=True)
            header = {"kind": "flight_recorder", "trigger": trigger,
                      "detail": dict(detail or {}),
                      "wall_time": time.time(),
                      "monotonic_us": time.perf_counter() * 1e6,
                      "pid": os.getpid(), "events": len(events),
                      "events_dropped": self.tracer.dropped,
                      "metrics": metrics}
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(header) + "\n")
                for ev in events:
                    f.write(json.dumps(ev) + "\n")
            os.replace(tmp, path)  # a dump is whole or absent, never torn
            self.dumps.append(path)
            logger.error(f"flight recorder: {trigger} -> {path} "
                         f"({len(events)} events)")
            return path
        except Exception as e:
            logger.error(f"flight recorder: dump for {trigger!r} failed: "
                         f"{type(e).__name__}: {e}")
            return None

    # -- DS_FAULT integration ------------------------------------------

    def arm_faults(self) -> None:
        """Dump on every DS_FAULT firing.

        Arming is exclusive per output directory: when another live
        recorder already covers ``out_dir`` this call is a no-op, so one
        firing produces ONE dump per directory, not one per recorder.
        The registered listener holds only a weak reference — an armed
        recorder (and the engine behind its ``metrics_fn``) stays
        garbage-collectable, and a dead recorder's listener removes
        itself on the next firing."""
        from ..utils import fault_injection

        key = os.path.abspath(self.out_dir)
        with _arm_lock:
            cur = _fault_armed_dirs.get(key)
            holder = cur() if cur is not None else None
            if holder is not None and holder is not self:
                return  # another live recorder already covers this dir
            _fault_armed_dirs[key] = weakref.ref(self)
        if self._fault_cb is None:
            ref = weakref.ref(self)

            def cb(name: str, ctx: Dict[str, Any]) -> None:
                fr = ref()
                if fr is None:  # recorder died: self-remove, free the slot
                    fault_injection.remove_listener(cb)
                    with _arm_lock:
                        slot = _fault_armed_dirs.get(key)
                        if slot is not None and slot() is None:
                            del _fault_armed_dirs[key]
                    return
                fr.record(f"fault_{name}", ctx)

            self._fault_cb = cb
        fault_injection.add_listener(self._fault_cb)

    def disarm(self) -> None:
        from ..utils import fault_injection

        if self._fault_cb is not None:
            fault_injection.remove_listener(self._fault_cb)
        with _arm_lock:
            key = os.path.abspath(self.out_dir)
            slot = _fault_armed_dirs.get(key)
            if slot is not None and slot() in (None, self):
                del _fault_armed_dirs[key]
