"""Deterministic fault injection for the fault-tolerance layer.

Counterpart of ``deepspeed_tpu/utils/fault_injection.py``: the same
``DS_FAULT`` grammar and the same seeded probabilistic streams, so one
spec fires at the same probes in both packages. The ``maybe_*`` actions
take one more keyword, ``detail``: a dict that listeners receive with the
probe's context (the serving engine names the requests a firing hits) and
that plays no part in matching; :func:`fire` and :func:`stall_seconds`
split a stall's firing from its sleep, so the serving engine can fire a
stall and wait out its end against its step watchdog's deadline.

Faults are requested through the ``DS_FAULT`` environment variable so a
test or a chaos drill can arm them without touching the training or
serving script. Grammar — comma-separated specs, each
``name[:key=value]*``. The checkpoint save path's injection points
(``checkpoint/engine.py``)::

    DS_FAULT=crash_during_save:step=3        # die after the data commit of
                                             # the step-3 save, before its
                                             # manifest/latest are written
    DS_FAULT=corrupt_manifest                # scribble over the manifest
                                             # right after it is written
    DS_FAULT=truncate_latest                 # tear the `latest` tag file
    DS_FAULT=flaky_save:fails=2              # first 2 save attempts raise
                                             # OSError (exercises the
                                             # retry-with-backoff path)

The serving engine's (``inference/serving/engine.py``)::

    DS_FAULT=stall:tag=serving_step          # wedge before the step
    DS_FAULT=slow_step:seconds=1             # the step goes slow INSIDE
                                             # the watchdog-guarded region
    DS_FAULT=slow_chunk:seconds=1            # the same, on a step that
                                             # carries prefill work
    DS_FAULT=corrupt_logits:fails=1          # NaN one active slot's logits
                                             # (the output guard quarantines
                                             # that request, not the batch);
                                             # tag=serving_step for a decode
                                             # row, tag=serving_prefill for
                                             # a prefill chunk
    DS_FAULT=flaky_prefill:fails=2           # prefill raises; the request
                                             # fails, serving continues
    DS_FAULT=slow_step:p=0.2:seconds=0.1     # probabilistic variant: any
                                             # spec may carry p=<prob>

Recognized match keys: ``step`` / ``rank`` / ``tag`` (spec fires only when
the injection point reports a matching value), ``fails`` (bounded faults:
fire at most N times, then the point behaves normally), ``seconds`` (stall
duration; default forever), ``p`` (probabilistic faults: fire with
probability p per otherwise-matching probe, seeded by ``DS_FAULT_SEED`` so
chaos runs replay — injection points may also declare a named ``stream``,
and each stream draws from its own (seed, stream)-derived generator, so a
fuzz schedule replays per engine regardless of step interleaving),
``phase`` (``crash_during_save``: ``begin`` dies before any bytes are
written, default ``commit`` dies between the data commit and the manifest
write — the classic partial save).

Each injection point is a no-op unless a spec matches, so the harness
costs nothing in production.
"""

import os
import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

from .logging import logger

ENV_VAR = "DS_FAULT"

#: exit code used by injected crashes — distinguishable from real signals
CRASH_EXIT_CODE = 87

@dataclass
class FaultSpec:
    name: str
    params: Dict[str, str] = field(default_factory=dict)
    fired: int = 0  # process-local trigger count (drives ``fails=N``)

    def matches(self, *, step: Optional[int] = None, rank: Optional[int] = None,
                tag: Optional[str] = None,
                phase: Optional[str] = None,
                stream: Optional[str] = None) -> bool:
        if "step" in self.params and (step is None
                                      or int(self.params["step"]) != int(step)):
            return False
        if "rank" in self.params and (rank is None
                                      or int(self.params["rank"]) != int(rank)):
            return False
        if "tag" in self.params and self.params["tag"] != tag:
            return False
        # phase-aware points (crash_during_save: begin|commit) declare their
        # phase; a spec fires only at its chosen phase (default "commit")
        if phase is not None and self.params.get("phase", "commit") != phase:
            return False
        fails = self.params.get("fails")
        if fails is not None and self.fired >= int(fails):
            return False
        p = self.params.get("p")
        if p is not None and _prob_rng(stream).random() >= float(p):
            return False
        return True


def parse_faults(text: str) -> List[FaultSpec]:
    """Parse the ``DS_FAULT`` grammar; malformed entries raise ValueError
    (silently dropping a chaos-drill spec would void the drill)."""
    specs: List[FaultSpec] = []
    for chunk in (text or "").split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        name, params = parts[0].strip(), {}
        if not name:
            raise ValueError(f"DS_FAULT: empty fault name in {chunk!r}")
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(f"DS_FAULT: expected key=value, got {kv!r}")
            k, v = kv.split("=", 1)
            params[k.strip()] = v.strip()
        specs.append(FaultSpec(name, params))
    return specs


# Parsed specs are cached per env-var VALUE so bounded faults (``fails=N``)
# keep their trigger counts across calls, while tests that monkeypatch
# DS_FAULT get a fresh parse.
_cache: Tuple[Optional[str], List[FaultSpec]] = (None, [])

# Probabilistic faults (p=<prob>) draw from seeded streams so a chaos
# drill replays exactly under the same DS_FAULT_SEED; reset() reseeds.
# Streams are PER-NAME: an injection point that declares a stream (the
# fleet wires each replica's engine to its own — ``replica:r0``,
# ``replica:r1``, ...) draws from a generator derived from (seed, stream),
# so one replica's probe cadence can never perturb another's firing
# sequence — a fuzz schedule replays per-replica regardless of how the
# router interleaves their steps. Points that declare no stream share
# the process-global stream (seed alone), the pre-fleet behavior.
_prob_streams: Dict[Optional[str], random.Random] = {}


def _prob_rng(stream: Optional[str] = None) -> random.Random:
    rng = _prob_streams.get(stream)
    if rng is None:
        seed = int(os.environ.get("DS_FAULT_SEED", "0"))
        # derive per-stream: a string seed folds the stream name into
        # the generator state deterministically (random.Random hashes
        # str seeds via SHA-512, stable across processes)
        rng = random.Random(seed if stream is None
                            else f"{seed}/{stream}")
        _prob_streams[stream] = rng
    return rng


def _specs() -> List[FaultSpec]:
    global _cache
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return []
    if _cache[0] != raw:
        _cache = (raw, parse_faults(raw))
    return _cache[1]


def get_fault(name: str, *, step: Optional[int] = None,
              rank: Optional[int] = None, tag: Optional[str] = None,
              phase: Optional[str] = None,
              stream: Optional[str] = None) -> Optional[FaultSpec]:
    for spec in _specs():
        if spec.name == name and spec.matches(step=step, rank=rank, tag=tag,
                                              phase=phase, stream=stream):
            return spec
    return None


def reset() -> None:
    """Forget trigger counts and reseed every probabilistic stream (test
    isolation / episode replay). Listeners survive a reset on purpose: a
    flight recorder armed for the whole chaos drill must keep observing
    across the per-test DS_FAULT re-arms."""
    global _cache
    _cache = (None, [])
    _prob_streams.clear()


# ---------------------------------------------------------------------------
# Fault-firing listeners (observability hook)
# ---------------------------------------------------------------------------

#: callbacks invoked as ``cb(name, ctx)`` every time a fault FIRES (after
#: the spec matched and consumed its trigger count, before the damage).
#: The flight recorder subscribes here so every injected incident leaves a
#: post-mortem dump — including ``maybe_crash``, which notifies before
#: ``os._exit``.
_listeners: List[Callable[[str, Dict[str, Any]], None]] = []


def add_listener(cb: Callable[[str, Dict[str, Any]], None]) -> None:
    if cb not in _listeners:
        _listeners.append(cb)


def remove_listener(cb: Callable[[str, Dict[str, Any]], None]) -> None:
    try:
        _listeners.remove(cb)
    except ValueError:
        pass


def _notify(name: str, ctx: Dict[str, Any]) -> None:
    for cb in list(_listeners):
        try:
            cb(name, ctx)
        except Exception as e:  # an observer must never alter the drill
            logger.warning(f"DS_FAULT listener {cb!r} failed: "
                           f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# Injection actions
# ---------------------------------------------------------------------------


def fire(name: str, ctx: Dict[str, Any],
         detail: Optional[Dict[str, Any]] = None) -> Optional[FaultSpec]:
    """The matching spec with its trigger count consumed and the listeners
    told (``ctx`` matches; ``detail`` only rides the notification), or
    None. The ``maybe_*`` actions fire and then do their damage; a caller
    that does the damage itself (the serving engine waits out a stall
    against its watchdog's deadline) fires here."""
    spec = get_fault(name, **ctx)
    if spec is None:
        return None
    spec.fired += 1
    _notify(name, {**ctx, **(detail or {})})
    return spec


def maybe_crash(name: str, detail: Optional[Dict[str, Any]] = None,
                **ctx: Any) -> None:
    """Hard process death (no atexit, no flush) — models SIGKILL/OOM. The
    listeners hear of it before the process dies: that is the post-mortem
    the flight recorder exists for."""
    spec = fire(name, ctx, detail)
    if spec is None:
        return
    logger.error(f"DS_FAULT: injected crash at {name} ({ctx})")
    import sys

    sys.stderr.flush()
    os._exit(CRASH_EXIT_CODE)


def stall_seconds(name: str, spec: FaultSpec, ctx: Dict[str, Any]) -> float:
    """How long a fired stall sleeps: ``seconds`` (default forever)."""
    seconds = float(spec.params.get("seconds", 10 * 365 * 24 * 3600))
    logger.error(f"DS_FAULT: injected stall at {name} ({ctx}); "
                 f"sleeping {seconds:g}s")
    return seconds


def stall(name: str, spec: FaultSpec, ctx: Dict[str, Any]) -> None:
    """The damage of a fired stall: sleep :func:`stall_seconds`."""
    deadline = time.time() + stall_seconds(name, spec, ctx)
    while time.time() < deadline:
        time.sleep(min(1.0, max(0.0, deadline - time.time())))


def maybe_stall(name: str, detail: Optional[Dict[str, Any]] = None,
                **ctx: Any) -> None:
    """Wedge this thread (models a step stuck on the device)."""
    spec = fire(name, ctx, detail)
    if spec is not None:
        stall(name, spec, ctx)


def maybe_flag(name: str, detail: Optional[Dict[str, Any]] = None,
               **ctx: Any) -> Optional[FaultSpec]:
    """Arm a fault the CALLER realizes (e.g. the serving engine flagging
    one slot's logits as poisoned for ``corrupt_logits``): returns the matching spec with
    its trigger count consumed, or None. The caller owns the actual damage;
    this just decides whether the drill fires here."""
    spec = fire(name, ctx, detail)
    if spec is not None:
        logger.error(f"DS_FAULT: armed {name} at {ctx}")
    return spec


def maybe_fail(name: str, exc: Type[Exception] = OSError,
               detail: Optional[Dict[str, Any]] = None, **ctx: Any) -> None:
    """Raise an error — models a transient failure of one request's work."""
    spec = fire(name, ctx, detail)
    if spec is None:
        return
    raise exc(f"DS_FAULT: injected failure at {name} "
              f"(attempt {spec.fired}, {ctx})")


def _fire_on_file(name: str, path: str, detail: Optional[Dict[str, Any]],
                  ctx: Dict[str, Any]) -> bool:
    """Fire ``name`` at a probe over ``path``: the spec is matched first
    (a ``p=`` draw happens whether or not the file exists, as in the JAX
    package), and fires only over an existing file."""
    spec = get_fault(name, **ctx)
    if spec is None or not os.path.exists(path):
        return False
    spec.fired += 1
    _notify(name, {**ctx, "path": path, **(detail or {})})
    return True


def maybe_corrupt_file(name: str, path: str,
                       detail: Optional[Dict[str, Any]] = None,
                       **ctx: Any) -> None:
    """Overwrite the head of ``path`` with garbage (bit-rot / torn write)."""
    if not _fire_on_file(name, path, detail, ctx):
        return
    logger.error(f"DS_FAULT: corrupting {path} ({name})")
    with open(path, "r+b") as f:
        f.write(b"\x00CORRUPT\x00")


def maybe_truncate_file(name: str, path: str,
                        detail: Optional[Dict[str, Any]] = None,
                        **ctx: Any) -> None:
    """Cut ``path`` to half its size (torn non-atomic write)."""
    if not _fire_on_file(name, path, detail, ctx):
        return
    size = os.path.getsize(path)
    logger.error(f"DS_FAULT: truncating {path} to {size // 2} bytes ({name})")
    with open(path, "r+b") as f:
        f.truncate(size // 2)


# ---------------------------------------------------------------------------
# Bounded retry (checkpoint I/O)
# ---------------------------------------------------------------------------


def retry_with_backoff(fn: Callable[[], Any], *, retries: int = 3,
                       base_delay: float = 0.5, max_delay: float = 30.0,
                       what: str = "operation",
                       exceptions: Sequence[Type[Exception]] = (OSError,)
                       ) -> Any:
    """Run ``fn`` with up to ``retries`` retries on transient errors,
    exponential backoff between attempts. The last failure propagates —
    bounded, never an infinite loop."""
    attempt = 0
    while True:
        try:
            return fn()
        except tuple(exceptions) as e:
            if attempt >= retries:
                raise
            delay = min(max_delay, base_delay * (2 ** attempt))
            attempt += 1
            logger.warning(f"{what} failed ({type(e).__name__}: {e}); "
                           f"retry {attempt}/{retries} in {delay:.1f}s")
            time.sleep(delay)
