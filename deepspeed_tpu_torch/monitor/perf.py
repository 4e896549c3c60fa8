"""Performance accounting: program registry, recompile sentinel, hand
FLOPs/bytes estimates, MFU/MBU, device memory watermarks, and the
artifact meta stamp.

Counterpart of ``deepspeed_tpu/monitor/perf.py`` for PyTorch on a CUDA
card. What differs:

- **What counts as a compile.** PyTorch runs eagerly, and a serving or
  training program is one CUDA graph per shape: its first run at a shape
  runs eagerly and is then captured. So :meth:`ProgramRegistry.observe_call`
  counts the first call at a fingerprint as a compile, and a later call
  whose fingerprint differs (a new width, batch shape or dtype) trips the
  sentinel, naming the argument, and counts one more. On the CPU the same
  bookkeeping runs without capture.
- **Costs are hand estimates.** There is no compiler cost model to ask,
  and ``FlopCounterMode`` cannot see the kernels launched through ctypes,
  so :meth:`PerfAccounting.capture_cost` records the caller's estimate with
  ``cost_source = "estimate"``.
- **Peaks are the card's.** :data:`DEVICE_PEAKS` is keyed by
  ``torch.cuda.get_device_name``; an unknown name (the CPU) gives
  ``(None, None)`` and the utilization gauges are then omitted, never
  faked. Watermarks are the caching allocator's tensor bytes
  (``torch.cuda.memory_stats``) and are None on the CPU.

A ``ProgramRegistry`` is cheap enough for hot paths: one dict-equality
check per dispatch (the fingerprints are small flat dicts of strings).
"""

import dataclasses
import functools
import hashlib
import os
import socket
import subprocess
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..utils.logging import logger

# ---------------------------------------------------------------------------
# device capability table (per card)
# ---------------------------------------------------------------------------

#: peak dense bf16 FLOP/s and peak HBM bytes/s per card, keyed by a
#: substring of ``torch.cuda.get_device_name``; the longest key wins.
#: NVIDIA H100 datasheet, SXM5 part ("H100 80GB HBM3" is the name it
#: reports): 989.4 TFLOP/s bf16 dense (1,979 with sparsity), 3.35 TB/s
#: HBM3, at its 700 W limit.
DEVICE_PEAKS: Dict[str, Tuple[float, float]] = {
    "H100 80GB HBM3": (989.4e12, 3.35e12),
}


def device_peaks(device_kind: Optional[str]
                 ) -> Tuple[Optional[float], Optional[float]]:
    """(peak_flops_per_s, peak_hbm_bytes_per_s) per card for a device
    name; (None, None) when unknown (the CPU, other hardware) —
    utilization gauges are then omitted rather than wrong."""
    if not device_kind:
        return (None, None)
    best = None
    for key, peaks in DEVICE_PEAKS.items():
        if key in device_kind and (best is None or len(key) > len(best[0])):
            best = (key, peaks)
    return best[1] if best else (None, None)


# ---------------------------------------------------------------------------
# argument fingerprints
# ---------------------------------------------------------------------------

def _is_array(x: Any) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype")


@functools.lru_cache(maxsize=4096)
def _array_spec(dtype, shape: Tuple[int, ...]) -> str:
    """``dtype[shape]``, memoized: a serving step fingerprints its arrays
    on every dispatch, always at the same few shapes."""
    name = str(dtype).replace("torch.", "")
    return f"{name}[{','.join(str(d) for d in shape)}]"


def _leaf_spec(x: Any) -> str:
    if _is_array(x):
        return _array_spec(x.dtype, x.shape)
    return repr(x)


def _leaves(x: Any) -> List[Any]:
    """Leaves of a nested dict / list / tuple / dataclass, dict keys in
    sorted order (the JAX package's pytree order)."""
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [leaf for f in dataclasses.fields(x)
                for leaf in _leaves(getattr(x, f.name))]
    return [x]


def spec(x: Any) -> str:
    """One argument's fingerprint component: ``dtype[shape]`` for arrays
    and tensors, a leaf-spec summary for nested containers (a module: its
    ``state_dict``), ``repr`` for statics — the properties a captured
    graph is keyed on."""
    if _is_array(x):
        return _array_spec(x.dtype, x.shape)
    if isinstance(x, torch.nn.Module):
        x = dict(x.state_dict())
    if isinstance(x, (list, tuple, dict)) or dataclasses.is_dataclass(x):
        leaves = _leaves(x)
        if leaves and any(_is_array(leaf) for leaf in leaves):
            specs = [_leaf_spec(leaf) for leaf in leaves]
            # collapse runs of identical leaves ("float32[64,64] x48") so
            # big trees fingerprint compactly AND compare fast
            out: List[str] = []
            run = 1
            for i in range(1, len(specs) + 1):
                if i < len(specs) and specs[i] == specs[i - 1]:
                    run += 1
                    continue
                out.append(specs[i - 1] if run == 1
                           else f"{specs[i - 1]} x{run}")
                run = 1
            return f"pytree[{len(specs)}: " + "; ".join(out) + "]"
    return repr(x)


def fingerprint(**args: Any) -> Dict[str, str]:
    """Named-argument fingerprint of one program call."""
    return {name: spec(v) for name, v in args.items()}


def fingerprint_diff(old: Dict[str, str], new: Dict[str, str]
                     ) -> Dict[str, Tuple[Optional[str], Optional[str]]]:
    """{arg: (before, after)} for every argument that changed (None =
    argument added/removed)."""
    out: Dict[str, Tuple[Optional[str], Optional[str]]] = {}
    for k in {**old, **new}:
        if old.get(k) != new.get(k):
            out[k] = (old.get(k), new.get(k))
    return out


# ---------------------------------------------------------------------------
# program registry + recompile sentinel
# ---------------------------------------------------------------------------

class CompiledProgram:
    """One resident program's accounting record."""

    __slots__ = ("name", "fingerprint", "compiles", "calls", "recompiles",
                 "flops", "bytes_accessed", "cost_source", "cost_attempted")

    def __init__(self, name: str):
        self.name = name
        self.fingerprint: Optional[Dict[str, str]] = None
        self.compiles = 0      # first calls at a fingerprint
        self.calls = 0         # dispatches observed
        self.recompiles = 0    # sentinel alarms: fingerprint changed
        self.flops: Optional[float] = None           # per call
        self.bytes_accessed: Optional[float] = None  # per call
        self.cost_source: Optional[str] = None  # "estimate"
        #: capture tried (even unsuccessfully): the estimate runs once,
        #: not on every hot-path dispatch
        self.cost_attempted = False

    @property
    def fingerprint_hash(self) -> Optional[str]:
        if self.fingerprint is None:
            return None
        blob = ";".join(f"{k}={v}" for k, v in
                        sorted(self.fingerprint.items()))
        return hashlib.sha1(blob.encode()).hexdigest()[:10]

    def row(self) -> Dict[str, Any]:
        return {"name": self.name, "fingerprint": self.fingerprint_hash,
                "compiles": self.compiles, "recompiles": self.recompiles,
                "calls": self.calls, "flops": self.flops,
                "bytes_accessed": self.bytes_accessed,
                "cost_source": self.cost_source}


#: every live ProgramRegistry in the process, for
#: :func:`live_program_table` (weak: it must never pin a dropped engine)
_live_lock = threading.Lock()
_live_registries: "weakref.WeakSet[ProgramRegistry]" = weakref.WeakSet()  # guarded by _live_lock


class ProgramRegistry:
    """Get-or-create registry of :class:`CompiledProgram` records with the
    recompile sentinel on :meth:`observe_call`."""

    def __init__(self, tracer=None, metrics=None, scope: str = ""):
        self.scope = scope
        self.tracer = tracer
        self.metrics = metrics  # MetricsRegistry for the alarm counters
        self._lock = threading.Lock()
        self.programs: Dict[str, CompiledProgram] = {}  # guarded by _lock
        with _live_lock:
            _live_registries.add(self)

    def program(self, name: str) -> CompiledProgram:
        with self._lock:
            prog = self.programs.get(name)
            if prog is None:
                prog = self.programs[name] = CompiledProgram(name)
        return prog

    def observe_call(self, name: str, fp: Dict[str, str]
                     ) -> Optional[Dict[str, Tuple[Optional[str],
                                                   Optional[str]]]]:
        """Record one dispatch. The first call registers the fingerprint
        and counts a compile; a later call with a DIFFERENT fingerprint
        runs eagerly (and is captured) anew — the sentinel fires (tracer
        event + metrics counter + warning log) naming every argument whose
        spec changed, counts one more compile, unlatches the cost estimate
        (it was the old shape's), and returns the diff (None = fingerprint
        stable)."""
        prog = self.program(name)
        prog.calls += 1
        if prog.fingerprint is None:
            prog.fingerprint = fp
            prog.compiles += 1
            return None
        if fp == prog.fingerprint:
            return None
        diff = fingerprint_diff(prog.fingerprint, fp)
        prog.fingerprint = fp
        prog.recompiles += 1
        prog.compiles += 1
        # a cost belongs to a shape: the next capture_cost estimates anew
        prog.cost_attempted = False
        offenders = sorted(diff)
        if self.metrics is not None:
            self.metrics.counter("recompiles", program=name).inc()
        if self.tracer is not None and getattr(self.tracer, "enabled", False):
            self.tracer.instant(
                "recompile", cat="perf",
                args={"program": name, "args": offenders,
                      "changed": {k: [diff[k][0], diff[k][1]]
                                  for k in offenders}})
        changes = "; ".join(f"{k}: {diff[k][0]} -> {diff[k][1]}"
                            for k in offenders)
        logger.warning(
            f"perf sentinel: program {self.scope + '/' if self.scope else ''}"
            f"{name} RECOMPILED (call {prog.calls}) — argument(s) changed: "
            f"{changes}. Resident programs are supposed to see one shape "
            f"forever; this call runs eagerly and captures anew.")
        return diff

    def set_cost(self, name: str, flops: Optional[float],
                 bytes_accessed: Optional[float], source: str) -> None:
        prog = self.program(name)
        prog.flops = flops
        prog.bytes_accessed = bytes_accessed
        prog.cost_source = source

    @property
    def recompile_total(self) -> int:
        with self._lock:
            progs = list(self.programs.values())
        return sum(p.recompiles for p in progs)

    def table(self) -> List[Dict[str, Any]]:
        with self._lock:
            items = list(self.programs.items())
        rows = []
        for name, prog in sorted(items):
            row = prog.row()
            if self.scope:
                row["name"] = f"{self.scope}/{name}"
            rows.append(row)
        return rows


def live_program_table() -> List[Dict[str, Any]]:
    """The resident program table across every live registry in this
    process."""
    with _live_lock:
        regs = list(_live_registries)
    rows: List[Dict[str, Any]] = []
    for reg in regs:
        rows.extend(reg.table())
    return sorted(rows, key=lambda r: r["name"])


# ---------------------------------------------------------------------------
# hand-rolled transformer estimates
# ---------------------------------------------------------------------------

def transformer_flops_per_token(cfg, context_len: int) -> float:
    """Dense-transformer FLOPs for ONE token against a
    ``context_len``-wide KV context. Counts matmuls at 2·M·N·K: qkv/o
    projections, the (gate/up/down when ``intermediate_size`` is set,
    else 2-matmul) MLP, QKᵀ + AV attention over ``context_len`` keys, and
    the LM head. Embedding gathers are free."""
    L = int(getattr(cfg, "num_hidden_layers", getattr(cfg, "n_layer", 0)))
    h = int(getattr(cfg, "hidden_size", getattr(cfg, "n_embd", 0)))
    H = int(getattr(cfg, "num_attention_heads", getattr(cfg, "n_head", 1)))
    Hkv = int(getattr(cfg, "num_key_value_heads", H) or H)
    D = int(getattr(cfg, "head_dim", max(1, h // max(1, H))))
    V = int(getattr(cfg, "vocab_size", 0))
    inter = getattr(cfg, "intermediate_size", None)
    if inter:  # llama-family: gate + up + down
        mlp = 2 * h * int(inter) * 3
    else:      # gpt2-family: fc(4h) + proj
        mlp = 2 * h * (4 * h) * 2
    qkv = 2 * h * (H * D + 2 * Hkv * D)
    o = 2 * (H * D) * h
    attn = 2 * 2 * H * D * int(context_len)
    return float(L * (qkv + o + mlp + attn) + 2 * h * V)


def estimate_decode_step_flops(cfg, batch: int, context_len: int) -> float:
    """FLOPs of one decode step: every one of its ``batch`` slots (padding
    included — that IS the hardware work) against a ``context_len``-deep
    context."""
    return batch * transformer_flops_per_token(cfg, context_len)


def param_bytes(params) -> int:
    """Bytes of a state dict (or a module's), every tensor counted."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    return sum(int(t.numel() * t.element_size()) for t in params.values())


def estimate_decode_step_bytes(cfg, batch: int, context_len: int,
                               params_nbytes: int,
                               kv_bytes_per_elem: int = 2) -> float:
    """Bytes of one decode step: weights streamed once plus the KV context
    read per slot — decode's two bandwidth sinks."""
    L = int(getattr(cfg, "num_hidden_layers", getattr(cfg, "n_layer", 0)))
    H = int(getattr(cfg, "num_attention_heads", getattr(cfg, "n_head", 1)))
    Hkv = int(getattr(cfg, "num_key_value_heads", H) or H)
    h = int(getattr(cfg, "hidden_size", getattr(cfg, "n_embd", 0)))
    D = int(getattr(cfg, "head_dim", max(1, h // max(1, H))))
    kv = batch * L * 2 * Hkv * D * int(context_len) * kv_bytes_per_elem
    return float(params_nbytes + kv)


def train_step_flops(n_params: int, batch: int, seq: int, n_layer: int,
                     hidden: int) -> float:
    """FLOPs of one training step, forward and backward: 6·N per token
    plus causal-free attention, 12·L·B·T²·h (PaLM, appendix B; the JAX
    package's bench formula)."""
    return 6.0 * n_params * batch * seq + 12.0 * n_layer * batch * seq \
        * seq * hidden


# ---------------------------------------------------------------------------
# device memory watermarks
# ---------------------------------------------------------------------------

def allocated_bytes(device) -> Tuple[int, int]:
    """(current, peak) bytes the caching allocator holds for tensors on a
    CUDA device: ``memory_stats``' ``allocated_bytes.all.current`` /
    ``.peak``, read from the nested dict (flattening it costs ~100 µs, a
    serving step's bookkeeping reads this every step)."""
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    alloc = stats.get("allocated_bytes", {}).get("all", {})
    return int(alloc.get("current", 0)), int(alloc.get("peak", 0))


def device_memory_stats() -> List[Dict[str, Any]]:
    """Live/peak tensor bytes on each CUDA device, ``[]`` without CUDA —
    watermark consumers degrade to absent fields, never fake zeros."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        live, peak = allocated_bytes(i)
        out.append({"device": str(i),
                    "kind": torch.cuda.get_device_name(i),
                    "bytes_in_use": live, "peak_bytes_in_use": peak})
    return out


def hbm_watermarks() -> Tuple[Optional[int], Optional[int]]:
    """(bytes_in_use, peak_bytes_in_use) summed over the CUDA devices;
    (None, None) without CUDA."""
    stats = device_memory_stats()
    if not stats:
        return (None, None)
    return (sum(s["bytes_in_use"] for s in stats),
            sum(s["peak_bytes_in_use"] for s in stats))


# ---------------------------------------------------------------------------
# artifact meta stamp
# ---------------------------------------------------------------------------

def git_sha(repo_root: Optional[str] = None) -> Optional[str]:
    root = repo_root or os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=root, capture_output=True, text=True,
                             timeout=10)
        sha = out.stdout.strip()
        return sha or None
    except (OSError, subprocess.SubprocessError):
        return None


def perf_meta() -> Dict[str, Any]:
    """The provenance block of a measurement: the code, the torch and
    CUDA versions and the card behind a number."""
    cuda = torch.cuda.is_available()
    return {
        "schema": 1,
        "git_sha": git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "host": socket.gethostname(),
        "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "device_count": torch.cuda.device_count() if cuda else 0,
    }


# ---------------------------------------------------------------------------
# PerfAccounting: the engine-side bundle
# ---------------------------------------------------------------------------

def _device_kind(device) -> Optional[str]:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class PerfAccounting:
    """Everything one engine needs, bundled: a scoped
    :class:`ProgramRegistry`, the card's peak table, per-program
    utilization math, cached fingerprints for stable-identity args
    (params), and watermark sampling. ``device_kind`` defaults to the name
    of ``device``."""

    def __init__(self, tracer=None, metrics=None, scope: str = "",
                 n_devices: int = 1, device_kind: Optional[str] = None,
                 device="cpu"):
        self.device = torch.device(device)
        if device_kind is None:
            device_kind = _device_kind(self.device)
        self.device_kind = device_kind
        self.n_devices = max(1, int(n_devices))
        self.peak_flops, self.peak_hbm_bw = device_peaks(device_kind)
        self.programs = ProgramRegistry(tracer=tracer, metrics=metrics,
                                        scope=scope)
        self._spec_memo: Dict[str, Tuple[int, str]] = {}
        #: per-step utilization entries keyed by program name
        self.last: Dict[str, Dict[str, Optional[float]]] = {}

    # -- fingerprints ---------------------------------------------------

    def cached_spec(self, key: str, tree: Any) -> str:
        """Spec memoized on object identity — the params keep one object
        across a run, so the per-call cost is one ``id()`` compare instead
        of a walk over every tensor."""
        memo = self._spec_memo.get(key)
        if memo is not None and memo[0] == id(tree):
            return memo[1]
        s = spec(tree)
        self._spec_memo[key] = (id(tree), s)
        return s

    def observe_call(self, name: str, **args: Any):
        return self.programs.observe_call(name, fingerprint(**args))

    # -- cost capture ---------------------------------------------------

    def capture_cost(self, name: str,
                     estimate: Callable[[], Optional[Dict[str, float]]]
                     ) -> None:
        """Record a program's per-call FLOPs / bytes, once, from the hand
        ``estimate`` (``{"flops"[, "bytes_accessed"]}`` or None). Never
        raises — accounting must not take down the engine it measures; a
        failed estimate is latched too (``cost_attempted``)."""
        prog = self.programs.program(name)
        if prog.cost_attempted:
            return
        prog.cost_attempted = True
        try:
            cost = estimate()
        except Exception as e:  # accounting never takes the engine down
            logger.debug(f"perf: flops estimate for {name} failed: {e}")
            cost = None
        if cost is None:
            return
        self.programs.set_cost(name, cost.get("flops"),
                               cost.get("bytes_accessed"), "estimate")

    # -- utilization ----------------------------------------------------

    def on_program_step(self, name: str, dt_s: float,
                        tokens: Optional[int] = None
                        ) -> Dict[str, Optional[float]]:
        """Fold one timed dispatch of ``name`` into utilization gauges:
        MFU = flops / (dt · peak_flops · cards), MBU = bytes / (dt ·
        peak_bw · cards); both None until the cost is captured or where
        the peak is unknown (the CPU). ``tokens`` adds tokens/s/card."""
        prog = self.programs.programs.get(name)
        vals: Dict[str, Optional[float]] = {
            "flops_per_step": prog.flops if prog else None,
            "bytes_per_step": prog.bytes_accessed if prog else None,
            "mfu": None, "mbu": None, "flops_per_sec": None,
            "tokens_per_sec_per_chip": None,
        }
        if dt_s > 0 and prog is not None:
            if prog.flops:
                vals["flops_per_sec"] = prog.flops / dt_s
                if self.peak_flops:
                    vals["mfu"] = prog.flops / (
                        dt_s * self.peak_flops * self.n_devices)
            if prog.bytes_accessed and self.peak_hbm_bw:
                vals["mbu"] = prog.bytes_accessed / (
                    dt_s * self.peak_hbm_bw * self.n_devices)
            if tokens is not None:
                vals["tokens_per_sec_per_chip"] = tokens / (
                    dt_s * self.n_devices)
        self.last[name] = vals
        return vals

    # -- watermarks -----------------------------------------------------

    def memory_watermarks(self) -> Tuple[Optional[int], Optional[int]]:
        """(live, peak) tensor bytes on the engine's device; (None, None)
        on the CPU."""
        if self.device.type != "cuda":
            return (None, None)
        return allocated_bytes(self.device)

    # -- reporting ------------------------------------------------------

    @property
    def recompile_total(self) -> int:
        return self.programs.recompile_total

    def summary(self) -> Dict[str, Any]:
        """One JSON-able block for reports and measurement artifacts."""
        live, peak = self.memory_watermarks()
        return {
            "device_kind": self.device_kind,
            "n_devices": self.n_devices,
            "peak_flops_per_chip": self.peak_flops,
            "peak_hbm_bytes_per_s_per_chip": self.peak_hbm_bw,
            "hbm_bytes_in_use": live,
            "hbm_peak_bytes": peak,
            "programs": self.programs.table(),
            "utilization": {k: dict(v) for k, v in list(self.last.items())},
        }
