"""The training engine.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``
and ``initialize``) for one device without sharding. One JSON config sets
precision, optimizer, schedule, gradient accumulation, clipping and loss
scaling. The engine keeps fp32 master weights; each micro-step binds them
to the model cast to the compute dtype (an explicit cast, not autocast, so
the math matches the JAX step, which casts every floating param inside
the step), so autograd returns fp32 gradients into the masters.

As the JAX ``TrainState``, every piece of mutable state lives on the
device and a step reads nothing back: the masters, their gradient buffers
(allocated once, zeroed in place each step), the optimizer's moments and
step count (``optimizer.count``, which is also the engine's step count:
both move together in JAX), the fp16 loss-scale automaton and the count
of skipped steps. A step (``train_batch``): for each of the ``gas``
microbatches, the loss times the device loss scale goes backward and the
gradients add up in the buffers; the sum is divided by ``gas`` and by the
scale; the global norm is taken; an fp16 overflow (a non-finite norm, a
device bool) moves the scale automaton and makes the optimizer (kernel
K3) keep every tensor as it was; otherwise clipping (``g * clip / norm``
when the norm exceeds ``clip``) and K3 update the masters in place. The
host reads the loss, the norm, the scale, the lr or the skip count only
when asked (``float(loss)``, ``get_global_grad_norm``, ``loss_scale``,
``get_lr``, ``get_skipped_steps``, the ``steps_per_print`` log).

On a CUDA device the step runs as a CUDA graph, the counterpart of the
JAX step's ``jax.jit``: one graph per batch shape and dtype set, all in
one memory pool. A shape's first step runs eagerly on a side stream (the
warm-up) and is then captured; later steps copy the batch into the
graph's input buffers and replay it. ``cuda_graph=False`` (a port-only
keyword of ``initialize``, beside ``device``) runs the same step
uncaptured; on the CPU nothing is captured. A capture that fails raises.

The micro-step API (``engine(batch)``, ``backward``, ``step``) queues
microbatches and runs ``train_batch`` at the accumulation boundary, as the
JAX engine does.

Accounting, as in the JAX engine: ``registry`` holds the ``train_batch_s``
histogram (the wall time of each ``train_batch`` call) and the
``train_mfu`` / ``train_tflops_per_chip`` gauges, and ``perf`` registers
the ``train_step`` program (fingerprint of the state and the batch: a new
batch shape is a new capture and trips the recompile sentinel) with the
estimate 6·N·tokens + attention. The gauges divide it by the step's time:
on a CUDA device the time between the CUDA events that mark the ends of
the previous step and of this one (the host does not wait for a step, so
the call's wall time would measure the enqueue; the interval holds the
step's device work and any idle the host left before it, what a run of
steps takes each), read once the step has ended — at the next step, or
waiting for it in :meth:`DeepSpeedEngine.perf_summary`; on the CPU the
call's wall time. A shape's first step (it carries the capture) is left
out. The MFU gauge is set only where the card's peak is known.
"""

import re
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..inference.engine import resolve_device
from ..monitor.perf import PerfAccounting, spec, train_step_flops
from ..monitor.registry import MetricsRegistry
from ..ops.optimizers import FusedAdam, get_optimizer
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from .config import DeepSpeedConfig
from .config_utils import unported
from .fp16.loss_scaler import create_loss_scaler, update_scale
from .lr_schedules import get_lr_schedule

#: the layer index in a state_dict name (``model.layers.3.mlp...``)
_LAYER_INDEX = re.compile(r"(^|\.)layers\.\d+\.")

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
           "fp32": torch.float32}


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _bind(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Put ``tensors`` in place of the module's parameters, by
    ``state_dict`` name. They stay bound until the next bind, so a
    rematerialized block recomputes its forward in the backward on the
    same tensors."""
    for name, t in tensors.items():
        owner, _, attr = name.rpartition(".")
        module.get_submodule(owner)._parameters[attr] = t


class DeepSpeedEngine:
    """See the module docstring. Construct through :func:`initialize`."""

    def __init__(self, model: nn.Module, config=None,
                 model_parameters: Optional[Dict[str, Any]] = None,
                 lr_scheduler=None, device=None, cuda_graph: bool = True):
        self.device = resolve_device(device)
        if not isinstance(model, nn.Module) or \
                not hasattr(model, "init_params"):
            raise NotImplementedError(
                "initialize takes a port model (deepspeed_tpu_torch.models); "
                "wrapping other torch modules arrives with the training "
                "engine's remaining parts (ROADMAP.md Queue 1, item 7)")
        self.module = model
        self.client_lr_scheduler = lr_scheduler
        self.global_steps = 0
        self.micro_steps = 0

        self._config = DeepSpeedConfig(config or {}, world_size=1)
        self.dp_world_size = 1
        self.train_batch_size = self._config.train_batch_size
        self.micro_batch_size = self._config.train_micro_batch_size_per_gpu
        self.gradient_accumulation_steps = \
            self._config.gradient_accumulation_steps
        self.compute_dtype = _DTYPES[self._config.precision]
        self.fp16_enabled = self._config.fp16.enabled
        self.bfloat16_enabled = self._config.bf16.enabled

        # ---- fp32 masters ------------------------------------------------
        params = model_parameters if model_parameters is not None else \
            model.init_params(seed=self._config.seed, device=self.device)
        want = set(model.state_dict().keys())
        if set(params) != want:
            raise ValueError(
                f"model_parameters must be the model's state_dict: missing "
                f"{sorted(want - set(params))}, unexpected "
                f"{sorted(set(params) - want)}")
        self.master: Dict[str, torch.Tensor] = {}
        for name, p in params.items():
            p = _as_tensor(p).detach()
            if p.is_floating_point():
                p = p.to(device=self.device, dtype=torch.float32,
                         copy=True).requires_grad_(True)
            else:
                p = p.to(self.device)
            self.master[name] = p
        self._trainable_names = [n for n, p in self.master.items()
                                 if p.requires_grad]
        self._trainable = [self.master[n] for n in self._trainable_names]
        # the gradient buffers: allocated once, zeroed in place each step,
        # so a captured step (and K3's table of pointers) sees the same
        # memory every time
        for p in self._trainable:
            p.grad = torch.zeros_like(p)
        self._grads = [p.grad for p in self._trainable]

        self.lr_scheduler = self._build_lr_scheduler()
        self.optimizer = self._build_optimizer()
        self._scaler = create_loss_scaler(self._config.fp16,
                                          device=self.device) \
            if self.fp16_enabled else None
        #: skipped (fp16 overflow) steps, a device int32 scalar
        self._skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self._graphed = bool(cuda_graph) and self.device.type == "cuda"
        #: captured steps by batch signature: (graph, inputs, outputs, K3's
        #: table, which the graph reads by address at each replay)
        self._graphs: Dict[tuple, Tuple[Any, Dict[str, torch.Tensor],
                                        Tuple[torch.Tensor, ...], Any]] = {}
        self._graph_pool = None

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size,
            steps_per_output=self._config.steps_per_print)
        self.wall_clock_breakdown = self._config.wall_clock_breakdown
        self.registry = MetricsRegistry()
        self._step_hist = self.registry.histogram("train_batch_s",
                                                  lo=1e-4, hi=4e3)
        self.perf = PerfAccounting(metrics=self.registry, scope="train",
                                   device=self.device)
        #: the masters' fingerprint, taken once: their shapes are fixed
        self._state_spec = spec(self.master)
        #: the CUDA event at the end of the last step, and the (previous
        #: end, end) pair of the last judged step until its time is read
        self._last_end = None
        self._step_events = None
        self._pending_microbatches = []
        self._last_loss = None
        self._last_grad_norm = None
        log_dist(f"DeepSpeedEngine initialized: device={self.device}, "
                 f"precision={self._config.precision}, batch="
                 f"{self.train_batch_size} (micro={self.micro_batch_size} x "
                 f"gas={self.gradient_accumulation_steps})", ranks=[0])

    # ------------------------------------------------------------------
    # construction helpers
    # ------------------------------------------------------------------

    def _build_lr_scheduler(self):
        if self.client_lr_scheduler is not None:
            return self.client_lr_scheduler
        sched = self._config.scheduler
        if sched is None or sched.type is None:
            return None
        return get_lr_schedule(sched.type, sched.params)

    def _build_optimizer(self):
        opt = self._config.optimizer
        if opt is None:
            return FusedAdam(self._trainable, self.lr_scheduler or 1e-3)
        return get_optimizer(opt.type, self._trainable, opt.params,
                             self.lr_scheduler,
                             groups=self._trust_ratio_groups())

    def _trust_ratio_groups(self):
        """LAMB's trust-ratio groups, as indices into the trainable list: a
        model whose config has ``scan_layers`` (the JAX default) groups
        ``layers.{i}.<name>`` over i, the tensors that make one ``[L, ...]``
        leaf of the JAX tree; otherwise each tensor is its own group, as in
        JAX with unscanned layers and DeepSpeed's per-tensor fused LAMB."""
        config = getattr(self.module, "config", None)
        scanned = bool(getattr(config, "scan_layers", False))
        groups: Dict[str, list] = {}
        for i, name in enumerate(self._trainable_names):
            key = _LAYER_INDEX.sub(r"\1layers.*.", name) if scanned else name
            groups.setdefault(key, []).append(i)
        return list(groups.values())

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------

    def _bind_params(self) -> None:
        """Bind the masters cast to the compute dtype (a differentiable
        cast when grad mode is on)."""
        dt = self.compute_dtype
        _bind(self.module, {n: p.to(dt) if p.is_floating_point() else p
                            for n, p in self.master.items()})

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        self._bind_params()
        out = self.module(**batch)
        if isinstance(out, tuple):
            out = out[0]
        if isinstance(out, dict):
            out = out["loss"]
        return out

    def _train_step(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX ``train_step`` on the device state; returns the mean
        loss and the global gradient norm as device scalars. Reads nothing
        back, so it runs inside a CUDA graph."""
        gas = self.gradient_accumulation_steps
        scale = self._scaler.cur_scale if self.fp16_enabled else None
        grads = self._grads
        torch._foreach_zero_(grads)
        total = None
        for i in range(gas):
            loss = self._loss({k: v[i] for k, v in batch.items()}).float()
            (loss if scale is None else loss * scale).backward()
            total = loss.detach() if total is None \
                else total + loss.detach()
        loss = total / gas
        if gas > 1:
            torch._foreach_div_(grads, float(gas))
        if scale is not None:
            torch._foreach_div_(grads, scale)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        overflow = None
        if self.fp16_enabled:
            overflow = ~torch.isfinite(norm)
            self._scaler.copy_(update_scale(self._scaler, overflow))
            self._skipped.add_(overflow.to(torch.int32))
        clip = self._config.gradient_clipping
        factor = None
        if clip and clip > 0:
            factor = torch.where(norm < clip, torch.ones_like(norm),
                                 clip / norm)
        self.optimizer.step(grads, grad_scale=factor, skip=overflow)
        return loss, norm

    def _graphed_step(self, batch: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_train_step` as a CUDA graph for the batch's signature:
        the first step of a signature runs eagerly on a side stream and is
        then captured; later steps copy the batch into the graph's inputs
        and replay. Returns copies of the graph's outputs (a replay
        overwrites them)."""
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        entry = self._graphs.get(key)
        if entry is not None:
            graph, inputs, outputs, _ = entry
            for k, v in batch.items():
                inputs[k].copy_(v)
            graph.replay()
            return tuple(t.clone() for t in outputs)
        inputs = {k: v.clone() for k, v in batch.items()}
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._train_step(inputs)
            # the casts bound to the module hold the warm-up's autograd
            # graph, whose gradient accumulators belong to this stream:
            # rebind without a graph, so the capture makes its own
            with torch.no_grad():
                self._bind_params()
        current.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            outputs = self._train_step(inputs)
        self._graphs[key] = (graph, inputs, outputs, self.optimizer.table)
        return out

    # ------------------------------------------------------------------
    # public training API
    # ------------------------------------------------------------------

    def _shape_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """``[train_batch, ...] -> [gas, micro, ...]`` on the device."""
        gas = self.gradient_accumulation_steps
        out = {}
        for k, x in batch.items():
            if k == "attention_mask":
                raise unported("a training attention_mask (padding bias)",
                               "the Llama training subset (item 5)")
            x = _as_tensor(x)
            if x.shape[0] == self.train_batch_size:
                x = x.reshape((gas, self.train_batch_size // gas)
                              + tuple(x.shape[1:]))
            elif x.shape[0] != gas:
                raise ValueError(
                    f"batch leading dim {x.shape[0]} != train_batch_size "
                    f"{self.train_batch_size} (or gas {gas})")
            out[k] = x.to(self.device, non_blocking=True)
        return out

    def train_batch(self, data_iter: Optional[Iterator] = None,
                    batch: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        """One optimizer step over ``gas`` microbatches. Pass a global batch
        (leading dim ``train_batch_size``) or an iterator of microbatches.
        Returns the mean loss as a device scalar (reading it waits for the
        step; a captured step returns a copy, never the graph's buffer)."""
        if batch is None:
            if data_iter is None:
                raise ValueError("train_batch needs a batch or a data "
                                 "iterator")
            micro = [next(data_iter)
                     for _ in range(self.gradient_accumulation_steps)]
            batch = {k: torch.cat([_as_tensor(m[k]) for m in micro])
                     for k in micro[0]}
        if self.wall_clock_breakdown:
            self.timers("train_batch").start()
        self.tput_timer.start()
        t_batch0 = time.perf_counter()
        batch = self._shape_batch(batch)
        self._read_step_events(wait=False)
        # a shape's first step runs eagerly (and is captured): judged no
        diff = self.perf.programs.observe_call(
            "train_step", {"state": self._state_spec, "batch": spec(batch)})
        warm = diff is None and \
            self.perf.programs.program("train_step").calls > 1
        self.perf.capture_cost("train_step",
                               lambda: self._train_flops_estimate(batch))
        loss, self._last_grad_norm = self._graphed_step(batch) \
            if self._graphed else self._train_step(batch)
        self.global_steps += 1
        self.micro_steps += self.gradient_accumulation_steps
        self.tput_timer.stop()
        if self.wall_clock_breakdown:
            self.timers("train_batch").stop()
        dt_batch = time.perf_counter() - t_batch0
        self._step_hist.observe(dt_batch)
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            if warm and self._last_end is not None:
                self._step_events = (self._last_end, end)
            self._last_end = end
        elif warm:
            self._note_train_perf(dt_batch)
        if self._config.steps_per_print and \
                self.global_steps % self._config.steps_per_print == 0:
            log_dist(f"step={self.global_steps}, skipped="
                     f"{self.get_skipped_steps()}, lr={self.get_lr()}, "
                     f"loss={float(loss):.6f}", ranks=[0])
        self._last_loss = loss
        return loss

    def _train_flops_estimate(self, batch: Dict[str, torch.Tensor]):
        """FLOPs of one step over ``batch`` (``[gas, micro, T]`` ids):
        6·N·tokens + 12·L·B·T²·h."""
        cfg = getattr(self.module, "config", None)
        ids = batch.get("input_ids")
        if cfg is None or ids is None:
            return None
        gas, micro, seq = ids.shape
        n_params = sum(p.numel() for p in self.master.values())
        return {"flops": train_step_flops(n_params, gas * micro, seq,
                                          cfg.num_hidden_layers,
                                          cfg.hidden_size)}

    def _note_train_perf(self, dt_s: float) -> None:
        vals = self.perf.on_program_step("train_step", dt_s)
        if vals["mfu"] is not None:
            self.registry.gauge("train_mfu").set(vals["mfu"])
        if vals["flops_per_sec"]:
            self.registry.gauge("train_tflops_per_chip").set(
                vals["flops_per_sec"] / 1e12 / self.perf.n_devices)

    def _read_step_events(self, wait: bool) -> None:
        """Fold the last judged CUDA step's time (the previous step's end
        to its end) into the gauges once it has ended (``wait``: wait for
        it)."""
        if self._step_events is None:
            return
        start, end = self._step_events
        if wait:
            end.synchronize()
        elif not end.query():
            return
        self._step_events = None
        self._note_train_perf(start.elapsed_time(end) / 1e3)

    def perf_summary(self) -> Dict[str, Any]:
        """The ``perf`` block (device peaks, memory watermarks, the
        ``train_step`` program, utilization) after the last step's time
        is in the gauges."""
        self._read_step_events(wait=True)
        return self.perf.summary()

    def forward(self, batch: Dict[str, Any]):
        """``engine(batch)`` queues a microbatch and returns a lazy loss;
        the step runs at the accumulation boundary in ``step()``, and the
        loss costs an extra forward only if the caller reads it."""
        self._pending_microbatches.append(batch)
        return _LazyLoss(self, batch)

    __call__ = forward

    def backward(self, loss=None, **_):
        """No-op: the gradients are computed in ``step()``."""
        return loss

    def step(self):
        """Take the optimizer step once ``gas`` microbatches are queued."""
        gas = self.gradient_accumulation_steps
        if len(self._pending_microbatches) < gas:
            return None
        micro = self._pending_microbatches[:gas]
        self._pending_microbatches = self._pending_microbatches[gas:]
        batch = {k: torch.cat([_as_tensor(m[k]) for m in micro])
                 for k in micro[0]}
        return self.train_batch(batch=batch)

    def eval_batch(self, batch: Dict[str, Any]) -> torch.Tensor:
        """The loss of ``batch`` (one forward, no gradients)."""
        mb = {k: _as_tensor(v).to(self.device) for k, v in batch.items()}
        with torch.no_grad():
            return self._loss(mb)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def config(self) -> DeepSpeedConfig:
        return self._config

    def zero_optimization_stage(self) -> int:
        return self._config.zero_optimization_stage

    def get_global_grad_norm(self) -> Optional[float]:
        """The global (pre-clip) gradient norm of the last step; None
        before the first and for a non-finite (skipped) one."""
        if self._last_grad_norm is None:
            return None
        norm = float(self._last_grad_norm)
        return norm if np.isfinite(norm) else None

    @property
    def loss_scaler(self):
        """The fp16 loss-scale state (device tensors), or None."""
        return self._scaler

    @loss_scaler.setter
    def loss_scaler(self, state) -> None:
        """Replace the scaler's state (moved to the engine's device); the
        captured steps read the old tensors, so they are dropped and the
        next step captures anew."""
        self._scaler = None if state is None else state.replace(**{
            name: getattr(state, name).to(self.device)
            for name in ("cur_scale", "cur_iter", "cur_hysteresis")})
        self._graphs.clear()

    @property
    def loss_scale(self) -> float:
        return 1.0 if self._scaler is None else float(self._scaler.cur_scale)

    @property
    def skipped_steps(self) -> int:
        return int(self._skipped)

    def get_lr(self):
        if self.lr_scheduler is None:
            opt = self._config.optimizer
            return [opt.params.get("lr", 1e-3) if opt else 1e-3]
        return [float(self.lr_scheduler(self.optimizer.count))]

    def get_skipped_steps(self) -> int:
        return int(self._skipped)

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The fp32 master weights by ``state_dict`` name."""
        return {n: p.detach() for n, p in self.master.items()}


class _LazyLoss:
    """The loss handle of ``engine(batch)``: reading it (``float``) runs
    one eval forward; handing it to ``backward`` costs nothing."""

    def __init__(self, engine: DeepSpeedEngine, batch):
        self._engine = engine
        self._batch = batch
        self._value = None

    def __float__(self):
        if self._value is None:
            self._value = self._engine.eval_batch(self._batch)
        return float(self._value)

    def __repr__(self):
        return f"LazyLoss({float(self) if self._value is not None else 'unevaluated'})"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, loss_fn=None, example_batch=None,
               device=None, cuda_graph: bool = True
               ) -> Tuple[DeepSpeedEngine, Any, None, Any]:
    """Build a :class:`DeepSpeedEngine`. Returns ``(engine, optimizer,
    None, lr_scheduler)``. ``model_parameters`` is a ``state_dict`` (the
    JAX param tree goes through ``checkpoint.from_flax`` first); without
    it the weights are ``model.init_params(seed=config["seed"])``, so
    ``example_batch`` is not needed. Runs on ``cuda`` unless ``device``
    says otherwise; there each step is one replayed CUDA graph unless
    ``cuda_graph=False``, which runs the same step uncaptured. A client
    ``lr_scheduler`` is called with the device step count (a 0-d int32
    tensor) and returns the lr as a tensor, as JAX traces
    ``lr(state.count)``."""
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and \
            getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if optimizer is not None:
        raise unported("a client optimizer", "the training engine's "
                       "remaining parts (item 7)")
    if loss_fn is not None:
        raise unported("a custom loss_fn", "the training engine's remaining "
                       "parts (item 7)")
    if training_data is not None:
        raise unported("training_data (the data loader)", "the training "
                       "engine's remaining parts (item 7)")
    if mpu is not None:
        raise unported("an mpu", "the distributed and ZeRO slice (item 9)")
    engine = DeepSpeedEngine(model, config=config,
                             model_parameters=model_parameters,
                             lr_scheduler=lr_scheduler, device=device,
                             cuda_graph=cuda_graph)
    return engine, engine.optimizer, None, engine.lr_scheduler
