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

ZeRO-Offload (``zero_optimization.offload_optimizer`` ``cpu`` or
``nvme``; the JAX engine's ``engine.py:203-262`` and
``_offload_train_batch``): the device holds compute-dtype weights only
and runs no optimizer (no K3). Its step is the forward and backward and
the loss: at gas 1 it leaves the gradients in the compute dtype, at gas > 1
it adds them up in fp32 and divides by gas (captured under ``cuda_graph``
as the fused step is). The gradients go to pinned host buffers, the host
optimizer (``runtime/zero/offload.py``: SIMD Adam or Adagrad over fp32
masters, the moments on NVMe for ``nvme``) steps, and the new weights go
back into the bound parameters (bf16 rounded by the host kernel itself).
fp16 grads leave the device scaled; the host unscales, an overflow skips
the step and moves the loss-scale automaton. ``offload_times`` holds the
last step's split (device grad step, D2H, host optimizer, H2D, seconds).
A save adds the host state as ``{tag}.host_optimizer.npz`` beside the
universal directory (whose params are the fp32 masters); a universal
restore copies the checkpoint's fp32 masters and resets the moments.

The model is a port model or any ``nn.Module`` (the JAX engine takes any
flax module): its ``forward(**batch)`` gives the loss, or a ``loss_fn(
module, batch, generator)`` does. A client ``torch.optim.Optimizer`` takes
K3's place, its groups re-pointed at the masters, the engine keeping the
device step count beside it. Progressive layer drop computes theta from
the device step count inside the step and hands it, with the engine's
device generator (registered with each captured graph, so every replay
draws anew), to a model that accepts ``pld_theta``. Every MoE gate
(``moe.TopKGate``) of the module draws its Gumbel noise, RTS priorities
and jitter from the engine's gating generator, registered the same way.
The TensorBoard and CSV monitors get the JAX engine's events after each
step; the ``tracing`` block switches on the process-global tracer.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``, the JAX engine's
``engine.py:1191-1305``): the state goes to disk under the JAX
``TrainState``'s leaf names and layouts (``step``, ``params/<flax path>``,
the optax state's ``count``, ``mu`` and ``nu`` where the JAX chain for the
config nests them, ``loss_scale/...``, ``skipped_steps``; scanned layers
stacked ``[L, in, out]``), as a universal directory a tag behind the
verified-manifest protocol (``checkpoint/engine.py``), so each package
loads the other's. The port's one device count stands for ``step`` and
every optax count (all move together in JAX). A load writes
every tensor in place (``copy_``): the captured steps and K3's pointer
table keep reading the same memory, and nothing is recaptured. The lr is
not saved: the schedule reads the restored count. ``save_16bit_model``
writes the JAX file format (flat flax names, bf16 as uint16 bit patterns
and a ``__dtypes__`` list).

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

import inspect
import os
import re
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..inference.engine import resolve_device
from ..models.layers import copy_into
from ..moe.layer import set_gating_generator
from ..monitor.monitor import MonitorMaster
from ..monitor.perf import PerfAccounting, spec, train_step_flops
from ..monitor.registry import MetricsRegistry
from ..monitor.tracing import ENV_TRACE_DIR, get_tracer
from ..monitor.tracing import configure as configure_tracing
from ..ops.optimizers import Adagrad, FusedAdam, get_optimizer
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from .config import DeepSpeedConfig
from .config_utils import unported
from .fp16.loss_scaler import create_loss_scaler, update_scale
from .lr_schedules import get_lr_schedule
from .progressive_layer_drop import ProgressiveLayerDrop
from ..ops._host import host_buffers
from .zero.config import offload_on

#: the layer index in a state_dict name (``model.layers.3.mlp...``)
_LAYER_INDEX = re.compile(r"(^|\.)layers\.\d+\.")

_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16,
           "fp32": torch.float32}


def _derived_seed(seed: int, stream: int) -> int:
    """A seed for the engine's ``stream``-th generator, mixed from the
    config's seed (the engine's counterpart of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def load_config_dict(config):
    """A config path or dict as a dict (duplicate JSON keys raise)."""
    if isinstance(config, (str, os.PathLike)):
        import json

        from .config_utils import dict_raise_error_on_duplicate_keys

        with open(config) as f:
            return json.load(
                f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
    return config


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
                 model_parameters=None, lr_scheduler=None, device=None,
                 cuda_graph: bool = True, optimizer=None,
                 loss_fn: Optional[Callable] = None):
        self.device = resolve_device(device)
        if not isinstance(model, nn.Module):
            raise TypeError(f"initialize takes a torch.nn.Module, got "
                            f"{type(model).__name__}")
        self.module = model
        self.loss_fn = loss_fn
        self.client_optimizer = optimizer
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
        self._graphed = bool(cuda_graph) and self.device.type == "cuda"
        self._offload = offload_on(self._config.zero_config.offload_optimizer)
        if self._offload and optimizer is not None:
            raise ValueError("offload_optimizer steps the config's optimizer "
                             "on the host; a client optimizer is not "
                             "supported with it")
        if self._offload and self._config.progressive_layer_drop.enabled:
            raise ValueError("progressive_layer_drop is not supported with "
                             "offload_optimizer (the host-optimizer grad "
                             "step does not thread pld_theta)")

        # ---- fp32 masters ------------------------------------------------
        self.master = self._init_masters(model_parameters)
        self._trainable_names = [n for n, p in self.master.items()
                                 if p.requires_grad]
        self._trainable = [self.master[n] for n in self._trainable_names]
        self.lr_scheduler = self._build_lr_scheduler()
        if self._offload:
            self._init_offload()
        else:
            # the gradient buffers: allocated once, zeroed in place each
            # step, so a captured step (and K3's table of pointers) sees
            # the same memory every time
            for p in self._trainable:
                p.grad = torch.zeros_like(p)
            self._grads = [p.grad for p in self._trainable]
        #: the engine's random numbers (PLD's keep decisions, a loss_fn's
        #: dropout): a generator on the device, seeded from the config, that
        #: a captured step registers so each replay draws anew
        self.generator = torch.Generator(device=self.device).manual_seed(
            self._config.seed)
        #: the MoE gates' draws (Gumbel, RTS, jitter): a generator of its
        #: own, seeded from (seed, 1) as the JAX engine derives the gates'
        #: key ``fold_in(base, 1)``, set on every ``TopKGate`` of the
        #: module (None when it has none) and registered with each
        #: captured step
        self.gating_generator = torch.Generator(
            device=self.device).manual_seed(_derived_seed(self._config.seed,
                                                          1))
        if not set_gating_generator(model, self.gating_generator):
            self.gating_generator = None

        #: the device step count of a client optimizer (FusedAdam keeps
        #: its own, ``optimizer.count``)
        self._count = None
        self._client_lrs = None
        self.optimizer = None if self._offload else self._build_optimizer()
        self._scaler = create_loss_scaler(self._config.fp16,
                                          device=self.device) \
            if self.fp16_enabled else None
        #: skipped (fp16 overflow) steps, a device int32 scalar
        self._skipped = torch.zeros((), dtype=torch.int32, device=self.device)
        self._pld = self._build_pld()
        #: progressive layer drop's theta of the last step that ran (a
        #: device scalar buffer, which a captured step's replays rewrite)
        self.pld_theta: Optional[torch.Tensor] = None
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
        self.monitor = MonitorMaster(self._config)
        self.tracer = self._build_tracer()
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

    def _generators(self):
        """The engine's generators that a step draws from."""
        return [g for g in (self.generator, self.gating_generator)
                if g is not None]

    def _build_lr_scheduler(self):
        if self.client_lr_scheduler is not None:
            return self.client_lr_scheduler
        sched = self._config.scheduler
        if sched is None or sched.type is None:
            return None
        return get_lr_schedule(sched.type, sched.params)

    def _init_masters(self, model_parameters) -> Dict[str, torch.Tensor]:
        """The fp32 masters on the device, by parameter name: from
        ``model_parameters`` (a ``state_dict``, or DeepSpeed's form, an
        iterable of the module's own parameters, the ones to train), else
        from a port model's ``init_params`` (seeded from the config), else
        from the module's own parameters (any ``nn.Module``, as the JAX
        engine takes any flax module). A generic module's buffers move to
        the device; its parameters are replaced by the cast masters at
        each bind."""
        module = self.module
        own = dict(module.named_parameters())
        trained = {n for n, p in own.items() if p.requires_grad}
        if model_parameters is None:
            params = module.init_params(seed=self._config.seed,
                                        device=self.device) \
                if hasattr(module, "init_params") else own
        elif isinstance(model_parameters, dict):
            params = model_parameters
        else:
            by_id = {id(p): n for n, p in own.items()}
            chosen = list(model_parameters)    # often a generator
            if any(id(p) not in by_id for p in chosen):
                raise ValueError("model_parameters holds a tensor that is "
                                 "not a parameter of the model")
            params = own
            trained = {by_id[id(p)] for p in chosen}
        if set(params) != set(own):
            raise ValueError(
                f"model_parameters must be the model's state_dict: missing "
                f"{sorted(set(own) - set(params))}, unexpected "
                f"{sorted(set(params) - set(own))}")
        for name, b in list(module.named_buffers()):
            owner, _, attr = name.rpartition(".")
            module.get_submodule(owner)._buffers[attr] = b.to(self.device)
        master = {}
        for name, p in params.items():
            p = _as_tensor(p).detach()
            if p.is_floating_point():
                p = p.to(device=self.device, dtype=torch.float32,
                         copy=True).requires_grad_(name in trained)
            else:
                p = p.to(self.device)
            master[name] = p
        return master

    def _init_offload(self) -> None:
        """ZeRO-Offload's state: the host optimizer over the trainable
        masters (moved to host memory a tensor at a time), the device's
        compute-dtype weights (``_dev_params``, bound to the module), the
        static device gradient buffers a captured grad step writes, and the
        pinned host buffers of the two copies."""
        from .zero.offload import HostOffloadOptimizer

        dt, dev = self.compute_dtype, self.device
        pin = dev.type == "cuda"
        gas = self.gradient_accumulation_steps
        self._dev_params = {}
        host = {}
        for name in list(self.master):
            p = self.master[name]
            if p.is_floating_point():
                self._dev_params[name] = p.detach().to(dt).requires_grad_(
                    p.requires_grad)
                if p.requires_grad:
                    host[name] = p.detach().to("cpu")
            else:
                self._dev_params[name] = p
            del p
            self.master[name] = None     # frees the device fp32 copy
        opt = self._config.optimizer
        self._host_opt = HostOffloadOptimizer(
            [host.pop(n) for n in self._trainable_names],
            opt.type if opt else "AdamW", opt.params if opt else {},
            self._config.zero_config.offload_optimizer,
            gradient_clipping=self._config.gradient_clipping,
            lr_scheduler=self.lr_scheduler)
        # the engine's masters are the host optimizer's, by name
        for name, flat in zip(self._trainable_names, self._host_opt.master):
            self.master[name] = flat.view(self._dev_params[name].shape)
        for name, p in self._dev_params.items():
            if self.master[name] is None:
                self.master[name] = p.detach().to("cpu") \
                    if p.is_floating_point() else p
        self._trainable = [self._dev_params[n] for n in self._trainable_names]
        # at gas 1 the gradients stay in the compute dtype (the JAX grad
        # step's dtype); at gas > 1 they add up in fp32
        gdt = dt if gas == 1 else torch.float32
        self._grads = [torch.zeros(p.shape, dtype=gdt, device=dev)
                       for p in self._trainable]

        sizes = [p.numel() for p in self._trainable]
        self._host_grads = host_buffers(sizes, gdt, pin)
        #: the new compute-dtype weights on their way to the card (bf16:
        #: written by the host kernel's fused rounding). At gas 1 they are
        #: the gradients' own buffers, which the host step widens a leaf at
        #: a time before it overwrites them: 14 host bytes a parameter
        #: (fp32 master, two moments, one bf16 buffer)
        self._staging = self._host_grads if gdt == dt else \
            host_buffers(sizes, dt, pin)
        self.offload_times: Dict[str, float] = {}

    def _build_optimizer(self):
        if self.client_optimizer is not None:
            return self._adopt_client_optimizer(self.client_optimizer)
        opt = self._config.optimizer
        if opt is None:
            return FusedAdam(self._trainable, self.lr_scheduler or 1e-3)
        return get_optimizer(opt.type, self._trainable, opt.params,
                             self.lr_scheduler,
                             groups=self._trust_ratio_groups())

    def _adopt_client_optimizer(self, opt):
        """A ``torch.optim.Optimizer`` built over the module's parameters
        (DeepSpeed's form): its groups are re-pointed at the fp32 masters,
        which the engine's step fills with gradients. A captured step
        needs it ``capturable``. A schedule (the config's or
        ``lr_scheduler``) feeds each group's lr from the device step
        count, which the engine keeps: captured through a device tensor,
        uncaptured as a float."""
        if not isinstance(opt, torch.optim.Optimizer):
            raise TypeError(f"a client optimizer must be a "
                            f"torch.optim.Optimizer, got "
                            f"{type(opt).__name__}")
        if opt.state:
            raise ValueError("a client optimizer must not have stepped "
                             "before initialize")
        if self._config.optimizer is not None:
            raise ValueError("pass a client optimizer or the config's "
                             "optimizer block, not both")
        if self._graphed and not all(g.get("capturable", False)
                                     for g in opt.param_groups):
            raise ValueError(
                f"a captured training step needs a capturable client "
                f"optimizer (e.g. torch.optim.{type(opt).__name__}(..., "
                f"capturable=True)); or pass cuda_graph=False")
        if self._graphed and self.fp16_enabled:
            raise NotImplementedError(
                "fp16 loss scaling skips an overflowed step of a client "
                "optimizer on the host, which a captured step cannot do; "
                "pass cuda_graph=False")
        names = {id(p): n for n, p in self.module.named_parameters()}
        for group in opt.param_groups:
            try:
                group["params"] = [self.master[names[id(p)]]
                                   for p in group["params"]]
            except KeyError:
                raise ValueError("a client optimizer's group holds a tensor "
                                 "that is not a parameter of the model")
        self._count = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.lr_scheduler is not None and self._graphed:
            self._client_lrs = [torch.as_tensor(
                float(g["lr"]), dtype=torch.float32, device=self.device)
                for g in opt.param_groups]
            for g, lr in zip(opt.param_groups, self._client_lrs):
                g["lr"] = lr
        return opt

    @property
    def step_count(self) -> torch.Tensor:
        """The device step count (int32 0-d): K3's count, or the engine's
        beside a client optimizer (under offload the host optimizer's, as
        a CPU tensor). Skipped steps do not count."""
        if self._offload:
            return torch.tensor(self._host_opt.step_count, dtype=torch.int32)
        return self._count if self._count is not None else \
            self.optimizer.count

    def _build_pld(self):
        """Progressive layer drop (the JAX ``engine.py:330-352``): theta is
        computed on the device from the step count inside each step and
        passed to the model with the engine's generator."""
        cfg = self._config.progressive_layer_drop
        if not cfg.enabled:
            return None
        if self.loss_fn is not None:
            raise ValueError("progressive_layer_drop drives the model's "
                             "pld_theta input and requires the default "
                             "model loss path")
        sig = inspect.signature(type(self.module).forward)
        if "pld_theta" not in sig.parameters:
            raise ValueError(f"progressive_layer_drop requires a model "
                             f"accepting pld_theta; "
                             f"{type(self.module).__name__} does not")
        return ProgressiveLayerDrop(theta=cfg.theta, gamma=cfg.gamma)

    def _build_tracer(self):
        """The process-global tracer; the ``tracing`` block switches it on
        (with the flight recorder under ``dir``), as ``DS_TRACE_DIR``
        does."""
        tcfg = self._config.tracing
        if tcfg.enabled or tcfg.dir:
            configure_tracing(trace_dir=tcfg.dir or
                              os.environ.get(ENV_TRACE_DIR),
                              capacity=tcfg.capacity,
                              flight_events=tcfg.flight_events)
        return get_tracer()

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
        cast when grad mode is on); under offload the device's
        compute-dtype weights themselves."""
        if self._offload:
            _bind(self.module, self._dev_params)
            return
        dt = self.compute_dtype
        _bind(self.module, {n: p.to(dt) if p.is_floating_point() else p
                            for n, p in self.master.items()})

    def _loss(self, batch: Dict[str, torch.Tensor],
              pld_theta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One microbatch's loss on the bound compute-dtype weights:
        ``loss_fn(module, batch, generator)``'s first output, else the
        module's ``forward(**batch)`` (a scalar, the first of a tuple, or
        a dict's ``"loss"``), with PLD's theta and the generator when PLD
        is on."""
        self._bind_params()
        if self.loss_fn is not None:
            out = self.loss_fn(self.module, batch, self.generator)
        else:
            extra = {} if pld_theta is None else \
                {"pld_theta": pld_theta, "generator": self.generator}
            out = self.module(**batch, **extra)
        if isinstance(out, tuple):
            out = out[0]
        if isinstance(out, dict):
            out = out["loss"]
        return out

    def _train_step(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The JAX ``train_step`` on the device state; returns the mean
        loss and the global gradient norm as device scalars. Reads nothing
        back (but for a client optimizer's fp16 skip and scheduled lr,
        which run uncaptured only), so it runs inside a CUDA graph."""
        gas = self.gradient_accumulation_steps
        scale = self._scaler.cur_scale if self.fp16_enabled else None
        grads = self._grads
        torch._foreach_zero_(grads)
        theta = None
        if self._pld is not None:
            theta = self._pld.get_theta(self.step_count)
            self.pld_theta = copy_into(self.pld_theta, theta)
        total = None
        for i in range(gas):
            loss = self._loss({k: v[i] for k, v in batch.items()},
                              theta).float()
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
        if self._count is None:
            self.optimizer.step(grads, grad_scale=factor, skip=overflow)
        else:
            self._client_step(grads, factor, overflow)
        return loss, norm

    def _client_step(self, grads, factor, overflow) -> None:
        """A client optimizer's step over the masters' gradients: clipped
        in place, the lr fed from the schedule, the device count advanced.
        An fp16 overflow (read on the host: uncaptured only) skips it."""
        if overflow is not None and bool(overflow):
            return
        if factor is not None:
            torch._foreach_mul_(grads, factor)
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self._count)
            for i, group in enumerate(self.optimizer.param_groups):
                if self._client_lrs is not None:
                    self._client_lrs[i].copy_(lr)
                else:
                    group["lr"] = float(lr)
        self.optimizer.step()
        self._count.add_(1)

    def _offload_grad_step(self, batch: Dict[str, torch.Tensor]
                           ) -> Tuple[torch.Tensor]:
        """ZeRO-Offload's device step (the JAX ``_compile_grad_step``): the
        loss (times the fp16 scale) goes backward through the bound
        compute-dtype weights; at gas 1 the gradients are copied into the
        static buffers in the compute dtype, at gas > 1 they are summed in
        fp32 and divided by gas. Returns the mean loss (a device scalar)."""
        gas = self.gradient_accumulation_steps
        scale = self._scaler.cur_scale if self.fp16_enabled else None
        total = None
        for i in range(gas):
            loss = self._loss({k: v[i] for k, v in batch.items()}).float()
            grads = torch.autograd.grad(
                loss if scale is None else loss * scale, self._trainable)
            if gas == 1:
                torch._foreach_copy_(self._grads, grads)
            elif i == 0:
                torch._foreach_copy_(self._grads, [g.float() for g in grads])
            else:
                torch._foreach_add_(self._grads, [g.float() for g in grads])
            total = loss.detach() if total is None \
                else total + loss.detach()
        if gas > 1:
            torch._foreach_div_(self._grads, float(gas))
        return (total / gas,)

    def _offload_train_step(self, batch: Dict[str, torch.Tensor]
                            ) -> Tuple[torch.Tensor, float]:
        """One ZeRO-Offload step (the JAX ``_offload_train_batch``): the
        device grad step (replayed from its graph when captured), the
        gradients to the pinned host buffers, the host optimizer, the new
        weights back. Its split lands in ``offload_times``."""
        cuda = self.device.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(self.device)
            return time.perf_counter()

        t0 = sync()
        (loss,) = self._graphed_step(batch, self._offload_grad_step) \
            if self._graphed else self._offload_grad_step(batch)
        t1 = sync()
        for host, grad in zip(self._host_grads, self._grads):
            host.copy_(grad.reshape(-1), non_blocking=True)
        t2 = sync()
        scale = float(self._scaler.cur_scale) if self.fp16_enabled else 1.0
        bf16 = self.compute_dtype == torch.bfloat16
        masters, overflow, norm = self._host_opt.step(
            self._host_grads, loss_scale=scale,
            bf16_out=self._staging if bf16 else None)
        t3 = time.perf_counter()
        if self.fp16_enabled:
            flag = torch.tensor(overflow, device=self.device)
            self._scaler.copy_(update_scale(self._scaler, flag))
        if overflow:
            self._skipped.add_(1)
        else:
            for stage, master, p in zip(self._staging, masters,
                                        self._trainable):
                if not bf16:
                    stage.copy_(master)
                with torch.no_grad():
                    p.view(-1).copy_(stage, non_blocking=True)
        t4 = sync()
        self.offload_times = {"grad_step": t1 - t0, "d2h": t2 - t1,
                              "host_step": t3 - t2, "h2d": t4 - t3}
        return loss, norm

    def _graphed_step(self, batch: Dict[str, torch.Tensor], step=None
                      ) -> Tuple[torch.Tensor, ...]:
        """:meth:`_train_step` (or ``step``) as a CUDA graph for the
        batch's signature: the first step of a signature runs eagerly on a
        side stream and is then captured; later steps copy the batch into the graph's inputs
        and replay. Returns copies of the graph's outputs (a replay
        overwrites them)."""
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        step = step or self._train_step
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
            out = step(inputs)
            # the casts bound to the module hold the warm-up's autograd
            # graph, whose gradient accumulators belong to this stream:
            # rebind without a graph, so the capture makes its own
            with torch.no_grad():
                self._bind_params()
        current.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # each replay advances the generators (PLD's draws, a loss_fn's,
        # the MoE gates')
        for gen in self._generators():
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=self._graph_pool):
            outputs = step(inputs)
        self._graphs[key] = (graph, inputs, outputs,
                             getattr(self.optimizer, "table", None))
        return out

    # ------------------------------------------------------------------
    # public training API
    # ------------------------------------------------------------------

    def _shape_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """``[train_batch, ...] -> [gas, micro, ...]`` on the device (every
        key: ``input_ids``, ``labels``, a padding ``attention_mask``, or a
        generic module's own inputs)."""
        gas = self.gradient_accumulation_steps
        out = {}
        for k, x in batch.items():
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
        tr = self.tracer
        # the span covers the step's enqueue (reading the loss here would
        # wait for the device every step just to trace)
        t_step0 = time.perf_counter() if tr.enabled else 0.0
        if self._offload:
            loss, self._last_grad_norm = self._offload_train_step(batch)
        else:
            loss, self._last_grad_norm = self._graphed_step(batch) \
                if self._graphed else self._train_step(batch)
        if tr.enabled:
            tr.complete("train_step", t_step0, time.perf_counter(),
                        cat="train", args={"step": self.global_steps})
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
        if tr.enabled:
            tr.complete("train_batch", t_batch0, time.perf_counter(),
                        cat="train", args={"step": self.global_steps - 1})
        if self.monitor.enabled:
            self._write_monitor(loss)
        if self._config.steps_per_print and \
                self.global_steps % self._config.steps_per_print == 0:
            log_dist(f"step={self.global_steps}, skipped="
                     f"{self.get_skipped_steps()}, lr={self.get_lr()}, "
                     f"loss={float(loss):.6f}", ranks=[0])
        self._last_loss = loss
        return loss

    def _write_monitor(self, loss) -> None:
        """The JAX engine's events at its steps (samples seen): the loss,
        the lr, the fp16 loss scale and the gradient norm (when finite),
        then the registry's snapshot at the step count. Reads the step's
        values back, so it waits for the step."""
        at = self.global_steps * self.train_batch_size
        events = [("Train/Samples/train_loss", float(loss), at),
                  ("Train/Samples/lr", self.get_lr()[0], at)]
        if self.fp16_enabled:
            events.append(("Train/Samples/loss_scale", self.loss_scale, at))
        gn = self.get_global_grad_norm()
        if gn is not None:
            events.append(("Train/Samples/grad_norm", gn, at))
        self.monitor.write_events(events)
        self.monitor.write_registry(self.registry, self.global_steps,
                                    prefix="Train/Registry/")

    def _train_flops_estimate(self, batch: Dict[str, torch.Tensor]):
        """FLOPs of one step over ``batch``: for a port model (``[gas,
        micro, T]`` ids) 6·N·tokens + 12·L·B·T²·h; for any other module
        one microbatch's forward and backward counted by torch's
        ``FlopCounterMode`` (its matmuls and convolutions), times gas (the
        JAX engine reads XLA's count of its compiled step)."""
        cfg = getattr(self.module, "config", None)
        ids = batch.get("input_ids")
        if hasattr(cfg, "num_hidden_layers") and ids is not None:
            gas, micro, seq = ids.shape
            n_params = sum(p.numel() for p in self.master.values())
            return {"flops": train_step_flops(n_params, gas * micro, seq,
                                              cfg.num_hidden_layers,
                                              cfg.hidden_size)}
        from torch.utils.flop_counter import FlopCounterMode

        states = [gen.get_state() for gen in self._generators()]
        with FlopCounterMode(display=False) as counter:
            loss = self._loss({k: v[0] for k, v in batch.items()})
            torch.autograd.grad(loss.float(), self._trainable,
                                allow_unused=True)
        for gen, state in zip(self._generators(), states):
            gen.set_state(state)
        # rebind without a graph: the counted one holds the masters'
        # gradient accumulators on this stream
        with torch.no_grad():
            self._bind_params()
        return {"flops": float(counter.get_total_flops()
                               * self.gradient_accumulation_steps)}

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
        if self._offload:
            return [self._host_opt.current_lr()]
        if self._count is not None:
            return [float(g["lr"]) for g in self.optimizer.param_groups]
        if self.lr_scheduler is None:
            opt = self._config.optimizer
            return [opt.params.get("lr", 1e-3) if opt else 1e-3]
        return [float(self.lr_scheduler(self.step_count))]

    def get_skipped_steps(self) -> int:
        return int(self._skipped)

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The fp32 master weights by ``state_dict`` name."""
        return {n: p.detach() for n, p in self.master.items()}

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _optax_layout(self) -> Tuple[str, Tuple[str, ...]]:
        """Where the JAX engine's optax state keeps the Adam count and
        moments, and the counts of its lr schedule beside them (optax's
        ``ScaleByScheduleState``, which advances with the Adam count): the
        prefixes under ``opt_state/``, as the chain that the JAX engine
        builds for this config nests them (``deepspeed_tpu/ops/
        optimizers.py``; ``optax.chain(clip_by_global_norm, tx)`` when
        clipping, ``runtime/engine.py`` ``_build_optimizer``)."""
        opt = self._config.optimizer
        kind = opt.type.lower() if opt is not None else "adamw"
        params = opt.params if opt is not None else {}
        sched = self.lr_scheduler is not None
        if params.get("pallas"):  # FusedAdamState(count, mu, nu) alone
            adam, counts = "", ()
        elif kind == "adagrad":  # [decay,] (rss, lr)
            adam = "1/0/" if params.get("weight_decay") else "0/"
            counts = (adam[:-2] + "1/",) if sched else ()
        elif kind == "lamb":  # adam, decay, trust ratio, lr
            adam, counts = "0/", ("3/",) if sched else ()
        elif kind == "adamw" or params.get("adam_w_mode", True):
            adam, counts = "0/", ("2/",) if sched else ()  # optax.adamw
        elif params.get("weight_decay"):  # decay, then optax.adam
            adam, counts = "1/0/", ("1/1/",) if sched else ()
        else:  # optax.adam: adam, lr
            adam, counts = "0/", ("1/",) if sched else ()
        if self._config.gradient_clipping and \
                self._config.gradient_clipping > 0:
            adam, counts = "1/" + adam, tuple("1/" + c for c in counts)
        return adam, counts

    def _check_port_state(self, what: str) -> None:
        """Checkpoints name the state as the JAX ``TrainState`` of a port
        model under K3's optimizer."""
        if not hasattr(self.module, "config") or self._count is not None:
            raise unported(f"{what} of a module that is not a port model, "
                           f"or of a client optimizer's state",
                           "the training engine's remaining parts (item 7)")

    def _state_leaves(self, for_load: bool = False):
        """The engine's state under the JAX ``TrainState``'s names, in its
        order, as views over the live tensors (a save reads each one when
        it writes it; a load writes into them in place). The device count
        stands for ``step``, the Adam count and the schedule's counts (all
        move together in JAX); a load takes it from the Adam count (with
        ``load_optimizer_states=False`` it stays, as JAX's optimizer count
        does) and reads the others into scratch tensors."""
        from ..checkpoint.from_flax import flax_leaves
        from ..checkpoint.universal import NamedLeaves

        self._check_port_state("a checkpoint")
        config = self.module.config
        opt = self.optimizer
        names = self._trainable_names
        adam, counts = self._optax_layout()

        def tree(prefix, tensors):
            return [(f"{prefix}/{path}", view)
                    for path, view in flax_leaves(tensors, config)]

        def count():
            return torch.zeros_like(opt.count) if for_load else opt.count

        if self._offload:
            # the JAX offload TrainState: no optax state on the device;
            # the params are the host fp32 masters
            self._loaded_step = torch.zeros((), dtype=torch.int32)
            leaves = [("step", self._loaded_step if for_load
                       else self.step_count)]
            leaves += tree("params", self.master)
            leaves += self._scaler_and_skips()
            return NamedLeaves(leaves)
        if isinstance(opt, Adagrad):
            # optax's ScaleByRssState has no count: the step carries it
            leaves = [("step", opt.count)]
            leaves += tree("params", self.master)
            leaves += tree(f"opt_state/{adam}sum_of_squares",
                           dict(zip(names, opt.sum_of_squares)))
            leaves += [(f"opt_state/{c}count", count()) for c in counts]
            leaves += self._scaler_and_skips()
            return NamedLeaves(leaves)
        leaves = [("step", count())]
        leaves += tree("params", self.master)
        leaves.append((f"opt_state/{adam}count", opt.count))
        leaves += tree(f"opt_state/{adam}mu", dict(zip(names, opt.exp_avg)))
        leaves += tree(f"opt_state/{adam}nu",
                       dict(zip(names, opt.exp_avg_sq)))
        leaves += [(f"opt_state/{c}count", count()) for c in counts]
        leaves += self._scaler_and_skips()
        return NamedLeaves(leaves)

    def _scaler_and_skips(self):
        leaves = []
        if self._scaler is not None:
            leaves += [(f"loss_scale/{f}", getattr(self._scaler, f))
                       for f in ("cur_scale", "cur_iter", "cur_hysteresis")]
        leaves.append(("skipped_steps", self._skipped))
        return leaves

    def _host_optimizer_path(self, save_dir: str, tag: str) -> str:
        return os.path.join(save_dir, f"{tag}.host_optimizer.npz")

    def _save_host_optimizer(self, save_dir: str, tag: str) -> None:
        """The host masters, moments and count beside the save (the JAX
        engine's ``{tag}.host_optimizer.npz``), written before the
        manifest so that it covers them."""
        os.makedirs(save_dir, exist_ok=True)
        sd = self._host_opt.state_dict()
        np.savez(self._host_optimizer_path(save_dir, tag), step=sd["step"],
                 **{f"master_{i}": m.numpy()
                    for i, m in enumerate(sd["master"])},
                 **{f"moment_{mi}_{li}": buf.numpy()
                    for mi, bank in enumerate(sd["moments"])
                    for li, buf in enumerate(bank)})

    def _after_offload_load(self, load_dir: str, tag: Optional[str],
                            universal: bool,
                            load_optimizer_states: bool) -> None:
        """The host state after a load wrote the params into the masters:
        the sidecar's masters, moments and count when there is one (and
        the optimizer states are asked for); else, as the JAX engine does
        for a universal restore or a save without it, the moments reset.
        Then the device weights are the masters in the compute dtype."""
        opt = self._host_opt
        path = None
        if not universal:
            if tag is None:
                with open(os.path.join(load_dir, "latest")) as f:
                    tag = f.read().strip()
            path = self._host_optimizer_path(load_dir, tag)
        if path is not None and load_optimizer_states and \
                os.path.exists(path):
            z = np.load(path)
            n = len(opt.master)
            opt.load_state_dict({
                "step": int(z["step"]),
                "master": [z[f"master_{i}"] for i in range(n)],
                "moments": [[z[f"moment_{mi}_{li}"] for li in range(n)]
                            for mi in range(len(opt._moments))]})
        else:
            opt.reset_optimizer_state()
            if universal:
                log_dist("[load_checkpoint] universal restore on an offload "
                         "engine: fp32 masters copied from the checkpoint, "
                         "optimizer moments reset", ranks=[0])
        with torch.no_grad():
            for p, m in zip(self._trainable, opt.master):
                p.copy_(m.view(p.shape))

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True) -> bool:
        """Write the state as the save ``tag`` (default
        ``global_step<N>``) of ``save_dir``: data, client state, manifest,
        then ``latest`` (reference ``engine.save_checkpoint`` :2881). Each
        tensor is read behind the steps already queued on the current
        stream, one leaf at a time."""
        from ..checkpoint.engine import save_train_state

        tag = tag or f"global_step{self.global_steps}"
        client_state = dict(client_state or {})
        client_state.update(global_steps=self.global_steps,
                            skipped_steps=self.get_skipped_steps())
        ft = self._config.fault_tolerance
        t_save0 = time.perf_counter()
        if self._offload:
            self._save_host_optimizer(save_dir, tag)
        save_train_state(save_dir, tag, self._state_leaves(), client_state,
                         save_latest=save_latest,
                         save_retries=ft.save_retries if ft.enabled else 0,
                         retry_backoff_s=ft.save_retry_backoff,
                         manifest_checksums=ft.manifest_checksums)
        # checkpoint I/O is the step loop's big non-compute latency: a
        # traced run shows which steps paid it
        tracer = self.tracer
        if tracer.enabled:
            tracer.complete("checkpoint_save", t_save0, time.perf_counter(),
                            cat="checkpoint", args={"tag": tag})
        self.registry.histogram("checkpoint_save_s", lo=1e-3,
                                hi=4e3).observe(time.perf_counter() - t_save0)
        return True

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_universal: Optional[bool] = None, **_):
        """Restore a save into the engine's tensors in place (reference
        ``engine.load_checkpoint`` :2531); returns ``(load_dir,
        client_state)``. With ``load_universal`` (the argument, or the
        ``checkpoint.load_universal`` config) ``load_dir`` is a universal
        directory — either package's, or one tag of a port save; else the
        tag (default ``latest``) is verified through its manifest, walking
        back to the newest verified save when ``latest`` is damaged."""
        from ..checkpoint.engine import load_train_state
        from ..checkpoint.manifest import resolve_load_tag
        from ..checkpoint.universal import restore_into

        if load_universal is None:
            load_universal = self._config.load_universal_checkpoint
        template = self._state_leaves(for_load=True)
        if load_universal:
            _, meta = restore_into(template, load_dir,
                                   load_optimizer_states=load_optimizer_states)
            client_state = meta.get("client_state", {})
            self.global_steps = int(client_state.get(
                "global_steps", meta.get("step") or 0))
        else:
            ft = self._config.fault_tolerance
            if ft.enabled and ft.verify_on_load:
                tag = resolve_load_tag(load_dir, tag)
            _, client_state = load_train_state(
                load_dir, tag, template,
                load_optimizer_states=load_optimizer_states, verify=False)
            self.global_steps = int(client_state.get("global_steps", 0))
        if self._offload:
            self._after_offload_load(load_dir, tag, bool(load_universal),
                                     load_optimizer_states)
        self.micro_steps = self.global_steps * self.gradient_accumulation_steps
        return load_dir, client_state

    def _consolidated_16bit_state_dict(self) -> Dict[str, torch.Tensor]:
        """The weights at bf16 by ``state_dict`` name (reference
        ``_zero3_consolidated_16bit_state_dict`` :3198; one device holds
        them whole)."""
        return {n: p.detach().to(torch.bfloat16) if p.is_floating_point()
                else p.detach() for n, p in self.master.items()}

    def save_16bit_model(self, save_dir: str,
                         output_file: str = "pytorch_model.npz") -> bool:
        """Write a consolidated half-precision weights file in the JAX
        package's format (reference ``save_16bit_model`` :3268): a flat npz
        keyed by flax param path, bf16 stored as uint16 bit patterns, and
        a ``__dtypes__`` list of ``name=dtype``."""
        from ..checkpoint.from_flax import flax_leaves

        self._check_port_state("save_16bit_model")
        os.makedirs(save_dir, exist_ok=True)
        flat, dtypes = {}, {}
        for name, view in flax_leaves(self._consolidated_16bit_state_dict(),
                                      self.module.config):
            t = view.tensor()
            if t.dtype == torch.bfloat16:
                flat[name] = t.view(torch.int16).cpu().numpy().view(np.uint16)
                dtypes[name] = "bfloat16"
            else:
                flat[name] = t.cpu().numpy()
                dtypes[name] = str(flat[name].dtype)
        path = os.path.join(save_dir, output_file)
        np.savez(path, __dtypes__=np.asarray([f"{k}={v}" for k, v
                                              in dtypes.items()]), **flat)
        log_dist(f"saved 16-bit model to {path}", ranks=[0])
        return True


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
               ) -> Tuple[DeepSpeedEngine, Any, Any, Any]:
    """Build a :class:`DeepSpeedEngine`. Returns ``(engine, optimizer,
    dataloader, lr_scheduler)``; the dataloader (a
    :class:`~deepspeed_tpu_torch.runtime.dataloader.DeepSpeedDataLoader` of
    microbatches) when ``training_data`` is given, else None.

    ``model`` is a port model or any ``nn.Module`` whose ``forward(**batch)``
    returns the loss (a scalar, a ``(loss, *aux)`` tuple or a dict with
    ``"loss"``); ``loss_fn(module, batch, generator) -> (loss, aux)``
    replaces that call. ``model_parameters`` is a ``state_dict`` (the JAX
    param tree goes through ``checkpoint.from_flax`` first) or the module's
    parameters; without it a port model's weights are
    ``model.init_params(seed=config["seed"])`` and any other module's are
    its own, so ``example_batch`` is not needed. ``optimizer`` is a client
    ``torch.optim.Optimizer`` over the module's parameters (capturable
    under ``cuda_graph``). Runs on ``cuda`` unless ``device`` says
    otherwise; there each step is one replayed CUDA graph unless
    ``cuda_graph=False``, which runs the same step uncaptured. A client
    ``lr_scheduler`` is called with the device step count (a 0-d int32
    tensor) and returns the lr as a tensor, as JAX traces
    ``lr(state.count)``."""
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None and \
            getattr(args, "deepspeed_config", None):
        config = args.deepspeed_config
    if mpu is not None:
        raise unported("an mpu", "the distributed and ZeRO slice (item 9)")
    from ..pipe.module import PipelineModule

    if isinstance(model, PipelineModule):
        engine = _pipeline_engine(model, config, model_parameters, loss_fn,
                                  optimizer, lr_scheduler, device, cuda_graph)
    else:
        engine = DeepSpeedEngine(model, config=config,
                                 model_parameters=model_parameters,
                                 lr_scheduler=lr_scheduler, device=device,
                                 cuda_graph=cuda_graph, optimizer=optimizer,
                                 loss_fn=loss_fn)
    dataloader = None
    if training_data is not None:
        from .dataloader import DeepSpeedDataLoader

        dataloader = DeepSpeedDataLoader(training_data,
                                         batch_size=engine.micro_batch_size,
                                         collate_fn=collate_fn)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler


def _pipeline_engine(model, config, model_parameters, loss_fn, optimizer,
                     lr_scheduler, device, cuda_graph):
    """A ``PipelineModule``'s engine (the JAX ``engine.py:1369-1410``):
    with ``offload_param`` on a one-stage module the ``ZeroInfinityEngine``
    streams its body, else the ``PipelineEngine``."""
    from ..pipe.engine import PipelineEngine
    from .zero.config import DeepSpeedZeroConfig

    bad = [k for k, v in {"model_parameters": model_parameters,
                          "loss_fn": loss_fn}.items() if v is not None]
    if bad:
        raise ValueError(
            f"initialize(model=PipelineModule) does not accept {bad}: the "
            "pipeline module owns its params and loss (use "
            "engine.load_checkpoint to restore weights)")
    cfg = load_config_dict(config) or {}
    zcfg = DeepSpeedZeroConfig.from_dict(cfg.get("zero_optimization"),
                                         "zero_optimization")
    if offload_on(zcfg.offload_param) and model.num_stages == 1:
        from .zero.infinity import ZeroInfinityEngine

        if optimizer is not None:
            raise ValueError("ZeroInfinityEngine builds its own host "
                             "optimizer from the config; a client optimizer "
                             "is not supported with offload_param")
        return ZeroInfinityEngine(model, config=cfg,
                                  lr_scheduler=lr_scheduler, device=device)
    return PipelineEngine(model, config=cfg, device=device,
                          cuda_graph=cuda_graph, optimizer=optimizer,
                          lr_scheduler=lr_scheduler)
