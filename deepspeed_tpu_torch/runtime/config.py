"""The single-JSON training config.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (``DeepSpeedConfig``):
one JSON file or dict sets the batch triangulation (train = micro x gas x
dp), precision, optimizer, scheduler, clipping, progressive layer drop,
the activation-checkpointing block, the TensorBoard and CSV monitors,
tracing, the ZeRO block with its offload blocks, the ``aio`` block and
the reporting knobs (``PipelineEngine`` reads the ``pipeline`` block).
This slice trains on one device (dp = 1). Every block it does not implement raises
``NotImplementedError`` when it is switched on, naming the ``ROADMAP.md``
Queue 1 entry that brings it; keys that neither package knows raise
``ValueError``. ``memory_breakdown`` and ``dump_state`` are parsed and, as
in the JAX package, acted on by nothing; an enabled ``amp`` block is
ignored with a warning, as the JAX config ignores it.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Union

from ..utils.logging import logger
from .config_utils import (AUTO, ConfigBlock, auto_none,
                           dict_raise_error_on_duplicate_keys, unported)
from .zero.config import DeepSpeedZeroConfig

GRADIENT_CLIPPING_DEFAULT = 0.0
STEPS_PER_PRINT_DEFAULT = 10


@dataclasses.dataclass
class FP16Config(ConfigBlock):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


@dataclasses.dataclass
class BF16Config(ConfigBlock):
    enabled: bool = False


@dataclasses.dataclass
class OptimizerConfig(ConfigBlock):
    type: str = "Adam"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    legacy_fusion: bool = False


@dataclasses.dataclass
class SchedulerConfig(ConfigBlock):
    type: Optional[str] = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FaultToleranceConfig(ConfigBlock):
    """The JAX block's fields and defaults: verified atomic checkpoints
    and bounded retry on transient checkpoint I/O
    (``checkpoint/manifest.py``). ``heartbeat_interval`` and
    ``keep_checkpoints`` act under elasticity only, whose block raises
    naming its item."""

    enabled: bool = True
    #: verify the manifest before restoring; on a missing/corrupt/partial
    #: save, walk back to the newest verified one instead of crashing
    verify_on_load: bool = True
    #: sha256 the small files of each save in its manifest (sizes are
    #: always recorded)
    manifest_checksums: bool = True
    heartbeat_interval: int = 1
    #: transient checkpoint-I/O retry policy (bounded exponential backoff)
    save_retries: int = 3
    save_retry_backoff: float = 0.5
    keep_checkpoints: int = 2


@dataclasses.dataclass
class CheckpointConfig(ConfigBlock):
    """The ``checkpoint`` keys the JAX config reads: ``load_universal``
    (``load_checkpoint`` reads a universal directory by default) and
    ``use_node_local_storage`` (read and unused by both packages on one
    host)."""

    load_universal: bool = False
    use_node_local_storage: bool = False


@dataclasses.dataclass
class ProgressiveLayerDropConfig(ConfigBlock):
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclasses.dataclass
class ActivationCheckpointingConfig(ConfigBlock):
    """The JAX block's fields. The engine acts on none of them (as the
    JAX engine does: a model's remat is set in its config);
    ``checkpointing.configure(deepspeed_config=...)`` reads
    ``cpu_checkpointing``, ``profile`` and ``number_checkpoints``."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclasses.dataclass
class AIOConfig(ConfigBlock):
    """The async-IO handle's knobs (the JAX ``AIOConfig``), read by the
    NVMe swap of ``runtime/zero/offload.py``."""

    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclasses.dataclass
class TensorBoardConfig(ConfigBlock):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class CSVConfig(ConfigBlock):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class TracingConfig(ConfigBlock):
    """Switches on the process-global tracer (``monitor/tracing.py``), as
    ``DS_TRACE_DIR`` does: spans of each ``train_batch`` and its step,
    and with ``dir`` the flight recorder's dumps there. ``comm`` (comm
    spans) has nothing to trace on one device."""

    enabled: bool = False
    capacity: int = 8192
    dir: Optional[str] = None
    flight_events: int = 512
    comm: bool = True


def _enabled(block) -> bool:
    return isinstance(block, dict) and bool(block.get("enabled", False))


def _nonempty(block) -> bool:
    return bool(block)


def _parallel(block) -> bool:
    return isinstance(block, dict) and any(
        v not in (1, -1, None, AUTO) for v in block.values())


#: top-level keys of the JAX config that this slice does not implement:
#: (is it switched on?, the Queue 1 entry that brings it)
UNPORTED_BLOCKS = {
    "sparse_gradients": (bool, "the distributed and ZeRO slice (item 9)"),
    "curriculum_learning": (_enabled, "the auxiliary subsystems (item 11)"),
    "quantize_training": (_enabled, "the auxiliary subsystems (item 11)"),
    "compression_training": (_nonempty, "the auxiliary subsystems "
                             "(item 11)"),
    "elasticity": (_enabled, "the auxiliary subsystems (item 11)"),
    "flops_profiler": (_enabled, "the auxiliary subsystems (item 11)"),
    "autotuning": (_enabled, "the auxiliary subsystems (item 11)"),
    "wandb": (_enabled, "no slice: use tensorboard or csv_monitor"),
    "comms_logger": (_enabled, "the distributed and ZeRO slice (item 9)"),
    "parallel": (_parallel, "the distributed and ZeRO slice (item 9)"),
    "pipeline": (lambda v: int((v or {}).get("stages", 1)) > 1,
                 "the distributed and ZeRO slice (item 9): a pipeline of "
                 "more than one stage needs as many devices"),
    "prescale_gradients": (bool, "the distributed and ZeRO slice (item 9)"),
    "gradient_predivide_factor": (lambda v: v != 1.0,
                                  "the distributed and ZeRO slice (item 9)"),
    "communication_data_type": (lambda v: v is not None,
                                "the distributed and ZeRO slice (item 9)"),
    "disable_allgather": (bool, "the distributed and ZeRO slice (item 9)"),
}

PORTED_KEYS = {
    "train_batch_size", "train_micro_batch_size_per_gpu",
    "gradient_accumulation_steps", "steps_per_print", "gradient_clipping",
    "wall_clock_breakdown", "fp16", "bf16", "bfloat16", "optimizer",
    "scheduler", "zero_optimization", "seed", "fault_tolerance",
    "checkpoint", "progressive_layer_drop", "activation_checkpointing",
    "tensorboard", "csv_monitor", "tracing", "memory_breakdown",
    "dump_state", "amp", "moe", "aio",
}


class DeepSpeedConfig:
    """``config``: a path to JSON or a dict. ``world_size`` is the
    data-parallel world used for batch triangulation (1 in this slice)."""

    def __init__(self, config: Union[str, os.PathLike, Dict],
                 world_size: Optional[int] = None):
        if isinstance(config, (str, os.PathLike)):
            with open(config, "r") as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise ValueError(f"Expected a string path or dict, got: "
                             f"{config!r}")
        self.world_size = world_size if world_size is not None else 1
        if self.world_size != 1:
            raise unported(f"data-parallel world size {self.world_size}",
                           "the distributed and ZeRO slice (item 9)")
        self._check_keys(self._param_dict)
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()
        self._do_sanity_check()

    @staticmethod
    def _check_keys(pd: Dict) -> None:
        unknown = sorted(set(pd) - PORTED_KEYS - set(UNPORTED_BLOCKS))
        if unknown:
            raise ValueError(f"unknown DeepSpeed config keys {unknown}")
        for key, (switched_on, entry) in UNPORTED_BLOCKS.items():
            if key in pd and switched_on(pd[key]):
                raise unported(f"config block {key!r}", entry)

    def _initialize_params(self, pd: Dict) -> None:
        get = pd.get
        self.train_batch_size = auto_none(get("train_batch_size"))
        self.train_micro_batch_size_per_gpu = auto_none(
            get("train_micro_batch_size_per_gpu"))
        self.gradient_accumulation_steps = auto_none(
            get("gradient_accumulation_steps"))
        self.steps_per_print = get("steps_per_print", STEPS_PER_PRINT_DEFAULT)
        clip = auto_none(get("gradient_clipping"))
        self.gradient_clipping = GRADIENT_CLIPPING_DEFAULT if clip is None \
            else clip
        self.wall_clock_breakdown = get("wall_clock_breakdown", False)
        self.fp16 = FP16Config.from_dict(get("fp16"), "fp16")
        self.bf16 = BF16Config.from_dict(get("bf16", get("bfloat16")), "bf16")
        if _enabled(get("amp")):
            logger.warning("amp (apex mixed precision) has no counterpart "
                           "here; use bf16 (recommended) or fp16. Ignoring "
                           "the amp block.")
        self.optimizer = OptimizerConfig.from_dict(get("optimizer"),
                                                   "optimizer") \
            if get("optimizer") else None
        self.scheduler = SchedulerConfig.from_dict(get("scheduler"),
                                                   "scheduler") \
            if get("scheduler") else None
        self.zero_config = DeepSpeedZeroConfig.from_dict(
            get("zero_optimization"), "zero_optimization")
        self.zero_optimization_stage = self.zero_config.stage
        self.fault_tolerance = FaultToleranceConfig.from_dict(
            get("fault_tolerance"), "fault_tolerance")
        self.checkpoint = CheckpointConfig.from_dict(get("checkpoint"),
                                                     "checkpoint")
        self.load_universal_checkpoint = self.checkpoint.load_universal
        self.use_node_local_storage = self.checkpoint.use_node_local_storage
        self.progressive_layer_drop = ProgressiveLayerDropConfig.from_dict(
            get("progressive_layer_drop"), "progressive_layer_drop")
        self.activation_checkpointing = \
            ActivationCheckpointingConfig.from_dict(
                get("activation_checkpointing"), "activation_checkpointing")
        self.tensorboard = TensorBoardConfig.from_dict(get("tensorboard"),
                                                       "tensorboard")
        self.csv_monitor = CSVConfig.from_dict(get("csv_monitor"),
                                               "csv_monitor")
        self.tracing = TracingConfig.from_dict(get("tracing"), "tracing")
        self.aio = AIOConfig.from_dict(get("aio"), "aio")
        # the JAX engine reads only ``replicate_tokens`` (its token layout
        # over the expert mesh axis), which changes nothing on one device;
        # other keys are accepted and unread, as there
        self.moe = dict(get("moe") or {})
        # parsed and acted on by neither package
        self.memory_breakdown = get("memory_breakdown", False)
        self.dump_state = get("dump_state", False)
        self.seed = get("seed", 1234)

    def _configure_train_batch_size(self) -> None:
        """Triangulation (the JAX ``config.py:363-401``)."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        dp = max(1, self.world_size)
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
        elif train is not None and gas is not None:
            micro = train // (dp * gas)
        elif micro is not None and gas is not None:
            train = micro * gas * dp
        elif train is not None:
            gas = 1
            micro = train // dp
        elif micro is not None:
            train = micro * dp
            gas = 1
        else:
            raise ValueError("Either train_batch_size or "
                             "train_micro_batch_size_per_gpu needs to be "
                             "provided")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    def _do_sanity_check(self) -> None:
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if not (train > 0 and micro > 0 and gas > 0):
            raise ValueError(f"batch sizes must be positive: train {train}, "
                             f"micro {micro}, gas {gas}")
        if train != micro * gas * self.world_size:
            raise ValueError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {train} != {micro} * {gas} * {self.world_size}")
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 cannot both be enabled")

    @property
    def precision(self) -> str:
        if self.bf16.enabled:
            return "bf16"
        if self.fp16.enabled:
            return "fp16"
        return "fp32"
