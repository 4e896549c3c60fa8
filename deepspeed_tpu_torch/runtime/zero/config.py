"""ZeRO configuration.

Counterpart of ``deepspeed_tpu/runtime/zero/config.py``. The port trains
on one device: ``stage`` 1-3 there shard nothing (the JAX engine on a
one-device mesh computes what stage 0 computes), so every stage takes the
same step. The offload blocks are ported: ``offload_optimizer`` moves the
fp32 masters and the optimizer state to the host (``runtime/zero/
offload.py``), ``offload_param`` with a ``PipelineModule`` streams the
body's parameters through the card (``runtime/zero/infinity.py``). The
explicit overlap lane raises ``NotImplementedError`` naming its item; the
bucket and prefetch knobs act only when a stage shards, so they are
accepted and have nothing to steer.
"""

import dataclasses
from typing import Any, Optional

from ..config_utils import ConfigBlock, unported

OFFLOAD_DEVICES = ("none", "cpu", "nvme")


@dataclasses.dataclass
class DeepSpeedZeroOffloadParamConfig(ConfigBlock):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False
    #: body layers streamed as one block by the ZeroInfinityEngine
    block_layers: int = 2

    def __post_init__(self):
        _check_device(self.device, "offload_param")
        if int(self.block_layers) < 1:
            raise ValueError(f"offload_param.block_layers must be >= 1, got "
                             f"{self.block_layers}")
        for name in ("buffer_count", "buffer_size", "max_in_cpu"):
            if int(getattr(self, name)) < 0:
                raise ValueError(f"offload_param.{name} must be >= 0")


@dataclasses.dataclass
class DeepSpeedZeroOffloadOptimizerConfig(ConfigBlock):
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False

    def __post_init__(self):
        _check_device(self.device, "offload_optimizer")
        if int(self.buffer_count) < 0:
            raise ValueError("offload_optimizer.buffer_count must be >= 0")


def _check_device(device, block: str) -> None:
    if device not in OFFLOAD_DEVICES:
        raise ValueError(f"{block}.device must be one of {OFFLOAD_DEVICES}, "
                         f"got {device!r}")


def offload_on(block) -> bool:
    """True for an offload block whose device is ``cpu`` or ``nvme``."""
    return block is not None and block.device != "none"


@dataclasses.dataclass
class DeepSpeedZeroConfig(ConfigBlock):
    stage: int = 0
    offload_param: Optional[Any] = None
    offload_optimizer: Optional[Any] = None
    overlap_grad_sync: bool = False
    cpu_offload: Optional[bool] = None
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    # knobs of the sharding stages (nothing to shard on one device)
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    sub_group_size: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False

    def __post_init__(self):
        self.stage = int(self.stage)
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0-3, got "
                             f"{self.stage}")
        if isinstance(self.offload_param, dict):
            self.offload_param = DeepSpeedZeroOffloadParamConfig.from_dict(
                self.offload_param, "offload_param")
        if isinstance(self.offload_optimizer, dict):
            self.offload_optimizer = \
                DeepSpeedZeroOffloadOptimizerConfig.from_dict(
                    self.offload_optimizer, "offload_optimizer")
        # the deprecated switches (the JAX config's aliases)
        pin = bool(self.cpu_offload_use_pin_memory)
        if self.cpu_offload:
            self.offload_optimizer = DeepSpeedZeroOffloadOptimizerConfig(
                device="cpu", pin_memory=pin)
        if self.cpu_offload_param:
            self.offload_param = DeepSpeedZeroOffloadParamConfig(
                device="cpu", pin_memory=pin)
        if self.overlap_comm is None:
            self.overlap_comm = self.stage >= 1
        if self.overlap_grad_sync:
            raise unported("zero_optimization.overlap_grad_sync",
                           "the distributed and ZeRO slice (item 9)")
