"""ZeRO configuration.

Counterpart of ``deepspeed_tpu/runtime/zero/config.py``. This slice of the
port trains on one device with unsharded state, so it takes ``stage`` 0
only; a higher stage, an offload block or the explicit overlap lane raise
``NotImplementedError``. The bucket and prefetch knobs act only when a
stage shards, so at stage 0 they are accepted and have nothing to steer.
"""

import dataclasses
from typing import Any, Optional

from ..config_utils import ConfigBlock, unported


@dataclasses.dataclass
class DeepSpeedZeroConfig(ConfigBlock):
    stage: int = 0
    offload_param: Optional[Any] = None
    offload_optimizer: Optional[Any] = None
    overlap_grad_sync: bool = False
    cpu_offload: Optional[bool] = None
    cpu_offload_param: Optional[bool] = None
    cpu_offload_use_pin_memory: Optional[bool] = None
    # knobs of the sharding stages (no effect at stage 0)
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
        if self.stage > 0:
            raise unported(f"zero_optimization.stage={self.stage}",
                           "the distributed and ZeRO slice (item 9)")

        def on(block):
            device = block.get("device", "none") if isinstance(block, dict) \
                else block
            return device not in (None, "none", False)

        if on(self.offload_optimizer) or on(self.offload_param) or \
                self.cpu_offload or self.cpu_offload_param:
            raise unported("zero_optimization offload_optimizer/offload_param",
                           "the offload slice (item 11)")
        if self.overlap_grad_sync:
            raise unported("zero_optimization.overlap_grad_sync",
                           "the distributed and ZeRO slice (item 9)")
