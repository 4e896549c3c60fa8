"""Inference engine configuration.

Counterpart of ``deepspeed_tpu/inference/config.py``: the keyword surface
of ``init_inference``. ``dtype`` resolves to a torch dtype. Knobs that
this slice of the port does not implement raise ``NotImplementedError``
naming the slice that brings them (ROADMAP.md Queue 1).
"""

import dataclasses
from typing import Any, Optional

import torch

_DTYPES = {
    "fp32": torch.float32, "float32": torch.float32,
    "fp16": torch.float16, "float16": torch.float16, "half": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}


def resolve_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype.lower() in _DTYPES:
        return _DTYPES[dtype.lower()]
    raise ValueError(f"unknown dtype {dtype!r}; use one of {sorted(_DTYPES)} "
                     f"or a torch.dtype")


@dataclasses.dataclass
class DeepSpeedInferenceConfig:
    #: tensor-parallel degree
    mp_size: int = 1
    dtype: Any = None
    checkpoint: Optional[str] = None
    #: legacy grouped int8 weight quantization
    quantize: bool = False
    #: int8 KV pool: absmax-quantized per (position, kv head) at append,
    #: dequantized per page inside the attention kernel
    kv_cache_int8: bool = False
    #: quantized projection weights ("int8" | "int4" | None)
    quantize_weights: Optional[str] = None
    #: int8 payloads for the tensor-parallel all-reduce
    quantized_collectives: bool = False

    def __post_init__(self):
        self.dtype = resolve_dtype(self.dtype)
        if self.mp_size != 1:
            raise NotImplementedError(
                "mp_size > 1 (tensor parallelism) arrives with the "
                "distributed slice of the port (ROADMAP.md Queue 1)")
        if self.quantize or self.dtype == torch.int8 or \
                self.quantize_weights or self.quantized_collectives:
            raise NotImplementedError(
                "quantize / dtype=int8 / quantize_weights / "
                "quantized_collectives arrive with the quantized-inference "
                "slice of the port (ROADMAP.md Queue 1)")
        if self.checkpoint is not None:
            raise NotImplementedError(
                "checkpoint= arrives with the checkpoint slice of the port "
                "(ROADMAP.md Queue 1); pass params= (a state_dict)")
