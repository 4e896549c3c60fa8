"""Inference engine configuration.

Counterpart of ``deepspeed_tpu/inference/config.py``: the keyword surface
of ``init_inference``. ``dtype`` resolves to a torch dtype. Knobs that
this port does not implement yet raise ``NotImplementedError`` naming the
slice that brings them (ROADMAP.md Queue 1).
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
    #: expert parallelism for MoE models
    ep_size: int = 1
    dtype: Any = None
    #: DeepSpeed's kernel-injection switch. A port model (and an injected
    #: HF model, which becomes one) always runs the port's kernels, so
    #: either value is accepted
    replace_with_kernel_inject: bool = True
    #: HF module-injection policy (a ``module_inject`` ``DSPolicy`` class
    #: or instance; None = matched from the model or its config)
    injection_policy: Optional[Any] = None
    #: a directory written by ``checkpoint.engine.save_pytree`` (a
    #: ``state_dict`` or a flax params tree): the weights when ``params``
    #: is not given; or an HF checkpoint directory (a ``config.json``):
    #: the model and its weights
    checkpoint: Optional[str] = None
    #: kernel-injection workspace batch (the JAX engine reads it nowhere;
    #: serving sizes its batch in ServingConfig)
    max_batch_size: int = 8
    #: static KV-cache capacity (accepted as in the JAX package; generate
    #: sizes its cache from the request)
    max_out_tokens: int = 1024
    #: legacy grouped int8 weight quantization (``compression/
    #: quantization.py``): every floating leaf of the JAX param tree with
    #: at least 4096 elements is quantized to int8 codes in
    #: ``quantize_groups`` groups at init and bound dequantized to the
    #: compute dtype (``dtype=int8`` sets it; the compute dtype is then bf16)
    quantize: bool = False
    #: groups of the legacy quantize (at most; at least 128 elements each)
    quantize_groups: int = 32
    #: accepted as in the JAX package, where it dequantizes again inside
    #: each decode step; the port binds the dequantized weights once, which
    #: are the same values every step, so it changes nothing here
    dequant_per_step: bool = False
    #: int8 KV cache / pool: absmax-quantized per (position, kv head) at
    #: append, dequantized per tile inside the attention kernels
    kv_cache_int8: bool = False
    #: quantized projection weights ("int8" | "int4" | None): quantized at
    #: init_inference (inference/quant.py), multiplied by kernel K5
    quantize_weights: Optional[str] = None
    #: scale-group length along K for quantize_weights (0 = per-column for
    #: int8, 64 for int4)
    quantize_group_size: int = 0
    #: int8 payloads for the tensor-parallel all-reduce
    quantized_collectives: bool = False
    #: values per scale of the quantized all-reduce
    quantized_psum_block: int = 256
    #: HF module-injection method ("auto" matches a policy; accepted as
    #: the JAX package accepts it)
    replace_method: str = "auto"
    #: on a CUDA device, capture ``generate``'s decode step (one graph per
    #: batch and cache length) and the serving engine's unified step (one
    #: graph per packed width) as CUDA graphs over static buffers and
    #: replay them; on the CPU the same static-buffer code runs uncaptured.
    #: The JAX package accepts it for parity (XLA always compiles)
    enable_cuda_graph: bool = False
    #: the JAX package's escape hatch for tensor-parallel degrees above the
    #: kv heads
    allow_unsafe_tp: bool = False
    #: bucket generate() shapes to powers of two (prompts left-padded, new
    #: tokens over-generated and trimmed)
    bucket_shapes: bool = True
    #: shapes <= this run exactly; larger ones pad to the next power of two
    bucket_min: int = 8
    #: "while" stops decoding the step every row has emitted EOS (with an
    #: eos_token_id); "scan" always runs every step
    decode_loop: str = "while"

    def __post_init__(self):
        if self.decode_loop not in ("while", "scan"):
            raise ValueError(f"decode_loop must be 'while' or 'scan', got "
                             f"{self.decode_loop!r}")
        if self.quantize_weights not in (None, "int8", "int4"):
            raise ValueError(
                f"quantize_weights must be None, 'int8' or 'int4', got "
                f"{self.quantize_weights!r}")
        self.dtype = resolve_dtype(self.dtype)
        # dtype=int8 means weight quantization, never a value cast of the
        # float weights to int8 (the reference sets quantize for it)
        if self.dtype == torch.int8:
            self.quantize = True
        # after the dtype=int8 set, so dtype="int8" with quantize_weights
        # cannot slip past as a doubly quantized tree
        if self.quantize_weights and self.quantize:
            raise ValueError(
                "quantize_weights and the legacy grouped-flat quantize are "
                "mutually exclusive (quantize_weights keeps the tree "
                "TP-sliceable; quantize flattens it)")
        if isinstance(self.quantize_groups, bool) or \
                not isinstance(self.quantize_groups, int) or \
                self.quantize_groups < 1:
            raise ValueError(f"quantize_groups must be a positive int, got "
                             f"{self.quantize_groups!r}")
        if self.mp_size != 1:
            raise NotImplementedError(
                "mp_size > 1 (tensor parallelism) arrives with the "
                "distributed slice of the port (ROADMAP.md Queue 1, item 9)")
        if self.quantized_collectives:
            raise NotImplementedError(
                "quantized_collectives arrives with the distributed slice "
                "of the port (ROADMAP.md Queue 1, item 9)")
        # JAX knobs that are no-ops for a port model at these values (the
        # JAX defaults); any other value raises naming its slice
        for name, off, slice_name, item in _LATER:
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} arrives with the "
                    f"{slice_name} slice of the port (ROADMAP.md Queue 1, "
                    f"item {item})")


#: (field, accepted value, slice, ROADMAP.md Queue 1 item)
_LATER = (
    ("ep_size", 1, "distributed", "9"),
    ("quantized_psum_block", 256, "distributed", "9"),
    ("allow_unsafe_tp", False, "distributed", "9"),
)
