"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

Three paths are ported. Serving: Llama-family models through the
continuous-batching engine's unified mixed step on a hand-written ragged
paged-attention CUDA kernel. Dense generation: ``init_inference`` ->
``InferenceEngine.generate`` over a contiguous KV cache, on hand-written
decode-attention and, with ``quantize_weights`` ("int8" / "int4"),
quantized-matmul CUDA kernels (the serving step takes quantized weights
too, and both take the legacy grouped ``quantize``); the Llama, Mixtral,
GPT-2 and the generic transformer's families (OPT, BLOOM, GPT-NeoX,
BERT, GPT-J, GPT-Neo, Falcon, Phi), from HF models or HF directories,
and Megatron-LM checkpoints (``module_inject.replace_policy.
MegatronLayerPolicy``). Training: ``initialize`` -> ``train_batch`` on
one device (a port model, Mixtral's sparse MoE included, or any
``nn.Module``, with the GShard ``moe.MoE`` layer; remat policies, the
chunked loss, padded batches, progressive layer drop, a client
optimizer, ``loss_fn`` and ``training_data``), with hand-written
flash-attention (forward and backward) and fused-Adam CUDA kernels;
``checkpointing`` is the activation-checkpointing API. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .version import __version__  # noqa: F401

from . import checkpointing  # noqa: F401

from .inference.engine import InferenceEngine, init_inference  # noqa: F401
from .inference.serving.engine import (ServingConfig,  # noqa: F401
                                       ServingEngine, init_serving)
from .runtime.config import DeepSpeedConfig  # noqa: F401
from .runtime.engine import DeepSpeedEngine, initialize  # noqa: F401
from .utils.logging import log_dist, logger  # noqa: F401


def add_config_arguments(parser):
    """The DeepSpeed arguments on an ``argparse`` parser (the JAX
    package's and the reference's ``deepspeed/__init__.py:209``)."""
    group = parser.add_argument_group("DeepSpeed-TPU",
                                      "DeepSpeed-TPU configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed-TPU (helper flag for argument "
                            "parsing)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="Path to the DeepSpeed-TPU json configuration "
                            "file")
    group.add_argument("--deepscale", default=False, action="store_true",
                       help=argparse_suppress())
    return parser


def argparse_suppress():
    import argparse

    return argparse.SUPPRESS


#: namespaces imported when first asked for
_LAZY_MODULES = {"moe": ".moe", "module_inject": ".module_inject",
                 "ops": ".ops"}
_LAZY_NAMES = {"RejectedError": (".inference.serving", "RejectedError")}


def __getattr__(name):
    import importlib

    if name in _LAZY_MODULES:
        mod = importlib.import_module(_LAZY_MODULES[name], __name__)
        globals()[name] = mod
        return mod
    if name in _LAZY_NAMES:
        modname, attr = _LAZY_NAMES[name]
        val = getattr(importlib.import_module(modname, __name__), attr)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_MODULES) | set(_LAZY_NAMES))
