"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

This slice serves Llama-family models through the continuous-batching
engine's unified mixed step on a hand-written ragged paged-attention CUDA
kernel. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""

from .inference.engine import init_inference  # noqa: F401
from .inference.serving.engine import (ServingConfig,  # noqa: F401
                                       ServingEngine, init_serving)
from .utils.logging import log_dist  # noqa: F401
