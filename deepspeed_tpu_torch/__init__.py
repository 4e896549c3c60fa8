"""deepspeed_tpu_torch: the PyTorch/CUDA port of deepspeed_tpu.

Three paths are ported. Serving: Llama-family models through the
continuous-batching engine's unified mixed step on a hand-written ragged
paged-attention CUDA kernel. Dense generation: ``init_inference`` ->
``InferenceEngine.generate`` over a contiguous KV cache, on hand-written
decode-attention and, with ``quantize_weights`` ("int8" / "int4"),
quantized-matmul CUDA kernels (the serving step takes quantized weights
too, and both take the legacy grouped ``quantize``); the Llama, GPT-2
and the generic transformer's families (OPT, BLOOM, GPT-NeoX, BERT,
GPT-J, GPT-Neo, Falcon, Phi), from HF models or HF directories. Training: ``initialize`` -> ``train_batch`` on one device (a port
model or any ``nn.Module``; remat policies, the chunked loss, padded
batches, progressive layer drop, a client optimizer, ``loss_fn`` and
``training_data``), with hand-written flash-attention (forward and
backward) and fused-Adam CUDA kernels; ``checkpointing`` is the
activation-checkpointing API. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from . import checkpointing  # noqa: F401

from .inference.engine import init_inference  # noqa: F401
from .inference.serving.engine import (ServingConfig,  # noqa: F401
                                       ServingEngine, init_serving)
from .runtime.config import DeepSpeedConfig  # noqa: F401
from .runtime.engine import DeepSpeedEngine, initialize  # noqa: F401
from .utils.logging import log_dist  # noqa: F401
