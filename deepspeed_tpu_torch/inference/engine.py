"""Inference engine: a model definition bound to its weights on one device.

Counterpart of ``deepspeed_tpu/inference/engine.py`` for the serving
path: ``init_inference`` casts the params to ``dtype``, binds them to the
model on the chosen device, and hands the engine to the serving layer.
The entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device they raise rather than quietly
running on the CPU.
"""

from typing import Dict, Optional

import torch
from torch import nn

from ..utils.logging import log_dist
from .config import DeepSpeedInferenceConfig


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 << max(0, (n - 1).bit_length())


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is present); any
    explicit device is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepspeed_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _sample_logits(logits, generator: Optional[torch.Generator],
                   do_sample: bool, temperature: float, top_k: int,
                   top_p: float):
    """Greedy / temperature / top-k / top-p sampling over the last axis;
    the random draw comes from ``generator``."""
    if not do_sample:
        return logits.argmax(dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = logits.topk(top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e9)
    if top_p and top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = sorted_logits.softmax(dim=-1)
        cum = probs.cumsum(dim=-1)
        # keep tokens whose prefix mass (exclusive) is < top_p; the cutoff
        # is the smallest KEPT logit
        cutoff = torch.where((cum - probs) >= top_p,
                             torch.full_like(sorted_logits, float("inf")),
                             sorted_logits).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, -1e9)
    probs = logits.softmax(dim=-1).reshape(-1, logits.shape[-1])
    return torch.multinomial(probs, 1, generator=generator).reshape(
        logits.shape[:-1])


class InferenceEngine:
    """A model with its weights cast to ``config.dtype`` on ``device``.
    Construct via :func:`init_inference`."""

    def __init__(self, module: nn.Module, params: Dict[str, torch.Tensor],
                 config: DeepSpeedInferenceConfig, device=None):
        self.device = resolve_device(device)
        self.config = config
        dtype = config.dtype
        cast = {name: p.to(device=self.device,
                           dtype=dtype if p.is_floating_point() else p.dtype)
                for name, p in params.items()}
        module.load_state_dict(cast, strict=True, assign=True)
        module.eval().requires_grad_(False)
        self.module = module
        log_dist(f"InferenceEngine: device={self.device}, dtype={dtype}",
                 ranks=[0])

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.config.dtype


def init_inference(model=None, config=None, mp_size: Optional[int] = None,
                   dtype=None, checkpoint: Optional[str] = None, params=None,
                   quantize: Optional[bool] = None, device=None,
                   **kwargs) -> InferenceEngine:
    """Bind ``params`` (a ``state_dict``) to ``model`` (a port model such as
    :class:`~deepspeed_tpu_torch.models.llama.LlamaForCausalLM`). ``config``
    may be a dict or a :class:`DeepSpeedInferenceConfig`; keyword arguments
    override it. Runs on ``cuda`` unless ``device`` says otherwise."""
    if isinstance(config, DeepSpeedInferenceConfig):
        cfg = config
    else:
        merged = dict(config or {})
        for k, v in [("mp_size", mp_size), ("dtype", dtype),
                     ("checkpoint", checkpoint), ("quantize", quantize)]:
            if v is not None:
                merged[k] = v
        merged.update(kwargs)
        known = {f.name for f in
                 DeepSpeedInferenceConfig.__dataclass_fields__.values()}
        unknown = sorted(set(merged) - known)
        if unknown:
            raise TypeError(f"init_inference: unknown options {unknown}")
        cfg = DeepSpeedInferenceConfig(**merged)
    device = resolve_device(device)
    if not isinstance(model, nn.Module) or \
            not hasattr(model, "init_paged_cache"):
        raise NotImplementedError(
            "init_inference takes a port model (deepspeed_tpu_torch.models); "
            "HF module injection arrives with the dense-inference slice "
            "(ROADMAP.md Queue 1)")
    if params is None:
        raise ValueError("init_inference needs params (a state_dict)")
    return InferenceEngine(model, params, cfg, device=device)
