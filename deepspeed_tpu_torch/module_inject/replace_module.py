"""Model replacement entry point: an HF torch model, or an HF checkpoint
directory, as the port's model and its ``state_dict``.

Counterpart of ``deepspeed_tpu/module_inject/replace_module.py``. The
conversion is out of place (the HF model is not changed) and torch to
torch (``replace_policy.convert_tensor``). A checkpoint directory is read
one shard at a time, and each shard's tensors are cast and moved to the
device as they are read, so the host holds about one shard, never the
whole model in fp32. ``transformers`` and ``safetensors`` are imported
only here, inside the functions that read a directory.
"""

import json
import os
from typing import Any, Optional, Tuple

import torch

from ..utils.logging import log_dist
from .replace_policy import DSPolicy, convert_shards, match_policy


def replace_transformer_layer(model, policy: Optional[Any] = None
                              ) -> Tuple[Any, Any]:
    """An HF torch model -> ``(port model, state_dict)``. ``policy`` may be
    a ``DSPolicy`` instance or class, or None to match one
    (``replace_method='auto'``). The tensors keep the HF model's dtype and
    device; ``init_inference`` casts and moves them."""
    if policy is None:
        policy = match_policy(model)
        if policy is None:
            raise ValueError(
                f"No injection policy for {type(model).__name__}; known: "
                "GPT2, Llama/Mistral, Qwen2, Gemma, Mixtral, OPT, BLOOM, "
                "GPT-NeoX, BERT, GPT-J, GPT-Neo, Falcon, Phi. Pass policy= "
                "explicitly.")
    elif isinstance(policy, type):
        policy = policy()
    if not isinstance(policy, DSPolicy):
        raise TypeError(f"policy must be a DSPolicy, got {type(policy)}")
    log_dist(f"module_inject: converting {type(model).__name__} via "
             f"{type(policy).__name__}", ranks=[0])
    return policy.convert(model)


def _match_policy_by_config(hf_config):
    """Policy discovery from an HF config alone (no torch module needed):
    its ``architectures`` and ``model_type`` against each registered
    policy, in order."""
    from .replace_policy import generic_policies

    names = list(getattr(hf_config, "architectures", None) or [])
    names.append(getattr(hf_config, "model_type", None))
    for policy_cls in generic_policies:
        if any(n in policy_cls.hf_model_types for n in names if n):
            return policy_cls
    return None


class _SafetensorsShard:
    """One ``.safetensors`` file as a mapping that reads a tensor when it
    is asked for (``safetensors.safe_open``), so a shard is never read
    whole into host memory."""

    def __init__(self, path: str):
        from safetensors import safe_open

        self._file = safe_open(path, framework="pt", device="cpu")
        self._names = list(self._file.keys())

    def __iter__(self):
        return iter(self._names)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._file.get_tensor(name)


def _load_shard(path: str):
    if path.endswith(".safetensors"):
        return _SafetensorsShard(path)
    sd = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return sd.get("state_dict", sd) if isinstance(sd, dict) else sd


def _iter_checkpoint_shards(ckpt_dir: str):
    """Yield the state-dict fragments of an HF checkpoint directory, one
    shard at a time: a sharded ``*.index.json`` layout (its shards in
    sorted order) or a single file; ``.safetensors`` through
    ``safetensors`` (a tensor read when it is asked for), ``.bin`` through
    ``torch.load(weights_only=True)`` (memory-mapped)."""
    for index_name in ("model.safetensors.index.json",
                       "pytorch_model.bin.index.json"):
        idx = os.path.join(ckpt_dir, index_name)
        if os.path.exists(idx):
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            for shard in sorted(set(weight_map.values())):
                yield _load_shard(os.path.join(ckpt_dir, shard))
            return
    for single in ("model.safetensors", "pytorch_model.bin"):
        path = os.path.join(ckpt_dir, single)
        if os.path.exists(path):
            yield _load_shard(path)
            return
    raise FileNotFoundError(
        f"no model weights found in {ckpt_dir} (expected model.safetensors, "
        "pytorch_model.bin, or a sharded *.index.json layout)")


def load_checkpoint_dir(ckpt_dir: str, policy: Optional[Any] = None,
                        dtype=None, device=None) -> Tuple[Any, Any]:
    """An HF checkpoint directory -> ``(port model, state_dict)`` without
    building the HF torch model: ``transformers.AutoConfig`` reads its
    ``config.json``, the policy is matched from it (or given), and the
    weights are converted shard by shard, each tensor cast to ``dtype``
    and moved to ``device`` (when given) as it is read."""
    import transformers

    hf_config = transformers.AutoConfig.from_pretrained(ckpt_dir)
    if policy is None:
        policy = _match_policy_by_config(hf_config)
        if policy is None:
            raise ValueError(f"No injection policy for checkpoint {ckpt_dir} "
                             f"(architectures={hf_config.architectures})")
    if not isinstance(policy, type):
        policy = type(policy)
    if not (isinstance(policy, type) and issubclass(policy, DSPolicy)):
        raise TypeError(f"policy must be a DSPolicy, got {policy}")
    log_dist(f"module_inject: loading {ckpt_dir} "
             f"({hf_config.architectures}) via {policy.__name__}", ranks=[0])
    return convert_shards(policy, hf_config, _iter_checkpoint_shards(ckpt_dir),
                          dtype, device)


def revert_transformer_layer(*args, **kwargs):
    """DeepSpeed reverts injected modules. The conversion here is out of
    place (the HF model is untouched), so there is nothing to revert."""
    raise NotImplementedError(
        "conversion is out-of-place; the original HF model is unmodified")
