"""Convert a JAX (flax) Llama param tree into the port's ``state_dict``.

The tree holds numpy arrays (``jax.device_get`` of the JAX package's
params); nothing here imports JAX. Layout of the tree:

- scanned layers are stacked ``[L, ...]`` under ``model/layers/block/...``,
  or live under ``model/layers_{i}/...`` when ``scan_layers=False``;
- a Dense ``kernel`` is ``[in, out]`` where ``nn.Linear.weight`` is
  ``[out, in]``; a Dense ``bias`` and an RMSNorm ``scale`` map as they are;
- ``model/embed_tokens/embedding`` is ``[V, hidden]``, like
  ``nn.Embedding.weight``;
- ``lm_head/kernel`` is absent with tied embeddings.
"""

from typing import Any, Dict

import numpy as np
import torch

_PROJ = {"self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
         "mlp": ("gate_proj", "up_proj", "down_proj")}
_NORMS = ("input_layernorm", "post_attention_layernorm")


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: numpy has no native one
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def flax_to_torch_state_dict(params_np: Dict[str, Any],
                             config) -> Dict[str, torch.Tensor]:
    """``params_np``: the flax ``params`` tree of a ``LlamaForCausalLM``
    (numpy leaves); ``config``: the port's ``LlamaConfig``. Returns the
    ``state_dict`` of the port's ``LlamaForCausalLM``."""
    model = params_np["model"]
    L = config.num_hidden_layers
    if "layers" in model:
        block = model["layers"]["block"]
        layers = [_index_tree(block, i) for i in range(L)]
    else:
        layers = [model[f"layers_{i}"] for i in range(L)]
    sd = {"model.embed_tokens.weight": _t(model["embed_tokens"]["embedding"]),
          "model.norm.weight": _t(model["norm"]["scale"])}
    for i, layer in enumerate(layers):
        pre = f"model.layers.{i}."
        for norm in _NORMS:
            sd[pre + norm + ".weight"] = _t(layer[norm]["scale"])
        for group, names in _PROJ.items():
            for name in names:
                dense = layer[group][name]
                sd[f"{pre}{group}.{name}.weight"] = _t(dense["kernel"]).T \
                    .contiguous()
                if "bias" in dense:
                    sd[f"{pre}{group}.{name}.bias"] = _t(dense["bias"])
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = _t(params_np["lm_head"]["kernel"]).T \
            .contiguous()
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]
