"""Convert between a JAX (flax) Llama, Mixtral, GPT-2 or generic
transformer param tree and the port's ``state_dict``.

The tree holds numpy arrays (``jax.device_get`` of the JAX package's
params); nothing here imports JAX. Layout of the tree:

- scanned layers are stacked ``[L, ...]`` under ``model/layers/block/...``,
  or live under ``model/layers_{i}/...`` when ``scan_layers=False``;
- a Dense ``kernel`` is ``[in, out]`` where ``nn.Linear.weight`` is
  ``[out, in]``; a Dense ``bias`` and an RMSNorm ``scale`` map as they are;
- ``model/embed_tokens/embedding`` is ``[V, hidden]``, like
  ``nn.Embedding.weight``;
- ``lm_head/kernel`` is absent with tied embeddings;
- a quantized tree (the JAX ``quantize_param_tree``'s output) holds int8
  or packed-int4 codes under a projection's ``kernel`` and fp32 scales
  under its ``wscale``: they map to ``qweight`` (NOT transposed: the codes
  keep the ``[K, N]`` layout ``QuantLinear`` reads) and ``wscale``;
- a GPT-2 tree holds ``wte``, ``wpe``, ``ln_f`` and the blocks under
  ``h/block`` (scanned) or ``h_{i}``, with ``ln_1``/``ln_2`` LayerNorms
  (``scale``, ``bias``) and the ``attn/c_attn``, ``attn/c_proj``,
  ``mlp/c_fc``, ``mlp/c_proj`` Denses; the port names them as HF does;
- a Mixtral tree has no ``mlp``: its ``block_sparse_moe`` holds the
  router Dense ``gate`` and the stacked experts ``w1``, ``w3`` ``[E, H,
  I]`` and ``w2`` ``[E, I, H]``, which the port keeps in that layout
  (``[L, E, ...]`` scanned);
- a generic transformer's tree (``models/transformer.py``, and the
  ``layer/...`` tree of ``DeepSpeedTransformerLayer``) maps path for path:
  the port's names are its flax paths (a LayerNorm's ``scale`` and an
  ``embedding`` become ``weight``, the MLM head's ``mlm_bias`` stays).

The reverse, :func:`flax_leaves`, names each flax leaf of an fp
``state_dict`` and gives it as a :class:`LeafView` over the port's tensors:
the per-layer tensors are stacked (scanned layers) and the ``[out, in]``
weights transposed only when the leaf is read, one leaf at a time, so a
caller that streams the leaves (a checkpoint save) holds one stacked leaf
at a time. The same views write a leaf back into the port's tensors in
place (a checkpoint load). :func:`torch_to_flax` reads them all into a
nested numpy tree.
"""

import re
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_PROJ = {"self_attn": ("q_proj", "k_proj", "v_proj", "o_proj"),
         "mlp": ("gate_proj", "up_proj", "down_proj")}
_NORMS = ("input_layernorm", "post_attention_layernorm")
#: a Mixtral layer's stacked expert weights (kept in the flax layout)
_EXPERTS = ("w1", "w2", "w3")
#: the generic transformer's LayerNorms and embeddings (by module name)
_GENERIC_NORMS = ("ln_attn", "ln_mlp", "embed_ln", "final_ln", "mlm_ln")
_GENERIC_EMBEDS = ("embed_positions", "token_type_embeddings")


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: numpy has no native one
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _dense(sd, name: str, dense) -> None:
    """One flax Dense (``kernel [in, out]``, optional ``bias``; quantized:
    codes under ``kernel`` and fp32 ``wscale``) into ``sd`` under the
    ``nn.Linear`` / ``QuantLinear`` names ``<name>.weight`` / ``.qweight``,
    ``.wscale``, ``.bias``."""
    if "wscale" in dense:
        sd[f"{name}.qweight"] = _t(dense["kernel"])
        sd[f"{name}.wscale"] = _t(dense["wscale"]).float()
    else:
        sd[f"{name}.weight"] = _t(dense["kernel"]).T.contiguous()
    if "bias" in dense:
        sd[f"{name}.bias"] = _t(dense["bias"])


def flax_to_torch_state_dict(params_np: Dict[str, Any],
                             config) -> Dict[str, torch.Tensor]:
    """``params_np``: the flax ``params`` tree (numpy leaves) of a JAX
    ``LlamaForCausalLM``, ``MixtralForCausalLM``, ``GPT2LMHeadModel``,
    generic ``TransformerLMHeadModel`` / ``TransformerForMaskedLM`` or
    ``DeepSpeedTransformerLayer``; ``config``: the port's config of that
    model (``LlamaConfig``, ``MixtralConfig``, ``GPT2Config``,
    ``TransformerConfig`` or ``DeepSpeedTransformerConfig``), which picks
    the mapping. Returns the port model's ``state_dict``."""
    from ..models import GPT2Config
    from ..models.transformer import TransformerConfig
    from ..ops.transformer import DeepSpeedTransformerConfig

    if isinstance(config, GPT2Config):
        return _gpt2_state_dict(params_np, config)
    if isinstance(config, (TransformerConfig, DeepSpeedTransformerConfig)):
        return _generic_state_dict(params_np, config)
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
                if group in layer:
                    _dense(sd, f"{pre}{group}.{name}", layer[group][name])
        if "block_sparse_moe" in layer:
            moe = layer["block_sparse_moe"]
            _dense(sd, f"{pre}block_sparse_moe.gate", moe["gate"])
            for w in _EXPERTS:
                sd[f"{pre}block_sparse_moe.{w}"] = _t(moe[w])
    if not config.tie_word_embeddings:
        sd["lm_head.weight"] = _t(params_np["lm_head"]["kernel"]).T \
            .contiguous()
    return sd


def _gpt2_state_dict(params_np: Dict[str, Any],
                     config) -> Dict[str, torch.Tensor]:
    """A JAX ``GPT2LMHeadModel``'s params (layers stacked under
    ``h/block`` when scanned, else under ``h_{i}``) as the port's
    ``state_dict`` (HF's names; the head is tied to ``wte``)."""
    L = config.n_layer
    if "h" in params_np:
        layers = [_index_tree(params_np["h"]["block"], i) for i in range(L)]
    else:
        layers = [params_np[f"h_{i}"] for i in range(L)]
    sd = {"transformer.wte.weight": _t(params_np["wte"]["embedding"]),
          "transformer.wpe.weight": _t(params_np["wpe"]["embedding"])}
    for i, layer in enumerate(layers):
        pre = f"transformer.h.{i}."
        for norm in ("ln_1", "ln_2"):
            sd[f"{pre}{norm}.weight"] = _t(layer[norm]["scale"])
            sd[f"{pre}{norm}.bias"] = _t(layer[norm]["bias"])
        for group, name in (("attn", "c_attn"), ("attn", "c_proj"),
                            ("mlp", "c_fc"), ("mlp", "c_proj")):
            _dense(sd, f"{pre}{group}.{name}", layer[group][name])
    sd["transformer.ln_f.weight"] = _t(params_np["ln_f"]["scale"])
    sd["transformer.ln_f.bias"] = _t(params_np["ln_f"]["bias"])
    return sd


#: flax leaf name -> (the ``state_dict`` attribute, transposed)
_GENERIC_LEAVES = {"kernel": ("weight", True), "scale": ("weight", False),
                   "embedding": ("weight", False), "bias": ("bias", False),
                   "mlm_bias": ("mlm_bias", False)}
_SCANNED = re.compile(r"^model/layers/block/(.+)$")
_UNSCANNED = re.compile(r"^model/layers_(\d+)/(.+)$")


def _generic_state_dict(params_np: Dict[str, Any],
                        config) -> Dict[str, torch.Tensor]:
    """A generic transformer's (or layer's) flax tree as the port's
    ``state_dict``: every flax path is the port name with ``/`` for ``.``,
    scanned layers ``model/layers/block/...`` stacked ``[L, ...]`` become
    ``model.layers.{i}....``, unscanned ``model/layers_{i}/...`` too; a
    ``kernel`` becomes the transposed ``weight``, a LayerNorm ``scale`` and
    an ``embedding`` the ``weight``."""
    sd: Dict[str, torch.Tensor] = {}

    def emit(path: str, value):
        *owner, leaf = path.split("/")
        attr, transpose = _GENERIC_LEAVES[leaf]
        name = ".".join(owner + [attr])
        t = _t(value)
        sd[name] = t.T.contiguous() if transpose else t

    def walk(tree, path):
        for key, value in tree.items():
            p = f"{path}/{key}" if path else key
            if isinstance(value, dict):
                walk(value, p)
                continue
            m = _SCANNED.match(p)
            if m:
                for i in range(np.asarray(value).shape[0]):
                    emit(f"model/layers/{i}/{m.group(1)}", value[i])
                continue
            m = _UNSCANNED.match(p)
            emit(f"model/layers/{m.group(1)}/{m.group(2)}" if m else p, value)

    walk(params_np, "")
    return sd


def flax_dense_to_torch_state_dict(params_np: Dict[str, Any]
                                   ) -> Dict[str, torch.Tensor]:
    """A generic flax tree of ``Dense`` layers (numpy leaves) as an
    ``nn.Linear`` ``state_dict``: each module path's ``kernel [in, out]``
    becomes ``<path with / as .>.weight [out, in]`` and its ``bias``
    ``<path>.bias``, so a torch twin names its layers as the flax modules
    (``Dense_0``, ``block.Dense_1``)."""
    sd = {}

    def walk(tree, path):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, path + [key])
                continue
            name = ".".join(path)
            if key == "kernel":
                sd[f"{name}.weight"] = _t(value).T.contiguous()
            elif key == "bias":
                sd[f"{name}.bias"] = _t(value)
            else:
                raise ValueError(f"{'/'.join(path)}/{key} is not a Dense "
                                 f"leaf (kernel or bias)")

    walk(params_np, [])
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


_LAYER = re.compile(r"^model\.layers\.(\d+)\.(.+)$")
#: GPT-2's blocks (``transformer.h.{i}...``: ``h/block/...`` scanned)
_GPT2_LAYER = re.compile(r"^transformer\.h\.(\d+)\.(.+)$")
_GPT2_NORMS = ("ln_1", "ln_2", "ln_f")
_GPT2_EMBEDS = ("wte", "wpe")


def _flax_suffix(name: str) -> Tuple[str, bool]:
    """A ``state_dict`` name below a layer (or the model) -> the flax path
    below it and whether the tensor is transposed there."""
    owner, _, attr = name.rpartition(".")
    path = owner.replace(".", "/")
    if name == "mlm_bias":
        return "mlm_bias", False
    if attr == "bias":
        return f"{path}/bias", False
    if attr in _EXPERTS:
        return f"{path}/{attr}", False
    if attr != "weight":
        raise ValueError(f"no flax leaf for {name!r} (quantized or unknown "
                         f"parameters are not checkpointed this way)")
    last = owner.rpartition(".")[2]
    if last in _NORMS or owner == "model.norm" or \
            last in _GENERIC_NORMS + _GPT2_NORMS:
        return f"{path}/scale", False
    if owner == "model.embed_tokens" or last in _GENERIC_EMBEDS + \
            _GPT2_EMBEDS:
        return f"{path}/embedding", False
    return f"{path}/kernel", True


class LeafView:
    """One flax leaf over the port's tensors: ``parts`` stacked along a new
    first axis when ``stacked`` (one tensor a layer), else one tensor;
    each part transposed when ``transpose``."""

    def __init__(self, parts: List[torch.Tensor], stacked: bool,
                 transpose: bool):
        self.parts, self.stacked, self.transpose = parts, stacked, transpose
        shape = tuple(parts[0].shape)
        if transpose:
            shape = shape[::-1]
        self.shape = ((len(parts),) if stacked else ()) + shape

    def tensor(self) -> torch.Tensor:
        """The leaf in the flax layout, on the parts' device."""
        parts = [p.detach() for p in self.parts]
        if self.transpose:
            parts = [p.t() for p in parts]
        return torch.stack(parts) if self.stacked else \
            parts[0].contiguous()

    @torch.no_grad()
    def write(self, t: torch.Tensor) -> None:
        """Copy a flax-layout tensor on the parts' device into the parts,
        in place (no host transfer; a CUDA graph may capture it)."""
        for i, p in enumerate(self.parts):
            a = t[i] if self.stacked else t
            p.copy_(a.t() if self.transpose else a)

    @torch.no_grad()
    def load(self, src) -> None:
        """Write a flax-layout array into the parts, in place."""
        src = np.asarray(src)
        for i, p in enumerate(self.parts):
            a = src[i] if self.stacked else src
            t = torch.from_numpy(np.array(a)).to(p.device)
            p.copy_(t.t() if self.transpose else t)


def flax_leaves(tensors: Dict[str, torch.Tensor], config
                ) -> List[Tuple[str, LeafView]]:
    """The flax params of a fp ``state_dict`` (``tensors``, by the port's
    names, of a Llama, Mixtral, GPT-2 or generic transformer; ``config``
    gives the family and ``scan_layers``), as ``(path, LeafView)`` pairs
    in the order ``jax.tree_util`` flattens the flax tree (sorted
    keys at every level). Paths are ``/``-joined, as the JAX package
    names its leaves."""
    from ..models import GPT2Config

    scanned = bool(getattr(config, "scan_layers", True))
    gpt2 = isinstance(config, GPT2Config)
    layer_re, stacked_at, layer_at = (_GPT2_LAYER, "h/block", "h_{}") \
        if gpt2 else (_LAYER, "model/layers/block", "model/layers_{}")
    views: Dict[str, LeafView] = {}
    #: scanned layers: flax path below the block -> (transpose, {i: tensor})
    stacks: Dict[str, Tuple[bool, Dict[int, torch.Tensor]]] = {}
    for name, t in tensors.items():
        m = layer_re.match(name)
        if m is None:
            if gpt2:
                name = name[len("transformer."):]
            path, transpose = _flax_suffix(name)
            views[path] = LeafView([t], False, transpose)
            continue
        sub, transpose = _flax_suffix(m.group(2))
        if scanned:
            stacks.setdefault(sub, (transpose, {}))[1][int(m.group(1))] = t
        else:
            views[f"{layer_at.format(m.group(1))}/{sub}"] = LeafView(
                [t], False, transpose)
    for sub, (transpose, layers) in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"the layers of {sub!r} are not 0..L-1")
        views[f"{stacked_at}/{sub}"] = LeafView(
            [layers[i] for i in range(len(layers))], True, transpose)
    return sorted(views.items(), key=lambda kv: tuple(kv[0].split("/")))


def torch_to_flax(state_dict: Dict[str, torch.Tensor], config
                  ) -> Dict[str, Any]:
    """The reverse of :func:`flax_to_torch_state_dict`: the flax ``params``
    tree (nested dicts of numpy arrays; bf16 widened to fp32, as numpy has
    no bf16)."""
    tree: Dict[str, Any] = {}
    for path, view in flax_leaves(state_dict, config):
        t = view.tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t.cpu().numpy()
    return tree
