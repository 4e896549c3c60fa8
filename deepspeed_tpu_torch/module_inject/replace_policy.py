"""Injection policies: HF torch model families -> the port's models.

Counterpart of ``deepspeed_tpu/module_inject/replace_policy.py``. A policy
names the HF architectures it applies to, builds the port model's config
from the HF config, and maps the HF ``state_dict`` onto the port model's
``state_dict``. The port's models keep HF's state-dict names (Llama:
``model.layers.{i}.self_attn.q_proj.weight``, ``model.norm.weight``,
``lm_head.weight``; GPT-2: ``transformer.h.{i}.attn.c_attn.weight``), so
the conversion is torch to torch, one tensor at a time: a rename, GPT-2's
``Conv1D`` transpose (``[in, out]`` to the ``nn.Linear`` layout ``[out,
in]``), Gemma's ``1 + w`` norm fold, and the drop of a tied head. Each
tensor keeps its dtype and device unless the caller asks for others, and
none goes through numpy or fp32 on the host (:func:`convert_tensor`).

The generic families (OPT, BLOOM, GPT-NeoX, BERT, GPT-J, GPT-Neo, Falcon,
Phi) convert to ``models.transformer`` (:class:`TransformerLMHeadModel`,
or :class:`TransformerForMaskedLM` for BERT), whose names are the JAX
generic model's flax paths: each policy maps an HF name onto one of them,
and a fused QKV tensor (BLOOM's and NeoX's head-interleaved ``[H, 3, D]``
rows, Falcon's ``[kv, q per group + 2, D]`` rows) onto three, split along
its rows. Their configs follow the JAX policies field for field, with the
same refusals.

Mixtral converts to ``models.mixtral``; its per-expert HF tensors land in
one stacked tensor a layer (:class:`StackSlot`). Megatron-LM checkpoints
(``MegatronLayerPolicy``, called by name, as in the JAX package) go onto
the generic decoder from their state dict, after the TP shards are merged
by ``checkpoint.reshape.ShardedCheckpointLoader``.

The registry keeps the JAX package's order and class names, so
``match_policy`` picks the same class in both packages.
"""

import functools
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

#: HF buffers that are not weights (causal masks, rotary tables)
_NOT_WEIGHTS = (".attn.bias", ".attn.masked_bias", ".rotary_emb.inv_freq")


class DSPolicy:
    """Base policy: the HF architectures it applies to (``hf_model_types``,
    class names or ``config.model_type`` values), the port model it builds
    (:meth:`build`) and the per-tensor map of the HF ``state_dict``
    (:meth:`map_name`; :func:`convert_tensor` applies it)."""

    hf_model_types: Tuple[str, ...] = ()

    @classmethod
    def applies_to(cls, hf_model) -> bool:
        name = type(hf_model).__name__
        cfg_type = getattr(getattr(hf_model, "config", None), "model_type",
                           None)
        return name in cls.hf_model_types or cfg_type in cls.hf_model_types

    @classmethod
    def build(cls, hc):
        """The port model (a definition on the ``meta`` device) for the HF
        config ``hc``."""
        raise NotImplementedError

    @classmethod
    def map_name(cls, model, name: str, hc=None):
        """``(port name, transform)`` of an HF tensor name, a list of such
        pairs for a tensor that becomes several (a fused QKV), or None for
        a tensor the port model has no place for and does not need (a tied
        head, a mask buffer). ``transform`` is "", a key of
        :func:`convert_tensor`, a function of the tensor, or a
        :class:`StackSlot`. ``hc`` is the
        HF config. A name that maps to no tensor of the port model makes
        :func:`convert_shards` raise."""
        raise NotImplementedError

    def convert(self, hf_model):
        """``(port model, state_dict)`` of an HF torch model; the tensors
        keep the HF model's dtype and device (see :func:`convert_tensor`)."""
        return self.convert_state_dict(hf_model.config,
                                       hf_model.state_dict())

    @classmethod
    def convert_state_dict(cls, hc, sd: Dict[str, torch.Tensor], dtype=None,
                           device=None):
        """``(port model, state_dict)`` from an HF config and ``state_dict``
        (all of it, or an iterable of shards: see
        :func:`convert_shards`)."""
        return convert_shards(cls, hc, [dict(sd)], dtype, device)


def convert_tensor(t: torch.Tensor, transform: Union[str, Callable],
                   dtype=None, device=None) -> torch.Tensor:
    """One HF tensor in the port's layout: moved to ``device`` and cast to
    ``dtype`` (each when given) FIRST, so a bf16 checkpoint never widens on
    the host, then ``transform``ed there: "transpose" (``Conv1D``'s ``[in,
    out]`` to ``[out, in]``), "one_plus" (Gemma's zero-centred norm
    scale; the sum in fp32, then the tensor's dtype) or a function (a part
    of a fused tensor, made contiguous)."""
    t = t.detach()
    if device is not None or dtype is not None:
        floating = t.is_floating_point()
        t = t.to(device=device if device is not None else t.device,
                 dtype=dtype if dtype is not None and floating else t.dtype)
    if callable(transform):
        return transform(t).contiguous()
    if transform == "transpose":
        return t.t().contiguous()
    if transform == "one_plus":
        return (1.0 + t.float()).to(t.dtype)
    if transform:
        raise ValueError(f"unknown transform {transform!r}")
    return t


class StackSlot:
    """A ``map_name`` transform that puts its tensor, after ``transform``
    (a :func:`convert_tensor` transform), at ``index`` of a port tensor
    stacked from ``count`` HF tensors (Mixtral's experts)."""

    def __init__(self, index: int, count: int,
                 transform: Union[str, Callable] = ""):
        self.index, self.count, self.transform = index, count, transform


def convert_shards(policy, hc, shards, dtype=None, device=None):
    """``(port model, state_dict)`` from an HF config and an iterable of
    state-dict fragments, converted as they come: each tensor is moved,
    cast and transformed (:func:`convert_tensor`) before the next fragment
    is read, so a caller that yields one checkpoint shard at a time holds
    at most one shard on the host. A fragment is a dict (emptied as it is
    converted) or any mapping that lists its names and reads a tensor by
    name. Raises ``KeyError`` naming what the
    port model misses or cannot place."""
    model = policy.build(hc)
    want = set(model.state_dict().keys())
    out: Dict[str, torch.Tensor] = {}
    #: a stacked port tensor's slots written so far
    slots: Dict[str, set] = {}
    for shard in shards:
        for name in list(shard):
            target = policy.map_name(model, name, hc)
            t = shard.pop(name) if isinstance(shard, dict) else shard[name]
            if target is None:
                continue
            for port_name, transform in (
                    target if isinstance(target, list) else [target]):
                if port_name not in want:
                    raise KeyError(
                        f"{policy.__name__}: the HF tensor {name!r} maps to "
                        f"{port_name!r}, which {type(model).__name__} does "
                        f"not have")
                if isinstance(transform, StackSlot):
                    part = convert_tensor(t, transform.transform, dtype,
                                          device)
                    if port_name not in out:
                        out[port_name] = part.new_empty(
                            (transform.count,) + tuple(part.shape))
                        slots[port_name] = set()
                    out[port_name][transform.index].copy_(part)
                    slots[port_name].add(transform.index)
                    del part
                else:
                    out[port_name] = convert_tensor(t, transform, dtype,
                                                    device)
            del t
        del shard     # a file's mapping goes before the next is opened
    missing = sorted(want - set(out))
    missing += sorted(f"{name}[{i}]" for name, done in slots.items()
                      for i in range(out[name].shape[0]) if i not in done)
    if missing:
        raise KeyError(f"{policy.__name__}: the HF weights lack "
                       f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return model, out


class HFGPT2LayerPolicy(DSPolicy):
    """HF ``GPT2LMHeadModel`` -> ``models.gpt2.GPT2LMHeadModel``. HF's
    ``Conv1D`` stores ``[in, out]`` kernels, which become ``nn.Linear``'s
    ``[out, in]``; the head is tied to ``wte``."""

    hf_model_types = ("GPT2LMHeadModel", "gpt2", "GPT2Model")

    _CONV1D = ("attn.c_attn.weight", "attn.c_proj.weight", "mlp.c_fc.weight",
               "mlp.c_proj.weight")

    @classmethod
    def build(cls, hc):
        from ..models.gpt2 import GPT2Config, GPT2LMHeadModel

        act = getattr(hc, "activation_function", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            raise NotImplementedError(
                f"GPT-2 activation_function={act!r} is not mapped (the "
                f"port's GPT-2 runs the tanh GELU)")
        if not getattr(hc, "scale_attn_weights", True) or \
                getattr(hc, "scale_attn_by_inverse_layer_idx", False):
            raise NotImplementedError(
                "GPT-2 attention without the 1/sqrt(head_dim) scale, or "
                "scaled by the inverse layer index, is not mapped")
        return GPT2LMHeadModel(GPT2Config(
            vocab_size=hc.vocab_size, n_positions=hc.n_positions,
            n_embd=hc.n_embd, n_layer=hc.n_layer, n_head=hc.n_head,
            layer_norm_epsilon=hc.layer_norm_epsilon, remat=False))

    @classmethod
    def map_name(cls, model, name: str, hc=None):
        if name == "lm_head.weight":
            return None                          # tied to wte
        if not name.startswith("transformer."):
            name = "transformer." + name         # a GPT2Model's tensors
        if name.endswith(_NOT_WEIGHTS):
            return None
        return name, "transpose" if name.endswith(cls._CONV1D) else ""


class HFLlamaLayerPolicy(DSPolicy):
    """HF ``LlamaForCausalLM`` (and Mistral) -> ``models.llama.
    LlamaForCausalLM``: the same names and layouts, so every tensor maps
    as it is (both use the rotate-half RoPE)."""

    hf_model_types = ("LlamaForCausalLM", "llama", "LlamaModel",
                      "MistralForCausalLM", "mistral")
    #: Qwen2 flips this: q/k/v carry biases (o/mlp stay bias-free)
    QKV_BIAS = False

    @staticmethod
    def _window(hc):
        """Mistral-style sliding window, None when not binding."""
        window = getattr(hc, "sliding_window", None)
        if window is not None and window < hc.max_position_embeddings:
            return int(window)
        return None

    @staticmethod
    def _rope_theta(hc) -> float:
        """RoPE's base (see the module's :func:`_rope_theta`); any RoPE
        type but the plain one raises."""
        return _rope_theta(hc, "rope_theta")

    @classmethod
    def _check(cls, hc) -> None:
        """Refuse the HF options that change the math and have no place
        in the port's Llama."""
        if getattr(hc, "attention_bias", False) and not cls.QKV_BIAS or \
                getattr(hc, "mlp_bias", False):
            raise NotImplementedError(
                "Llama attention_bias / mlp_bias are not mapped")

    @classmethod
    def _head_dim(cls, hc) -> Optional[int]:
        explicit = getattr(hc, "head_dim", None)
        if explicit is None or \
                explicit == hc.hidden_size // hc.num_attention_heads:
            return None
        return int(explicit)

    @classmethod
    def _build_config(cls, hc):
        from ..models.llama import LlamaConfig

        cls._check(hc)
        act = getattr(hc, "hidden_act", "silu")
        if act != "silu":
            raise NotImplementedError(f"Llama hidden_act={act!r} is not "
                                      f"mapped")
        return LlamaConfig(
            sliding_window=cls._window(hc),
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=hc.intermediate_size,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            num_key_value_heads=getattr(hc, "num_key_value_heads", None)
            or hc.num_attention_heads,
            max_position_embeddings=hc.max_position_embeddings,
            rms_norm_eps=hc.rms_norm_eps, rope_theta=cls._rope_theta(hc),
            tie_word_embeddings=getattr(hc, "tie_word_embeddings", False),
            attention_qkv_bias=cls.QKV_BIAS,
            head_dim_override=cls._head_dim(hc), remat=False)

    @classmethod
    def build(cls, hc):
        from ..models.llama import LlamaForCausalLM

        return LlamaForCausalLM(cls._build_config(hc))

    @staticmethod
    def _transform(name: str) -> str:
        """Per-tensor value hook (Gemma folds its norms' ``1 + w``)."""
        return ""

    @classmethod
    def map_name(cls, model, name: str, hc=None):
        if name == "lm_head.weight":
            return None if model.config.tie_word_embeddings else (name, "")
        if not name.startswith("model."):
            name = "model." + name               # a LlamaModel's tensors
        if name.endswith(_NOT_WEIGHTS):
            return None
        return name, cls._transform(name)


class HFGemmaLayerPolicy(HFLlamaLayerPolicy):
    """HF ``GemmaForCausalLM`` -> the Llama graph with Gemma's deltas:
    explicit head_dim, gelu-tanh MLP, sqrt(hidden) embedding scaling,
    tied embeddings, and zero-centred RMSNorm weights (HF computes ``x *
    (1 + w)``; ``1 + w`` is folded into the port's scale at conversion).
    Gemma-2B/7B's head dim 256 runs on the card through every attention
    kernel of the generate and serving paths."""

    hf_model_types = ("GemmaForCausalLM", "gemma", "GemmaModel")

    @classmethod
    def _build_config(cls, hc):
        from ..models.llama import LlamaConfig

        explicit = getattr(hc, "hidden_activation", None)
        if explicit not in (None, "gelu_pytorch_tanh"):
            # HF falls back to the tanh GELU only when it is unset
            raise NotImplementedError(
                f"gemma hidden_activation={explicit!r} is not mapped (the "
                f"port's Gemma MLP runs the tanh GELU)")
        cls._check(hc)
        return LlamaConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=hc.intermediate_size,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            num_key_value_heads=hc.num_key_value_heads,
            max_position_embeddings=hc.max_position_embeddings,
            rms_norm_eps=hc.rms_norm_eps, rope_theta=cls._rope_theta(hc),
            tie_word_embeddings=True,  # gemma always ties
            head_dim_override=hc.head_dim, mlp_activation="gelu_tanh",
            embed_scale=float(hc.hidden_size) ** 0.5, remat=False)

    @staticmethod
    def _transform(name: str) -> str:
        return "one_plus" if name.endswith("norm.weight") else ""


class HFQwen2LayerPolicy(HFLlamaLayerPolicy):
    """HF ``Qwen2ForCausalLM`` -> the Llama graph with QKV biases; Qwen2's
    sliding window binds only when ``use_sliding_window`` is set."""

    hf_model_types = ("Qwen2ForCausalLM", "qwen2", "Qwen2Model")
    QKV_BIAS = True

    @staticmethod
    def _window(hc):
        if not getattr(hc, "use_sliding_window", False):
            return None
        # HF Qwen2 windows only layers i >= max_window_layers; the port's
        # model applies ONE global window, so a mixed split must refuse
        mwl = int(getattr(hc, "max_window_layers", 0) or 0)
        if mwl >= hc.num_hidden_layers:
            return None  # no layer actually slides
        if mwl > 0:
            raise NotImplementedError(
                f"Qwen2 per-layer sliding gating (max_window_layers={mwl} < "
                f"num_hidden_layers={hc.num_hidden_layers}) mixes full and "
                "windowed layers, which the converted model's single global "
                "window cannot represent")
        return HFLlamaLayerPolicy._window(hc)


class HFMixtralLayerPolicy(DSPolicy):
    """HF ``MixtralForCausalLM`` -> ``models.mixtral.MixtralForCausalLM``:
    the Llama names for attention and norms, the router ``gate`` as it
    is, and each layer's experts ``experts.{e}.w1`` / ``w3`` (``[I, H]``)
    and ``w2`` (``[H, I]``) stacked into ``block_sparse_moe.w1`` / ``w3``
    ``[E, H, I]`` and ``w2`` ``[E, I, H]`` (each transposed into its
    expert's slot as it is read). The routing is HF's, so logits match
    HF's token for token."""

    hf_model_types = ("MixtralForCausalLM", "mixtral", "MixtralModel")

    _EXPERT = re.compile(
        r"^(model\.layers\.\d+\.block_sparse_moe)\.experts\.(\d+)\."
        r"(w[123])\.weight$")

    @classmethod
    def build(cls, hc):
        from ..models.mixtral import MixtralConfig, MixtralForCausalLM

        return MixtralForCausalLM(MixtralConfig(
            sliding_window=HFLlamaLayerPolicy._window(hc),
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=hc.intermediate_size,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            num_key_value_heads=hc.num_key_value_heads,
            max_position_embeddings=hc.max_position_embeddings,
            rms_norm_eps=hc.rms_norm_eps,
            rope_theta=_rope_theta(hc, "rope_theta", 1e6),
            num_local_experts=hc.num_local_experts,
            num_experts_per_tok=hc.num_experts_per_tok,
            router_aux_loss_coef=getattr(hc, "router_aux_loss_coef", 0.02),
            tie_word_embeddings=getattr(hc, "tie_word_embeddings", False),
            remat=False))

    @classmethod
    def map_name(cls, model, name: str, hc=None):
        if name == "lm_head.weight":
            return None if model.config.tie_word_embeddings else (name, "")
        if not name.startswith("model."):
            name = "model." + name               # a MixtralModel's tensors
        if name.endswith(_NOT_WEIGHTS):
            return None
        m = cls._EXPERT.match(name)
        if m is not None:
            return (f"{m.group(1)}.{m.group(3)}",
                    StackSlot(int(m.group(2)),
                              model.config.num_local_experts, "transpose"))
        return name, ""


_ACTS = {"gelu": "gelu", "gelu_new": "gelu_new", "relu": "relu"}


def _act(name: str, extra: Optional[Dict[str, str]] = None) -> str:
    table = dict(_ACTS, **(extra or {}))
    if name not in table:
        raise KeyError(name)
    return table[name]


def _rows(t: torch.Tensor, groups: int, per: int, take: slice,
          head_dim: int) -> torch.Tensor:
    """Rows ``take`` of each of ``groups`` blocks of ``per`` heads of a
    fused tensor ``[groups * per * head_dim, ...]``, as ``[groups * n *
    head_dim, ...]``."""
    tail = tuple(t.shape[1:])
    t = t.reshape((groups, per, head_dim) + tail)[:, take]
    return t.reshape((-1,) + tail)


class _GenericTransformerPolicy(DSPolicy):
    """Shared machinery of the policies whose target is the generic
    transformer (``models/transformer.py``). A subclass gives the HF
    config's mapping (:meth:`convert_config`) and its names: the prefixes
    a bare or headed HF model puts before them (``PREFIXES``), the layer
    container (``LAYERS``), the top-level tensors (``TOP``), the per-layer
    ones (``LAYER``) and those outside the base model (``HEAD``, checked
    before any prefix is stripped; None for a tied copy, and an
    ``lm_head.*`` target is dropped when the config ties the head); a name
    in ``SKIP`` (a buffer) has no place in the port."""

    causal = True
    PREFIXES: Tuple[str, ...] = ()
    LAYERS = "layers"
    TOP: Dict[str, str] = {}
    LAYER: Dict[str, str] = {}
    HEAD: Dict[str, str] = {}
    SKIP: Tuple[str, ...] = ()

    @classmethod
    def convert_config(cls, hc):
        raise NotImplementedError

    @classmethod
    def build(cls, hc):
        from ..models.transformer import (TransformerForMaskedLM,
                                          TransformerLMHeadModel)

        cfg = cls.convert_config(hc)
        return (TransformerLMHeadModel if cls.causal
                else TransformerForMaskedLM)(cfg)

    @classmethod
    def map_layer(cls, model, suffix: str, hc):
        """The port target(s) of one layer's HF tensor ``suffix``."""
        return cls.LAYER.get(suffix)

    @classmethod
    def map_name(cls, model, name: str, hc=None):
        cfg = model.config
        if name in cls.HEAD:
            target = cls.HEAD[name]
            tied = target is not None and target.startswith("lm_head.") \
                and cfg.tie_word_embeddings
            return None if target is None or tied else (target, "")
        for pfx in cls.PREFIXES:
            if name.startswith(pfx):
                name = name[len(pfx):]
                break
        if name.endswith(cls.SKIP):
            return None
        m = re.match(rf"^{re.escape(cls.LAYERS)}\.(\d+)\.(.+)$", name)
        if m is not None:
            target = cls.map_layer(model, m.group(2), hc)
            if target is None:
                raise KeyError(f"{cls.__name__}: no place for the HF tensor "
                               f"{name!r}")
            pre = f"model.layers.{m.group(1)}."
            if isinstance(target, list):
                return [(pre + t, fn) for t, fn in target]
            return pre + target, ""
        if name not in cls.TOP:
            raise KeyError(f"{cls.__name__}: no place for the HF tensor "
                           f"{name!r}")
        target = cls.TOP[name]
        if target.startswith("model.final_ln") and not cfg.final_layernorm:
            return None
        return target, ""


def _modules(pairs) -> Dict[str, str]:
    """HF module -> port module, as the names of their ``weight`` and
    ``bias``."""
    return {f"{hf}.{attr}": f"{port}.{attr}" for hf, port in pairs
            for attr in ("weight", "bias")}


def _fused_interleaved(suffix: str, cfg):
    """BLOOM's and NeoX's fused QKV (``[H, 3, D]`` rows) as q/k/v."""
    attr = suffix.rpartition(".")[2]
    H, D = cfg.num_attention_heads, cfg.head_dim
    return [(f"attn.{p}_proj.{attr}",
             functools.partial(_rows, groups=H, per=3, take=slice(j, j + 1),
                               head_dim=D))
            for j, p in enumerate("qkv")]


class HFOPTLayerPolicy(_GenericTransformerPolicy):
    """HF ``OPTForCausalLM`` -> the generic decoder: learned positions
    stored at p + 2, ReLU (or GELU) MLP, pre-LN but for the 350m post-LN
    variant."""

    hf_model_types = ("OPTForCausalLM", "opt", "OPTModel")
    PREFIXES = ("model.decoder.", "decoder.")
    TOP = dict(_modules([("embed_tokens", "model.embed_tokens"),
                         ("embed_positions", "model.embed_positions"),
                         ("final_layer_norm", "model.final_ln")]))
    LAYER = _modules([("self_attn.q_proj", "attn.q_proj"),
                      ("self_attn.k_proj", "attn.k_proj"),
                      ("self_attn.v_proj", "attn.v_proj"),
                      ("self_attn.out_proj", "attn.o_proj"),
                      ("fc1", "mlp.fc_in"), ("fc2", "mlp.fc_out"),
                      ("self_attn_layer_norm", "ln_attn"),
                      ("final_layer_norm", "ln_mlp")])
    HEAD = {"lm_head.weight": "lm_head.weight"}

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        if getattr(hc, "word_embed_proj_dim", hc.hidden_size) != \
                hc.hidden_size:
            raise NotImplementedError(
                "OPT word_embed_proj_dim != hidden_size (the 350m projection "
                "layers) is not supported")
        act = {"relu": "relu", "gelu": "gelu"}[hc.activation_function]
        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=hc.ffn_dim,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            max_position_embeddings=hc.max_position_embeddings,
            pos_embedding="learned", pos_offset=2, activation=act,
            norm_eps=1e-5, pre_layernorm=hc.do_layer_norm_before,
            final_layernorm=hc.do_layer_norm_before,
            tie_word_embeddings=getattr(hc, "tie_word_embeddings", True))


class HFBloomLayerPolicy(_GenericTransformerPolicy):
    """HF ``BloomForCausalLM`` -> the generic decoder with ALiBi, the
    embedding LayerNorm and a tied head; the fused QKV (``[H, 3, D]``
    rows) is split at conversion."""

    hf_model_types = ("BloomForCausalLM", "bloom", "BloomModel")
    PREFIXES = ("transformer.",)
    LAYERS = "h"
    TOP = _modules([("word_embeddings", "model.embed_tokens"),
                    ("word_embeddings_layernorm", "model.embed_ln"),
                    ("ln_f", "model.final_ln")])
    LAYER = _modules([("self_attention.dense", "attn.o_proj"),
                      ("mlp.dense_h_to_4h", "mlp.fc_in"),
                      ("mlp.dense_4h_to_h", "mlp.fc_out"),
                      ("input_layernorm", "ln_attn"),
                      ("post_attention_layernorm", "ln_mlp")])
    HEAD = {"lm_head.weight": "lm_head.weight"}

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=4 * hc.hidden_size,
            num_hidden_layers=hc.n_layer, num_attention_heads=hc.n_head,
            max_position_embeddings=2048, pos_embedding="alibi",
            activation="gelu_new", norm_eps=hc.layer_norm_epsilon,
            pre_layernorm=True, embedding_layernorm=True,
            tie_word_embeddings=True)

    @classmethod
    def map_layer(cls, model, suffix, hc):
        if suffix.startswith("self_attention.query_key_value."):
            return _fused_interleaved(suffix, model.config)
        return cls.LAYER.get(suffix)


class HFGPTNeoXLayerPolicy(_GenericTransformerPolicy):
    """HF ``GPTNeoXForCausalLM`` -> the generic decoder: partial rotary,
    the parallel attention + MLP residual, the fused ``[H, 3, D]`` QKV and
    an untied head (``embed_out``)."""

    hf_model_types = ("GPTNeoXForCausalLM", "gpt_neox")
    PREFIXES = ("gpt_neox.",)
    TOP = _modules([("embed_in", "model.embed_tokens"),
                    ("final_layer_norm", "model.final_ln")])
    LAYER = _modules([("attention.dense", "attn.o_proj"),
                      ("mlp.dense_h_to_4h", "mlp.fc_in"),
                      ("mlp.dense_4h_to_h", "mlp.fc_out"),
                      ("input_layernorm", "ln_attn"),
                      ("post_attention_layernorm", "ln_mlp")])
    HEAD = {"embed_out.weight": "lm_head.weight"}
    SKIP = (".attention.bias", ".attention.masked_bias", ".inv_freq")

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=hc.intermediate_size,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            max_position_embeddings=hc.max_position_embeddings,
            pos_embedding="rope", rotary_pct=_rotary_pct(hc),
            rope_theta=_rope_theta(hc, "rotary_emb_base"),
            parallel_residual=hc.use_parallel_residual,
            activation=_act(hc.hidden_act),
            norm_eps=hc.layer_norm_eps, pre_layernorm=True,
            tie_word_embeddings=False)

    @classmethod
    def map_layer(cls, model, suffix, hc):
        if suffix.startswith("attention.query_key_value."):
            return _fused_interleaved(suffix, model.config)
        return cls.LAYER.get(suffix)


class HFBertLayerPolicy(_GenericTransformerPolicy):
    """HF ``BertForMaskedLM`` -> the generic post-LN encoder with its MLM
    head (``TransformerForMaskedLM``)."""

    hf_model_types = ("BertForMaskedLM", "bert")
    causal = False
    PREFIXES = ("bert.",)
    LAYERS = "encoder.layer"
    TOP = _modules([("embeddings.word_embeddings", "model.embed_tokens"),
                    ("embeddings.position_embeddings",
                     "model.embed_positions"),
                    ("embeddings.token_type_embeddings",
                     "model.token_type_embeddings"),
                    ("embeddings.LayerNorm", "model.embed_ln")])
    LAYER = _modules([("attention.self.query", "attn.q_proj"),
                      ("attention.self.key", "attn.k_proj"),
                      ("attention.self.value", "attn.v_proj"),
                      ("attention.output.dense", "attn.o_proj"),
                      ("intermediate.dense", "mlp.fc_in"),
                      ("output.dense", "mlp.fc_out"),
                      ("attention.output.LayerNorm", "ln_attn"),
                      ("output.LayerNorm", "ln_mlp")])
    HEAD = dict(_modules([("cls.predictions.transform.dense", "mlm_dense"),
                          ("cls.predictions.transform.LayerNorm", "mlm_ln")]),
                **{"cls.predictions.bias": "mlm_bias",
                   # the decoder is tied to the word embeddings and its
                   # bias to cls.predictions.bias
                   "cls.predictions.decoder.weight": None,
                   "cls.predictions.decoder.bias": None})
    SKIP = ("embeddings.position_ids",)

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=hc.intermediate_size,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            max_position_embeddings=hc.max_position_embeddings,
            causal=False, pos_embedding="learned",
            activation=_act(hc.hidden_act), norm_eps=hc.layer_norm_eps,
            pre_layernorm=False, embedding_layernorm=True,
            final_layernorm=False, type_vocab_size=hc.type_vocab_size,
            mlm_head=True, tie_word_embeddings=True)


class HFGPTJLayerPolicy(_GenericTransformerPolicy):
    """HF ``GPTJForCausalLM`` -> the generic decoder: partial interleaved
    rotary (rotate_every_two), the parallel residual behind one shared
    LayerNorm, bias-free attention projections, a biased untied head."""

    hf_model_types = ("GPTJForCausalLM", "gptj")
    PREFIXES = ("transformer.",)
    LAYERS = "h"
    TOP = _modules([("wte", "model.embed_tokens"), ("ln_f", "model.final_ln")])
    LAYER = _modules([("attn.q_proj", "attn.q_proj"),
                      ("attn.k_proj", "attn.k_proj"),
                      ("attn.v_proj", "attn.v_proj"),
                      ("attn.out_proj", "attn.o_proj"),
                      ("mlp.fc_in", "mlp.fc_in"), ("mlp.fc_out", "mlp.fc_out"),
                      ("ln_1", "ln_attn")])
    HEAD = {"lm_head.weight": "lm_head.weight",
            "lm_head.bias": "lm_head.bias"}
    SKIP = (".attn.bias", ".attn.masked_bias", ".attn.embed_positions")

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        head_dim = hc.n_embd // hc.n_head
        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.n_embd,
            intermediate_size=getattr(hc, "n_inner", None) or 4 * hc.n_embd,
            num_hidden_layers=hc.n_layer, num_attention_heads=hc.n_head,
            max_position_embeddings=hc.n_positions, pos_embedding="rope",
            rotary_pct=(hc.rotary_dim or head_dim) / head_dim,
            rope_style="interleaved", parallel_residual=True,
            shared_parallel_ln=True,
            activation=_act(hc.activation_function,
                            {"gelu_pytorch_tanh": "gelu_new"}),
            norm_eps=hc.layer_norm_epsilon, pre_layernorm=True,
            attention_bias=False, mlp_bias=True, tie_word_embeddings=False,
            lm_head_bias=True)


class HFGPTNeoLayerPolicy(_GenericTransformerPolicy):
    """HF ``GPTNeoForCausalLM`` -> the generic decoder: learned positions,
    alternating global / local (sliding-window) layers, unscaled attention
    logits, bias-free q/k/v beside a biased output projection."""

    hf_model_types = ("GPTNeoForCausalLM", "gpt_neo")
    PREFIXES = ("transformer.",)
    LAYERS = "h"
    TOP = _modules([("wte", "model.embed_tokens"),
                    ("wpe", "model.embed_positions"),
                    ("ln_f", "model.final_ln")])
    LAYER = _modules([("attn.attention.q_proj", "attn.q_proj"),
                      ("attn.attention.k_proj", "attn.k_proj"),
                      ("attn.attention.v_proj", "attn.v_proj"),
                      ("attn.attention.out_proj", "attn.o_proj"),
                      ("mlp.c_fc", "mlp.fc_in"), ("mlp.c_proj", "mlp.fc_out"),
                      ("ln_1", "ln_attn"), ("ln_2", "ln_mlp")])
    HEAD = {"lm_head.weight": "lm_head.weight"}
    SKIP = (".attention.bias", ".attention.masked_bias")

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        # HF's attention_layers is the expanded per-layer list
        pattern = tuple(getattr(hc, "attention_layers", None) or ("global",))
        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=getattr(hc, "intermediate_size", None)
            or 4 * hc.hidden_size,
            num_hidden_layers=hc.num_layers, num_attention_heads=hc.num_heads,
            max_position_embeddings=hc.max_position_embeddings,
            pos_embedding="learned", activation=_act(hc.activation_function),
            norm_eps=hc.layer_norm_epsilon, pre_layernorm=True,
            attention_bias=False, attention_out_bias=True,
            attention_scale=1.0,    # GPT-Neo does not scale by 1/sqrt(d)
            attention_layers=pattern,
            attention_window=getattr(hc, "window_size", 256), mlp_bias=True,
            tie_word_embeddings=getattr(hc, "tie_word_embeddings", True))


class HFFalconLayerPolicy(_GenericTransformerPolicy):
    """HF ``FalconForCausalLM`` -> the generic decoder: rotary, the
    parallel attention + MLP behind one shared LayerNorm (two under the new
    decoder architecture), multi-query or grouped KV, bias-free
    projections, tied embeddings. Fused QKV rows: the classic multi-query
    layout (7B) ``[Q (all heads); K; V]``, the classic multi-head one
    ``[H, 3, D]``, the new architecture's (40B/180B) ``[q per group; K;
    V] x kv`` (:meth:`_split_falcon_qkv`)."""

    hf_model_types = ("FalconForCausalLM", "falcon", "FalconModel")
    PREFIXES = ("transformer.",)
    LAYERS = "h"
    TOP = _modules([("word_embeddings", "model.embed_tokens"),
                    ("ln_f", "model.final_ln")])
    LAYER = _modules([("self_attention.dense", "attn.o_proj"),
                      ("mlp.dense_h_to_4h", "mlp.fc_in"),
                      ("mlp.dense_4h_to_h", "mlp.fc_out"),
                      ("ln_attn", "ln_attn"), ("input_layernorm", "ln_attn"),
                      ("ln_mlp", "ln_mlp")])
    HEAD = {"lm_head.weight": "lm_head.weight"}

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        if getattr(hc, "alibi", False):
            raise NotImplementedError("Falcon alibi variants are not mapped "
                                      "(falcon-7b/40b/180b use rotary)")
        if not getattr(hc, "parallel_attn", True):
            raise NotImplementedError("Falcon without parallel_attn (RW "
                                      "prototype configs) is not mapped")
        if getattr(hc, "new_decoder_architecture", False):
            kv = hc.num_kv_heads
        else:
            kv = 1 if getattr(hc, "multi_query", True) else \
                hc.num_attention_heads
        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=getattr(hc, "ffn_hidden_size", None)
            or 4 * hc.hidden_size,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            num_key_value_heads=kv,
            max_position_embeddings=getattr(hc, "max_position_embeddings",
                                            2048),
            pos_embedding="rope", rope_theta=_rope_theta(hc, "rope_theta"),
            parallel_residual=True, shared_parallel_ln=not cls._two_ln(hc),
            activation="gelu", norm_eps=hc.layer_norm_epsilon,
            pre_layernorm=True,
            attention_bias=bool(getattr(hc, "bias", False)),
            mlp_bias=bool(getattr(hc, "bias", False)),
            tie_word_embeddings=getattr(hc, "tie_word_embeddings", True))

    @staticmethod
    def _two_ln(hc) -> bool:
        """FalconDecoderLayer's two LayerNorms (``ln_attn``, ``ln_mlp``):
        the new architecture with ``num_ln_in_parallel_attn`` 2 or unset
        (falcon2-11B sets 1 and keeps the shared one)."""
        if not getattr(hc, "new_decoder_architecture", False):
            return False
        n = getattr(hc, "num_ln_in_parallel_attn", None)
        return n is None or n == 2

    @staticmethod
    def _split_falcon_qkv(w: torch.Tensor, hc, cfg):
        """``(q, k, v)`` rows of a fused QKV weight ``[rows, in]`` or bias
        ``[rows]`` in HF's layout for ``hc``."""
        D, H = cfg.head_dim, cfg.num_attention_heads
        tail = tuple(w.shape[1:])
        if getattr(hc, "new_decoder_architecture", False):
            kv = hc.num_kv_heads
            g = H // kv
            w = w.reshape((kv, g + 2, D) + tail)
            return (w[:, :g].reshape((H * D,) + tail),
                    w[:, g].reshape((kv * D,) + tail),
                    w[:, g + 1].reshape((kv * D,) + tail))
        if getattr(hc, "multi_query", True):
            return tuple(w.split([H * D, D, D], dim=0))
        w = w.reshape((H, 3, D) + tail)
        return tuple(w[:, j].reshape((H * D,) + tail) for j in range(3))

    @classmethod
    def map_layer(cls, model, suffix, hc):
        cfg = model.config
        if suffix.startswith("self_attention.query_key_value."):
            attr = suffix.rpartition(".")[2]
            return [(f"attn.{p}_proj.{attr}",
                     functools.partial(_falcon_part, hc=hc, cfg=cfg, j=j))
                    for j, p in enumerate("qkv")]
        if suffix.startswith("ln_mlp.") and cfg.shared_parallel_ln:
            return None
        return cls.LAYER.get(suffix)


def _falcon_part(t, hc, cfg, j):
    return HFFalconLayerPolicy._split_falcon_qkv(t, hc, cfg)[j]


class HFPhiLayerPolicy(_GenericTransformerPolicy):
    """HF ``PhiForCausalLM`` (phi-1/1.5/2) -> the generic decoder: partial
    rotary, the parallel attention + MLP behind one shared LayerNorm,
    biases on every projection, a biased untied head."""

    hf_model_types = ("PhiForCausalLM", "phi", "PhiModel")
    PREFIXES = ("model.",)
    TOP = _modules([("embed_tokens", "model.embed_tokens"),
                    ("final_layernorm", "model.final_ln")])
    LAYER = _modules([("self_attn.q_proj", "attn.q_proj"),
                      ("self_attn.k_proj", "attn.k_proj"),
                      ("self_attn.v_proj", "attn.v_proj"),
                      ("self_attn.dense", "attn.o_proj"),
                      ("mlp.fc1", "mlp.fc_in"), ("mlp.fc2", "mlp.fc_out"),
                      ("input_layernorm", "ln_attn")])
    HEAD = {"lm_head.weight": "lm_head.weight",
            "lm_head.bias": "lm_head.bias"}
    SKIP = (".inv_freq",)

    @classmethod
    def convert_config(cls, hc):
        from ..models.transformer import TransformerConfig

        if getattr(hc, "qk_layernorm", False):
            raise NotImplementedError(
                "Phi qk_layernorm=True (per-head Q/K layernorms) is not "
                "mapped; conversion would silently drop those weights")
        if getattr(hc, "tie_word_embeddings", False):
            raise NotImplementedError(
                "tied-embedding Phi is not mapped: HF's lm_head keeps its "
                "bias even when tied, and the tied logits path here has no "
                "bias slot (no released Phi checkpoint ties embeddings)")
        return TransformerConfig(
            vocab_size=hc.vocab_size, hidden_size=hc.hidden_size,
            intermediate_size=hc.intermediate_size,
            num_hidden_layers=hc.num_hidden_layers,
            num_attention_heads=hc.num_attention_heads,
            num_key_value_heads=getattr(hc, "num_key_value_heads", None),
            max_position_embeddings=hc.max_position_embeddings,
            pos_embedding="rope", rotary_pct=_rotary_pct(hc, 0.5),
            rope_theta=_rope_theta(hc, "rope_theta"),
            parallel_residual=True, shared_parallel_ln=True,
            activation=_act(hc.hidden_act), norm_eps=hc.layer_norm_eps,
            pre_layernorm=True, attention_bias=True, mlp_bias=True,
            lm_head_bias=True, tie_word_embeddings=False)


def _rope_params(hc) -> dict:
    return getattr(hc, "rope_parameters", None) or \
        getattr(hc, "rope_scaling", None) or {}


def _rope_theta(hc, field: str, default: float = 10000.0) -> float:
    """The rotary base from ``field`` (transformers 4), else from
    ``rope_parameters`` (transformers 5 moves it there), else ``default``;
    a RoPE type other than the plain one raises (the JAX package has
    none)."""
    params = _rope_params(hc)
    kind = params.get("rope_type", params.get("type", "default"))
    if kind != "default":
        raise NotImplementedError(
            f"RoPE type {kind!r} ({params!r}) is not mapped: the port runs "
            f"plain RoPE, as the JAX package does")
    theta = getattr(hc, field, None) or params.get("rope_theta")
    return float(theta or default)


def _rotary_pct(hc, default: float = 1.0) -> float:
    """NeoX's ``rotary_pct`` / Phi's ``partial_rotary_factor`` (in
    ``rope_parameters`` under transformers 5)."""
    for field in ("rotary_pct", "partial_rotary_factor"):
        value = getattr(hc, field, None)
        if value is not None:
            return float(value)
    return float(_rope_params(hc).get("partial_rotary_factor", default))


def _split_fused_qkv(w: torch.Tensor, b: Optional[torch.Tensor],
                     n_heads: int, head_dim: int, interleaved: bool = True):
    """A fused QKV weight ``[3 * H * D, in]`` (and bias) -> three ``[in, H *
    D]`` kernels (and biases), as the JAX function returns them.

    ``interleaved=True``: the head-interleaved ``[H, 3, D]`` layout along
    the output dim (BLOOM / GPT-NeoX fused weights, Megatron v1.0/v2.0
    checkpoints); ``interleaved=False``: plain ``[Q; K; V]`` rows (Megatron
    version 0)."""
    hidden_out = n_heads * head_dim
    if not interleaved:
        kernels = [part.t() for part in w.chunk(3, dim=0)]
        biases = None if b is None else list(b.chunk(3, dim=0))
        return kernels, biases
    w = w.reshape(n_heads, 3, head_dim, -1)
    kernels = [w[:, j].reshape(hidden_out, -1).t() for j in range(3)]
    biases = None
    if b is not None:
        b = b.reshape(n_heads, 3, head_dim)
        biases = [b[:, j].reshape(hidden_out) for j in range(3)]
    return kernels, biases


class _MegatronSource(NamedTuple):
    """What a Megatron state dict gives in place of an HF config: the
    state dict, the head count, the layout flags and its name prefixes."""

    sd: Dict[str, torch.Tensor]
    heads: int
    scan_layers: bool
    qkv_version: float
    layers: str        # the transformer's prefix, up to ``layers.``
    embedding: str     # the embedding block's prefix


def _megatron_qkv(t: torch.Tensor, cfg, interleaved: bool, j: int):
    """Part ``j`` (q, k, v) of a Megatron fused QKV weight ``[3 * H * D,
    in]`` or bias ``[3 * H * D]`` in the ``nn.Linear`` layout, through
    :func:`_split_fused_qkv`."""
    w = t if t.dim() == 2 else t[:, None]
    kernel = _split_fused_qkv(w, None, cfg.num_attention_heads, cfg.head_dim,
                              interleaved=interleaved)[0][j]
    return kernel.t() if t.dim() == 2 else kernel.reshape(-1)


class MegatronLayerPolicy(_GenericTransformerPolicy):
    """Megatron-LM GPT -> the generic decoder (``models/transformer.py``).
    The reference's ``MegatronLayerPolicy`` (``replace_policy.py:281``)
    targets ``ParallelTransformerLayer``; here, as in the JAX package, the
    unit is the Megatron STATE DICT: TP-sharded ``mp_rank_XX`` files are
    merged first by ``checkpoint.reshape.ShardedCheckpointLoader``
    (:meth:`from_megatron_checkpoint`), then mapped onto the generic
    graph.

    Megatron GPT: learned absolute positions, GELU, pre-LN with a final
    LayerNorm, the head tied to the word embeddings, a fused
    ``query_key_value``. Both the classic ``language_model.transformer.
    layers.N`` and the newer ``language_model.encoder.layers.N`` names are
    read; tensors the graph has no place for are left out, as the JAX
    policy reads only what it needs.

    The fused QKV's rows depend on the checkpoint version (reference
    ``state_dict_factory.py:243``): version 1.0/2.0 rows are
    head-interleaved ``[H, 3, D]`` (a rank-major merge keeps each head's
    block), version 0 rows contiguous ``[Q; K; V]``; ``qkv_version`` must
    match the files. Not in the registry: ``match_policy`` never picks
    it."""

    hf_model_types = ()
    LAYER = _modules([("attention.dense", "attn.o_proj"),
                      ("mlp.dense_h_to_4h", "mlp.fc_in"),
                      ("mlp.dense_4h_to_h", "mlp.fc_out"),
                      ("input_layernorm", "ln_attn"),
                      ("post_attention_layernorm", "ln_mlp")])

    @staticmethod
    def _prefix(sd) -> str:
        for p in ("language_model.transformer.", "language_model.encoder.",
                  "transformer.", "encoder."):
            if any(k.startswith(p + "layers.0.") for k in sd):
                return p
        raise KeyError("no Megatron transformer layers found in state dict "
                       "(expected language_model.{transformer|encoder}."
                       "layers.N.*)")

    @staticmethod
    def _embedding_prefix(sd) -> str:
        for p in ("language_model.embedding.", "embedding."):
            if any(k.startswith(p) for k in sd):
                return p
        raise KeyError("no Megatron embedding block in state dict")

    @classmethod
    def infer_config(cls, sd, num_attention_heads: int,
                     scan_layers: bool = True, norm_eps: float = 1e-5):
        """The generic decoder's config from the weights' shapes (a
        Megatron checkpoint carries no HF config; only the head count is
        not recoverable)."""
        from ..models.transformer import TransformerConfig

        tp = cls._prefix(sd)
        ep = cls._embedding_prefix(sd)
        vocab, hidden = sd[f"{ep}word_embeddings.weight"].shape
        max_pos = sd[f"{ep}position_embeddings.weight"].shape[0]
        n_layers = 1 + max(
            int(k.split("layers.")[1].split(".")[0])
            for k in sd if k.startswith(f"{tp}layers."))
        inter = sd[f"{tp}layers.0.mlp.dense_h_to_4h.weight"].shape[0]
        return TransformerConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
            num_hidden_layers=n_layers,
            num_attention_heads=num_attention_heads,
            max_position_embeddings=max_pos, pos_embedding="learned",
            activation="gelu", norm_eps=norm_eps, pre_layernorm=True,
            final_layernorm=True, tie_word_embeddings=True,
            scan_layers=scan_layers)

    @classmethod
    def convert_config(cls, hc: _MegatronSource):
        return cls.infer_config(hc.sd, hc.heads, hc.scan_layers)

    @classmethod
    def map_name(cls, model, name: str, hc: _MegatronSource = None):
        top = {f"{hc.embedding}word_embeddings.weight":
               "model.embed_tokens.weight",
               f"{hc.embedding}position_embeddings.weight":
               "model.embed_positions.weight",
               f"{hc.layers}final_layernorm.weight": "model.final_ln.weight",
               f"{hc.layers}final_layernorm.bias": "model.final_ln.bias"}
        if name in top:
            return top[name], ""
        m = re.match(rf"^{re.escape(hc.layers)}layers\.(\d+)\.(.+)$", name)
        if m is None:
            return None
        pre, suffix = f"model.layers.{m.group(1)}.", m.group(2)
        if suffix.startswith("attention.query_key_value."):
            attr = suffix.rpartition(".")[2]
            return [(f"{pre}attn.{p}_proj.{attr}",
                     functools.partial(_megatron_qkv, cfg=model.config,
                                       interleaved=hc.qkv_version != 0, j=j))
                    for j, p in enumerate("qkv")]
        target = cls.LAYER.get(suffix)
        return None if target is None else (pre + target, "")

    @classmethod
    def convert_state_dict(cls, hf_config, sd, scan_layers: bool = True,
                           qkv_version: float = 2.0, dtype=None, device=None):
        """``(TransformerLMHeadModel, state_dict)`` from a merged Megatron
        state dict (torch tensors or numpy arrays); ``hf_config`` is the
        head count, as in the JAX policy."""
        sd = {k: torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v)
              else v for k, v in sd.items()}
        hc = _MegatronSource(sd, int(hf_config), scan_layers,
                             float(qkv_version), cls._prefix(sd),
                             cls._embedding_prefix(sd))
        return convert_shards(cls, hc, [dict(sd)], dtype, device)

    @classmethod
    def from_megatron_checkpoint(cls, ckpt_files, num_attention_heads: int,
                                 version: float = 2.0,
                                 scan_layers: bool = True, dtype=None,
                                 device=None):
        """``(model, state_dict)`` from Megatron ``mp_rank_XX`` files at any
        TP degree, merged by the reshape loader's QKV-aware merge (the
        merged layout per ``version`` drives the Q/K/V split)."""
        from ..checkpoint.reshape import ShardedCheckpointLoader

        loader = ShardedCheckpointLoader(list(ckpt_files), version=version)
        sd = loader.load(mp_world_size=1, mp_rank=0)
        return cls.convert_state_dict(num_attention_heads, sd,
                                      scan_layers=scan_layers,
                                      qkv_version=version, dtype=dtype,
                                      device=device)


#: every registered policy, in the JAX package's order
generic_policies: List[type] = [HFGPT2LayerPolicy, HFQwen2LayerPolicy,
                                HFGemmaLayerPolicy, HFLlamaLayerPolicy,
                                HFMixtralLayerPolicy,
                                HFFalconLayerPolicy, HFPhiLayerPolicy,
                                HFOPTLayerPolicy, HFBloomLayerPolicy,
                                HFGPTNeoXLayerPolicy, HFBertLayerPolicy,
                                HFGPTJLayerPolicy, HFGPTNeoLayerPolicy]


def match_policy(hf_model) -> Optional[DSPolicy]:
    """``replace_method='auto'``: the first registered policy that applies
    to ``hf_model``, as an instance (None when none does)."""
    for policy_cls in generic_policies:
        if policy_cls.applies_to(hf_model):
            return policy_cls()
    return None
