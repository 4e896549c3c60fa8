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

The registry keeps the JAX package's order and class names, so
``match_policy`` picks the same class in both packages. The families whose
target model is not ported yet (the JAX ``models/transformer.py`` and
``models/mixtral.py``) are registered too; converting with them raises
``NotImplementedError`` naming their ROADMAP.md item.
"""

from typing import Dict, List, Optional, Tuple

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
    def map_name(cls, model, name: str) -> Optional[Tuple[str, str]]:
        """``(port name, transform)`` of an HF tensor name, None for a
        tensor the port model has no place for and does not need (a tied
        head, a mask buffer). ``transform`` is "" or a key of
        :func:`convert_tensor`. A name that maps to no tensor of the port
        model makes :func:`convert_shards` raise."""
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


def convert_tensor(t: torch.Tensor, transform: str, dtype=None,
                   device=None) -> torch.Tensor:
    """One HF tensor in the port's layout: moved to ``device`` and cast to
    ``dtype`` (each when given) FIRST, so a bf16 checkpoint never widens on
    the host, then ``transform``ed there: "transpose" (``Conv1D``'s ``[in,
    out]`` to ``[out, in]``) or "one_plus" (Gemma's zero-centred norm
    scale; the sum in fp32, then the tensor's dtype)."""
    t = t.detach()
    if device is not None or dtype is not None:
        floating = t.is_floating_point()
        t = t.to(device=device if device is not None else t.device,
                 dtype=dtype if dtype is not None and floating else t.dtype)
    if transform == "transpose":
        return t.t().contiguous()
    if transform == "one_plus":
        return (1.0 + t.float()).to(t.dtype)
    if transform:
        raise ValueError(f"unknown transform {transform!r}")
    return t


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
    for shard in shards:
        for name in list(shard):
            target = policy.map_name(model, name)
            t = shard.pop(name) if isinstance(shard, dict) else shard[name]
            if target is None:
                continue
            port_name, transform = target
            if port_name not in want:
                raise KeyError(f"{policy.__name__}: the HF tensor {name!r} "
                               f"maps to {port_name!r}, which "
                               f"{type(model).__name__} does not have")
            out[port_name] = convert_tensor(t, transform, dtype, device)
            del t
        del shard     # a file's mapping goes before the next is opened
    missing = sorted(want - set(out))
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
    def map_name(cls, model, name: str):
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
        """RoPE's base: ``rope_theta`` (transformers 4), else the one in
        ``rope_parameters`` / ``rope_scaling`` (transformers 5 moves it
        there), else 10000. Any RoPE type but the plain one raises."""
        params = getattr(hc, "rope_parameters", None) or \
            getattr(hc, "rope_scaling", None) or {}
        kind = params.get("rope_type", params.get("type", "default"))
        if kind != "default":
            raise NotImplementedError(
                f"RoPE type {kind!r} ({params!r}) is not mapped (the port's "
                f"Llama runs plain RoPE); other RoPE variants arrive with "
                f"the model-families slice of the port (ROADMAP.md Queue 1, "
                f"item 10)")
        theta = getattr(hc, "rope_theta", None) or params.get("rope_theta")
        return float(theta or 10000.0)

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
    def map_name(cls, model, name: str):
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
    The port's attention kernels take head dims 64 and 128: Gemma-2B/7B's
    256 runs on the CPU only."""

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


class _UnportedPolicy(DSPolicy):
    """A family whose target model is not in the port yet: it matches as
    in the JAX package, and converting raises naming the item that brings
    the target."""

    #: the JAX package's target module
    target = "models/transformer.py"

    @classmethod
    def build(cls, hc):
        raise NotImplementedError(
            f"{cls.__name__} converts to the JAX package's {cls.target}, "
            f"which arrives with the model-families slice of the port "
            f"(ROADMAP.md Queue 1, item 10)")

    @classmethod
    def map_name(cls, model, name: str):
        raise NotImplementedError(cls.__name__)


class HFMixtralLayerPolicy(_UnportedPolicy):
    hf_model_types = ("MixtralForCausalLM", "mixtral", "MixtralModel")
    target = "models/mixtral.py"


class HFFalconLayerPolicy(_UnportedPolicy):
    hf_model_types = ("FalconForCausalLM", "falcon", "FalconModel")


class HFPhiLayerPolicy(_UnportedPolicy):
    hf_model_types = ("PhiForCausalLM", "phi", "PhiModel")


class HFOPTLayerPolicy(_UnportedPolicy):
    hf_model_types = ("OPTForCausalLM", "opt", "OPTModel")


class HFBloomLayerPolicy(_UnportedPolicy):
    hf_model_types = ("BloomForCausalLM", "bloom", "BloomModel")


class HFGPTNeoXLayerPolicy(_UnportedPolicy):
    hf_model_types = ("GPTNeoXForCausalLM", "gpt_neox")


class HFBertLayerPolicy(_UnportedPolicy):
    hf_model_types = ("BertForMaskedLM", "bert")


class HFGPTJLayerPolicy(_UnportedPolicy):
    hf_model_types = ("GPTJForCausalLM", "gptj")


class HFGPTNeoLayerPolicy(_UnportedPolicy):
    hf_model_types = ("GPTNeoForCausalLM", "gpt_neo")


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
