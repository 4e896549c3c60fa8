"""Generic transformer covering the injection policies' model families
(BERT, OPT, BLOOM, GPT-NeoX/Pythia, GPT-J, GPT-Neo, Falcon, Phi).

Counterpart of ``deepspeed_tpu/models/transformer.py``: one block over the
option axes of those families (pre- or post-LN, learned / rotary / ALiBi /
no positions, a partial or interleaved rotary, the activation, the
parallel residual with one or two LayerNorms, GPT-Neo's per-layer local
window), an LM head for the decoders and BERT's MLM head for the encoder.

Paths and the kernels they reach, as the JAX model reaches its own:

- the dense forward (training, logits): attention through
  ``layers.dot_product_attention``, which runs the flash kernels (K1/K2,
  causal for the decoders, non-causal for BERT) when the attention has no
  additive bias and no dropout, and the plain attention otherwise (a
  padding mask, ALiBi, GPT-Neo's windows, dropout in training);
- generation over the contiguous head-major cache: a decode step through
  ``ops.decode_attention.decode_attention`` (K4) and a prefill from an
  empty cache through the masked flash kernel (K1's key mask) with
  ``prefill_flash_from_empty``, on configs those kernels represent
  (triangular and key-padding masking only: no ALiBi, no
  ``attention_layers``), given the raw ``[B, S]`` key mask; otherwise the
  plain cached attention under the model's composite bias (cache
  causality, padding, ALiBi, the local window).

The generic models have no paged cache (neither package gives them one),
so the serving engines do not take them. On the card a config outside a
kernel's range (head dims 64 and 128, a GQA group of at most 8 for K4)
raises in the kernel's wrapper; nothing falls back.

The JAX config's ``attention_impl`` ("xla" | "flash") and
``decode_attention_impl`` ("xla" | "pallas") are accepted and change
nothing: the device picks the kernel here, as in the port's Llama, so
:meth:`TransformerConfig.pallas_decode_eligible` keeps only the
structural conditions. ``scan_layers`` changes no layout (one module a
layer) and sets the span of LAMB's trust ratio.

Each projection is a flax ``Dense`` with fp32 params: its input and
weights are promoted to one dtype, or cast to ``compute_dtype`` when the
config sets one; a LayerNorm computes in fp32 and returns the promoted
dtype of its input and its params (flax's promotion), so a bf16 block
over fp32 params (``DeepSpeedTransformerLayer(fp16=True)``) rounds where
the JAX block rounds. State-dict names follow the flax paths
(``model.layers.{i}.attn.q_proj.weight`` for ``model/layers/block/attn/
q_proj/kernel``), with the ``nn.Linear`` layout ``[out, in]``.

As with the port's Llama, a model object is a definition: its parameters
are built on the ``meta`` device, and an engine binds real weights to it
(``init_params`` makes seeded random ones; ``checkpoint.from_flax``
converts a JAX param tree, ``module_inject`` an HF model or checkpoint
directory).
"""

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.decode_attention import decode_attention
from .layers import (HostStash, LayerNorm, apply_rotary,
                     cache_attention_bias, cached_attention,
                     chunked_cross_entropy_loss, cross_entropy_loss,
                     default_positions, dot_product_attention, dropout,
                     flash_prefill_from_empty, gelu_new, init_kv_cache,
                     key_mask_to_bias, remat, repeat_kv,
                     resolve_remat_policy, rotary_embedding, shift_labels,
                     update_kv_cache)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50272
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    #: GQA kv heads (None = as many as the query heads)
    num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 2048
    causal: bool = True
    #: "learned" (BERT/OPT), "rope" (NeoX), "alibi" (BLOOM), "none"
    pos_embedding: str = "learned"
    #: OPT stores position p at row p + 2
    pos_offset: int = 0
    rope_theta: float = 10000.0
    #: NeoX's partial rotary: the first pct of head_dim rotates
    rotary_pct: float = 1.0
    #: "half" (rotate-half) | "interleaved" (GPT-J's rotate_every_two)
    rope_style: str = "half"
    #: "gelu" (erf) | "gelu_new" (tanh) | "relu"
    activation: str = "gelu"
    norm_eps: float = 1e-5
    #: False = post-LN (BERT, OPT-350m)
    pre_layernorm: bool = True
    #: NeoX: x + attn(ln1 x) + mlp(ln2 x)
    parallel_residual: bool = False
    #: GPT-J: one LayerNorm feeds both parallel branches
    shared_parallel_ln: bool = False
    #: BLOOM's word_embeddings_layernorm / BERT's embedding LayerNorm
    embedding_layernorm: bool = False
    final_layernorm: bool = True
    #: BERT token-type embeddings (0 = none)
    type_vocab_size: int = 0
    attention_bias: bool = True
    #: the output projection's bias when it differs (GPT-Neo)
    attention_out_bias: Optional[bool] = None
    #: None = 1/sqrt(head_dim); GPT-Neo does not scale (1.0)
    attention_scale: Optional[float] = None
    mlp_bias: bool = True
    tie_word_embeddings: bool = False
    #: GPT-J's and Phi's biased LM head
    lm_head_bias: bool = False
    #: BERT's cls.predictions transform before the tied decoder
    mlm_head: bool = False
    #: the JAX attention choice ("xla" | "flash"): accepted, the device
    #: picks the kernel here; the sequence-parallel ones raise
    attention_impl: str = "xla"
    #: the JAX cached-decode choice ("xla" | "pallas"): accepted, changes
    #: nothing (see the module docstring)
    decode_attention_impl: str = "xla"
    #: a prefill from an EMPTY cache attends its fresh K/V through the
    #: masked flash kernel (on eligible configs)
    prefill_flash_from_empty: bool = False
    #: GPT-Neo: each layer's attention kind, cycled over the layers;
    #: "local" limits causal attention to ``attention_window`` keys
    attention_layers: Optional[tuple] = None
    attention_window: int = 256
    #: the JAX layout of the block weights; LAMB's trust ratio spans one
    #: ``[L, ...]`` leaf when True
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "nothing"
    #: dropout (BERT's convention: the attention probabilities and each
    #: sublayer's output before the residual); active only in a forward
    #: with ``deterministic=False``
    attn_dropout: float = 0.0
    hidden_dropout: float = 0.0
    #: the projections' torch dtype (None = promotion of input and
    #: params); LayerNorms compute in fp32
    compute_dtype: Optional[Any] = None
    #: kernel init N(0, initializer_range) when set (BERT); lecun normal
    #: when None. ``adjust_init_range`` scales the residual-output
    #: projections by 1/sqrt(2 * num_hidden_layers)
    initializer_range: Optional[float] = None
    adjust_init_range: bool = False
    #: > 0: the training loss runs over token chunks of this size and never
    #: makes the [tokens, vocab] logits; 0 = plain loss
    loss_chunk: int = 0

    def __post_init__(self):
        checks = (("pos_embedding", ("learned", "rope", "alibi", "none")),
                  ("rope_style", ("half", "interleaved")),
                  ("activation", ("gelu", "gelu_new", "relu")),
                  ("decode_attention_impl", ("xla", "pallas")))
        for name, allowed in checks:
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got "
                                 f"{getattr(self, name)!r}")
        if self.attention_impl in ("ulysses", "ring", "ulysses_flash"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r} (sequence "
                f"parallelism) arrives with the distributed slice of the "
                f"port (ROADMAP.md Queue 1, item 9)")
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}")
        if self.hidden_size % self.num_attention_heads or \
                self.num_attention_heads % self.kv_heads:
            raise ValueError(
                f"hidden_size {self.hidden_size}, {self.num_attention_heads} "
                f"heads and {self.kv_heads} kv heads do not divide")
        if self.attention_layers is not None:
            bad = set(self.attention_layers) - {"global", "local"}
            if bad:
                raise ValueError(f"attention_layers holds {sorted(bad)}; "
                                 f"each kind is 'global' or 'local'")
        resolve_remat_policy(self.remat_policy)
        if self.compute_dtype not in (None, torch.float32, torch.bfloat16,
                                      torch.float16):
            raise ValueError(f"compute_dtype must be None or a torch float "
                             f"dtype, got {self.compute_dtype!r}")
        if isinstance(self.loss_chunk, bool) or \
                not isinstance(self.loss_chunk, int) or self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be an int >= 0, got "
                             f"{self.loss_chunk!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads

    def pallas_decode_eligible(self, q_len: int) -> bool:
        """One cached query a row through the decode kernel (K4), which
        represents triangular and key-padding masking only. Shared by the
        model (what it hands the attention) and the attention (the
        route)."""
        return q_len == 1 and self.pos_embedding != "alibi" and \
            self.attention_layers is None

    def prefill_flash_eligible(self, q_len: int) -> bool:
        """A cached prefill from an empty cache through the masked flash
        kernel (``prefill_flash_from_empty``); triangular and key-padding
        masking only."""
        return (self.prefill_flash_from_empty and q_len > 1
                and self.pos_embedding != "alibi"
                and self.attention_layers is None)

    @property
    def rotary_dim(self) -> int:
        # rounded, not truncated: policies rebuild rotary_dim from a float
        # ratio, and int(d / h * h) falls short for many integer pairs
        d = int(round(self.head_dim * self.rotary_pct))
        return d - d % 2


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes: a geometric sequence; a head count that is
    not a power of two gets the interleaved tail (the standard
    construction)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(np.log2(n) - 3)))
        return start * (start ** np.arange(n))

    if np.log2(n_heads).is_integer():
        return pow2_slopes(n_heads).astype(np.float32)
    base = 2 ** int(np.floor(np.log2(n_heads)))
    slopes = list(pow2_slopes(base))
    extra = pow2_slopes(2 * base)[0::2][:n_heads - base]
    return np.asarray(slopes + list(extra), np.float32)


@functools.lru_cache(maxsize=None)
def _alibi_slopes_on(n_heads: int, device: torch.device) -> torch.Tensor:
    """The slopes on ``device``, copied there once (a copy from host memory
    cannot be captured in a CUDA graph)."""
    with torch.inference_mode(False):   # a normal tensor, for training too
        return torch.from_numpy(alibi_slopes(n_heads)).to(device)


def alibi_bias(n_heads: int, kv_len: int, device=None) -> torch.Tensor:
    """``[1, H, 1, S]`` fp32 additive bias ``slope_h * key_position``. The
    query's own term (``slope * query_position``) is constant along a row
    and cancels in the softmax, so this one form is exact for the full,
    the cached-prefill and the decode attention."""
    slopes = _alibi_slopes_on(n_heads, torch.device(device or "cpu"))
    pos = torch.arange(kv_len, device=slopes.device, dtype=torch.float32)
    return (slopes[:, None] * pos[None, :])[None, :, None, :]


def _act(name: str):
    return {"gelu": F.gelu, "gelu_new": gelu_new, "relu": F.relu}[name]


def _apply_rotary_interleaved(x, cos, sin):
    """GPT-J's rotate_every_two: pairs ``(x[2i], x[2i+1])``, not the
    rotate-half pairs ``(x[i], x[i + D/2])``."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def _apply_rotary_partial(x, cos, sin, rotary_dim: int, style: str = "half"):
    """Rotate the first ``rotary_dim`` channels of ``x [B, T, H, D]``."""
    rot_fn = apply_rotary if style == "half" else _apply_rotary_interleaved
    if rotary_dim >= x.shape[-1]:
        return rot_fn(x, cos, sin)
    rot, rest = x[..., :rotary_dim], x[..., rotary_dim:]
    return torch.cat([rot_fn(rot, cos, sin), rest], dim=-1)


class Dense(nn.Linear):
    """flax ``nn.Dense`` over fp32 params: input, weight and bias promoted
    to one dtype, or cast to ``compute_dtype`` when given."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class GenericAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        cd = cfg.compute_dtype
        ab = cfg.attention_bias
        ob = ab if cfg.attention_out_bias is None else cfg.attention_out_bias
        self.q_proj = Dense(cfg.hidden_size, H * D, ab, cd)
        self.k_proj = Dense(cfg.hidden_size, Hkv * D, ab, cd)
        self.v_proj = Dense(cfg.hidden_size, Hkv * D, ab, cd)
        self.o_proj = Dense(H * D, cfg.hidden_size, ob, cd)

    def forward(self, x, cos, sin, bias, layer_cache=None, cache_index=None,
                deterministic: bool = True):
        """``bias``: on a cached route the kernels take (see
        :meth:`TransformerConfig.pallas_decode_eligible`) the raw ``[B, S]``
        key mask or None; elsewhere the model's additive bias or None."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
        q = self.q_proj(x).view(B, T, H, D)
        k = self.k_proj(x).view(B, T, Hkv, D)
        v = self.v_proj(x).view(B, T, Hkv, D)
        if cfg.pos_embedding == "rope":
            q = _apply_rotary_partial(q, cos, sin, cfg.rotary_dim,
                                      cfg.rope_style)
            k = _apply_rotary_partial(k, cos, sin, cfg.rotary_dim,
                                      cfg.rope_style)
        if layer_cache is not None:
            update_kv_cache(layer_cache, k, v, cache_index)
            if cfg.pallas_decode_eligible(T):
                out = decode_attention(
                    q[:, 0], layer_cache["k"], layer_cache["v"], cache_index,
                    key_mask=bias, sm_scale=cfg.attention_scale,
                    k_scale=layer_cache.get("k_scale"),
                    v_scale=layer_cache.get("v_scale"))[:, None]
            elif cfg.prefill_flash_eligible(T):
                out = flash_prefill_from_empty(q, k, v, key_mask=bias,
                                               sm_scale=cfg.attention_scale)
            else:
                out = cached_attention(q, layer_cache, bias=bias,
                                       scale=cfg.attention_scale)
        else:
            k, v = repeat_kv(k, H // Hkv), repeat_kv(v, H // Hkv)
            drop = cfg.attn_dropout if not deterministic else 0.0
            out = dot_product_attention(q, k, v, bias=bias, causal=cfg.causal,
                                        scale=cfg.attention_scale,
                                        dropout_p=drop)
        return self.o_proj(out.reshape(B, T, H * D))


class GenericMLP(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        cd = cfg.compute_dtype
        self.act = _act(cfg.activation)
        self.fc_in = Dense(cfg.hidden_size, cfg.intermediate_size,
                           cfg.mlp_bias, cd)
        self.fc_out = Dense(cfg.intermediate_size, cfg.hidden_size,
                            cfg.mlp_bias, cd)

    def forward(self, x):
        return self.fc_out(self.act(self.fc_in(x)))


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.ln_attn = LayerNorm(cfg.hidden_size, cfg.norm_eps)
        self.attn = GenericAttention(cfg)
        if not (cfg.parallel_residual and cfg.shared_parallel_ln):
            self.ln_mlp = LayerNorm(cfg.hidden_size, cfg.norm_eps)
        self.mlp = GenericMLP(cfg)

    def forward(self, x, cos, sin, bias, layer_cache=None, cache_index=None,
                deterministic: bool = True):
        cfg = self.cfg
        active = not deterministic and cfg.hidden_dropout > 0

        def drop(y):
            # BERT's convention: each sublayer's output before the residual
            return dropout(y, cfg.hidden_dropout, active)

        def attn(h):
            return self.attn(h, cos, sin, bias, layer_cache, cache_index,
                             deterministic)

        if cfg.parallel_residual:
            # NeoX: both branches read the same input, summed once; GPT-J
            # shares one LayerNorm between them
            h = self.ln_attn(x)
            a = attn(h)
            m = self.mlp(h if cfg.shared_parallel_ln else self.ln_mlp(x))
            return x + drop(a) + drop(m)
        if cfg.pre_layernorm:
            x = x + drop(attn(self.ln_attn(x)))
            return x + drop(self.mlp(self.ln_mlp(x)))
        # post-LN (BERT, OPT-350m)
        x = self.ln_attn(x + drop(attn(x)))
        return self.ln_mlp(x + drop(self.mlp(x)))


def layer_kinds(cfg: TransformerConfig):
    """GPT-Neo's attention kind of each layer, or None when no layer is
    local (the all-global case drops the window machinery)."""
    if cfg.attention_layers is None:
        return None
    kinds = [cfg.attention_layers[i % len(cfg.attention_layers)]
             for i in range(cfg.num_hidden_layers)]
    return kinds if "local" in kinds else None


class TransformerModel(nn.Module):
    """Embeddings, the block stack and the final LayerNorm; ``cache``
    switches to the contiguous-cache path."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, H)
        if cfg.pos_embedding == "learned":
            self.embed_positions = nn.Embedding(
                cfg.max_position_embeddings + cfg.pos_offset, H)
        if cfg.type_vocab_size:
            self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H)
        if cfg.embedding_layernorm:
            self.embed_ln = LayerNorm(H, cfg.norm_eps)
        self.layers = nn.ModuleList(TransformerBlock(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        if cfg.final_layernorm:
            self.final_ln = LayerNorm(H, cfg.norm_eps)
        #: the offload remat policy's pinned host buffers, one a layer
        self._stashes = [HostStash() for _ in range(cfg.num_hidden_layers)]

    def forward(self, input_ids, positions=None, attention_mask=None,
                token_type_ids=None, deterministic: bool = True, cache=None,
                cache_index=None):
        """With ``cache``, ``attention_mask`` is the ``[B, cache_len]`` key
        mask; without, the ``[B, T]`` padding mask of a batch."""
        cfg = self.cfg
        B, T = input_ids.shape
        dev = input_ids.device
        x = self.embed_tokens(input_ids)
        if positions is None:
            positions = default_positions((B, T), cache, cache_index, dev)
        if cfg.pos_embedding == "learned":
            rows = positions + cfg.pos_offset
            if cache is not None:
                # a cached position past the table occurs only in the
                # tokens generate's bucketing makes and trims (the JAX
                # gather fills them with NaN); the engine refuses longer
                # requests
                rows = rows.clamp(0, self.embed_positions.num_embeddings - 1)
            x = x + self.embed_positions(rows)
        if cfg.type_vocab_size:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids)
        if cfg.embedding_layernorm:
            x = self.embed_ln(x)
        cos = sin = None
        if cfg.pos_embedding == "rope":
            cos, sin = rotary_embedding(positions, cfg.rotary_dim,
                                        cfg.rope_theta, dtype=x.dtype)

        # the attention's input, decided once a forward: the raw key mask
        # on the kernels' cached routes, else the additive bias (padding,
        # cache causality, ALiBi); the dense path leaves causality to the
        # attention core
        kv_len = T if cache is None else cache["k"].shape[-2]
        bias = None
        if cache is not None:
            if not cfg.causal:
                raise ValueError("KV cache requires a causal decoder config")
            if cfg.pallas_decode_eligible(T) or \
                    cfg.prefill_flash_eligible(T):
                bias = attention_mask
            else:
                bias = cache_attention_bias(T, kv_len, cache_index,
                                            key_mask=attention_mask,
                                            device=dev)
        elif attention_mask is not None:
            bias = key_mask_to_bias(attention_mask)
        if cfg.pos_embedding == "alibi":
            ab = alibi_bias(cfg.num_attention_heads, kv_len, device=dev)
            bias = ab if bias is None else bias + ab

        # GPT-Neo: a local layer's bias adds the sliding window; a global
        # layer of a mixed stack gets the plain bias (zeros when none)
        kinds = layer_kinds(cfg)
        biases = None
        if kinds is not None:
            start = 0 if cache is None else torch.as_tensor(
                cache_index, device=dev).reshape(()).long()
            q_pos = (start + torch.arange(T, device=dev))[:, None]
            k_pos = torch.arange(kv_len, device=dev)[None, :]
            window_bias = torch.where(q_pos - k_pos < cfg.attention_window,
                                      0.0, -1e9)[None, None].float()
            local_bias = window_bias if bias is None else bias + window_bias
            biases = (torch.zeros_like(window_bias) if bias is None
                      else bias, local_bias)

        drawing = not deterministic and (cfg.attn_dropout > 0 or
                                         cfg.hidden_dropout > 0)
        rematted = cfg.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            lbias = bias if kinds is None else \
                biases[1 if kinds[i] == "local" else 0]
            layer_cache = None if cache is None else \
                {name: t[i] for name, t in cache.items()}
            if rematted:
                # a block that draws dropout recomputes on the RNG state
                # its forward started from
                x = remat(layer, x, cos, sin, lbias, None, None,
                          deterministic, policy=cfg.remat_policy,
                          stash=self._stashes[i],
                          preserve_rng_state=drawing)
            else:
                x = layer(x, cos, sin, lbias, layer_cache, cache_index,
                          deterministic)
        if cfg.final_layernorm:
            x = self.final_ln(x)
        return x


class TransformerLMHeadModel(nn.Module):
    """Causal LM head over :class:`TransformerModel` (OPT, BLOOM, NeoX,
    GPT-J, GPT-Neo, Falcon, Phi). ``forward(input_ids, labels=...)`` gives
    the fp32 token-mean loss over shifted labels (the chunked loss with
    ``loss_chunk``); without labels the logits; with ``cache`` ``(logits,
    cache)``."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = TransformerModel(config)
            self.lm_head = None if config.tie_word_embeddings else \
                Dense(config.hidden_size, config.vocab_size,
                      config.lm_head_bias)

    def forward(self, input_ids, labels=None, positions=None,
                attention_mask=None, deterministic: bool = True, cache=None,
                cache_index=None):
        cfg = self.config
        hidden = self.model(input_ids, positions, attention_mask, None,
                            deterministic, cache, cache_index)
        if cache is None and labels is not None and cfg.loss_chunk:
            if self.lm_head is None:
                w, b = self.model.embed_tokens.weight.T, None
            else:
                w, b = self.lm_head.weight.T, self.lm_head.bias
            return chunked_cross_entropy_loss(hidden, w, shift_labels(labels),
                                              bias=b, chunk=cfg.loss_chunk)
        if self.lm_head is None:
            logits = hidden @ self.model.embed_tokens.weight.T.to(
                hidden.dtype)
        else:
            logits = self.lm_head(hidden)
        if cache is not None:
            return logits, cache
        if labels is None:
            return logits
        return cross_entropy_loss(logits, shift_labels(labels))

    @property
    def max_positions(self) -> Optional[int]:
        """The longest sequence a learned position table takes (None for
        rotary, ALiBi or no positions)."""
        cfg = self.config
        return cfg.max_position_embeddings \
            if cfg.pos_embedding == "learned" else None

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """Empty contiguous KV cache for incremental decoding."""
        cfg = self.config
        return init_kv_cache(batch, max_len, cfg.kv_heads, cfg.head_dim,
                             n_layers=cfg.num_hidden_layers, dtype=dtype,
                             device=device)

    def init_params(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded random weights as a ``state_dict`` (see
        :func:`init_params`)."""
        return init_params(self, self.config, seed, dtype, device)


class TransformerForMaskedLM(nn.Module):
    """BERT-style encoder with its MLM head: ``forward(input_ids,
    attention_mask, token_type_ids)`` gives ``[B, T, V]`` logits (the
    transform ``dense -> activation -> LayerNorm`` under ``mlm_head``,
    then the tied decoder ``embed.T`` plus ``mlm_bias``)."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = TransformerModel(config)
            if config.mlm_head:
                self.mlm_dense = Dense(config.hidden_size, config.hidden_size,
                                       True)
                self.mlm_ln = LayerNorm(config.hidden_size, config.norm_eps)
            self.mlm_bias = nn.Parameter(torch.zeros(config.vocab_size))
        self.act = _act(config.activation)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                positions=None, deterministic: bool = True):
        cfg = self.config
        h = self.model(input_ids, positions, attention_mask, token_type_ids,
                       deterministic)
        if cfg.mlm_head:
            h = self.mlm_ln(self.act(self.mlm_dense(h)))
        logits = h @ self.model.embed_tokens.weight.T.to(h.dtype)
        return logits + self.mlm_bias

    def init_params(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded random weights as a ``state_dict`` (see
        :func:`init_params`)."""
        return init_params(self, self.config, seed, dtype, device)


def _lecun_normal_(t: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                       generator=g)


def init_params(module: nn.Module, cfg: TransformerConfig, seed: int = 0,
                dtype=torch.float32, device=None):
    """Seeded random weights of a generic model or layer as a
    ``state_dict`` made on ``device`` (the JAX init's distributions, not
    its draws): LayerNorm scales one, biases zero, embeddings N(0, 0.02),
    the block projections N(0, ``initializer_range``) when it is set (the
    residual-output ones divided by sqrt(2L) under
    ``adjust_init_range``) and lecun normal otherwise, the MLM transform
    and an untied LM head lecun normal."""
    g = torch.Generator(device=device).manual_seed(seed)
    mods = dict(module.named_modules())
    params = {}
    for name, p in module.state_dict(keep_vars=True).items():
        owner, _, attr = name.rpartition(".")
        mod = mods.get(owner)
        t = torch.empty(p.shape, dtype=torch.float32, device=device)
        if isinstance(mod, LayerNorm):
            t.fill_(1.0 if attr == "weight" else 0.0)
        elif attr == "bias" or name == "mlm_bias":
            t.zero_()
        elif isinstance(mod, nn.Embedding):
            t.normal_(0.0, 0.02, generator=g)
        elif isinstance(mod, Dense):
            block = owner.rpartition(".")[0].rpartition(".")[2] in \
                ("attn", "mlp")
            std = cfg.initializer_range if block else None
            if std is None:
                _lecun_normal_(t, p.shape[1], g)
            else:
                # the residual-output projections (JAX's residual_out)
                if owner.endswith(("o_proj", "fc_out")) and \
                        cfg.adjust_init_range:
                    std = std / math.sqrt(2.0 * max(1, cfg.num_hidden_layers))
                t.normal_(0.0, std, generator=g)
        else:
            raise ValueError(f"no init for {name!r}")
        params[name] = t.to(dtype)
    return params
