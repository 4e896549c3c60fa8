"""Llama-family decoder (RoPE + RMSNorm + SwiGLU + GQA).

Counterpart of ``deepspeed_tpu/models/llama.py``. Four of its paths are
ported:

- the paged MIXED step of the serving engine: ``forward(input_ids [1, T],
  cache=pool, cache_index=paged bundle with token_rows)`` appends the
  packed batch's KV into the paged pool and runs ragged paged attention
  through ``ops.ragged_attention.ragged_paged_attention`` (kernel K6);
- the paged steps of the two-program serving engine, ``forward(input_ids
  [B, T], cache=pool, cache_index=paged bundle)``: with ``T == 1`` the
  decode over all slots through
  ``ops.decode_attention.paged_decode_attention`` (kernel K7a); with
  ``chunk_start`` in the bundle a prefill chunk that attends the pool
  through ``paged_prefill_attention`` (kernel K7b); otherwise the
  from-empty prefill over the fresh K/V, through the masked flash kernel
  (K1's key mask) when ``prefill_flash_from_empty``, else a plain masked
  attention;
- the contiguous-cache path of dense generation: ``forward(input_ids
  [B, T], cache=init_cache(...), cache_index=position, positions=...,
  attention_mask=[B, S] key mask)`` appends into the head-major cache,
  then attends one new token per row through
  ``ops.decode_attention.decode_attention`` (kernel K4) or a prefill
  through the plain ``cached_attention`` (the masked flash kernel when
  ``prefill_flash_from_empty``);
- the dense forward: ``forward(input_ids [B, T], labels)`` returns the
  fp32 token-mean cross entropy over shifted labels (logits without
  labels; with ``loss_chunk`` the chunked loss, which never makes the
  logits), with kv heads repeated before causal (optionally windowed)
  flash attention through ``ops.flash_attention`` (kernels K1 and K2), or
  with a ``[B, T]`` padding ``attention_mask`` the plain attention under
  its -1e9 key bias, as the JAX model sends a biased attention down its
  XLA path; with ``remat`` each block is recomputed in the backward
  under ``remat_policy`` (``layers.remat``), and with ``pld_theta``
  progressive layer drop gates each block's residual update.

The cached branches (paged and contiguous) are ``layers.attend_cache``,
which GPT-2 shares. Every projection comes from ``layers.model_dense``:
``nn.Linear``, or with
``quantize_weights`` a ``QuantLinear`` over int8/int4 codes (kernel K5).
Each wrapper launches its hand-written kernel on CUDA tensors and its
plain PyTorch version on CPU tensors: the device decides, so the JAX
config's ``attention_impl`` and ``decode_attention_impl`` have no
counterpart here (both are accepted, as are the flash tile sizes).
``scan_layers`` changes no layout: the port keeps one module a layer, and
the field sets the span of LAMB's trust ratio.

As with a flax module, the model object is a definition: its parameters
are built on the ``meta`` device (shapes only, no memory), and an engine
binds real weights to it (``init_params`` makes seeded random ones;
``checkpoint.from_flax`` converts a JAX param tree).
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (HostStash, RMSNorm, apply_rotary, attend_cache,
                     chunked_cross_entropy_loss, copy_into,
                     cross_entropy_loss, default_positions,
                     dot_product_attention, head_weight, init_kv_cache,
                     init_paged_kv_cache, key_mask_to_bias, lm_head_output,
                     model_dense, remat, repeat_kv, resolve_remat_policy,
                     rotary_embedding, shift_labels)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    #: Mistral-style sliding-window attention: query i attends keys j with
    #: 0 <= i - j < window (None = full causal)
    sliding_window: Optional[int] = None
    #: Qwen2-style: biases on q/k/v projections (o/mlp stay bias-free)
    attention_qkv_bias: bool = False
    #: Gemma-style knobs: explicit head_dim (H*D need not equal hidden),
    #: gelu-tanh MLP activation, sqrt(hidden) embedding scaling
    head_dim_override: Optional[int] = None
    mlp_activation: str = "silu"  # "silu" | "gelu_tanh"
    embed_scale: Optional[float] = None
    #: the JAX kernel choices ("xla" | "flash", "xla" | "pallas"): the
    #: device picks the kernel here, so both are accepted and change nothing
    attention_impl: str = "xla"
    decode_attention_impl: str = "xla"
    #: the JAX flash kernel's tiles: any positive value is accepted; the
    #: port's kernels fix their own
    flash_block_q: int = 512
    flash_block_k: int = 512
    #: the JAX layout of the block weights (one [L, ...] leaf per weight
    #: when True); LAMB's trust ratio spans one such leaf (runtime/engine.py)
    scan_layers: bool = True
    #: training: recompute each block in the backward instead of keeping
    #: its activations
    remat: bool = True
    #: what a rematerialized block keeps (``layers.resolve_remat_policy``):
    #: "nothing", "dots" (every matmul's output), "dots_no_batch" (the
    #: projections' outputs) or "offload_dots_no_batch" (those in pinned
    #: host memory)
    remat_policy: str = "nothing"
    #: >0: the training loss runs over token chunks of this size and never
    #: makes the [tokens, vocab] logits (``layers.
    #: chunked_cross_entropy_loss``); 0 = plain loss
    loss_chunk: int = 0
    #: a prefill that starts from an EMPTY cache (generate's, and the
    #: serving engine's monolithic paged prefill) attends its fresh K/V
    #: through the masked, GQA-native flash kernel instead of the plain
    #: cached attention, which materializes [B, H, T, S] logits
    prefill_flash_from_empty: bool = False
    # -- quantized weights (set by init_inference, which rewrites the fp
    # state_dict to match) ---------------------------------------------
    #: attention/MLP projections stored as "int8" per-column codes or
    #: "int4" codes packed two per byte with grouped scales
    #: (layers.QuantLinear, kernel K5); embeddings, norms and the LM head
    #: stay fp
    quantize_weights: Optional[str] = None
    #: scale-group length along K (0 = per-column for int8, 64 for int4)
    quantize_group_size: int = 0
    #: int8 payloads for the tensor-parallel all-reduce, and its values
    #: per scale: only the off values (False, 256) are accepted
    quantized_collectives: bool = False
    quantized_psum_block: int = 256
    #: the tensor-parallel width the weights were quantized for
    #: (row-parallel scale groups align to it; 1 in this port)
    quantize_row_shards: int = 1

    def __post_init__(self):
        if self.mlp_activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"mlp_activation must be 'silu' or "
                             f"'gelu_tanh', got {self.mlp_activation!r}")
        if self.quantize_weights not in (None, "int8", "int4"):
            raise ValueError(f"quantize_weights must be None, 'int8' or "
                             f"'int4', got {self.quantize_weights!r}")
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be 'xla' or 'flash', got "
                             f"{self.attention_impl!r}")
        if self.decode_attention_impl not in ("xla", "pallas"):
            raise ValueError(f"decode_attention_impl must be 'xla' or "
                             f"'pallas', got {self.decode_attention_impl!r}")
        for name in ("flash_block_q", "flash_block_k"):
            value = getattr(self, name)
            if isinstance(value, bool) or not isinstance(value, int) or \
                    value <= 0:
                raise ValueError(f"{name} must be a positive int, got "
                                 f"{value!r}")
        if not isinstance(self.scan_layers, bool):
            raise ValueError(f"scan_layers must be True or False, got "
                             f"{self.scan_layers!r}")
        if self.quantized_collectives or self.quantized_psum_block != 256:
            raise NotImplementedError(
                "quantized_collectives and quantized_psum_block != 256 "
                "arrive with the distributed slice of the port (ROADMAP.md "
                "Queue 1, item 9)")
        resolve_remat_policy(self.remat_policy)
        if isinstance(self.loss_chunk, bool) or \
                not isinstance(self.loss_chunk, int) or self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be an int >= 0, got "
                             f"{self.loss_chunk!r}")

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b(**over):
        return LlamaConfig(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=8192, rope_theta=500000.0), **over})

    @staticmethod
    def llama_400m(**over):
        return LlamaConfig(**{**dict(
            vocab_size=32000, hidden_size=1024, intermediate_size=2816,
            num_hidden_layers=24, num_attention_heads=16,
            num_key_value_heads=16, max_position_embeddings=1024), **over})

    @staticmethod
    def tiny(**over):
        return LlamaConfig(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128), **over})


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, \
            cfg.head_dim
        qb = cfg.attention_qkv_bias
        self.q_proj = model_dense(cfg, cfg.hidden_size, H * D, qb)
        self.k_proj = model_dense(cfg, cfg.hidden_size, Hkv * D, qb)
        self.v_proj = model_dense(cfg, cfg.hidden_size, Hkv * D, qb)
        self.o_proj = model_dense(cfg, H * D, cfg.hidden_size,
                                  row_parallel=True)

    def forward(self, x, cos, sin, layer_cache, cache_index, mask=None):
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, \
            cfg.head_dim
        q = apply_rotary(self.q_proj(x).view(B, T, H, D), cos, sin)
        k = apply_rotary(self.k_proj(x).view(B, T, Hkv, D), cos, sin)
        v = self.v_proj(x).view(B, T, Hkv, D)
        if layer_cache is None:
            # dense training path: kv heads repeated, causal flash, or the
            # plain attention when ``mask`` carries the padding bias
            out = dot_product_attention(q, repeat_kv(k, H // Hkv),
                                        repeat_kv(v, H // Hkv), bias=mask,
                                        causal=True,
                                        window=cfg.sliding_window)
        else:
            out = attend_cache(q, k, v, layer_cache, cache_index, mask,
                               window=cfg.sliding_window,
                               flash_from_empty=cfg.prefill_flash_from_empty)
        return self.o_proj(out.reshape(B, T, H * D))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gelu = cfg.mlp_activation == "gelu_tanh"
        self.gate_proj = model_dense(cfg, cfg.hidden_size,
                                     cfg.intermediate_size)
        self.up_proj = model_dense(cfg, cfg.hidden_size,
                                   cfg.intermediate_size)
        self.down_proj = model_dense(cfg, cfg.intermediate_size,
                                     cfg.hidden_size, row_parallel=True)

    def forward(self, x):
        gate = self.gate_proj(x)
        act = F.gelu(gate, approximate="tanh") if self.gelu else F.silu(gate)
        return self.down_proj(act * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, cos, sin, layer_cache, cache_index, mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin,
                               layer_cache, cache_index, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


def pld_keep(p_keep: torch.Tensor, generator=None) -> torch.Tensor:
    """One Bernoulli keep decision per layer: ``uniform < p_keep`` (as
    ``jax.random.bernoulli`` draws it), from ``generator`` (the default
    generator of ``p_keep``'s device when None)."""
    u = torch.rand(p_keep.shape, generator=generator, device=p_keep.device)
    return u < p_keep


def pld_gates(theta, num_layers: int, generator=None, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """Progressive layer drop's ``[L]`` gates for one step (the JAX
    ``LlamaModel``): layer ``l`` keeps with ``p_l = 1 - (l + 1) / L * (1 -
    theta)``; the gate is ``keep / max(p_l, 1e-6)`` (0 when dropped),
    in ``dtype``. ``theta`` may be a device scalar, so nothing is read
    back."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=device)
    depth = (torch.arange(num_layers, device=theta.device) + 1.0) / \
        num_layers
    p_keep = 1.0 - depth * (1.0 - theta)
    keep = pld_keep(p_keep, generator)
    return torch.where(keep, 1.0 / p_keep.clamp_min(1e-6),
                       torch.zeros_like(p_keep)).to(dtype)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        #: the offload remat policy's pinned host buffers, one stash a
        #: layer (kept, so a captured step replays over the same buffers)
        self._stashes = [HostStash() for _ in range(cfg.num_hidden_layers)]
        #: the PLD gates of the last training forward that ran (a device
        #: buffer, which a captured step's replays rewrite)
        self.last_pld_gates: Optional[torch.Tensor] = None

    def forward(self, input_ids, cache=None, cache_index=None, positions=None,
                attention_mask=None, pld_theta=None, generator=None):
        """With ``cache`` and a contiguous ``cache_index``,
        ``attention_mask`` is the ``[B, cache_len]`` key mask; without a
        cache it is the ``[B, T]`` padding mask of a training batch.
        ``pld_theta`` (a device scalar) switches on progressive layer drop
        for this forward: the keep decisions are drawn from ``generator``
        before any block runs (outside the checkpointed blocks, whose
        recompute restores no RNG state), and every block is still
        computed, so a captured step's graph is the same at every
        theta."""
        cfg = self.cfg
        x = self.embed_tokens(input_ids)
        if cfg.embed_scale is not None:
            x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
        if positions is None:
            positions = default_positions(input_ids.shape, cache,
                                          cache_index, x.device)
        cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                    dtype=x.dtype)
        if cache is not None:
            for i, layer in enumerate(self.layers):
                x = layer(x, cos, sin, {name: t[i] for name, t in
                                        cache.items()}, cache_index,
                          attention_mask)
            return self.norm(x)
        # training / dense forward: the padding mask as the JAX additive
        # key bias [B, 1, 1, T] (causality stays in the attention core)
        bias = None if attention_mask is None else \
            key_mask_to_bias(attention_mask)
        gates = None
        if pld_theta is not None:
            gates = pld_gates(pld_theta, cfg.num_hidden_layers, generator,
                              dtype=x.dtype, device=x.device)
            self.last_pld_gates = copy_into(self.last_pld_gates, gates)
        rematted = cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            x_in = x
            if rematted:
                # the blocks draw nothing (PLD draws outside them)
                x = remat(layer, x, cos, sin, None, None, bias,
                          policy=cfg.remat_policy, stash=self._stashes[i],
                          preserve_rng_state=False)
            else:
                x = layer(x, cos, sin, None, None, bias)
            if gates is not None:
                # stochastic depth: a dropped block passes its input on
                x = x_in + gates[i] * (x - x_in)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """``forward(input_ids, cache=, cache_index=[, positions,
    attention_mask]) -> (logits, cache)`` over a packed token batch (paged
    pool) or a ``[B, T]`` batch (contiguous cache), or ``forward(input_ids
    [B, T], labels[, attention_mask, pld_theta, generator]) -> loss``
    (logits without labels); see the module docstring."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = LlamaModel(config)
            self.lm_head = None if config.tie_word_embeddings else \
                nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def forward(self, input_ids, labels=None, cache=None, cache_index=None,
                attention_mask=None, positions=None, pld_theta=None,
                generator=None):
        hidden = self.model(input_ids, cache, cache_index, positions,
                            attention_mask, pld_theta, generator)
        embed = self.model.embed_tokens.weight
        if cache is None and labels is not None and self.config.loss_chunk:
            return chunked_cross_entropy_loss(
                hidden, head_weight(embed, self.lm_head),
                shift_labels(labels), chunk=self.config.loss_chunk)
        logits = lm_head_output(hidden, embed, self.lm_head)
        if cache is not None:
            return logits, cache
        if labels is None:
            return logits
        return cross_entropy_loss(logits, shift_labels(labels))

    #: no learned position table: RoPE takes any length (see
    #: ``GPT2LMHeadModel.max_positions``)
    max_positions = None

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """Empty contiguous KV cache for incremental decoding."""
        cfg = self.config
        return init_kv_cache(batch, max_len, cfg.num_key_value_heads,
                             cfg.head_dim, n_layers=cfg.num_hidden_layers,
                             dtype=dtype, device=device)

    @staticmethod
    def quantizable_projections(config: LlamaConfig):
        """``(state_dict regex, role)`` of every weight ``init_inference``
        may store quantized: "col" = output features split under tensor
        parallelism, "row" = input features split (see
        ``inference/quant.py``)."""
        return [
            (r"(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$", "col"),
            (r"(o_proj|down_proj)\.weight$", "row"),
        ]

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, device=None):
        """Empty paged KV pool for the continuous-batching serving engine."""
        cfg = self.config
        return init_paged_kv_cache(num_blocks, block_size,
                                   cfg.num_key_value_heads, cfg.head_dim,
                                   n_layers=cfg.num_hidden_layers,
                                   dtype=dtype, device=device)

    def init_params(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded random fp weights as a ``state_dict`` made on ``device``:
        norms one, biases zero, every other weight N(0, 0.02). For a
        quantized config these are the fp weights that ``init_inference``
        quantizes."""
        g = torch.Generator(device=device).manual_seed(seed)
        params = {}
        fp = self if self.config.quantize_weights is None else \
            LlamaForCausalLM(dataclasses.replace(self.config,
                                                 quantize_weights=None))
        for name, p in fp.state_dict(keep_vars=True).items():
            t = torch.empty(p.shape, dtype=dtype, device=device)
            if name.endswith("layernorm.weight") or name == "model.norm.weight":
                t.fill_(1.0)
            elif name.endswith(".bias"):
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=g)
            params[name] = t
        return params
