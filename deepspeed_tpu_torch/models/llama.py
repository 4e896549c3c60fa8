"""Llama-family decoder for the serving path (RoPE + RMSNorm + SwiGLU + GQA).

Counterpart of ``deepspeed_tpu/models/llama.py``. This slice ports the
paged MIXED step only: ``forward`` takes a packed ragged token batch
``[1, T]``, appends its KV into the paged pool through each token's row
of the block tables, and runs ragged paged attention over the pool through
``ops.ragged_attention.ragged_paged_attention``: the hand-written kernel on
CUDA tensors, its plain PyTorch version on CPU tensors. The JAX config's
``decode_attention_impl`` has no counterpart here, since the device decides.
The dense, contiguous-cache and training paths arrive with later slices and
raise here.

As with a flax module, the model object is a definition: its parameters
are built on the ``meta`` device (shapes only, no memory), and
``init_inference`` binds real weights to it (``init_params`` makes seeded
random ones; ``checkpoint.from_flax`` converts a JAX param tree).
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ragged_attention import ragged_paged_attention
from .layers import (RMSNorm, apply_rotary, init_paged_kv_cache,
                     is_paged_index, rotary_embedding, update_paged_kv_cache)


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

    def __post_init__(self):
        if self.mlp_activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"mlp_activation must be 'silu' or "
                             f"'gelu_tanh', got {self.mlp_activation!r}")

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
        self.q_proj = nn.Linear(cfg.hidden_size, H * D, bias=qb)
        self.k_proj = nn.Linear(cfg.hidden_size, Hkv * D, bias=qb)
        self.v_proj = nn.Linear(cfg.hidden_size, Hkv * D, bias=qb)
        self.o_proj = nn.Linear(H * D, cfg.hidden_size, bias=False)

    def forward(self, x, cos, sin, layer_cache, cache_index):
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, \
            cfg.head_dim
        q = apply_rotary(self.q_proj(x).view(B, T, H, D), cos, sin)
        k = apply_rotary(self.k_proj(x).view(B, T, Hkv, D), cos, sin)
        v = self.v_proj(x).view(B, T, Hkv, D)
        # the pool is updated in place (the JAX model returns a new one)
        update_paged_kv_cache(layer_cache, k, v, cache_index)
        out = ragged_paged_attention(
            q[0], layer_cache["k"], layer_cache["v"],
            cache_index["block_tables"], cache_index["query_start"],
            cache_index["query_len"], cache_index["chunk_start"],
            cache_index["context_len"], window=cfg.sliding_window,
            k_scale=layer_cache.get("k_scale"),
            v_scale=layer_cache.get("v_scale"))
        return self.o_proj(out.reshape(B, T, H * D))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.gelu = cfg.mlp_activation == "gelu_tanh"
        self.gate_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                   bias=False)
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 bias=False)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=False)

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

    def forward(self, x, cos, sin, layer_cache, cache_index):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin,
                               layer_cache, cache_index)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids, cache, cache_index):
        cfg = self.cfg
        if cache is None or not is_paged_index(cache_index) or \
                "token_rows" not in cache_index:
            raise NotImplementedError(
                "the port runs the packed paged mixed step only (cache + a "
                "paged_cache_index with token_rows); dense inference and "
                "training arrive with later slices (ROADMAP.md Queue 1)")
        x = self.embed_tokens(input_ids)
        if cfg.embed_scale is not None:
            x = x * torch.tensor(cfg.embed_scale, dtype=x.dtype)
        # each packed token's position IS its append slot (pads are -1)
        positions = cache_index["append_pos"].clamp_min(0)
        cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                    dtype=x.dtype)
        for i, layer in enumerate(self.layers):
            layer_cache = {name: t[i] for name, t in cache.items()}
            x = layer(x, cos, sin, layer_cache, cache_index)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """``forward(input_ids [1, T], cache, cache_index) -> (logits, cache)``
    over a packed token batch; see the module docstring."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = LlamaModel(config)
            self.lm_head = None if config.tie_word_embeddings else \
                nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def forward(self, input_ids, cache=None, cache_index=None):
        hidden = self.model(input_ids, cache, cache_index)
        if self.lm_head is None:
            logits = hidden @ self.model.embed_tokens.weight.T
        else:
            logits = self.lm_head(hidden)
        return logits, cache

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, device=None):
        """Empty paged KV pool for the continuous-batching serving engine."""
        cfg = self.config
        return init_paged_kv_cache(num_blocks, block_size,
                                   cfg.num_key_value_heads, cfg.head_dim,
                                   n_layers=cfg.num_hidden_layers,
                                   dtype=dtype, device=device)

    def init_params(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded random weights as a ``state_dict`` made on ``device``:
        norms one, biases zero, every other weight N(0, 0.02)."""
        g = torch.Generator(device=device).manual_seed(seed)
        params = {}
        for name, p in self.state_dict(keep_vars=True).items():
            t = torch.empty(p.shape, dtype=dtype, device=device)
            if name.endswith("layernorm.weight") or name == "model.norm.weight":
                t.fill_(1.0)
            elif name.endswith(".bias"):
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=g)
            params[name] = t
        return params
