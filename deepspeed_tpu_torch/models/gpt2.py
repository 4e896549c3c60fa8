"""GPT-2 family decoder (learned positions, pre-LN with biases, GELU).

Counterpart of ``deepspeed_tpu/models/gpt2.py``. Every path of the JAX
model is here, on the kernels the port's Llama runs: its cached branches
are ``layers.attend_cache``, which the Llama shares (H = Hkv, so no kv
head is repeated):

- the paged MIXED step of the serving engine (``token_rows`` in the
  bundle): ragged paged attention through
  ``ops.ragged_attention.ragged_paged_attention`` (kernel K6);
- the two-program serving engine's paged steps: the decode over all slots
  (``T == 1``) through ``ops.decode_attention.paged_decode_attention``
  (K7a), a prefill chunk mid-prompt (``chunk_start`` in the bundle)
  through ``paged_prefill_attention`` (K7b), and the from-empty prefill
  over the fresh K/V, through the masked flash kernel (K1's key mask) when
  ``prefill_flash_from_empty``, else a plain masked attention;
- dense generation over the contiguous head-major cache: one new token
  per row through ``ops.decode_attention.decode_attention`` (K4), a
  prefill through the plain ``cached_attention`` or, with
  ``prefill_flash_from_empty``, the masked flash kernel;
- the dense forward: logits, or with ``labels`` the fp32 token-mean loss
  over shifted labels (the chunked loss with ``loss_chunk``), through
  causal flash attention (K1/K2), or the plain attention under a padding
  ``attention_mask``'s -1e9 key bias; ``remat`` recomputes each block in
  the backward; the dropouts of the config apply in training mode (the
  attention's through the plain attention); a sequence longer than
  ``n_positions`` raises.

The JAX model sends its paged branches to XLA reference attentions; the
port's wrappers are those references' kernels. The projections come from
``layers.model_dense`` (``nn.Linear``, or ``QuantLinear`` over int8/int4
codes, kernel K5, with the bias added after the product). State-dict names
follow HF's ``GPT2LMHeadModel`` (``transformer.h.{i}.attn.c_attn.weight``
...), with the weights in the ``nn.Linear`` layout ``[out, in]`` (HF's
``Conv1D`` stores ``[in, out]``); the LM head is tied to ``wte`` and has
no tensor of its own.

As with the port's Llama, the model object is a definition: its
parameters are built on the ``meta`` device, and an engine binds real
weights to it (``init_params`` makes seeded random ones;
``checkpoint.from_flax`` converts a JAX param tree, ``module_inject`` an HF
model or checkpoint directory).
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (LayerNorm, attend_cache, chunked_cross_entropy_loss,
                     cross_entropy_loss, default_positions, dropout,
                     dot_product_attention, gelu_new, init_kv_cache,
                     init_paged_kv_cache, key_mask_to_bias, model_dense,
                     remat, shift_labels)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    #: the learned position table's length: no sequence may be longer
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    #: dropout rates, applied in training mode only
    resid_pdrop: float = 0.0
    attn_pdrop: float = 0.0
    embd_pdrop: float = 0.0
    #: the JAX attention choice ("xla" | "flash"): the device picks the
    #: kernel here, so both are accepted and change nothing
    attention_impl: str = "xla"
    #: a prefill that starts from an EMPTY cache attends its fresh K/V
    #: through the masked flash kernel (see ``LlamaConfig``)
    prefill_flash_from_empty: bool = False
    #: the JAX layout of the block weights; the port keeps one module a
    #: layer (LAMB's trust ratio spans a layer's tensors when True)
    scan_layers: bool = True
    #: training: recompute each block in the backward
    remat: bool = False
    #: >0: the chunked training loss; 0 = plain
    loss_chunk: int = 0
    # -- quantized weights (set by init_inference; see LlamaConfig) -----
    quantize_weights: Optional[str] = None
    quantize_group_size: int = 0
    quantized_collectives: bool = False
    quantized_psum_block: int = 256
    quantize_row_shards: int = 1

    def __post_init__(self):
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd={self.n_embd} is not a multiple of "
                             f"n_head={self.n_head}")
        if self.quantize_weights not in (None, "int8", "int4"):
            raise ValueError(f"quantize_weights must be None, 'int8' or "
                             f"'int4', got {self.quantize_weights!r}")
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be 'xla' or 'flash', got "
                             f"{self.attention_impl!r}")
        if not isinstance(self.scan_layers, bool):
            raise ValueError(f"scan_layers must be True or False, got "
                             f"{self.scan_layers!r}")
        for name in ("resid_pdrop", "attn_pdrop", "embd_pdrop"):
            if not 0.0 <= getattr(self, name) < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got "
                                 f"{getattr(self, name)!r}")
        if self.quantized_collectives or self.quantized_psum_block != 256:
            raise NotImplementedError(
                "quantized_collectives and quantized_psum_block != 256 "
                "arrive with the distributed slice of the port (ROADMAP.md "
                "Queue 1, item 9)")
        if isinstance(self.loss_chunk, bool) or \
                not isinstance(self.loss_chunk, int) or self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be an int >= 0, got "
                             f"{self.loss_chunk!r}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def gpt2_125m(**over):
        return GPT2Config(**{**dict(n_embd=768, n_layer=12, n_head=12),
                             **over})

    @staticmethod
    def tiny(**over):
        return GPT2Config(**{**dict(vocab_size=256, n_positions=128,
                                    n_embd=64, n_layer=2, n_head=4), **over})


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        C = cfg.n_embd
        self.c_attn = model_dense(cfg, C, 3 * C, bias=True)
        self.c_proj = model_dense(cfg, C, C, bias=True, row_parallel=True)

    def forward(self, x, layer_cache, cache_index, mask=None):
        cfg = self.cfg
        B, T, C = x.shape
        H, D = cfg.n_head, cfg.head_dim
        # the fused projection's thirds, each made contiguous (the
        # kernels take contiguous q, k and v)
        q, k, v = (t.reshape(B, T, H, D).contiguous()
                   for t in self.c_attn(x).split(C, dim=-1))
        if layer_cache is None:
            # dense training path: causal flash, or the plain attention
            # under the padding bias (or with attention dropout)
            out = dot_product_attention(
                q, k, v, bias=mask, causal=True,
                dropout_p=cfg.attn_pdrop if self.training else 0.0)
        else:
            out = attend_cache(q, k, v, layer_cache, cache_index, mask,
                               flash_from_empty=cfg.prefill_flash_from_empty)
        out = self.c_proj(out.reshape(B, T, C))
        return dropout(out, cfg.resid_pdrop, self.training)


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.pdrop = cfg.resid_pdrop
        self.c_fc = model_dense(cfg, cfg.n_embd, 4 * cfg.n_embd, bias=True)
        self.c_proj = model_dense(cfg, 4 * cfg.n_embd, cfg.n_embd, bias=True,
                                  row_parallel=True)

    def forward(self, x):
        h = self.c_proj(gelu_new(self.c_fc(x)))
        return dropout(h, self.pdrop, self.training)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon)
        self.attn = GPT2Attention(cfg)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon)
        self.mlp = GPT2MLP(cfg)

    def forward(self, x, layer_cache, cache_index, mask=None):
        x = x + self.attn(self.ln_1(x), layer_cache, cache_index, mask)
        return x + self.mlp(self.ln_2(x))


class GPT2Model(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Embedding(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList(GPT2Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon)

    def forward(self, input_ids, cache=None, cache_index=None, positions=None,
                attention_mask=None):
        """With ``cache`` and a contiguous ``cache_index``,
        ``attention_mask`` is the ``[B, cache_len]`` key mask; without a
        cache it is the ``[B, T]`` padding mask of a training batch."""
        cfg = self.cfg
        if cache is None and input_ids.shape[1] > cfg.n_positions:
            raise ValueError(
                f"a sequence of {input_ids.shape[1]} tokens exceeds the "
                f"model's n_positions={cfg.n_positions}")
        if positions is None:
            positions = default_positions(input_ids.shape, cache,
                                          cache_index, input_ids.device)
        if cache is not None:
            # a cached position past the table occurs only in the tokens
            # that generate's bucketing makes and trims (the JAX gather
            # fills them with NaN); the engines refuse longer requests
            positions = positions.clamp(0, cfg.n_positions - 1)
        x = self.wte(input_ids) + self.wpe(positions)
        x = dropout(x, cfg.embd_pdrop, self.training)
        if cache is not None:
            for i, block in enumerate(self.h):
                x = block(x, {name: t[i] for name, t in cache.items()},
                          cache_index, attention_mask)
            return self.ln_f(x)
        bias = None if attention_mask is None else \
            key_mask_to_bias(attention_mask)
        rematted = cfg.remat and torch.is_grad_enabled()
        for block in self.h:
            # remat keeps torch's RNG state, so a recomputed block draws
            # its dropout again (as jax.checkpoint replays its key)
            x = remat(block, x, None, None, bias) if rematted else \
                block(x, None, None, bias)
        return self.ln_f(x)


class GPT2LMHeadModel(nn.Module):
    """``forward(input_ids, cache=, cache_index=[, positions,
    attention_mask]) -> (logits, cache)`` over a packed token batch (paged
    pool) or a ``[B, T]`` batch (contiguous cache), or ``forward(input_ids
    [B, T], labels[, attention_mask]) -> loss`` (logits without labels);
    see the module docstring."""

    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.transformer = GPT2Model(config)

    def forward(self, input_ids, labels=None, cache=None, cache_index=None,
                attention_mask=None, positions=None):
        hidden = self.transformer(input_ids, cache, cache_index, positions,
                                  attention_mask)
        wte = self.transformer.wte.weight
        if cache is None and labels is not None and self.config.loss_chunk:
            return chunked_cross_entropy_loss(hidden, wte.T,
                                              shift_labels(labels),
                                              chunk=self.config.loss_chunk)
        # the LM head tied to wte (the GPT-2 convention)
        logits = hidden @ wte.T.to(hidden.dtype)
        if cache is not None:
            return logits, cache
        if labels is None:
            return logits
        return cross_entropy_loss(logits, shift_labels(labels))

    @property
    def max_positions(self) -> int:
        """The longest sequence the model takes: its learned position
        table's length (the engines refuse longer requests)."""
        return self.config.n_positions

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """Empty contiguous KV cache for incremental decoding."""
        cfg = self.config
        return init_kv_cache(batch, max_len, cfg.n_head, cfg.head_dim,
                             n_layers=cfg.n_layer, dtype=dtype,
                             device=device)

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         dtype=torch.bfloat16, device=None):
        """Empty paged KV pool for the continuous-batching serving engine."""
        cfg = self.config
        return init_paged_kv_cache(num_blocks, block_size, cfg.n_head,
                                   cfg.head_dim, n_layers=cfg.n_layer,
                                   dtype=dtype, device=device)

    @staticmethod
    def quantizable_projections(config: GPT2Config):
        """See ``LlamaForCausalLM.quantizable_projections``."""
        return [
            (r"(attn\.c_attn|mlp\.c_fc)\.weight$", "col"),
            (r"(attn|mlp)\.c_proj\.weight$", "row"),
        ]

    def init_params(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded random fp weights as a ``state_dict`` made on ``device``:
        LayerNorm scales one, biases zero, every other weight N(0, 0.02)."""
        g = torch.Generator(device=device).manual_seed(seed)
        fp = self if self.config.quantize_weights is None else \
            GPT2LMHeadModel(dataclasses.replace(self.config,
                                                quantize_weights=None))
        params = {}
        for name, p in fp.state_dict(keep_vars=True).items():
            t = torch.empty(p.shape, dtype=dtype, device=device)
            if name.endswith(".bias"):
                t.zero_()
            elif ".ln_" in name:
                t.fill_(1.0)
            else:
                t.normal_(0.0, 0.02, generator=g)
            params[name] = t
        return params
