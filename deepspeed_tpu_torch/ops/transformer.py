"""``DeepSpeedTransformerConfig`` and ``DeepSpeedTransformerLayer``: the
drop-in BERT-style encoder layer.

Counterpart of ``deepspeed_tpu/ops/transformer.py``. The layer is a thin
module over ``models.transformer.TransformerBlock`` (non-causal, no
positions, exact GELU), so its attention reaches the port's flash kernels
(K1/K2, non-causal) where the block's does: with no additive mask and no
dropout; a mask (a ``[B, S]`` key mask or an additive bias) takes the
plain attention, as the JAX layer sends a biased attention down its XLA
path.

The config keeps the reference's keyword surface. ``fp16`` selects bf16
compute for the projections (the input and the output are bf16,
LayerNorms compute in fp32); the dropout ratios apply in a forward with
``deterministic=False``; ``initializer_range`` / ``adjust_init_range``
give BERT's N(0, std) init with the residual-output projections scaled by
1/sqrt(2L); each activation-dropping memory knob
(``normalize_invertible``, ``gelu_checkpoint``,
``attn_dropout_checkpoint``) recomputes the block in the backward
(``remat_policy="nothing"``); ``batch_size``, ``local_rank``,
``training`` and ``stochastic_mode`` are accepted and change nothing, and
``seed`` (when >= 0) seeds the layer's initial weights.
"""

import dataclasses

import torch
from torch import nn

from ..inference.engine import resolve_device
from ..models.layers import key_mask_to_bias, remat
from ..models.transformer import (TransformerBlock, TransformerConfig,
                                  init_params)


@dataclasses.dataclass(frozen=True)
class DeepSpeedTransformerConfig:
    batch_size: int = -1
    hidden_size: int = -1
    intermediate_size: int = -1
    heads: int = -1
    attn_dropout_ratio: float = 0.0
    hidden_dropout_ratio: float = 0.0
    num_hidden_layers: int = -1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    local_rank: int = -1
    seed: int = -1
    fp16: bool = False
    pre_layer_norm: bool = True
    normalize_invertible: bool = False
    gelu_checkpoint: bool = False
    adjust_init_range: bool = True
    attn_dropout_checkpoint: bool = False
    stochastic_mode: bool = False
    return_tuple: bool = False
    training: bool = True

    def to_block_config(self) -> TransformerConfig:
        inter = self.intermediate_size if self.intermediate_size > 0 \
            else 4 * self.hidden_size
        return TransformerConfig(
            vocab_size=1,                  # the layer has no embeddings
            hidden_size=self.hidden_size,
            intermediate_size=inter,
            num_hidden_layers=max(1, self.num_hidden_layers),
            num_attention_heads=self.heads,
            max_position_embeddings=1,
            causal=False,                  # BERT's bidirectional layer
            pos_embedding="none",
            activation="gelu",
            norm_eps=self.layer_norm_eps,
            pre_layernorm=self.pre_layer_norm,
            attn_dropout=self.attn_dropout_ratio,
            hidden_dropout=self.hidden_dropout_ratio,
            compute_dtype=torch.bfloat16 if self.fp16 else None,
            initializer_range=self.initializer_range,
            adjust_init_range=self.adjust_init_range,
            # any activation-dropping knob: recompute in the backward
            remat=(self.normalize_invertible or self.gelu_checkpoint
                   or self.attn_dropout_checkpoint),
            remat_policy="nothing")


class DeepSpeedTransformerLayer(nn.Module):
    """``layer(hidden_states, attention_mask=None, deterministic=True)``:
    ``attention_mask`` is a ``[B, S]`` 1/0 key mask or an additive bias
    that broadcasts to ``[B, H, S, S]``. The weights (``layer.*``, the
    flax paths of the JAX layer's ``layer/...`` tree) are made on
    ``device`` (``cuda`` unless the caller says otherwise) from the
    config's init, seeded by ``config.seed`` (0 when it is -1)."""

    def __init__(self, config: DeepSpeedTransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.block_config = config.to_block_config()
        device = resolve_device(device)
        with torch.device("meta"):
            self.layer = TransformerBlock(self.block_config)
        params = init_params(self, self.block_config,
                             seed=max(config.seed, 0), device=device)
        self.load_state_dict(params, assign=True)

    def forward(self, hidden_states, attention_mask=None,
                deterministic: bool = True):
        cfg = self.block_config
        x = hidden_states
        if self.config.fp16:
            x = x.to(torch.bfloat16)
        bias = None
        if attention_mask is not None:
            bias = key_mask_to_bias(attention_mask) \
                if attention_mask.dim() == 2 else attention_mask.float()
        if cfg.remat and torch.is_grad_enabled():
            drawing = not deterministic and (cfg.attn_dropout > 0 or
                                             cfg.hidden_dropout > 0)
            out = remat(self.layer, x, None, None, bias, None, None,
                        deterministic, preserve_rng_state=drawing)
        else:
            out = self.layer(x, None, None, bias, None, None, deterministic)
        if self.config.fp16:
            out = out.to(torch.bfloat16)
        return (out,) if self.config.return_tuple else out
