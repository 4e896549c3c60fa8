"""Mixtral-family sparse-MoE decoder.

Counterpart of ``deepspeed_tpu/models/mixtral.py``: the Llama block with
the MLP replaced by a top-k mixture of SwiGLU experts, with HF
``MixtralForCausalLM``'s routing: router logits, softmax over all experts
(fp32), top-k, the k weights renormalized (fp32), the selected experts'
outputs summed with those weights (cast to the model dtype), and in
training the Switch load-balancing loss scaled by
``router_aux_loss_coef``. Attention, rotary and the KV cache are the
port's Llama ones (``LlamaAttention``), so on the card a dense training
forward runs kernels K1/K2, a cached decode K4 and, with
``prefill_flash_from_empty``, a prefill the masked K1.

The expert weights are stacked per layer, ``w1`` / ``w3`` ``[E, H, I]``
and ``w2`` ``[E, I, H]`` (the JAX leaves' layout), and the routing runs
in plain PyTorch, as the JAX model runs it outside any Pallas kernel. Two
routes, chosen as JAX chooses them:

- one token a row (``T == 1``) with more experts than are picked: only
  the touched experts' weights are gathered (``index_select``, ``B * K``
  expert slices) and multiplied;
- otherwise the dense route: every expert on every token, combined with
  ``[B, T, E]`` weights that are zero outside the top-k (exact, no
  capacity drops).

Both are static-shaped (no ``nonzero``, ``unique`` or read-back), so a
captured decode step or training step replays them.

Each layer returns its token-masked per-expert routed fraction and mean
router probability; the model sums them over layers and takes ``E *
sum((frac / L) * (prob / L))`` at the top, as HF's
``load_balancing_loss_func`` concatenates all layers' tokens before the
product. With a cache the aux statistics are not consumed (no token
mask). The model has ``init_cache`` and no ``init_paged_cache``, so the
serving engines refuse it, as the JAX ones do; it declares no quantizable
projections.
"""

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (HostStash, RMSNorm, chunked_cross_entropy_loss,
                     cross_entropy_loss, default_positions, head_weight,
                     init_kv_cache, key_mask_to_bias, lm_head_output, remat,
                     rotary_embedding, shift_labels)
from .llama import LlamaAttention, LlamaConfig


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    router_aux_loss_coef: float = 0.02

    @staticmethod
    def mixtral_8x7b(**over):
        return MixtralConfig(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, max_position_embeddings=32768,
            rope_theta=1e6, num_local_experts=8, num_experts_per_tok=2),
            **over})

    @staticmethod
    def tiny(**over):
        return MixtralConfig(**{**dict(
            vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            num_local_experts=4, num_experts_per_tok=2, remat=False), **over})


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx.unsqueeze(-1) ==
            torch.arange(n, device=idx.device)).to(torch.float32)


def touched_experts(x, w1, w3, w2, topk_w, topk_idx):
    """The decode route (one token a row): ``x [B, H]``; only the ``B *
    K`` picked experts' weights are gathered and multiplied. Returns
    ``[B, H]``."""
    B, H = x.shape
    K = topk_idx.shape[1]
    dt = x.dtype
    idx = topk_idx.reshape(-1)

    def take(w):
        return w.index_select(0, idx).view((B, K) + tuple(w.shape[1:])) \
            .to(dt)

    xt = x[:, None, None, :]                                # [B, 1, 1, H]
    hidden = F.silu(torch.matmul(xt, take(w1))) * \
        torch.matmul(xt, take(w3))                          # [B, K, 1, I]
    y = torch.matmul(hidden, take(w2))[:, :, 0]             # [B, K, H]
    return torch.einsum("bk,bkh->bh", topk_w.to(dt), y)


def every_expert(x, w1, w3, w2, combine):
    """The dense route: every expert on every token ``x [S, H]``, summed
    with ``combine [S, E]`` (fp32, zero outside the top-k, cast to the
    model dtype). Returns ``[S, H]``."""
    dt = x.dtype
    hidden = F.silu(torch.matmul(x, w1.to(dt))) * \
        torch.matmul(x, w3.to(dt))                          # [E, S, I]
    y = torch.matmul(hidden, w2.to(dt))                     # [E, S, H]
    return torch.einsum("se,esh->sh", combine.to(dt), y)


class MixtralSparseMoeBlock(nn.Module):
    """HF ``MixtralSparseMoeBlock`` semantics. ``forward(x [B, T, H],
    token_mask=None) -> (out, frac, prob)``: ``frac`` / ``prob`` are this
    layer's token-masked per-expert routed fraction and mean router
    probability ``[E]``, which the model sums over layers."""

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        E, H, I = cfg.num_local_experts, cfg.hidden_size, \
            cfg.intermediate_size
        self.num_experts, self.top_k = E, cfg.num_experts_per_tok
        self.gate = nn.Linear(H, E, bias=False)
        self.w1 = nn.Parameter(torch.empty(E, H, I))        # gate
        self.w3 = nn.Parameter(torch.empty(E, H, I))        # up
        self.w2 = nn.Parameter(torch.empty(E, I, H))        # down

    def forward(self, x, token_mask=None):
        B, T, H = x.shape
        E, K = self.num_experts, self.top_k
        w = self.gate.weight
        # flax's Dense promotes x and its kernel (fp32 when either is)
        ct = torch.promote_types(x.dtype, w.dtype)
        probs = F.linear(x.to(ct), w.to(ct)).float().softmax(dim=-1)
        topk_w, topk_idx = probs.topk(K, dim=-1)
        topk_w = topk_w / topk_w.sum(dim=-1, keepdim=True)
        onehot = _one_hot(topk_idx, E)                     # [B, T, K, E]
        if T == 1 and E > K:
            out = touched_experts(x[:, 0], self.w1, self.w3, self.w2,
                                  topk_w[:, 0], topk_idx[:, 0])[:, None]
        else:
            combine = torch.einsum("btk,btke->bte", topk_w, onehot)
            out = every_expert(x.reshape(B * T, H), self.w1, self.w3,
                               self.w2, combine.reshape(B * T, E)
                               ).reshape(B, T, H)
        routed = onehot.amax(dim=2)                         # [B, T, E]
        if token_mask is None:
            denom = float(B * T)
            frac = routed.sum(dim=(0, 1)) / denom
            prob = probs.sum(dim=(0, 1)) / denom
        else:
            m = token_mask.float()[..., None]
            denom = m.sum().clamp_min(1.0)
            frac = (routed * m).sum(dim=(0, 1)) / denom
            prob = (probs * m).sum(dim=(0, 1)) / denom
        return out, frac, prob


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.block_sparse_moe = MixtralSparseMoeBlock(cfg)

    def forward(self, x, cos, sin, layer_cache, cache_index, mask=None,
                token_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin,
                               layer_cache, cache_index, mask)
        out, frac, prob = self.block_sparse_moe(
            self.post_attention_layernorm(x), token_mask)
        return x + out, frac, prob


class MixtralModel(nn.Module):
    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(MixtralBlock(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        #: the offload remat policy's pinned host buffers, one a layer
        self._stashes = [HostStash() for _ in range(cfg.num_hidden_layers)]

    def forward(self, input_ids, cache=None, cache_index=None, positions=None,
                attention_mask=None):
        """``(hidden, aux)``. With ``cache``, ``attention_mask`` is the
        ``[B, cache_len]`` key mask and the aux statistics are over every
        token; without, it is the ``[B, T]`` padding mask of a training
        batch: the attention's -1e9 key bias and the aux loss's token
        mask."""
        cfg = self.cfg
        x = self.embed_tokens(input_ids)
        if positions is None:
            positions = default_positions(input_ids.shape, cache,
                                          cache_index, x.device)
        cos, sin = rotary_embedding(positions, cfg.head_dim, cfg.rope_theta,
                                    dtype=x.dtype)
        E = cfg.num_local_experts
        frac_sum = torch.zeros((E,), dtype=torch.float32, device=x.device)
        prob_sum = torch.zeros_like(frac_sum)
        if cache is not None:
            for i, layer in enumerate(self.layers):
                x, frac, prob = layer(x, cos, sin, {name: t[i] for name, t
                                                    in cache.items()},
                                      cache_index, attention_mask)
                frac_sum, prob_sum = frac_sum + frac, prob_sum + prob
        else:
            bias = None if attention_mask is None else \
                key_mask_to_bias(attention_mask)
            rematted = cfg.remat and torch.is_grad_enabled()
            for i, layer in enumerate(self.layers):
                if rematted:
                    # the blocks draw nothing
                    x, frac, prob = remat(
                        layer, x, cos, sin, None, None, bias, attention_mask,
                        policy=cfg.remat_policy, stash=self._stashes[i],
                        preserve_rng_state=False)
                else:
                    x, frac, prob = layer(x, cos, sin, None, None, bias,
                                          attention_mask)
                frac_sum, prob_sum = frac_sum + frac, prob_sum + prob
        L = cfg.num_hidden_layers
        aux = E * torch.sum((frac_sum / L) * (prob_sum / L))
        return self.norm(x), aux


class MixtralForCausalLM(nn.Module):
    """The same interface as ``LlamaForCausalLM``: ``forward(input_ids,
    labels)`` returns the LM loss plus ``router_aux_loss_coef`` times the
    aux loss (logits without labels); ``forward(input_ids, cache=,
    cache_index=[, positions, attention_mask])`` returns ``(logits,
    cache)``."""

    def __init__(self, config: MixtralConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.model = MixtralModel(config)
            self.lm_head = None if config.tie_word_embeddings else \
                nn.Linear(config.hidden_size, config.vocab_size, bias=False)

    def forward(self, input_ids, labels=None, cache=None, cache_index=None,
                attention_mask=None, positions=None):
        cfg = self.config
        hidden, aux = self.model(input_ids, cache, cache_index, positions,
                                 attention_mask)
        embed = self.model.embed_tokens.weight
        if cache is None and labels is not None and cfg.loss_chunk:
            lm = chunked_cross_entropy_loss(
                hidden, head_weight(embed, self.lm_head),
                shift_labels(labels), chunk=cfg.loss_chunk)
            return lm + cfg.router_aux_loss_coef * aux
        logits = lm_head_output(hidden, embed, self.lm_head)
        if cache is not None:
            return logits, cache
        if labels is None:
            return logits
        return cross_entropy_loss(logits, shift_labels(labels)) + \
            cfg.router_aux_loss_coef * aux

    #: RoPE takes any length
    max_positions = None

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   device=None):
        """Empty contiguous KV cache for incremental decoding."""
        cfg = self.config
        return init_kv_cache(batch, max_len, cfg.num_key_value_heads,
                             cfg.head_dim, n_layers=cfg.num_hidden_layers,
                             dtype=dtype, device=device)

    def init_params(self, seed: int = 0, dtype=torch.float32, device=None):
        """Seeded random weights as a ``state_dict`` made on ``device``:
        norms one, every other weight N(0, 0.02)."""
        g = torch.Generator(device=device).manual_seed(seed)
        params = {}
        for name, p in self.state_dict(keep_vars=True).items():
            t = torch.empty(p.shape, dtype=dtype, device=device)
            if name.endswith("layernorm.weight") or \
                    name == "model.norm.weight":
                t.fill_(1.0)
            else:
                t.normal_(0.0, 0.02, generator=g)
            params[name] = t
        return params
