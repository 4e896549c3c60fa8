"""Building blocks of the port's Llama model and its paged KV pool.

Counterparts of ``deepspeed_tpu/models/layers.py`` for the serving path:
RMSNorm, rotary embeddings, int8 KV quantization, the paged pool, its
index bundle, the packed append and the multi-position logit harvest.
JAX arrays are immutable, so the JAX pool update returns a new pool; here
the pool tensors are updated in place.
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


class RMSNorm(nn.Module):
    """RMS LayerNorm (Llama-style): fp32 statistics, result cast back to
    the input dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden_size))

    def forward(self, x):
        x32 = x.float()
        var = x32.pow(2).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 10000.0, dtype=torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables for positions ``[B, T]`` -> ``[B, T, head_dim/2]``,
    computed in fp32 and cast to ``dtype`` (the activation dtype)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                                / head_dim))
    freqs = positions[..., None].float() * torch.from_numpy(
        inv_freq).to(positions.device)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: ``[B, T, H, D]``; cos/sin: ``[B, T, D/2]``."""
    x1, x2 = x.chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _quantize_kv(x):
    """``[..., D]`` -> (int8 values, fp32 absmax-per-row scales over the
    last axis)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0
    q = torch.round(x32 / scale.clamp_min(1e-8)[..., None]).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of ``_quantize_kv`` (the per-row scale broadcasts over D)."""
    return (q.float() * scale[..., None]).to(dtype)


def init_paged_kv_cache(num_blocks: int, block_size: int, num_kv_heads: int,
                        head_dim: int, n_layers: Optional[int] = None,
                        dtype=torch.bfloat16, device=None):
    """An empty paged KV pool ``[L?, N, Hkv, bs, D]``. ``dtype=torch.int8``
    stores absmax-quantized values with fp32 scales ``[L?, N, Hkv, bs]``
    beside them (quantized per position and kv head at append)."""
    shape = (num_blocks, num_kv_heads, block_size, head_dim)
    sshape = (num_blocks, num_kv_heads, block_size)
    if n_layers is not None:
        shape = (n_layers,) + shape
        sshape = (n_layers,) + sshape
    if dtype == torch.int8:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v_scale": torch.zeros(sshape, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_cache_index(block_tables, append_pos, context_len,
                      chunk_start=None, token_rows=None, query_start=None,
                      query_len=None, device=None):
    """Bundle the paging state of one step as int32 tensors on ``device``.

    ``block_tables``: ``[R, nb]`` pool page ids per row (entry
    ``num_blocks`` = unallocated); ``append_pos``: ``[B, T]`` absolute
    position of each incoming token (``-1`` = padding); ``context_len``:
    ``[R]`` valid pool tokens after this step's append; ``chunk_start``:
    ``[R]`` position of each row's first query token. The packed mixed
    step adds ``token_rows`` (``[B, T]``, each token's row, ``-1`` =
    padding), ``query_start`` and ``query_len`` (``[R]``, each row's
    segment of the packed token axis)."""
    def t(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=torch.int32, device=device)

    out = {"block_tables": t(block_tables), "append_pos": t(append_pos),
           "context_len": t(context_len)}
    if chunk_start is not None:
        out["chunk_start"] = t(chunk_start)
    if token_rows is not None:
        out["token_rows"] = t(token_rows)
        out["query_start"] = t(query_start)
        out["query_len"] = t(query_len)
    return out


def is_paged_index(cache_index) -> bool:
    """True when ``cache_index`` is a paged-cache bundle."""
    return isinstance(cache_index, dict) and "block_tables" in cache_index


def _packed_write_targets(cache_index, num_blocks: int, block_size: int):
    """``(token, page, offset)`` of every packed token whose KV lands in the
    pool. Padding (``append_pos < 0`` or ``token_rows < 0``), positions past
    the table width and unallocated (sentinel) table entries are dropped.
    Computed once per step (one host sync for the compaction) and kept in
    the bundle, which every layer of the step shares."""
    key = (num_blocks, block_size)
    memo = cache_index.get("write_targets")
    if memo is not None and memo[0] == key:
        return memo[1]
    pos = cache_index["append_pos"].reshape(-1).long()
    rows = cache_index["token_rows"].reshape(-1).long()
    tables = cache_index["block_tables"]
    R, nb = tables.shape
    blk = pos.clamp_min(0) // block_size
    off = pos.clamp_min(0) % block_size
    bids = tables[rows.clamp(0, R - 1), blk.clamp_max(nb - 1)].long()
    valid = (pos >= 0) & (rows >= 0) & (blk < nb) & (bids >= 0) \
        & (bids < num_blocks)
    tok = valid.nonzero().squeeze(1)
    targets = (tok, bids[tok], off[tok])
    cache_index["write_targets"] = (key, targets)
    return targets


def update_paged_kv_cache(layer_cache, k, v, cache_index):
    """Append the packed step's ``[1, T, Hkv, D]`` keys/values into one
    layer's pool ``{"k", "v"[, "k_scale", "v_scale"]}`` in place: token
    ``t`` lands at ``pool[table[row[t], pos // bs], :, pos % bs]``. Pads and
    sentinel targets are dropped, never written. An int8 pool quantizes
    at append (absmax per token and kv head). Returns ``layer_cache``."""
    if "token_rows" not in cache_index:
        raise NotImplementedError(
            "only the packed mixed step's append (token_rows) is ported; "
            "the legacy per-row paged append arrives with the legacy "
            "two-program engine (ROADMAP.md Queue 1)")
    num_blocks, Hkv, bs, D = layer_cache["k"].shape
    tok, bids, off = _packed_write_targets(cache_index, num_blocks, bs)
    k = k.reshape(-1, Hkv, D)[tok]
    v = v.reshape(-1, Hkv, D)[tok]
    if "k_scale" in layer_cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        layer_cache["k"][bids, :, off] = kq
        layer_cache["v"][bids, :, off] = vq
        layer_cache["k_scale"][bids, :, off] = ks
        layer_cache["v_scale"][bids, :, off] = vs
    else:
        layer_cache["k"][bids, :, off] = k.to(layer_cache["k"].dtype)
        layer_cache["v"][bids, :, off] = v.to(layer_cache["v"].dtype)
    return layer_cache


def harvest_packed_logits(logits, token_rows, num_rows: int):
    """Multi-position harvest of the packed mixed step.

    ``logits``: ``[1, T, V]``; ``token_rows``: ``[1, T]`` or ``[T]``
    (``-1`` = padding). Returns ``(lg, bad)``: ``lg`` the ``[T, V]``
    per-position logits the caller samples, and ``bad`` a ``[R]`` flag of
    rows with a NaN/Inf logit at any of their valid tokens."""
    lg = logits[0]
    rows = token_rows.reshape(-1).long()
    valid = rows >= 0
    safe = rows.clamp(0, num_rows - 1)
    bad_tok = ~torch.isfinite(lg).all(dim=-1) & valid
    bad = torch.zeros(num_rows, dtype=torch.int32, device=lg.device)
    return lg, bad.index_add_(0, safe, bad_tok.int()) > 0
