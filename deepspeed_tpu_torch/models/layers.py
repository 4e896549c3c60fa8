"""Building blocks of the port's Llama model and its KV caches.

Counterparts of ``deepspeed_tpu/models/layers.py``. For the serving path:
RMSNorm, rotary embeddings, int8 KV quantization, the paged pool, its
index bundle, the packed and the per-row append, the page copy of
copy-on-write, the from-empty prefill attention and the multi-position
logit harvest.
For dense generation: the contiguous head-major cache, its append, the
cached attention of a prefill and the cache bias. JAX arrays are
immutable, so the JAX cache updates return new caches; here the cache
tensors are updated in place. For the training path: ``repeat_kv``, the
attention core, the loss and the LM head. For every path: the projection
factory ``model_dense`` and its quantized layer ``QuantLinear``.
"""

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.flash_attention import flash_attention
from ..ops.quant_matmul import effective_group_size, quant_matmul


class QuantLinear(nn.Module):
    """A linear layer whose weight is stored quantized: the counterpart of
    the JAX ``QuantDense`` without its tensor-parallel reduction.

    Buffers: ``qweight``, the codes in the JAX layout (int8 ``[K, N]``, or
    uint8 ``[K//2, N]`` with two int4 codes per byte along K; never
    transposed), ``wscale``, fp32 scales ``[G, N]``, and an optional fp
    ``bias``. The product runs through ``ops.quant_matmul.quant_matmul``
    (kernel K5 on CUDA tensors, its plain version on CPU tensors).
    ``init_inference`` fills the buffers from fp weights
    (``inference/quant.py``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 mode: str, group_size: int = 0, shards: int = 1):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.mode = mode
        g = effective_group_size(in_features, mode, group_size, shards)
        rows = in_features // 2 if mode == "int4" else in_features
        self.register_buffer("qweight", torch.zeros(
            rows, out_features,
            dtype=torch.uint8 if mode == "int4" else torch.int8))
        self.register_buffer("wscale", torch.ones(in_features // g,
                                                  out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        lead = x.shape[:-1]
        y = quant_matmul(x.reshape(-1, self.in_features), self.qweight,
                         self.wscale, self.mode)
        y = y.reshape(*lead, self.out_features)
        return y if self.bias is None else y + self.bias


def model_dense(cfg, in_features: int, out_features: int, bias: bool = False,
                row_parallel: bool = False) -> nn.Module:
    """The projection factory every family shares: ``nn.Linear`` unless
    ``cfg.quantize_weights`` asks for a :class:`QuantLinear`. Row-parallel
    projections (o_proj, down_proj) align their scale groups to
    ``cfg.quantize_row_shards``, the tensor-parallel width the weights
    were quantized for (1 in this port)."""
    mode = getattr(cfg, "quantize_weights", None)
    if mode is None:
        return nn.Linear(in_features, out_features, bias=bias)
    return QuantLinear(in_features, out_features, bias, mode,
                       getattr(cfg, "quantize_group_size", 0),
                       getattr(cfg, "quantize_row_shards", 1)
                       if row_parallel else 1)


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
    freqs = positions[..., None].float() * _inv_freq(head_dim, theta,
                                                     positions.device)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device
              ) -> torch.Tensor:
    """RoPE's inverse frequencies on ``device``, copied there once (a copy
    from host memory cannot be captured in a CUDA graph)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                                / head_dim))
    with torch.inference_mode(False):   # a normal tensor, for training too
        return torch.from_numpy(inv_freq).to(device)


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


def init_kv_cache(batch: int, max_len: int, num_kv_heads: int, head_dim: int,
                  n_layers: Optional[int] = None, dtype=torch.bfloat16,
                  device=None):
    """An empty contiguous KV cache, head-major ``[L?, B, Hkv, S, D]``.
    ``dtype=torch.int8`` stores absmax-quantized values with fp32 scales
    ``[L?, B, Hkv, S]`` beside them (quantized per position and kv head at
    append)."""
    shape = (batch, num_kv_heads, max_len, head_dim)
    sshape = (batch, num_kv_heads, max_len)
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


def _positions_from(cache_index, T: int, device) -> torch.Tensor:
    """``cache_index + [0, T)`` as int64 on ``device`` (``cache_index`` an
    int or a device scalar; no host sync either way)."""
    start = torch.as_tensor(cache_index, device=device).reshape(()).long()
    return start + torch.arange(T, device=device)


def update_kv_cache(layer_cache, k, v, cache_index):
    """Append ``[B, T, Hkv, D]`` keys/values at positions ``cache_index ..
    cache_index + T - 1`` of one layer's head-major cache, in place (only
    the new tokens are transposed). An int8 cache quantizes at append.
    Returns ``layer_cache``."""
    pos = _positions_from(cache_index, k.shape[1], k.device)
    k = k.transpose(1, 2)                       # [B, Hkv, T, D]
    v = v.transpose(1, 2)
    if "k_scale" in layer_cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        layer_cache["k"].index_copy_(2, pos, kq)
        layer_cache["v"].index_copy_(2, pos, vq)
        layer_cache["k_scale"].index_copy_(2, pos, ks)
        layer_cache["v_scale"].index_copy_(2, pos, vs)
    else:
        layer_cache["k"].index_copy_(2, pos, k.to(layer_cache["k"].dtype))
        layer_cache["v"].index_copy_(2, pos, v.to(layer_cache["v"].dtype))
    return layer_cache


def key_mask_to_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` 1/0 key mask -> additive fp32 ``[B, 1, 1, S]`` bias (0
    keep, -1e9 drop)."""
    return torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                       -1e9).float()


def cache_attention_bias(q_len: int, cache_len: int, cache_index,
                         key_mask: Optional[torch.Tensor] = None,
                         window: Optional[int] = None, device=None
                         ) -> torch.Tensor:
    """Additive fp32 bias ``[B or 1, 1, q_len, cache_len]`` for attention
    over a partially filled cache: query ``t`` sits at ``cache_index + t``
    and sees key ``j`` iff ``j <= cache_index + t`` and, with a window,
    ``cache_index + t - j < window``; ``key_mask`` (1 = real token) also
    hides padding. Masked entries get -1e9, not -inf, so a query that sees
    no key (a left-padding row) softmaxes to finite values."""
    q_pos = _positions_from(cache_index, q_len, device)
    kv_pos = torch.arange(cache_len, device=device)
    visible = q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        visible = visible & (q_pos[:, None] - kv_pos[None, :] < window)
    bias = torch.where(visible, 0.0, -1e9)[None, None]
    if key_mask is not None:
        bias = bias + torch.where(key_mask > 0, 0.0,
                                  -1e9)[:, None, None, :]
    return bias.float()


def cached_attention(q, layer_cache, cache_index, key_mask=None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None):
    """Plain attention of ``q [B, T, H, D]`` over one layer's head-major
    cache (``cached_attention_xla``: GQA by broadcasting kv heads, fp32
    logits plus :func:`cache_attention_bias`, probabilities cast to q's
    dtype). The prefill of ``generate`` takes it; the JAX package leaves
    the same math to XLA. Returns ``[B, T, H, D]``."""
    B, T, H, D = q.shape
    if "k_scale" in layer_cache:
        k = dequantize_kv(layer_cache["k"], layer_cache["k_scale"], q.dtype)
        v = dequantize_kv(layer_cache["v"], layer_cache["v_scale"], q.dtype)
    else:
        k = layer_cache["k"].to(q.dtype)
        v = layer_cache["v"].to(q.dtype)
    Hkv, S = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = k[:, :, None].expand(B, Hkv, rep, S, D).reshape(B, H, S, D)
        v = v[:, :, None].expand(B, Hkv, rep, S, D).reshape(B, H, S, D)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bhkd->bhqk", q, k).float() * scale
    logits = logits + cache_attention_bias(T, S, cache_index, key_mask,
                                           window, device=q.device)
    probs = logits.softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bqhd", probs, v)


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


class StaticIndexBuffers:
    """Static int32 buffers of a step's inputs: named fields of fixed
    shapes in one host buffer (pinned for a CUDA device) and one device
    buffer. :meth:`fill` writes a step's numpy arrays into the host buffer
    and copies it to the device in one transfer; ``views`` are views of
    the device buffer, so a CUDA graph captured over them replays with
    each step's values."""

    def __init__(self, shapes, device):
        device = torch.device(device)
        total = sum(int(np.prod(shape)) for shape in shapes.values())
        self.host = torch.zeros(total, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.buffer = torch.zeros(total, dtype=torch.int32, device=device)
        self._host_views, self.views, at = {}, {}, 0
        for name, shape in shapes.items():
            n = int(np.prod(shape))
            self._host_views[name] = self.host.numpy()[at:at + n].reshape(
                shape)
            self.views[name] = self.buffer[at:at + n].view(shape)
            at += n

    def fill(self, **arrays) -> None:
        """One step's arrays (each reshaped to its field) into the host
        buffer, then the one copy to the device, on the current stream."""
        for name, a in arrays.items():
            dst = self._host_views[name]
            dst[...] = np.asarray(a).reshape(dst.shape)
        self.buffer.copy_(self.host, non_blocking=True)


class PackedIndexBuffers(StaticIndexBuffers):
    """The packed step's static buffers: the token ids, the fields of
    :func:`paged_cache_index`, for ``R`` rows of ``nb`` table entries and
    up to ``width`` packed tokens, and the ``[R]`` ``corrupt`` flags of
    :func:`harvest_packed_logits` (zero on every step without an armed
    fault); :meth:`index` gives the ids and the bundle at a width as views
    of the device buffer."""

    _ROWS = ("query_start", "query_len", "chunk_start", "context_len")

    def __init__(self, rows: int, table_width: int, width: int, device):
        shapes = {"ids": (width,), "token_rows": (width,),
                  "append_pos": (width,)}
        shapes.update({n: (rows,) for n in self._ROWS})
        shapes["block_tables"] = (rows, table_width)
        shapes["corrupt"] = (rows,)
        super().__init__(shapes, device)

    def index(self, width: int):
        """``(ids [1, width], bundle)`` on the device: the bundle is
        :func:`paged_cache_index`'s at ``width`` packed tokens."""
        v = self.views
        bundle = {"block_tables": v["block_tables"],
                  "append_pos": v["append_pos"][:width].view(1, width),
                  "token_rows": v["token_rows"][:width].view(1, width)}
        for name in self._ROWS:
            bundle[name] = v[name]
        return v["ids"][:width].view(1, width), bundle


def is_paged_index(cache_index) -> bool:
    """True when ``cache_index`` is a paged-cache bundle."""
    return isinstance(cache_index, dict) and "block_tables" in cache_index


def _packed_write_targets(cache_index, num_blocks: int, block_size: int):
    """``(page, offset, source, lands)`` of the packed step's append, one
    entry per packed token (``[B * T]``, fixed shapes, no host sync, so a
    CUDA graph captures it). A token that lands writes its own KV
    (``source`` = itself) at ``pool[page, :, offset]``. A token that must
    not land (padding: ``append_pos < 0`` or ``token_rows < 0``; a position
    past the table width; an unallocated, sentinel, table entry) takes the
    target and the source of the first token that lands, so it writes the
    same value to the same place again. ``lands`` (0-dim) is False when no
    token lands: every entry then targets page 0, offset 0, and the caller
    writes back the value already there. Computed once per step and kept
    in the bundle, which every layer of the step shares."""
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
    lands = valid.any()
    src = torch.where(valid, torch.arange(pos.numel(), device=pos.device),
                      valid.int().argmax())
    zero = torch.zeros((), dtype=torch.long, device=pos.device)
    targets = (torch.where(lands, bids[src], zero),
               torch.where(lands, off[src], zero), src, lands)
    cache_index["write_targets"] = (key, targets)
    return targets


def update_paged_kv_cache(layer_cache, k, v, cache_index):
    """Append ``[B, T, Hkv, D]`` keys/values into one layer's pool ``{"k",
    "v"[, "k_scale", "v_scale"]}`` in place: a token at position ``pos``
    lands at ``pool[table[row, pos // bs], :, pos % bs]``, where ``row`` is
    the token's batch row (the two-program engine's decode step and
    prefills) or, in the packed mixed step, ``token_rows`` names it. Pads
    (``append_pos < 0``), positions past the table width and sentinel
    targets change no page (as the JAX model's out-of-bounds scatter drops
    them): they repeat a landing token's write (see
    :func:`_packed_write_targets`), so every step writes the same number
    of rows. An int8 pool quantizes at append (absmax per token and kv
    head). Returns ``layer_cache``."""
    num_blocks, Hkv, bs, D = layer_cache["k"].shape
    if "token_rows" not in cache_index:
        B, T = cache_index["append_pos"].shape
        cache_index = dict(cache_index, token_rows=torch.arange(
            B, device=k.device, dtype=torch.int32)[:, None].expand(B, T))
    page, off, src, lands = _packed_write_targets(cache_index, num_blocks,
                                                  bs)
    k = k.reshape(-1, Hkv, D)[src]
    v = v.reshape(-1, Hkv, D)[src]
    if "k_scale" in layer_cache:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        vals = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        vals = (("k", k), ("v", v))
    for name, val in vals:
        t = layer_cache[name]
        t[page, :, off] = torch.where(lands, val.to(t.dtype), t[0, :, 0])
    return layer_cache


def copy_paged_blocks(pool, src_ids, dst_ids):
    """Page copy ``pool[:, dst] = pool[:, src]`` across every pool tensor
    (K, V, int8 scales), in place: the copy half of copy-on-write when a
    sequence must append into a page other sequences still reference. Pool
    tensors carry the leading layer axis ``[L, N, ...]``; ``src_ids`` and
    ``dst_ids`` are equal-length page id lists. It runs on the pool's
    stream, so a copy issued before a step's appends lands before them.
    Returns ``pool``."""
    dev = pool["k"].device
    src = torch.as_tensor(src_ids, dtype=torch.long, device=dev)
    dst = torch.as_tensor(dst_ids, dtype=torch.long, device=dev)
    for t in pool.values():
        t[:, dst] = t[:, src]
    return pool


def flash_prefill_from_empty(q, k, v, key_mask=None,
                             sm_scale: Optional[float] = None,
                             window: Optional[int] = None):
    """From-empty cached prefill through the masked flash kernel (K1's
    key-mask mode). ``q``: ``[B, T, H, D]``; ``k``/``v`` are the fresh,
    un-repeated projections ``[B, T, Hkv, D]``; ``key_mask`` is the full
    ``[B, S]`` cache mask or None (sliced to the prompt span here).
    Attention over the fresh K/V equals cache attention when nothing
    precedes the prompt. A query row that sees no key (a left-padding row)
    returns zeros."""
    B, T = q.shape[0], q.shape[1]
    local = torch.ones((B, T), dtype=torch.int32, device=q.device) \
        if key_mask is None else key_mask[:, :T]
    return flash_attention(q, k, v, causal=True, sm_scale=sm_scale,
                           window=window, key_mask=local)


def masked_prefill_attention(q, k, v, key_mask, window: Optional[int] = None,
                             scale: Optional[float] = None):
    """Plain causal attention over fresh ``[B, T, Hkv, D]`` keys/values
    with a ``[B, T]`` key mask (1 = real token) as an additive -1e9 bias:
    the from-empty paged prefill without ``prefill_flash_from_empty`` (the
    JAX package leaves the same math to XLA). GQA by repeating kv heads,
    fp32 logits, probabilities cast to q's dtype. Returns ``[B, T, H,
    D]``."""
    B, T, H, D = q.shape
    k, v = repeat_kv(k, H // k.shape[2]), repeat_kv(v, H // v.shape[2])
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    i = torch.arange(T, device=q.device)
    seen = i[:, None] >= i[None, :]
    if window is not None:
        seen = seen & (i[:, None] - i[None, :] < window)
    logits = logits + torch.where(seen, 0.0, -1e9)[None, None] \
        + key_mask_to_bias(key_mask)
    probs = logits.softmax(dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def harvest_packed_logits(logits, token_rows, num_rows: int, corrupt=None):
    """Multi-position harvest of the packed mixed step.

    ``logits``: ``[1, T, V]``; ``token_rows``: ``[1, T]`` or ``[T]``
    (``-1`` = padding). Returns ``(lg, bad)``: ``lg`` the ``[T, V]``
    per-position logits the caller samples, and ``bad`` a ``[R]`` flag of
    rows with a NaN/Inf logit at any of their valid tokens. ``corrupt``
    (optional ``[R]``, nonzero = flagged) is the corrupt_logits chaos
    point, as data, so a drill never changes a captured graph: a flagged
    row is flagged ``bad`` as a NaN logit would flag it (its logits are
    left as they are, so the drill costs an ``[R]`` OR, not a pass over
    ``[T, V]``)."""
    lg = logits[0]
    rows = token_rows.reshape(-1).long()
    valid = rows >= 0
    safe = rows.clamp(0, num_rows - 1)
    bad_tok = ~torch.isfinite(lg).all(dim=-1) & valid
    bad = torch.zeros(num_rows, dtype=torch.int32, device=lg.device)
    bad = bad.index_add_(0, safe, bad_tok.int()) > 0
    if corrupt is not None:
        bad |= corrupt.reshape(-1) != 0
    return lg, bad


# ---------------------------------------------------------------------------
# the dense training path
# ---------------------------------------------------------------------------

def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA: expand kv heads ``[B, T, Hkv, D] -> [B, T, Hkv * n_rep, D]``
    (head ``h`` of the result reads kv head ``h // n_rep``)."""
    if n_rep == 1:
        return x
    b, t, h, d = x.shape
    return x[:, :, :, None, :].expand(b, t, h, n_rep, d).reshape(
        b, t, h * n_rep, d)


def dot_product_attention(q, k, v, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None):
    """``[B, T, H, D]`` attention core of the training path (kv heads
    repeated): bottom-right-aligned causality and an optional window,
    through the flash-attention wrapper (kernels K1/K2 on CUDA tensors,
    their plain versions on CPU tensors). A padding bias is not ported."""
    return flash_attention(q, k, v, causal=causal, sm_scale=scale,
                           window=window)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_index: int = -100) -> torch.Tensor:
    """Token-mean cross entropy in fp32; labels equal to ``ignore_index``
    count nowhere."""
    logits = logits.float()
    mask = (labels != ignore_index).float()
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels),
                       labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None].long()).squeeze(-1)
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)


def shift_labels(input_ids: torch.Tensor,
                 ignore_index: int = -100) -> torch.Tensor:
    """HF convention: labels == input_ids, shifted left, the last position
    ignored."""
    return torch.cat([input_ids[:, 1:],
                      torch.full_like(input_ids[:, :1], ignore_index)], dim=1)


def lm_head_output(hidden: torch.Tensor, embed_weight: torch.Tensor,
                   lm_head=None) -> torch.Tensor:
    """Logits through the untied head, or the embedding matrix when tied
    (``lm_head is None``). The chunked loss (``loss_chunk > 0``) is not
    ported."""
    if lm_head is None:
        return hidden @ embed_weight.T
    return lm_head(hidden)
