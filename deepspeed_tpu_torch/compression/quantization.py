"""Grouped symmetric/asymmetric quantization and the legacy whole-tree
int8 weight quantization of ``init_inference(quantize=True)``.

Counterpart of ``deepspeed_tpu/compression/quantization.py``. These are
plain tensor operations (the JAX package leaves them to XLA too, outside
any Pallas kernel). A tensor is grouped over its flattened elements: one
scale (and zero point) per contiguous group, the tail padded with zeros
to a whole group.

The whole-tree functions work on the JAX param tree's leaves, named by
their ``/``-joined flax paths and in the flax layout (a Dense kernel
``[in, out]``, scanned layers stacked ``[L, in, out]``): the groups cut
the flattened JAX leaf, so a torch ``[out, in]`` weight, one tensor a
layer, must be seen through that layout first
(``checkpoint.from_flax.flax_leaves`` gives such views of a port model's
``state_dict``), or its groups would hold other elements.
"""

from typing import Dict, Optional, Tuple

import torch

#: small tensors (norms, biases) stay in full precision
_MIN_QUANT_SIZE = 4096


def _grouped(x: torch.Tensor, num_groups: int
             ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n % num_groups:               # pad to a whole number of groups
        pad = num_groups - n % num_groups
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(num_groups, -1), tuple(x.shape)


def quantize(x: torch.Tensor, num_bits: int = 8, num_groups: int = 1,
             symmetric: bool = True):
    """``(q, scale, zero, shape)``: codes (int8, or int32 above 8 bits)
    ``[G, n/G]`` and fp32 ``scale`` / ``zero`` ``[G, 1]``, grouped over the
    flattened tensor. Symmetric: ``scale = absmax / qmax``, zero 0;
    asymmetric: ``scale = (max - min) / (2^bits - 1)``, zero the minimum; a
    zero scale becomes 1. Rounding to nearest even. (The JAX function's
    stochastic rounding, whose draws the port could not reproduce, has no
    caller in either package's inference path and is not ported.)"""
    g, orig_shape = _grouped(x.float(), num_groups)
    qmax = 2 ** (num_bits - 1) - 1
    one = torch.ones((), device=g.device)
    if symmetric:
        scale = g.abs().amax(dim=1, keepdim=True) / qmax
        scale = torch.where(scale == 0, one, scale)
        zero = torch.zeros_like(scale)
    else:
        lo = g.amin(dim=1, keepdim=True)
        hi = g.amax(dim=1, keepdim=True)
        scale = (hi - lo) / (2 ** num_bits - 1)
        scale = torch.where(scale == 0, one, scale)
        zero = lo
    y = torch.round((g - zero) / scale)
    lo_q = -qmax - 1 if symmetric else 0
    hi_q = qmax if symmetric else 2 ** num_bits - 1
    q = y.clamp(lo_q, hi_q)
    if num_bits <= 8:
        # the JAX package's float -> int8 conversion saturates (an 8-bit
        # asymmetric code above 127 becomes 127); torch's would wrap
        return q.clamp(-128, 127).to(torch.int8), scale, zero, orig_shape
    return q.to(torch.int32), scale, zero, orig_shape


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero: Optional[torch.Tensor], orig_shape: Tuple[int, ...],
               dtype=torch.float32,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse of :func:`quantize`: ``q * scale + zero`` in fp32, cut
    to ``orig_shape`` and cast to ``dtype`` (``zero`` None: symmetric
    codes, no zero point). With ``out`` (a contiguous tensor of
    ``orig_shape`` and ``dtype``) the result is written there one group at
    a time, so no fp32 copy of the whole tensor is made; without a zero
    point each group is one ``torch.mul`` that computes ``q * scale`` in
    fp32 and rounds it to ``dtype`` as it stores."""
    n = 1
    for s in orig_shape:
        n *= s
    if out is None:
        flat = q.float() * scale
        flat = (flat if zero is None else flat + zero).reshape(-1)
        return flat[:n].reshape(orig_shape).to(dtype)
    flat_out = out.view(-1)
    per = q.shape[1]
    for i in range(q.shape[0]):
        lo = i * per
        if lo >= n:
            break
        m = min(per, n - lo)
        if zero is None:
            torch.mul(q[i, :m], scale[i], out=flat_out[lo:lo + m])
        else:
            flat_out[lo:lo + m] = (q[i, :m].float() * scale[i] + zero[i]
                                   ).to(dtype)
    return out


def quantize_leaf(leaf: torch.Tensor, num_groups: int = 32):
    """``(codes, meta)`` of one leaf, as :func:`quantize_params` treats it:
    a floating leaf of at least ``_MIN_QUANT_SIZE`` elements becomes int8
    codes and ``meta = {"scale", "zero", "shape"}``; any other leaf is
    returned as it is with ``meta`` None."""
    if not leaf.is_floating_point() or leaf.numel() < _MIN_QUANT_SIZE:
        return leaf, None
    # one group at a time (the same ops as quantize over the whole leaf,
    # so the same codes), holding one group in fp32, not the whole leaf
    flat = leaf.reshape(-1)
    n = flat.numel()
    G = min(num_groups, max(1, n // 128))     # at least 128 a group
    per = -(-n // G)
    q = torch.empty((G, per), dtype=torch.int8, device=leaf.device)
    scale = torch.empty((G, 1), device=leaf.device)
    for g in range(G):
        row = flat[g * per:(g + 1) * per].float()
        if row.numel() < per:
            row = torch.cat([row, row.new_zeros(per - row.numel())])
        qg, sg, _, _ = quantize(row, 8, 1, symmetric=True)
        q[g], scale[g] = qg[0], sg[0]
    return q, {"scale": scale, "zero": torch.zeros_like(scale),
               "shape": tuple(leaf.shape)}


def quantize_params(params: Dict[str, torch.Tensor], num_groups: int = 32
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, Optional[dict]]]:
    """int8-quantize every large floating leaf of ``params`` (leaf name ->
    tensor in the JAX leaf's layout); returns ``(qparams, metas)``, the
    metas ``{"scale", "zero", "shape"}`` or None for a leaf kept in full
    precision."""
    qparams, metas = {}, {}
    for name, leaf in params.items():
        qparams[name], metas[name] = quantize_leaf(leaf, num_groups)
    return qparams, metas


def dequantize_params(qparams: Dict[str, torch.Tensor],
                      metas: Dict[str, Optional[dict]],
                      dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The tree at ``dtype``: quantized leaves dequantized, the others'
    floating leaves cast (so the tree is dtype-uniform), integer leaves as
    they are."""
    out = {}
    for name, leaf in qparams.items():
        meta = metas.get(name)
        if meta is None:
            out[name] = leaf.to(dtype) if leaf.is_floating_point() else leaf
        else:
            out[name] = dequantize(leaf, meta["scale"], meta["zero"],
                                   meta["shape"], dtype)
    return out
