"""Serving-time weight quantization at ``init_inference``.

Counterpart of ``deepspeed_tpu/inference/quant.py``. ``quantize_state_dict``
rewrites an fp ``state_dict`` into the layout ``models.layers.QuantLinear``
holds: each projection's ``weight`` (``[N, K]``, the ``nn.Linear`` layout)
becomes ``qweight``, absmax codes in the JAX layout (int8 ``[K, N]`` or
int4 packed two per byte ``[K//2, N]``), and ``wscale``, fp32 grouped
scales ``[G, N]``, together with a per-weight error report, so a bad
checkpoint or scale bug is named at startup. The model declares what
quantizes through ``quantizable_projections(config)``: embeddings, norms
and the LM head stay fp. The weights are quantized one tensor at a time
on their own device, so no second fp32 copy of the model exists.

The JAX ``replicate_kv_heads`` arrives with tensor parallelism (ROADMAP.md
Queue 1, item 9).
"""

import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..ops.quant_matmul import (dequantize_linear_weight,
                                effective_group_size, quantize_linear_weight)


def _match_role(name: str, specs) -> Optional[str]:
    for pattern, role in specs:
        if re.search(pattern, name):
            return role
    return None


def quantize_state_dict(sd: Dict[str, torch.Tensor], model, mode: str,
                        group_size: int = 0, mp_size: int = 1
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   List[Dict[str, Any]]]:
    """Quantize every projection weight of ``sd`` (the counterpart of the
    JAX ``quantize_param_tree``). Returns ``(new_sd, report)``: ``new_sd``
    has ``<proj>.qweight`` and ``<proj>.wscale`` where ``sd`` had
    ``<proj>.weight`` (other entries pass through), and each report row
    names the weight, mode, group, the fp (bf16) and quantized bytes and
    the max-abs / relative reconstruction error."""
    specs = model.quantizable_projections(model.config)
    out: Dict[str, torch.Tensor] = {}
    report: List[Dict[str, Any]] = []
    for name, w in sd.items():
        role = _match_role(name, specs)
        if role is None:
            out[name] = w
            continue
        if w.dim() != 2:
            raise ValueError(f"quantizable projection {name} has ndim "
                             f"{w.dim()}; expected [N, K]")
        kernel = w.T                                     # [K, N]
        g = effective_group_size(kernel.shape[0], mode, group_size,
                                 mp_size if role == "row" else 1)
        q, s = quantize_linear_weight(kernel, mode, g)
        w32 = kernel.float()
        max_abs_err = float((dequantize_linear_weight(q, s, mode)
                             - w32).abs().max())
        amax = float(w32.abs().max())
        del w32
        base = name[:-len("weight")]
        out[base + "qweight"] = q
        out[base + "wscale"] = s
        report.append({
            "param": name,
            "mode": mode,
            "group": g,
            "fp_bytes": w.numel() * 2,  # as served (a bf16 copy)
            "quant_bytes": q.numel() * q.element_size() + s.numel() * 4,
            "max_abs_err": max_abs_err,
            "rel_err": max_abs_err / max(amax, 1e-12),
        })
    return out, report


def quant_report_summary(report: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Roll a :func:`quantize_state_dict` report up to one block: the total
    byte shift and the worst weight by relative error."""
    if not report:
        return {}
    worst = max(report, key=lambda r: r["rel_err"])
    fp = sum(r["fp_bytes"] for r in report)
    quant = sum(r["quant_bytes"] for r in report)
    return {
        "mode": report[0]["mode"],
        "leaves": len(report),
        "fp_bytes": int(fp),
        "quant_weight_bytes": int(quant),
        "bytes_ratio": round(quant / max(fp, 1), 4),
        "max_rel_err": worst["rel_err"],
        "worst_param": worst["param"],
    }
