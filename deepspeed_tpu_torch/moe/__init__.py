"""Mixture of experts: the GShard ``MoE`` layer, its gate and its stacked
expert bank (the counterpart of ``deepspeed_tpu/moe``)."""

from .experts import ExpertMLP, Experts
from .layer import MoE
from .sharded_moe import MOELayer, TopKGate, top1gating, top2gating
from .utils import is_moe_param, split_params_into_moe_groups

__all__ = ["MoE", "MOELayer", "TopKGate", "Experts", "ExpertMLP",
           "top1gating", "top2gating", "is_moe_param",
           "split_params_into_moe_groups"]
