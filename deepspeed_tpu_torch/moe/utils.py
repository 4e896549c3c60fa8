"""MoE parameter bookkeeping.

Counterpart of ``deepspeed_tpu/moe/utils.py``. The expert bank keeps its
parameters stacked ``[E, ...]`` under ``experts.stacked`` (``Experts``),
so an expert parameter is found by its name, as the JAX package finds
one by its flax path. The token scatter / gather of the reference's
tensor-parallel MoE (``mappings.py``) are the identity on one device, as
the JAX functions are without a ``model`` mesh axis. The JAX
``moe_partition_rules`` (a mesh spec) has no counterpart: the port's
models carry no partition rules.
"""

import re
from typing import Dict, Mapping, Union

from torch import nn

#: a parameter path fragment marking expert-bank parameters (the
#: ``Experts`` module's name), with ``/`` (flax paths) or ``.`` (torch
#: names) between the parts
MOE_PATH_PATTERN = r"(^|[/.])experts([/.]|$)"


def is_moe_param(path: str) -> bool:
    """True for an expert-bank parameter's name or flax path (reference
    ``moe/utils.py:10``)."""
    return re.search(MOE_PATH_PATTERN, path) is not None


def split_params_into_moe_groups(params: Union[nn.Module, Mapping]
                                 ) -> Dict[str, str]:
    """``{name: "moe" | "dense"}`` for a module's parameters or a
    ``state_dict`` (the JAX function's label tree, by name): feed it to
    the optimizer's groups to give expert parameters their own settings
    (reference ``split_params_into_different_moe_groups_for_optimizer``,
    ``moe/utils.py:61``)."""
    names = dict(params.named_parameters()) if isinstance(params, nn.Module) \
        else params
    return {name: "moe" if is_moe_param(name) else "dense" for name in names}


def drop_tokens(x, dim: int = 0):
    """The reference's token scatter over tensor-parallel ranks
    (``mappings.py:27``): the identity on one device."""
    return x


def gather_tokens(x, dim: int = 0):
    """The inverse of :func:`drop_tokens` (``mappings.py:50``): the
    identity on one device."""
    return x
