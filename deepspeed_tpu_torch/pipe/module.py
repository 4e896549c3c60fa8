"""The pipeline model container.

Counterpart of ``deepspeed_tpu/pipe/module.py`` (``LayerSpec`` :35,
``TiedLayerSpec`` :66, ``PipelineModule`` :91) with torch ``nn.Module``
classes in the specs. The model is a list of layer specs; the longest run
of specs with one signature (the same class and constructor arguments) is
the homogeneous body, the layers before and after it the prefix and the
suffix. Specs that share a ``TiedLayerSpec`` key share one module (the
embedding and the LM head), so both uses add to its gradient.

The stage boundaries are computed for any ``num_stages`` as host
arithmetic (``stage_bounds``): the body divides evenly, the prefix goes to
the first stage and the suffix to the last (every ``partition_method`` of
a homogeneous body gives these bounds, as in the JAX module). Running
more than one stage needs that many devices: ``PipelineEngine`` takes one
stage, and ``ZeroInfinityEngine`` streams a one-stage module's body.
"""

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.logging import log_dist


class LayerSpec:
    """Delayed construction of a layer: a class and its arguments."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not isinstance(typename, type) or \
                not issubclass(typename, nn.Module):
            raise RuntimeError("LayerSpec requires a torch nn.Module "
                               "subclass")

    def build(self, log: bool = False) -> nn.Module:
        if log:
            log_dist(f"building {repr(self)}", ranks=[0])
        return self.typename(*self.module_args, **self.module_kwargs)

    def signature(self) -> str:
        """Homogeneity key: specs with equal signatures form the body."""
        return f"{self.typename.__module__}.{self.typename.__name__}" \
               f"({self.module_args!r},{sorted(self.module_kwargs.items())!r})"

    def __repr__(self) -> str:
        return f"LayerSpec({self.typename.__name__})"


class TiedLayerSpec(LayerSpec):
    """Layers that share ``key`` share one module. ``forward_fn(module,
    x)`` replaces the module's call for a secondary use, e.g. ``lambda m,
    x: x @ m.embed.weight.T`` for a head tied to an embedding."""

    def __init__(self, key, typename, *module_args,
                 forward_fn: Optional[Callable] = None,
                 tied_weight_attr: str = "weight", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr

    def signature(self) -> str:
        return f"tied:{self.key}:" + super().signature()


def _as_spec(layer) -> LayerSpec:
    if isinstance(layer, LayerSpec):
        return layer
    if isinstance(layer, type):
        return LayerSpec(layer)
    raise TypeError(f"pipeline layers must be LayerSpec or module classes, "
                    f"got {layer!r}")


class PipelineModule(nn.Module):
    """``layers``: ``LayerSpec`` / ``TiedLayerSpec`` entries (or module
    classes). ``loss_fn(outputs, labels)`` gives a microbatch's loss.
    ``forward(inputs, labels)`` runs the layers in order and returns the
    loss (``run(inputs)`` returns the outputs). ``activation_checkpoint_
    interval`` N recomputes the body in chunks of N layers in the
    backward (a chunk count that does not divide the body falls back to
    one layer a chunk, as in JAX)."""

    def __init__(self, layers: Sequence, num_stages: int, loss_fn: Callable,
                 partition_method: str = "uniform",
                 activation_checkpoint_interval: int = 0, topology=None):
        super().__init__()
        self.specs: List[LayerSpec] = [_as_spec(l) for l in layers]
        self.num_stages = int(num_stages)
        self.loss_fn = loss_fn
        if partition_method not in ("uniform", "parameters", "type"):
            raise ValueError(f"unknown partition_method {partition_method!r}")
        self.partition_method = partition_method
        self.activation_checkpoint_interval = activation_checkpoint_interval
        if self.num_stages < 1:
            raise ValueError("num_stages must be >= 1")
        start, n_body = self._longest_run([s.signature() for s in self.specs])
        if self.num_stages > 1 and n_body % self.num_stages != 0:
            raise ValueError(
                f"body of {n_body} homogeneous layers does not divide "
                f"{self.num_stages} stages (rebuild with a divisible layer "
                f"count)")
        self._body_slice = (start, start + n_body)
        self.prefix_specs = self.specs[:start]
        self.body_specs = self.specs[start:start + n_body]
        self.suffix_specs = self.specs[start + n_body:]
        self.layers_per_stage = n_body // self.num_stages if n_body else 0

        self.tied = nn.ModuleDict()

        def build(specs):
            out = []
            for spec in specs:
                if isinstance(spec, TiedLayerSpec):
                    if spec.key not in self.tied:
                        self.tied[spec.key] = spec.build()
                    out.append(nn.Identity())   # the tied module holds it
                else:
                    out.append(spec.build())
            return nn.ModuleList(out)

        self.prefix = build(self.prefix_specs)
        self.body = nn.ModuleList(s.build() for s in self.body_specs)
        self.suffix = build(self.suffix_specs)

    @staticmethod
    def _longest_run(sigs: List[str]) -> Tuple[int, int]:
        best_start, best_len, i = 0, 0, 0
        while i < len(sigs):
            j = i
            while j < len(sigs) and sigs[j] == sigs[i]:
                j += 1
            if j - i > best_len:
                best_start, best_len = i, j - i
            i = j
        return best_start, best_len

    def stage_bounds(self) -> List[Tuple[int, int]]:
        """``[start, end)`` spec indices of each stage: the body split
        evenly, the prefix on the first stage, the suffix on the last."""
        lo, hi = self._body_slice
        lp = self.layers_per_stage
        bounds = []
        for s in range(self.num_stages):
            a = 0 if s == 0 else lo + s * lp
            b = len(self.specs) if s == self.num_stages - 1 \
                else lo + (s + 1) * lp
            bounds.append((a, b))
        return bounds

    # ------------------------------------------------------------------
    # forward pieces
    # ------------------------------------------------------------------

    def _apply_seq(self, specs, modules, x):
        for spec, module in zip(specs, modules):
            if isinstance(spec, TiedLayerSpec):
                module = self.tied[spec.key]
                if spec.forward_fn is not None:
                    x = spec.forward_fn(module, x)
                    continue
            x = module(x)
        return x

    def apply_prefix(self, x):
        return self._apply_seq(self.prefix_specs, self.prefix, x)

    def apply_suffix(self, x):
        return self._apply_seq(self.suffix_specs, self.suffix, x)

    def apply_stage(self, layers: Sequence[nn.Module], x):
        """Run ``layers`` (body layers) in order, recomputed in chunks of
        ``activation_checkpoint_interval`` in the backward when it is set."""
        interval = self.activation_checkpoint_interval
        if not interval or not torch.is_grad_enabled():
            for layer in layers:
                x = layer(x)
            return x
        if len(layers) % interval != 0:
            interval = 1
        from ..checkpointing import checkpoint

        def chunk(mods):
            def run(h):
                for layer in mods:
                    h = layer(h)
                return h
            return run

        for i in range(0, len(layers), interval):
            x = checkpoint(chunk(layers[i:i + interval]), x)
        return x

    def run(self, x):
        """The layers in order (the JAX ``apply_sequential``)."""
        x = self.apply_prefix(x)
        x = self.apply_stage(list(self.body), x)
        return self.apply_suffix(x)

    apply_sequential = run

    def forward(self, inputs, labels):
        return self.loss_fn(self.run(inputs), labels)

    def __len__(self) -> int:
        return len(self.specs)
