"""Torch twins of the flax layers that the JAX package's pipeline and
ZeRO-Infinity tests build (``tests/unit/test_pipeline.py``,
``tests/unit/test_infinity.py``), and the copy of a JAX
``PipelineModule``'s params into the port's module of twins."""

import numpy as np
import torch
from torch import nn


class EmbedIn(nn.Module):
    """flax ``nn.Embed(vocab, hidden, name="embed")`` (the pipeline test's
    ``EmbedIn``; the Infinity test's ``Embed`` names it ``Embed_0``)."""

    def __init__(self, vocab=64, hidden=32):
        super().__init__()
        self.embed = nn.Embedding(vocab, hidden)

    def forward(self, ids):
        return self.embed(ids.long())


class Block(nn.Module):
    """``x + Dense(h)(tanh(Dense(2h)(LayerNorm(x))))``."""

    def __init__(self, hidden=32):
        super().__init__()
        self.norm = nn.LayerNorm(hidden, eps=1e-6)
        self.fc1 = nn.Linear(hidden, 2 * hidden)
        self.fc2 = nn.Linear(2 * hidden, hidden)

    def forward(self, x):
        return x + self.fc2(torch.tanh(self.fc1(self.norm(x))))


class HeadOut(nn.Module):
    def __init__(self, vocab=64, hidden=32):
        super().__init__()
        self.proj = nn.Linear(hidden, vocab, bias=False)

    def forward(self, x):
        return self.proj(x)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def block_state(p):
    """A flax ``Block``'s params as the twin's state_dict."""
    return {"norm.weight": _t(p["LayerNorm_0"]["scale"]),
            "norm.bias": _t(p["LayerNorm_0"]["bias"]),
            # flax names the outer Dense first: it is built before the
            # inner one is called
            "fc1.weight": _t(p["Dense_1"]["kernel"]).T.contiguous(),
            "fc1.bias": _t(p["Dense_1"]["bias"]),
            "fc2.weight": _t(p["Dense_0"]["kernel"]).T.contiguous(),
            "fc2.bias": _t(p["Dense_0"]["bias"])}


def edge_state(p):
    """An embedding's or a head's flax params as the twin's state_dict."""
    if "embedding" in str(p):
        sub = p.get("embed", p.get("Embed_0"))
        return {"embed.weight": _t(sub["embedding"])}
    return {"proj.weight": _t(p["Dense_0"]["kernel"]).T.contiguous()}
