"""Block-sparse attention layouts (fixed / variable / bigbird / bslongformer).

The port's copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``,
numpy only and unchanged in its code, so that the same arguments give
bit-identical layouts in both packages (the random blocks of the variable
and BigBird patterns depend on the order of the ``rng.choice`` calls). Each
config produces a block-level layout — a ``[num_heads, nb, nb]`` 0/1 matrix
over ``block``-sized tiles of the attention matrix — consumed by the
block-sparse kernels (``ops/block_sparse_attention.py``).

Implemented from the published pattern definitions (Sparse Transformers'
fixed pattern, BigBird's window+global+random, Longformer's sliding window +
global tokens). ``block`` defaults to 128.
"""

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SparsityConfig:
    """Base: dense layout (reference ``SparsityConfig``/``DenseSparsityConfig``)."""

    num_heads: int = 1
    block: int = 128
    different_layout_per_head: bool = False

    def num_blocks(self, seq_len: int) -> int:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} must be a multiple of "
                             f"block {self.block}")
        return seq_len // self.block

    def setup_layout(self, seq_len: int) -> np.ndarray:
        nb = self.num_blocks(seq_len)
        return np.zeros((self.num_heads, nb, nb), np.int64)

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout

    def check_and_propagate_first_head_layout(self, layout: np.ndarray) -> np.ndarray:
        if not self.different_layout_per_head:
            layout[1:] = layout[0:1]
        return layout


class DenseSparsityConfig(SparsityConfig):
    pass


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers fixed pattern: local blocks of
    ``num_local_blocks`` plus attention to the last
    ``num_global_blocks`` block-columns of each preceding local window
    (the "summary" columns every stride)."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"  # or "unidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1

    def __post_init__(self):
        if self.num_local_blocks % self.num_global_blocks:
            raise ValueError("num_local_blocks must be divisible by "
                             "num_global_blocks")
        if self.horizontal_global_attention and self.attention != "bidirectional":
            raise ValueError("horizontal global attention requires "
                             "bidirectional attention")
        if self.num_different_global_patterns > 1 and not self.different_layout_per_head:
            raise ValueError("num_different_global_patterns > 1 requires "
                             "different_layout_per_head")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        L = self.num_local_blocks
        G = self.num_global_blocks
        for h in range(self.num_heads):
            # local windows
            for start in range(0, nb, L):
                end = min(start + L, nb)
                layout[h, start:end, start:end] = 1
            # global (summary) columns: the pattern-shifted last G columns of
            # every local window; heads may rotate which columns are global
            pat = (h % self.num_different_global_patterns) \
                if self.different_layout_per_head else 0
            for start in range(0, nb, L):
                first = start + L - (pat + 1) * G
                for c in range(max(first, start), min(first + G, nb)):
                    if c < 0:
                        continue
                    if self.attention == "unidirectional":
                        layout[h, c + 1:, c] = 1  # later queries see it
                    else:
                        layout[h, :, c] = 1
                    if self.horizontal_global_attention:
                        layout[h, c, :] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """Variable pattern: mixed-size local windows + explicit global block
    indices + random blocks (reference ``VariableSparsityConfig``)."""

    num_random_blocks: int = 0
    local_window_blocks: Optional[List[int]] = None
    global_block_indices: Optional[List[int]] = None
    global_block_end_indices: Optional[List[int]] = None
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    seed: int = 0

    def __post_init__(self):
        self.local_window_blocks = self.local_window_blocks or [4]
        self.global_block_indices = self.global_block_indices \
            if self.global_block_indices is not None else [0]
        if self.global_block_end_indices is not None and \
                len(self.global_block_end_indices) != len(self.global_block_indices):
            raise ValueError("global_block_end_indices must pair with "
                             "global_block_indices")

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_heads):
            # variable local windows: cycle through the requested sizes
            start = 0
            i = 0
            while start < nb:
                w = self.local_window_blocks[min(i, len(self.local_window_blocks) - 1)]
                end = min(start + w, nb)
                layout[h, start:end, start:end] = 1
                start = end
                i += 1
            # globals
            for gi, g in enumerate(self.global_block_indices):
                if g >= nb:
                    continue
                ge = g + 1 if self.global_block_end_indices is None else \
                    min(self.global_block_end_indices[gi], nb)
                layout[h, :, g:ge] = 1
                if self.horizontal_global_attention:
                    layout[h, g:ge, :] = 1
            # random blocks per block-row
            for r in range(nb):
                for c in rng.choice(nb, size=min(self.num_random_blocks, nb),
                                    replace=False):
                    layout[h, r, c] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: sliding window + global first/last blocks + random blocks."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        g = self.num_global_blocks
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_heads):
            for r in range(nb):
                layout[h, r, max(0, r - w):min(nb, r + w + 1)] = 1  # window
            layout[h, :, :g] = 1   # global columns (everyone attends to them)
            layout[h, :g, :] = 1   # global rows (they attend to everyone)
            if self.attention == "bidirectional":
                layout[h, :, nb - g:] = 1
                layout[h, nb - g:, :] = 1
            for r in range(nb):    # random
                for c in rng.choice(nb, size=min(self.num_random_blocks, nb),
                                    replace=False):
                    layout[h, r, c] = 1
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer: symmetric sliding window + designated global blocks."""

    num_sliding_window_blocks: int = 3
    global_block_indices: Optional[List[int]] = None
    global_block_end_indices: Optional[List[int]] = None
    attention: str = "bidirectional"

    def __post_init__(self):
        self.global_block_indices = self.global_block_indices \
            if self.global_block_indices is not None else [0]

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        nb = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_heads):
            for r in range(nb):
                layout[h, r, max(0, r - w):min(nb, r + w + 1)] = 1
            for gi, g in enumerate(self.global_block_indices):
                if g >= nb:
                    continue
                ge = g + 1 if self.global_block_end_indices is None else \
                    min(self.global_block_end_indices[gi], nb)
                layout[h, :, g:ge] = 1  # global columns
                layout[h, g:ge, :] = 1  # global rows
        if self.attention == "unidirectional":
            layout = np.tril(layout)
        return self.check_and_propagate_first_head_layout(layout)
