"""Data loading.

A copy of ``deepspeed_tpu/runtime/dataloader.py`` (``DeepSpeedDataLoader``,
``RepeatingLoader``): dict batches of numpy arrays, shuffled per epoch by
``np.random.RandomState(seed + epoch).permutation(n)``, so both packages
yield the same batches in the same order. One process feeds the whole
microbatch; the engine moves it to the device.
"""

import math
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np


def _default_collate(samples: Sequence[Any]) -> Dict[str, np.ndarray]:
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples])
                for k in first}
    if isinstance(first, (tuple, list)):
        cols = list(zip(*samples))
        return {f"arg{i}": np.stack([np.asarray(x) for x in col])
                for i, col in enumerate(cols)}
    return {"input": np.stack([np.asarray(s) for s in samples])}


class RepeatingLoader:
    """Wraps an iterable so it restarts on StopIteration (an endless
    microbatch stream)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    def __init__(self, dataset, batch_size: int,
                 collate_fn: Optional[Callable] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 curriculum_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        #: maps (batch, difficulty) -> batch
        self.curriculum_fn = curriculum_fn
        self.epoch = 0
        self._difficulty = None
        self.len = (len(dataset) // batch_size if drop_last
                    else math.ceil(len(dataset) / batch_size))

    def set_difficulty(self, difficulty) -> None:
        """Curriculum hook."""
        self._difficulty = difficulty

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.len

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self.epoch).permutation(n)
        for i in range(self.len):
            idx = order[i * self.batch_size:(i + 1) * self.batch_size]
            batch = self.collate_fn([self.dataset[int(j)] for j in idx])
            if self.curriculum_fn is not None and \
                    self._difficulty is not None:
                batch = self.curriculum_fn(batch, self._difficulty)
            yield batch
