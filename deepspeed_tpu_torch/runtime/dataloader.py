"""Batching for the training engine.

Port of the part of ``deepspeed_tpu/runtime/dataloader.py`` that the
engine needs: ``default_collate``, a sequential ``DeepSpeedDataLoader``
(global micro-batches of a map-style dataset in order, the last partial
batch dropped, no device placement: the engine moves each batch to its
device) and ``RepeatingLoader``. Over ``num_replicas`` data-parallel ranks
each global micro-batch holds ``num_replicas x batch_size`` samples and
rank r collates only its rows ``r * batch_size ... (r + 1) * batch_size``:
the JAX loader's order with ``per_host=True``.
"""

from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (dicts of arrays / tuples / arrays) into a batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([np.asarray(s[i]) for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """This rank's ``batch_size`` rows of each global micro-batch, in dataset
    order, collated with ``collate_fn``."""

    def __init__(self, dataset, batch_size: int, collate_fn: Optional[Callable] = None, rank: int = 0,
                 num_replicas: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or default_collate
        self.rank = rank
        self.num_replicas = num_replicas

    def __len__(self):
        return len(self.dataset) // (self.batch_size * self.num_replicas)

    def __iter__(self) -> Iterator:
        for b in range(len(self)):
            first = (b * self.num_replicas + self.rank) * self.batch_size
            yield self.collate_fn([self.dataset[i] for i in range(first, first + self.batch_size)])


class RepeatingLoader:
    """Wraps an iterable to restart on StopIteration (reference ``pipe/engine``)."""

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
