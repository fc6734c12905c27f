"""Data loading: the sharded batch loader and the repeating wrapper.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``. ``DeepSpeedDataLoader``
batches any indexable dataset to the engine's micro-batch, takes this data
parallel rank's round-robin share, drops a short last batch by default and
shuffles by epoch from ``numpy.random.RandomState(seed + epoch)``: for the
same dataset and seed a batch holds the same rows as the JAX package's.
Samples (tuples, lists, dicts or arrays of numpy arrays, tensors or
numbers) are stacked with numpy and handed out as torch tensors; with a
CUDA ``device`` each batch is copied into pinned memory and sent to the card
``non_blocking``.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


class RepeatingLoader(object):
    """Wrap an iterable to restart it on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _stack_batch(samples):
    """Stack samples (each a tuple/list/dict/array) into batch tensors."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(
            _stack_batch([s[i] for s in samples]) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _stack_batch([s[k] for s in samples]) for k in first}
    return torch.from_numpy(np.stack([_to_numpy(s) for s in samples]))


def _to_device(batch, device):
    """Every tensor of ``batch`` on ``device``: pinned, then ``non_blocking``
    for a CUDA device."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) and batch.device != device:
        if device.type == "cuda":
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    return batch


class DeepSpeedDataLoader(object):
    """Shards and batches a dataset over the data-parallel group (module
    docstring). ``len()`` is the rank's number of batches."""

    def __init__(self, dataset, batch_size, local_rank=0,
                 data_parallel_world_size=1, data_parallel_rank=0,
                 collate_fn=None, num_local_io_workers=None,
                 data_sampler=None, drop_last=True, shuffle=False, seed=0,
                 device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.dp_world_size = data_parallel_world_size
        self.dp_rank = data_parallel_rank
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.device = None if device is None else torch.device(device)
        n = len(dataset)
        per_rank = n // self.dp_world_size if drop_last else \
            (n + self.dp_world_size - 1) // self.dp_world_size
        self.num_samples = per_rank
        self.len = per_rank // batch_size if drop_last else \
            (per_rank + batch_size - 1) // batch_size
        if self.len == 0:
            logger.warning(
                "DeepSpeedDataLoader: dataset of size %d yields 0 batches at "
                "micro-batch %d over %d ranks", n, batch_size,
                self.dp_world_size)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        # Round robin, as DistributedSampler: rank r takes order[r::W].
        return order[self.dp_rank::self.dp_world_size][:self.num_samples]

    def __iter__(self):
        indices = self._indices()
        for start in range(0, len(indices), self.batch_size):
            batch_idx = indices[start:start + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                return
            samples = [self.dataset[int(i)] for i in batch_idx]
            batch = self.collate_fn(samples) if self.collate_fn is not None \
                else _stack_batch(samples)
            yield batch if self.device is None else \
                _to_device(batch, self.device)

    def __len__(self):
        return self.len
