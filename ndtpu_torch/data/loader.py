"""Input pipeline (port of ``ndtpu/data/loader.py``): a batch iterator
over an indexable dataset, an in-memory sample cache, a one-batch-ahead
device prefetcher, and the device-resident dataset.

The prefetcher copies each batch from pinned host memory with
``non_blocking=True``, so the copy of batch i + 1 is queued behind step i
and the host does not wait for it. ``DeviceCachedDataset`` uploads a
whole dataset once and gathers each batch on the device.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterable, Iterator

import numpy as np
import torch

from ndtpu_torch.utils.device import resolve_device


def epoch_order(n: int, shuffle: bool = True, seed: int = 0):
    """The dataset indices of an epoch: ``arange(n)``, shuffled by
    ``np.random.default_rng(seed)`` when asked, as the JAX loader does."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    return order


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0) -> Iterator:
    """Yields tuples of stacked numpy arrays, samples fetched on a pool of
    4 threads; a last partial batch is dropped. The order is
    ``epoch_order``, so a seed gives the JAX loader's batches."""
    n = len(dataset)
    order = epoch_order(n, shuffle, seed)

    def fetch(i):
        return dataset[int(i)]

    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        for start in range(0, n - batch_size + 1, batch_size):
            idxs = order[start:start + batch_size]
            samples = list(pool.map(fetch, idxs))
            yield tuple(np.stack([s[k] for s in samples])
                        for k in range(len(samples[0])))


class CachedDataset:
    """Caches each sample of an indexable dataset after its first fetch
    (samples are deterministic per index, so later epochs skip the
    generation or parsing)."""

    def __init__(self, ds):
        self.ds = ds
        self._cache = {}

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        hit = self._cache.get(i)
        if hit is None:
            hit = self._cache[i] = self.ds[i]
        return hit


def to_device(batch, device):
    """numpy arrays -> tensors on ``device``; on the card through pinned
    host memory with a non-blocking copy."""
    dev = torch.device(device)
    out = []
    for a in batch:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory()
        out.append(t.to(dev, non_blocking=True))
    return tuple(out)


def prefetch_to_device(it: Iterable, device) -> Iterator:
    """Yield the batches of ``it`` as device tensors, the next one's copy
    issued before the current one is handed out."""
    pending = None
    for batch in it:
        nxt = to_device(batch, device)
        if pending is not None:
            yield pending
        pending = nxt
    if pending is not None:
        yield pending


class DeviceCachedDataset:
    """A whole dataset on ``device`` (the card unless the caller asks for
    the CPU): one upload at construction, each sample field stacked into
    one tensor ``arrays[k]`` [n, ...]; then batches are gathered on the
    device. ``loader`` gives ``batch_iterator``'s batches, and
    ``train/loop.py::run_epoch_scan`` gathers the same ones inside the
    epoch. The multi-process form of the JAX class (a ``sharding``)
    waits for the ROADMAP item "Multi-process data parallelism"."""

    def __init__(self, ds, device="cuda", sharding=None):
        if sharding is not None:
            raise NotImplementedError(
                "a sharded DeviceCachedDataset waits for the ROADMAP item "
                "\"Multi-process data parallelism\"")
        dev = resolve_device(device)
        samples = [ds[i] for i in range(len(ds))]
        self.arrays = tuple(
            torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
            for k in range(len(samples[0])))

    def __len__(self):
        return self.arrays[0].shape[0]

    def loader(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """Yield tuples of device tensors [batch_size, ...] in
        ``batch_iterator``'s order, a last partial batch dropped."""
        n = len(self)
        order = epoch_order(n, shuffle, seed)
        dev = self.arrays[0].device
        for start in range(0, n - batch_size + 1, batch_size):
            idx = to_device((order[start:start + batch_size],), dev)[0]
            yield tuple(a.index_select(0, idx) for a in self.arrays)
