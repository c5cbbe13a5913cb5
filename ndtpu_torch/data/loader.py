"""Input pipeline (port of ``ndtpu/data/loader.py``): a batch iterator
over an indexable dataset, an in-memory sample cache, a one-batch-ahead
device prefetcher, and the device-resident dataset.

The prefetcher copies each batch from pinned host memory with
``non_blocking=True``, so the copy of batch i + 1 is queued behind step i
and the host does not wait for it. ``DeviceCachedDataset`` uploads a
whole dataset once and gathers each batch on the device.

Under a data group of P processes every rank follows the same schedule of
global batches and loads only its slice of each (``batch_iterator``'s
``process_id``/``num_processes``); a sharded ``DeviceCachedDataset``
holds a 1/P block of the rows on each rank, and ``sharded_batch``
assembles a rank's slice of a global batch from the blocks.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ndtpu_torch.parallel.mesh import data_size
from ndtpu_torch.utils.device import resolve_device
from ndtpu_torch.utils.profiling import span


def epoch_order(n: int, shuffle: bool = True, seed: int = 0):
    """The dataset indices of an epoch: ``arange(n)``, shuffled by
    ``np.random.default_rng(seed)`` when asked, as the JAX loader does."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    return order


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, process_id: int = 0,
                   num_processes: int = 1) -> Iterator:
    """Yields tuples of stacked numpy arrays, samples fetched on a pool of
    4 threads; a last partial batch is dropped. The order is
    ``epoch_order``, so a seed gives the JAX loader's batches.

    ``batch_size`` is the global batch size: with ``num_processes`` > 1
    every process draws the same order and yields only its strided slice
    ``idxs[process_id::num_processes]`` of each global batch (ValueError
    unless the batch size divides by the process count)."""
    if batch_size % num_processes:
        raise ValueError(f"global batch_size {batch_size} must divide by "
                         f"num_processes {num_processes}")
    n = len(dataset)
    order = epoch_order(n, shuffle, seed)

    def fetch(i):
        return dataset[int(i)]

    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        for start in range(0, n - batch_size + 1, batch_size):
            idxs = order[start:start + batch_size][process_id::num_processes]
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
    issued before the current one is handed out; the making and copy of
    each batch is an ``ndtpu.data`` span."""
    it, pending = iter(it), None
    while True:
        with span("ndtpu.data"):
            batch = next(it, None)
            nxt = None if batch is None else to_device(batch, device)
        if nxt is None:
            break
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
    epoch.

    ``sharding`` (a process group: the data group) makes the
    multi-process form: rank r of P uploads only its contiguous block of
    rows ``[r n / P, (r + 1) n / P)`` (ValueError unless n divides by P),
    so global row i is still dataset index i, and ``len`` is n. Its
    batches are assembled inside ``make_epoch_scan(..., sharding)``'s
    epoch (``sharded_batch``); ``loader`` reads only a whole dataset.
    Under a data group of more than one process a dataset must be
    sharded."""

    def __init__(self, ds, device="cuda", sharding=None):
        dev = resolve_device(device)
        n = len(ds)
        rows = range(n)
        if sharding is None:
            if data_size() > 1:
                raise ValueError("multi-process DeviceCachedDataset needs "
                                 "the data group as its sharding")
        else:
            size, rank = dist.get_world_size(sharding), dist.get_rank(sharding)
            if n % size:
                raise ValueError(f"dataset length {n} must divide by "
                                 f"process count {size} for block sharding")
            rows = range(rank * (n // size), (rank + 1) * (n // size))
        self.n, self.sharding = n, sharding
        samples = [ds[i] for i in rows]
        self.arrays = tuple(
            torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
            for k in range(len(samples[0])))

    def __len__(self):
        return self.n

    def loader(self, batch_size: int, shuffle: bool = True, seed: int = 0):
        """Yield tuples of device tensors [batch_size, ...] in
        ``batch_iterator``'s order, a last partial batch dropped."""
        if self.sharding is not None:
            raise ValueError("a sharded DeviceCachedDataset is read by the "
                             "epoch scan (run_epoch_scan)")
        n = len(self)
        order = epoch_order(n, shuffle, seed)
        dev = self.arrays[0].device
        for start in range(0, n - batch_size + 1, batch_size):
            idx = to_device((order[start:start + batch_size],), dev)[0]
            yield tuple(a.index_select(0, idx) for a in self.arrays)


def sharded_batch(arrays, idx, group):
    """This rank's slice of a global batch from a ``DeviceCachedDataset``
    sharded over ``group``: ``arrays`` are the rank's block of rows,
    ``idx`` [B] the batch's global rows (on every rank). Each rank writes
    the rows it holds into a [B, ...] buffer of additive identities (-0.0
    for a float: -0.0 + x is x for every x, +0.0 and -0.0 included; 0 for
    an int), one sum all-reduce an array fills in the rest, and the rank
    keeps ``[rank::size]``: bit for bit ``batch_iterator``'s slice."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    rows = arrays[0].shape[0]
    local = idx - rank * rows
    mine = (local >= 0) & (local < rows)
    local = torch.where(mine, local, 0)
    out = []
    for a in arrays:
        got = a.index_select(0, local)
        empty = torch.full_like(got, -0.0 if got.is_floating_point() else 0)
        full = torch.where(mine.view(-1, *[1] * (a.dim() - 1)), got, empty)
        dist.all_reduce(full, group=group)
        out.append(full[rank::size].contiguous())
    return tuple(out)
