"""Process groups (counterpart of ``ndtpu/parallel/mesh.py``).

Where the JAX package builds a ``Mesh`` with a ``points`` or a ``data``
axis, the port uses the default ``torch.distributed`` process group, and
every rank calls the collectives, a single rank too:

- the point-sharded path (``parallel/point_sharded.py``): the ranks are
  the shards of one cloud's point axis (``make_group``);
- data parallelism (``init_distributed``, the trainers'
  ``--coordinator/--num_processes/--process_id``, or ``make_data_group``):
  the ranks are the data group, each holding a slice of every global
  batch. ``data_rank`` and ``data_size`` are the JAX trainers'
  ``process_index`` and ``process_count``; ``broadcast_state`` is
  ``replicate`` (rank 0's state on every rank).

Only a group made as the data group turns on the data-parallel arithmetic
(global BatchNorm statistics, global losses, the gradients' all-reduce):
``data_group`` returns it, and None under a point group or no group.

A group over the card uses NCCL; gloo is used only when the caller asks
for the CPU, as the tests do, or forces it with ``backend="gloo"``.
Nothing here reads a cluster's environment: the caller gives the
address, the world size and the rank. A group that cannot be made
raises; nothing falls back to one process.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from ndtpu_torch.utils.device import resolve_device

_data_group = None  # the group make_data_group made, until release_group


def make_group(device="cuda", init_method=None, world_size: int = 1,
               rank: int = 0, backend: Optional[str] = None):
    """Initialise this process's default process group and return it.

    device: "cuda" (NCCL, on card ``rank % device_count``, or the card
    it names; raises without a card) or "cpu" (gloo); ``backend`` forces
    another backend (gloo over the card's tensors). With ``world_size ==
    1`` and no ``init_method`` the group is one rank over an in-process
    store; otherwise ``init_method`` (e.g. ``tcp://localhost:<port>`` or
    ``file://<path>``) joins ``world_size`` processes. Release it with
    ``release_group``.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if dev.type == "cuda":
        index = rank % torch.cuda.device_count() if dev.index is None else dev.index
        torch.cuda.set_device(index)
        if backend == "nccl":  # the communicator is made here, not lazily
            kwargs["device_id"] = torch.device("cuda", index)
    if init_method is None:
        if world_size != 1:
            raise ValueError("world_size > 1 needs an init_method")
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend, world_size=world_size, rank=rank,
                            **kwargs)
    _data_group = None
    return dist.group.WORLD


def run_ranks(fn, n: int, *args):
    """Run ``fn(rank, n, init_method, *args)`` on ``n`` ranks and return
    their results, rank 0's first. One rank runs in this process with no
    ``init_method`` (a group of one over an in-process store); several
    are spawned processes (``torch.multiprocessing``) that meet at a
    FileStore in a temporary directory, and a rank that raises fails the
    call (the others are ended). ``fn`` must be importable by its module
    path and its results picklable. The results are read from their pipe
    while the ranks run, so a rank whose result outgrows the pipe's
    buffer is not left blocked in ``put``."""
    if n == 1:
        return [fn(0, 1, None, *args)]
    import torch.multiprocessing as mp

    queue = mp.get_context("spawn").SimpleQueue()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = mp.start_processes(
            _queued, args=(fn, n, "file://" + os.path.join(tmp, "store"),
                           args, queue),
            nprocs=n, join=False, start_method="spawn")
        done = False
        while not done:
            done = procs.join(timeout=0.1)  # raises when a rank fails
            while not queue.empty():
                rank, result = queue.get()
                results[rank] = result
    return [results[r] for r in range(n)]


def _queued(rank, fn, n, init_method, args, queue):
    queue.put((rank, fn(rank, n, init_method, *args)))


def make_data_group(device="cuda", init_method=None, world_size: int = 1,
                    rank: int = 0, backend: Optional[str] = None):
    """``make_group``'s group, recorded as the data group (``data_group``):
    the steps, BatchNorm and the loaders then compute across its ranks.
    One rank (no ``init_method``) gives the data-parallel arithmetic on a
    single process. Release it with ``release_group``."""
    global _data_group
    group = make_group(device, init_method, world_size, rank, backend)
    _data_group = group
    return group


def release_group():
    """Destroy the default process group, if there is one, and forget the
    data group."""
    global _data_group
    _data_group = None
    if dist.is_initialized():
        dist.destroy_process_group()


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the data group of ``num_processes`` processes as rank
    ``process_id``, the coordinator ``host:port`` at rank 0 (``tcp://``);
    a no-op when ``num_processes <= 1``. Call it before touching a device.
    Returns the device this rank computes on: ``cuda:{rank %
    device_count}`` for "cuda" (NCCL unless ``backend`` says gloo), or
    the CPU (gloo)."""
    dev = resolve_device(device)
    if num_processes is None or num_processes <= 1:
        return dev
    if coordinator is None:
        raise ValueError("--num_processes > 1 needs --coordinator host:port")
    rank = process_id or 0
    make_data_group(dev, f"tcp://{coordinator}", num_processes, rank, backend)
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def data_group():
    """The data group (``make_data_group``, ``init_distributed``), or None
    without one: a point group is not a data group."""
    return _data_group if dist.is_initialized() else None


def data_rank() -> int:
    """This process's rank in the data group (0 without one)."""
    group = data_group()
    return 0 if group is None else dist.get_rank(group)


def data_size() -> int:
    """The number of processes in the data group (1 without one)."""
    group = data_group()
    return 1 if group is None else dist.get_world_size(group)


def broadcast_state(state, src: int = 0):
    """Give every rank of the data group rank ``src``'s parameters,
    buffers and Adam state, in place (the tensors keep their addresses);
    a no-op without a group. The tensors go in one flat buffer per type
    on the parameters' device, one broadcast each (Adam's step counters,
    held on the CPU by a plain Adam, are staged through it). Returns the
    state."""
    group = data_group()
    if group is None:
        return state
    dev = next(state.model.parameters()).device
    tensors = list(state.model.state_dict().values())
    for s in state.optimizer.state.values():
        tensors += [v for v in s.values() if isinstance(v, torch.Tensor)]
    by_type = {}
    for t in tensors:
        by_type.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_type.values():
            flat = torch.cat([t.reshape(-1).to(dev) for t in ts])
            dist.broadcast(flat, src, group=group)
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view_as(t))
    return state


def shard_points(x, group=None):
    """This rank's equal slice of a cloud along dim 0 (``points``,
    ``mask`` or ``classes``), as ``P("points")`` lays it out. The length
    must divide by the group's size."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[0]
    if n % size:
        raise ValueError(f"{n} points do not split into {size} equal shards")
    per = n // size
    return x[rank * per:(rank + 1) * per]
