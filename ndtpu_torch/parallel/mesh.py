"""Process groups for the point-sharded path (counterpart of
``ndtpu/parallel/mesh.py``).

Where the JAX package builds a ``Mesh`` with a ``points`` axis, the port
uses a ``torch.distributed`` process group: its ranks are the shards of
the point axis, and every rank calls the collectives, a single rank too.
A group over the card uses NCCL; gloo is used only when the caller asks
for the CPU, as the tests do. Nothing here reads a cluster's environment:
the caller gives the address, the world size and the rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ndtpu_torch.utils.device import resolve_device


def make_point_group(device="cuda", init_method=None, world_size: int = 1,
                     rank: int = 0):
    """Initialise this process's default process group and return it.

    device: "cuda" (NCCL, on card ``rank``; raises without a card) or
    "cpu" (gloo). With ``world_size == 1`` and no ``init_method`` the
    group is one rank over an in-process store; otherwise ``init_method``
    (e.g. ``tcp://localhost:<port>`` or ``file://<path>``) joins
    ``world_size`` processes. Release it with ``release_point_group``.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if dev.type == "cuda":
        torch.cuda.set_device(rank if dev.index is None else dev.index)
    if init_method is None:
        if world_size != 1:
            raise ValueError("world_size > 1 needs an init_method")
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend, world_size=world_size, rank=rank,
                            **kwargs)
    return dist.group.WORLD


def release_point_group():
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


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
