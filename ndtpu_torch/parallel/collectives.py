"""The data group's collectives (the port's side of what XLA inserts under
a ``data`` mesh), and their count (counterpart of ``ndtpu/utils/hlo.py``).

- ``all_reduce_sum``: a sum over the data group that gradients flow
  through: its forward all-reduces a copy of the input, its backward
  all-reduces the incoming gradient (the rank's input feeds every rank's
  sum, so its gradient is the sum of theirs). Without a data group it is
  the identity. BatchNorm's global statistics and the steps' global
  losses go through it.
- ``all_reduce_gradients``: the parameters' gradients summed over the
  group, one flat buffer and one ``all_reduce`` per type.
- ``Collectives``: counts the ``torch.distributed`` collectives called
  inside a block, by op, shape and bytes, as ``ndtpu/utils/hlo.py``
  reads them from a compiled program's text (an all-gather counts its
  gathered result).

Every op is an ordinary ``torch.distributed`` call on the data group
(``parallel/mesh.py::data_group``), so a failed collective raises where
it is made; a point group does not turn them on.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch
import torch.distributed as dist

from ndtpu_torch.parallel.mesh import data_group


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x):
    """The sum of ``x`` over the data group's ranks, differentiable; ``x``
    itself without a data group."""
    group = data_group()
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_gradients(params):
    """Sum each parameter's ``.grad`` over the data group, in place: the
    gradients of one type in one flat buffer and one ``all_reduce``.
    Parameters without a gradient are left out (every rank runs the same
    model, so they are the same ones). A no-op without a data group."""
    group = data_group()
    if group is None:
        return
    by_type = {}
    for p in params:
        if p.grad is not None:
            by_type.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_type.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))


class Call(NamedTuple):
    op: str          # all_gather, all_reduce or broadcast
    shape: tuple     # the tensor handed in (one part of an all-gather)
    itemsize: int
    nbytes: int      # the tensor's bytes; an all-gather's whole result


class Collectives:
    """Counts the ``torch.distributed`` collectives (all_gather,
    all_reduce, broadcast) called inside the ``with`` block: ``log`` holds
    each ``Call``, ``calls`` counts them by (op, shape), ``ops`` by op,
    ``nbytes`` sums their bytes by op."""

    OPS = ("all_gather", "all_reduce", "broadcast")

    def __enter__(self):
        self.log = []
        self.saved = {op: getattr(dist, op) for op in self.OPS}
        for op in self.OPS:
            setattr(dist, op, self._counted(op))
        return self

    def __exit__(self, *exc):
        for op, fn in self.saved.items():
            setattr(dist, op, fn)

    def _counted(self, op):
        real = self.saved[op]

        def call(*args, **kw):
            if op == "all_gather":
                parts, t = args[0], args[1]
                nbytes = sum(p.numel() * p.element_size() for p in parts)
            else:
                t = args[0]
                nbytes = t.numel() * t.element_size()
            self.log.append(Call(op, tuple(t.shape), t.element_size(), nbytes))
            return real(*args, **kw)

        return call

    def clear(self):
        self.log.clear()

    @property
    def calls(self) -> collections.Counter:
        return collections.Counter((c.op, c.shape) for c in self.log)

    @property
    def ops(self) -> collections.Counter:
        return collections.Counter(c.op for c in self.log)

    @property
    def nbytes(self) -> collections.Counter:
        out = collections.Counter()
        for c in self.log:
            out[c.op] += c.nbytes
        return out
