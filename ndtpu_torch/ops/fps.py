"""Farthest point sampling (port of ``ndtpu/ops/fps.py``).

The JAX package's FPS is a ``lax.scan`` of XLA ops, not a Pallas kernel,
and here it is the same steps as torch ops: n_samples - 1 dependent steps,
each the squared distances to the last pick, the running minimum with
them, and an argmax (ties to the first index, as ``jnp.argmax``). The
carried index stays a device tensor, so no step waits for the card; on
the card each step is a handful of small launches, so a sample costs
launch overhead, not bandwidth (PERF.md).
"""
from __future__ import annotations

import torch


def farthest_point_sampling(points, n_samples: int, mask=None,
                            start: int = 0):
    """Select ``n_samples`` indices by the iterative farthest-point rule.

    points: [B, N, 3] (or [N, 3], taken as B = 1). mask: optional [B, N]
    (or [N]) bool; a masked row is never picked (its distance is held at
    -finfo.max), unless the seed ``start`` is one. Returns int64 indices
    [B, n_samples] (or [n_samples]), the first being ``start``.
    """
    single = points.dim() == 2
    if single:
        points = points[None]
        mask = None if mask is None else mask[None]
    b, n, _ = points.shape
    big = torch.finfo(points.dtype).max
    if mask is None:
        min_d = torch.full((b, n), big, dtype=points.dtype,
                           device=points.device)
    else:
        min_d = torch.where(mask, big, -big).to(points.dtype)
    last = torch.full((b,), start, dtype=torch.int64, device=points.device)
    picks = [last]
    for _ in range(n_samples - 1):
        q = points.gather(1, last[:, None, None].expand(b, 1, 3))
        diff = points - q
        sq = diff * diff
        d = sq[..., 0] + sq[..., 1] + sq[..., 2]
        if mask is not None:
            d = torch.where(mask, d, -big)
        min_d = torch.minimum(min_d, d)
        last = min_d.argmax(-1)
        picks.append(last)
    idx = torch.stack(picks, -1)
    return idx[0] if single else idx
