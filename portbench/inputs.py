"""The benchmark's inputs, made on the device from the run's seed: the
synthetic segmentation clouds and the model's weights.

The clouds are the trainers' synthetic segmentation set
(``ndtpu_torch/data/synthetic.py::SyntheticSeg``: 64 Gaussian clusters,
sigma 0.4 m, centres uniform in +-20 m; a point's class is its octant
modulo the class count, plus one), drawn for the whole split in a few
calls on the card instead of cloud by cloud on the host. The weights are
the program's seeded initialisation (a pointwise weight ~ N(0, 1 / fan
in), zero biases, BatchNorm at identity), drawn in one call.
"""
from __future__ import annotations

import numpy as np
import torch

CLUSTERS, EXTENT, SIGMA = 64, 20.0, 0.4


def generator(seed: int, purpose: int, device) -> torch.Generator:
    """A generator on ``device`` for one use of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + purpose) % 2**63)
    return g


def host_rng(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, purpose])


def clouds(seed: int, count: int, n_points: int, n_classes: int, device,
           purpose: int = 1, chunk: int = 64):
    """(points [count, n_points, 3] float32, tags [count, n_points] int32
    in 1..n_classes) on ``device``."""
    g = generator(seed, purpose, device)
    per = n_points // CLUSTERS + 1
    pts, tags = [], []
    for start in range(0, count, chunk):
        c = min(chunk, count - start)
        centres = torch.rand(c, CLUSTERS, 1, 3, generator=g, device=device)
        noise = torch.randn(c, CLUSTERS, per, 3, generator=g, device=device)
        p = ((centres * (2 * EXTENT) - EXTENT) + SIGMA * noise).reshape(c, -1, 3)
        p = p[:, :n_points].contiguous()
        octant = ((p[..., 0] > 0).int() * 4 + (p[..., 1] > 0).int() * 2
                  + (p[..., 2] > 0).int())
        pts.append(p)
        tags.append((octant % n_classes + 1).to(torch.int32))
    return torch.cat(pts), torch.cat(tags)


def weights(specs: dict, seed: int, device) -> dict:
    """name -> float32 tensor on ``device`` for every parameter and
    buffer of a model, from its family's ``param_specs``."""
    dense = [(n, s) for n, (k, s) in specs.items() if k == "dense"]
    draw = torch.randn(sum(o * i for _, (o, i) in dense),
                       generator=generator(seed, 2, device), device=device)
    out, at = {}, 0
    for name, (kind, shape) in specs.items():
        if kind == "dense":
            o, i = shape
            out[name] = (draw[at:at + o * i].reshape(o, i) / i**0.5).contiguous()
            at += o * i
        elif kind in ("one", "buffer_one"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
