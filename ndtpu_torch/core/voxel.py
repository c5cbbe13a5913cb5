"""Voxel-space math (port of ``ndtpu/core/voxel.py``).

Semantics follow the reference C core (``core_legacy/src/voxel.c``) exactly
as the JAX module does. Every function broadcasts over leading dims, so
per-cloud scalars (voxel size, grid lengths, offsets) of a batch are passed
as ``[B, 1]`` tensors against ``[B, N]`` coordinates. Integer outputs that
the JAX package keeps as int32 state (grid lengths, voxel coords) stay
int32; intermediate keys are int64.
"""
from __future__ import annotations

import torch

# 6-connected neighborhood, reference `enum direction_t` order
# (X_POS, X_NEG, Y_POS, Y_NEG, Z_POS, Z_NEG)
NEIGHBOR_OFFSETS = (
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
)
DIRECTION_LEN = 6

# float -> int conversions are clamped first: XLA saturates out-of-range
# converts, C++ (and so torch) leaves them undefined
_INT_CLAMP = float(2**62)


def _to_int(x: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    return x.clamp(-_INT_CLAMP, _INT_CLAMP).to(dtype)


def estimate_voxel_size(n_desired_voxels, mins, maxs):
    """Geometric-mean voxel sizing (voxel.c:28-59): the cube root of
    volume / n. mins/maxs [..., 3]. Returns (size [...], lens [..., 3]
    int32, offsets [..., 3])."""
    dims = maxs - mins
    logs = torch.log(dims)
    log_n = torch.full((), float(n_desired_voxels), dtype=dims.dtype,
                       device=dims.device).log()
    log_size = (logs[..., 0] + logs[..., 1] + logs[..., 2] - log_n) / 3.0
    size = torch.exp(log_size)
    lens = _to_int(torch.ceil(dims / size[..., None]), torch.int32)
    return size, lens, mins


def estimate_voxel_grid(mins, maxs, voxel_size):
    """Grid dims + offsets for a voxel size (voxel.c:61-81). mins/maxs
    [..., 3], voxel_size [...] (one per cloud). lens = max(ceil(d/s), 1)
    int32, offsets = mins."""
    vs = torch.as_tensor(voxel_size, dtype=mins.dtype, device=mins.device)
    dims = maxs - mins
    lens = torch.clamp(torch.ceil(dims / vs[..., None]), min=1.0)
    return _to_int(lens, torch.int32), mins


def metric_to_voxel_space(points, voxel_size, lens, offsets):
    """Points [..., 3] to voxel coords (voxel.c:83-103). voxel_size
    broadcasts against points[..., 0]. Returns (coords [..., 3] int32
    clamped into the grid, in_bounds [...] bool)."""
    vs = torch.as_tensor(voxel_size, dtype=points.dtype, device=points.device)
    raw = _to_int(torch.floor((points - offsets) / vs[..., None]))
    lens = lens.long()
    in_bounds = ((raw >= 0) & (raw < lens)).all(dim=-1)
    coords = torch.minimum(raw.clamp(min=0), lens - 1)
    return coords.to(torch.int32), in_bounds


def voxel_to_metric_space(coords, voxel_size, offsets):
    """Voxel coords [..., 3] to voxel centers (voxel.c:105-114)."""
    vs = torch.as_tensor(voxel_size, dtype=offsets.dtype,
                         device=offsets.device)
    return (coords.to(torch.float32) + 0.5) * vs[..., None] + offsets


def metric_to_voxel_axis(p, voxel_size, length, offset):
    """Per-axis metric->voxel coordinate (SoA form of
    metric_to_voxel_space): floor + clamp into [0, length). All arguments
    broadcast elementwise; returns int64."""
    raw = _to_int(torch.floor((p - offset) / voxel_size))
    return torch.minimum(raw.clamp(min=0), length.long() - 1)


def voxel_to_metric_axis(c, voxel_size, offset):
    """Per-axis voxel center (SoA form of voxel_to_metric_space)."""
    return (c.to(torch.float32) + 0.5) * voxel_size + offset


def voxel_pos_to_index(coords, lens):
    """Linearize voxel coords (x, y, z) x-fastest (voxel.c:177-189):
    idx = z*lx*ly + y*lx + x. int64."""
    coords = coords.long()
    lens = lens.long()
    lx, ly = lens[..., 0], lens[..., 1]
    return coords[..., 2] * (lx * ly) + coords[..., 1] * lx + coords[..., 0]


def index_to_voxel_pos(index, lens):
    """Inverse linearization (voxel.c:191-203). Returns [..., 3] (x, y, z)."""
    index = torch.as_tensor(index).long()
    lens = lens.long()
    lx, ly = lens[..., 0], lens[..., 1]
    z = torch.div(index, lx * ly, rounding_mode="floor")
    y = torch.div(index % (lx * ly), lx, rounding_mode="floor")
    x = index % lx
    return torch.stack([x, y, z], dim=-1)


def neighbor_indices(index, lens):
    """The 6 neighbor linear indices of `index` (voxel.c:116-175):
    (neighbor_idx [..., 6], valid [..., 6]); out-of-grid neighbors are
    invalid and their index is clamped into the grid."""
    pos = index_to_voxel_pos(index, lens)
    offs = torch.tensor(NEIGHBOR_OFFSETS, dtype=torch.int64,
                        device=pos.device)
    npos = pos[..., None, :] + offs
    lens = lens.long()
    valid = ((npos >= 0) & (npos < lens)).all(dim=-1)
    npos = torch.minimum(npos.clamp(min=0), lens - 1)
    return voxel_pos_to_index(npos, lens), valid


def pointcloud_limits(points, mask=None):
    """Per-axis min/max of a (masked) cloud (pointclouds.c:40-66 with its
    DBL_MIN bug fixed). points [..., N, 3], mask [..., N]."""
    if mask is None:
        return points.amin(dim=-2), points.amax(dim=-2)
    big = torch.finfo(points.dtype).max
    m = mask[..., None]
    mins = torch.where(m, points, big).amin(dim=-2)
    maxs = torch.where(m, points, -big).amax(dim=-2)
    return mins, maxs
