"""Per-voxel Gaussian moments as a sorted segment reduction (port of
``ndtpu/core/moments.py``).

Each point contributes (1, x~, x~x~^T, onehot(class)) to its voxel's
accumulator, x~ = x - voxel_center; finalisation gives the reference's
biased estimators (normal_distributions.c:82-103). Both reductions go
through the port's hand-written CUDA kernels on the card
(ops/segment_moments.py) and their plain versions on the CPU: the hot path
``segment_moments_soa`` through the fused moments kernel, and
``segment_moments`` through the generic sorted segment sum, as the JAX
package routes them under ``use_pallas=True``. The tensor's device picks
the route; there is no switch. Leading batch dims are allowed throughout.
"""
from __future__ import annotations

import torch

from ndtpu_torch.ops.segment_moments import (
    fused_moments_sorted,
    segment_sum_sorted,
)


def moment_features(points, centers, valid=None, classes=None,
                    num_class_slots=0):
    """The per-point rows [..., N, 13 (+ C)] that ``segment_moments`` sums:
    [1, x~ (3), x~x~^T (9), onehot(class) (C)], zero where not valid."""
    x = points - centers
    outer = x[..., :, None] * x[..., None, :]
    parts = [torch.ones_like(x[..., :1]), x, outer.reshape(x.shape[:-1] + (9,))]
    if classes is not None:
        slots = torch.arange(num_class_slots, device=points.device)
        parts.append((classes[..., None].long() == slots).to(points.dtype))
    feats = torch.cat(parts, dim=-1)
    if valid is not None:
        feats = torch.where(valid[..., None], feats, 0.0)
    return feats


def segment_moments(points, centers, seg_ids, num_segments, valid=None,
                    classes=None, num_class_slots=0):
    """Accumulate per-segment Gaussian moments (the sorted segment sum
    kernel on the card).

    points/centers [..., N, 3] f32; seg_ids [..., N] sorted per leading
    index, in [0, K) (ids >= K dropped); valid [..., N] bool; classes
    [..., N] int in [0, num_class_slots). Returns {counts [..., K] int32,
    sum_shift [..., K, 3], sum_outer [..., K, 3, 3], class_hist
    [..., K, C] int32 if classes}."""
    feats = moment_features(points, centers, valid, classes, num_class_slots)
    acc = segment_sum_sorted(feats, seg_ids.to(torch.int32).contiguous(),
                             num_segments)
    out = {
        "counts": torch.round(acc[..., 0]).to(torch.int32),
        "sum_shift": acc[..., 1:4],
        "sum_outer": acc[..., 4:13].reshape(acc.shape[:-1] + (3, 3)),
    }
    if classes is not None:
        out["class_hist"] = torch.round(acc[..., 13:]).to(torch.int32)
    return out


def segment_moments_soa(xt, yt, zt, v, seg_ids, num_segments, classes=None,
                        num_class_slots=0, tags=None):
    """Structure-of-arrays moments for the NDT hot path.

    xt/yt/zt [..., N] f32 shifted coordinates (invalid rows zero), v
    [..., N] f32 validity, seg_ids [..., N] int32 dense sorted ranks (K =
    dropped), classes [..., N] int32 or None, tags: sequence of [..., N]
    f32 columns with at most one nonzero per segment (returned exactly as
    "tag_sums" [..., K, T]). One launch of the fused kernel on the card
    for the whole batch; its plain version on the CPU.
    """
    tags = tuple(tags) if tags else ()
    slots = num_class_slots if classes is not None else 0
    acc = fused_moments_sorted(
        xt, yt, zt, v,
        classes.to(torch.int32) if classes is not None else None,
        seg_ids.to(torch.int32), num_segments, slots, tags=tags,
    )
    out = {
        "counts": torch.round(acc[..., 0]).to(torch.int32),
        "sum_shift": acc[..., 1:4],
        "sum_outer": acc[..., 4:13].reshape(acc.shape[:-1] + (3, 3)),
    }
    if classes is not None:
        out["class_hist"] = torch.round(acc[..., 13:13 + slots]).to(torch.int32)
    if tags:
        out["tag_sums"] = acc[..., 13 + slots:13 + slots + len(tags)]
    return out


def finalize_moments(counts, sum_shift, sum_outer, seg_centers):
    """Accumulated moments -> (mean [..., K, 3], covariance [..., K, 3, 3]).
    Empty segments give zeros; NaNs are scrubbed as in
    normal_distributions.c:87-99."""
    n = torch.clamp(counts, min=1).to(sum_shift.dtype)[..., None]
    mean_shift = sum_shift / n
    mean = seg_centers + mean_shift
    cov = (sum_outer / n[..., None]
           - mean_shift[..., :, None] * mean_shift[..., None, :])
    occupied = (counts > 0)[..., None]
    mean = torch.where(occupied, mean, 0.0)
    cov = torch.where(occupied[..., None], cov, 0.0)
    return torch.nan_to_num(mean), torch.nan_to_num(cov)
