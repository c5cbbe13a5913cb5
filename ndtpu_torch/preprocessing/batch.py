"""Batched NDT preprocessing (port of ``ndtpu/preprocessing/batch.py``).

The whole batch goes through one ``ndt_downsample`` call on ``[B, N, 3]``
points: one sort per search round for all clouds and one segment-moments
kernel launch. The JAX package's ``use_pallas`` switch has no counterpart:
the kernel runs when the points lie on the card, its plain version when
they lie on the CPU.
"""
from __future__ import annotations

import torch

from ndtpu_torch.core.ndt import ndt_downsample
from ndtpu_torch.utils.profiling import span


def ndt_preprocessing_with_state(num_nds: int, points, classes_onehot=None,
                                 num_classes: int = 0,
                                 search: str = "reference",
                                 fixed_voxel_sizes=None,
                                 warm_start_sizes=None):
    """NDT-downsample a batch of clouds to ``num_nds`` NDs each.

    points: [B, N, 3]. classes_onehot: None, one-hot ground truth
    [B, N, C+1], or integer class tags [B, N]. fixed_voxel_sizes: optional
    [B], skips the search. warm_start_sizes: optional [B], seeds the
    fast/probe search (ignored when fixed sizes are given).

    Returns (points [B, M, 3], covs [B, M, 9], one-hot classes
    [B, M, C+1], out_mask [B, M], NDTResult); NaN and +-inf scrubbed to 0.
    Untagged clouds carry the [B, K, 1] counts column as class_hist.
    """
    with span("ndtpu.prep"):
        slots = num_classes + 1
        if classes_onehot is None:
            tags, ds_slots = None, 1
        elif classes_onehot.dim() == points.dim() - 1:  # int tags [B, N]
            tags, ds_slots = classes_onehot.to(torch.int32), slots
        else:
            tags, ds_slots = classes_onehot.argmax(-1).to(torch.int32), slots
        pcl, covs, labels, mask, state = ndt_downsample(
            points, num_nds, None, tags, num_class_slots=ds_slots,
            search=search, fixed_voxel_size=fixed_voxel_sizes,
            warm_start_size=(warm_start_sizes if fixed_voxel_sizes is None
                             else None),
        )
        pcl = torch.nan_to_num(pcl, nan=0.0, posinf=0.0, neginf=0.0)
        covs = torch.nan_to_num(covs, nan=0.0, posinf=0.0, neginf=0.0)
        # a compare, as jax.nn.one_hot: no host-side range check
        # (F.one_hot's would stall the host on the card)
        classes = torch.arange(slots, device=labels.device)
        onehot = ((labels[..., None] == classes)
                  & mask[..., None]).to(torch.float32)
    return pcl, covs, onehot, mask, state


def ndt_preprocessing(num_nds: int, points, classes_onehot=None,
                      num_classes: int = 0):
    """The reference batch bridge (ndtnet_preprocessing.py:6):
    (points, covs, classes one-hot or None)."""
    pcl, covs, onehot, _, _ = ndt_preprocessing_with_state(
        num_nds, points, classes_onehot, num_classes
    )
    return pcl, covs, onehot if classes_onehot is not None else None
