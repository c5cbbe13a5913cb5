"""Shared helpers of the port's tools (port of ``tools/_common.py``):
the segmentation trainers' datasets."""
from __future__ import annotations

import numpy as np

from ndtpu_torch.data.carla import CarlaSeg
from ndtpu_torch.data.synthetic import SyntheticSeg


class IntLabels:
    """Adapter: (points, one-hot gt [N, C+1]) -> (points, tags [N] int32),
    the trainer's default ground-truth input (C+1 times fewer bytes to the
    card; the preprocessing gives the same one-hot either way)."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        pts, gt = self.ds[i]
        return pts, np.argmax(gt, axis=-1).astype(np.int32)


def make_dataset(n_classes, n_samples, path=None, synthetic_length=32,
                 seed=0, int_labels=False):
    """``CarlaSeg`` on the PLY tree at ``path`` (its generator seeded 0,
    as the JAX tools seed it), else the synthetic set (``SyntheticSeg``
    of ``synthetic_length`` clouds from ``seed``)."""
    ds = (CarlaSeg(n_classes, n_samples, path) if path else
          SyntheticSeg(n_classes, n_samples, length=synthetic_length,
                       seed=seed))
    return IntLabels(ds) if int_labels else ds
