"""Shared helpers of the port's tools (port of ``tools/_common.py``):
the segmentation trainers' datasets, the reference's class palette, and
the segmentation model of a trainer checkpoint."""
from __future__ import annotations

import os

import numpy as np
import torch

from ndtpu_torch.data.carla import CarlaSeg
from ndtpu_torch.data.synthetic import SyntheticSeg
from ndtpu_torch.train.loop import make_lr_schedule
from ndtpu_torch.train.state import (
    CHECKPOINT_FILE,
    create_train_state,
    restore_checkpoint,
)


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


# the reference's 29-class palette (its tools/seg_viz.py:17-46)
CLASS_COLORS = [
    [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1],
    [1, 0.5, 0], [1, 0, 0.5], [0.5, 1, 0], [0, 1, 0.5], [0.5, 0, 1],
    [0, 0.5, 1], [0.5, 1, 1], [1, 0.5, 1], [1, 1, 0.5], [0.5, 0, 0],
    [0, 0.5, 0], [0, 0, 0.5], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5],
    [0.5, 0.5, 1], [0.5, 1, 0.5], [1, 0.5, 0.5], [0.5, 0, 0.5],
    [0.5, 0.5, 0.5], [0.25, 0.25, 0], [0, 0.25, 0.25], [0.25, 0, 0.25],
]


def paint_classes(classes):
    """class tags [N] -> RGB [N, 3] floats using the reference palette."""
    pal = np.asarray(CLASS_COLORS, np.float32)
    return pal[np.asarray(classes, np.int64) % len(pal)]


def segmentation_model(n_classes, feature_dim, device, checkpoint=None,
                       seed=0):
    """An ``NDTNetSegmentation`` on ``device`` in eval mode: the model of
    a port trainer checkpoint directory (``restore_checkpoint``) when one
    is given, else random weights from ``seed``."""
    state = create_train_state(n_classes, feature_dim,
                               make_lr_schedule(1e-3, 1), seed=seed,
                               device=device)
    if checkpoint:
        state = restore_checkpoint(state, checkpoint)
    return state.model.eval()


def checkpoint_widths(checkpoint):
    """(n_classes, feature_dim) of the segmentation model saved in a port
    trainer checkpoint directory, read from its weights' shapes."""
    tree = torch.load(os.path.join(checkpoint, CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)["model"]
    return (tree["conv4.weight"].shape[0] - 1,
            tree["feature_extractor.conv3.weight"].shape[0])
