"""CARLA semantic-segmentation datasets (port of ``ndtpu/data/carla.py``).

- ``CarlaSeg`` (reference ``ndnet/datasets/CARLA_Seg.py:9-57``): a PLY
  cloud, a random subsample of n_samples points from one stateful
  ``default_rng(seed)``, the one-hot ground truth [n_samples, C+1]. Its
  items equal the JAX dataset's bit for bit.
- ``CarlaNDTSeg`` (``CARLA_NDT_Seg.py:9-55``): farthest point sampling to
  n_samples, then a tagged NDT downsample (the reference search) for
  class-consistent labels, both on ``device``, the card by default. As in
  the reference, the points returned are the FPS points and the ground
  truth the NDT-downsampled one-hot, so their lengths differ.

Both are indexable (``__len__``/``__getitem__``) numpy datasets for
``ndtpu_torch.data.loader.batch_iterator``. ``CarlaNDTSeg`` launches card
work from ``__getitem__``: use it in this process (the port's loader
fetches on threads, never in worker processes).
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from ndtpu_torch.core.ndt import ndt_downsample
from ndtpu_torch.data.ply import read_ply
from ndtpu_torch.ops.fps import farthest_point_sampling
from ndtpu_torch.utils.device import resolve_device


def color_to_class(color) -> int:
    """RGB [0, 1] floats -> packed int tag (CARLA_Seg.py:59-76)."""
    c = (np.asarray(color) * 255).astype(np.uint8)
    return int(c[0]) << 16 | int(c[1]) << 8 | int(c[2])


def class_to_color(class_tag: int) -> np.ndarray:
    """Packed int tag -> RGB [0, 1] floats (CARLA_Seg.py:78-95)."""
    r = (class_tag >> 16) & 0xFF
    g = (class_tag >> 8) & 0xFF
    b = class_tag & 0xFF
    return np.array([r, g, b], dtype=np.float32) / 255.0


class _PlyFolder:
    """The sorted PLY files of a directory, each read with its class
    column checked against n_classes."""

    def __init__(self, n_classes: int, n_samples: int, path: str):
        self.n_classes = int(n_classes)
        self.n_samples = int(n_samples)
        self.path = path
        if not os.path.exists(path):
            raise FileNotFoundError(f"Dataset not found at {path}")
        self.filenames: List[str] = sorted(os.listdir(path))

    def __len__(self) -> int:
        return len(self.filenames)

    def _load(self, idx: int):
        if idx < 0 or idx >= len(self.filenames):
            raise IndexError(f"Index {idx} out of bounds")
        points, classes = read_ply(os.path.join(self.path, self.filenames[idx]))
        if classes.max(initial=0) > self.n_classes:
            # CARLA_Seg.py:128-129
            raise ValueError(f"Class tag {int(classes.max())} out of bounds")
        return points, classes

    def _one_hot(self, classes) -> np.ndarray:
        gt = np.zeros((classes.shape[0], self.n_classes + 1), np.float32)
        gt[np.arange(classes.shape[0]), classes.astype(np.int64)] = 1.0
        return gt


class CarlaSeg(_PlyFolder):
    """Random-subsample variant. ``__getitem__`` -> (points [n_samples, 3]
    f32, gt [n_samples, n_classes + 1] f32); each call draws from the
    dataset's one generator, so a fetch's points depend on the fetches
    before it (and, under the loader's fetch threads, on their order), as
    in the JAX dataset."""

    def __init__(self, n_classes: int, n_samples: int, path: str,
                 seed: int = 0):
        super().__init__(n_classes, n_samples, path)
        self._rng = np.random.default_rng(seed)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        points, classes = self._load(idx)
        # CARLA_Seg.py:142-148
        sel = self._rng.choice(points.shape[0], self.n_samples, replace=False)
        return points[sel].astype(np.float32), self._one_hot(classes[sel])


class CarlaNDTSeg(_PlyFolder):
    """FPS + NDT variant. ``__getitem__`` -> (points [n_samples, 3] f32,
    gt [num_desired_nds, n_classes + 1] f32); runs on ``device``, the card
    unless the caller asks for the CPU."""

    def __init__(self, n_classes: int, n_samples: int, num_desired_nds: int,
                 path: str, device="cuda"):
        super().__init__(n_classes, n_samples, path)
        self.num_desired_nds = int(num_desired_nds)
        self.device = resolve_device(device)

    @torch.no_grad()
    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        points, classes = self._load(idx)
        pts = torch.from_numpy(points.astype(np.float32)).to(self.device)
        cls = torch.from_numpy(classes.astype(np.int32)).to(self.device)
        # CARLA_NDT_Seg.py:146 (Open3D there)
        fps_idx = farthest_point_sampling(pts, self.n_samples)
        fps_points = pts[fps_idx]
        # NDT labels (CARLA_NDT_Seg.py:150-154)
        _, _, labels, _, _ = ndt_downsample(
            fps_points[None], self.num_desired_nds, None, cls[fps_idx][None],
            num_class_slots=self.n_classes + 1, search="reference")
        return fps_points.cpu().numpy(), self._one_hot(labels[0].cpu().numpy())
