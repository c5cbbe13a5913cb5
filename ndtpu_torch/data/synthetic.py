"""Synthetic point clouds from a seed (numpy only).

Copies of the JAX package's cloud generators, with the same RNG calls so
a seed gives the same data: ``make_batch`` is bench.py's canonical serving
batch (600 Gaussian clusters in a 40 m cube), ``example_cloud`` is
``__graft_entry__._example_cloud`` (32 clusters, each cloud of the batch
scaled by 1 + 0.05 b), ``giant_cloud`` is bench.py's giant cloud (4096
clusters in an 80 m cube), and ``clustered_cloud`` / ``SyntheticSeg`` are
``ndtpu/data/synthetic.py``'s labelled segmentation set, the trainer's
default dataset.
"""
from __future__ import annotations

import numpy as np


def make_batch(batch: int, n_points: int, seed: int = 0) -> np.ndarray:
    """[batch, n_points, 3] float32 clustered clouds."""
    rng = np.random.default_rng(seed)
    clouds = []
    for _ in range(batch):
        centers = rng.uniform(-20, 20, size=(600, 3))
        per = n_points // 600 + 1
        pts = (
            (centers[:, None, :] + rng.normal(scale=0.4, size=(600, per, 3)))
            .reshape(-1, 3)[:n_points]
            .astype(np.float32)
        )
        clouds.append(pts)
    return np.stack(clouds)


def example_cloud(batch: int, n_points: int, seed: int = 0) -> np.ndarray:
    """[batch, n_points, 3] float32: one clustered cloud, scaled per row."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, size=(32, 3))
    per = max(1, n_points // 32 + 1)
    pts = (
        (centers[:, None, :] + rng.normal(scale=0.25, size=(32, per, 3)))
        .reshape(-1, 3)[:n_points]
        .astype(np.float32)
    )
    return np.stack([pts * (1 + 0.05 * b) for b in range(batch)])


def giant_cloud(n_points: int = 1_048_576, seed: int = 0) -> np.ndarray:
    """[n_points, 3] float32: bench.py's ``--giant`` cloud, 4096 Gaussian
    clusters (sigma 0.5 m) with centres uniform in +-40 m."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-40, 40, size=(4096, 3))
    per = n_points // 4096 + 1
    return (
        (centers[:, None, :] + rng.normal(scale=0.5, size=(4096, per, 3)))
        .reshape(-1, 3)[:n_points]
        .astype(np.float32)
    )


def clustered_cloud(n_points: int, n_clusters: int = 64, extent: float = 20.0,
                    scale: float = 0.4, seed: int = 0) -> np.ndarray:
    """[n_points, 3] float32 Gaussian clusters with centres uniform in
    +-extent."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, size=(n_clusters, 3))
    per = n_points // n_clusters + 1
    pts = centers[:, None, :] + rng.normal(scale=scale, size=(n_clusters, per, 3))
    return pts.reshape(-1, 3)[:n_points].astype(np.float32)


class SyntheticSeg:
    """Labelled segmentation clouds: __getitem__(i) -> (points [n_samples,
    3] f32, one-hot gt [n_samples, n_classes + 1] f32). Cloud i is
    ``clustered_cloud(n_samples, seed=seed + i)``; a point's class is its
    octant (1..8) mod n_classes, plus one (0 = unlabelled, never used)."""

    def __init__(self, n_classes: int, n_samples: int, length: int = 32,
                 seed: int = 0):
        self.n_classes = int(n_classes)
        self.n_samples = int(n_samples)
        self.length = int(length)
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        if idx < 0 or idx >= self.length:
            raise IndexError(idx)
        pts = clustered_cloud(self.n_samples, seed=self.seed + idx)
        octant = ((pts[:, 0] > 0).astype(np.int64) * 4
                  + (pts[:, 1] > 0).astype(np.int64) * 2
                  + (pts[:, 2] > 0).astype(np.int64))
        labels = octant % self.n_classes + 1
        gt = np.zeros((self.n_samples, self.n_classes + 1), np.float32)
        gt[np.arange(self.n_samples), labels] = 1.0
        return pts, gt
