"""Synthetic point clouds from a seed (numpy only).

Copies of the JAX package's cloud generators, with the same RNG calls so
a seed gives the same data: ``make_batch`` is bench.py's canonical serving
batch (600 Gaussian clusters in a 40 m cube), ``example_cloud`` is
``__graft_entry__._example_cloud`` (32 clusters, each cloud of the batch
scaled by 1 + 0.05 b), ``giant_cloud`` is bench.py's giant cloud (4096
clusters in an 80 m cube), and ``clustered_cloud`` / ``SyntheticSeg`` are
``ndtpu/data/synthetic.py``'s labelled segmentation set, the trainer's
default dataset; ``random_cloud`` is the uniform stress cloud and
``SyntheticCls`` the shape-classification set (8 primitives, a random
rotation and shift per cloud), the classification trainer's default.
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


def random_cloud(n_points: int = 90000, extent: float = 100.0,
                 seed: int = 0) -> np.ndarray:
    """[n_points, 3] float32 uniform in [0, extent)^3 (bench.py's
    ``--stress`` shape)."""
    rng = np.random.default_rng(seed)
    return (rng.random((n_points, 3)) * extent).astype(np.float32)


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


def _rotation(rng) -> np.ndarray:
    """Uniform random rotation: the QR factor of a Gaussian matrix, its
    columns' signs fixed by R's diagonal."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def _shape_cloud(cls: int, n: int, rng) -> np.ndarray:
    """[n, 3] float32 cloud of shape class ``cls``: 0 sphere shell, 1 solid
    ball, 2 plane patch, 3 two parallel planes, 4 cylinder shell, 5 thin
    rod, 6 cube surface, 7 torus; rotated, jittered and shifted."""
    u = rng.uniform(0.0, 2 * np.pi, n).astype(np.float32)
    if cls == 0:
        v = rng.normal(size=(n, 3))
        pts = 4.0 * v / np.linalg.norm(v, axis=1, keepdims=True)
    elif cls == 1:
        v = rng.normal(size=(n, 3))
        r = 4.0 * rng.uniform(0.0, 1.0, n) ** (1 / 3)
        pts = v / np.linalg.norm(v, axis=1, keepdims=True) * r[:, None]
    elif cls == 2:
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                        rng.normal(0, 0.05, n)], axis=1)
    elif cls == 3:
        z = np.where(rng.random(n) < 0.5, -2.0, 2.0) + rng.normal(0, 0.05, n)
        pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), z],
                       axis=1)
    elif cls == 4:
        pts = np.stack([3.0 * np.cos(u), 3.0 * np.sin(u),
                        rng.uniform(-4, 4, n)], axis=1)
    elif cls == 5:
        pts = np.stack([rng.normal(0, 0.08, n), rng.normal(0, 0.08, n),
                        rng.uniform(-5, 5, n)], axis=1)
    elif cls == 6:
        face = rng.integers(0, 6, n)
        a, b = rng.uniform(-3, 3, n), rng.uniform(-3, 3, n)
        s = np.where(face % 2 == 0, -3.0, 3.0)
        ax = face // 2
        pts = np.stack([np.where(ax == 0, s, a),
                        np.where(ax == 1, s, np.where(ax == 0, a, b)),
                        np.where(ax == 2, s, b)], axis=1)
    else:
        v = rng.uniform(0.0, 2 * np.pi, n).astype(np.float32)
        r0, r1 = 3.0, 1.0
        pts = np.stack([(r0 + r1 * np.cos(v)) * np.cos(u),
                        (r0 + r1 * np.cos(v)) * np.sin(u),
                        r1 * np.sin(v)], axis=1)
    pts = pts.astype(np.float32) @ _rotation(rng).T
    pts += rng.normal(0, 0.02, size=pts.shape).astype(np.float32)
    pts += rng.uniform(-1, 1, size=(1, 3)).astype(np.float32)
    return pts.astype(np.float32)


class SyntheticCls:
    """Shape-classification clouds: __getitem__(i) -> (points [n_points,
    3] f32, label int). Cloud i has class i % 8 and is drawn from
    ``default_rng(seed * 100003 + i)``."""

    NUM_CLASSES = 8

    def __init__(self, n_points: int = 2048, length: int = 64, seed: int = 0):
        self.n_points = int(n_points)
        self.length = int(length)
        self.seed = seed

    @property
    def n_classes(self) -> int:
        return self.NUM_CLASSES

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int):
        if idx < 0 or idx >= self.length:
            raise IndexError(idx)
        rng = np.random.default_rng(self.seed * 100003 + idx)
        label = idx % self.NUM_CLASSES
        return _shape_cloud(label, self.n_points, rng), label
