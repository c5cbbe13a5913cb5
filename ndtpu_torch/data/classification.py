"""Classification datasets (port of ``ndtpu/data/classification.py``):
``ModelNetCls`` reads a ModelNet-style tree of OFF/PLY meshes,
``<root>/<class>/<split>/<file>``, and samples each mesh's vertices to
n_points; ``SyntheticCls`` (``data/synthetic.py``) is the procedural
stand-in. Both yield (points [n_points, 3] f32, label int).
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ndtpu_torch.data.ply import read_ply


def read_off(path: str) -> np.ndarray:
    """[V, 3] float64 vertices of an OFF mesh; the counts may sit on the
    header's own line, as ModelNet's glued ``OFF123 456 0``."""
    with open(path, "r") as f:
        first = f.readline().strip()
        if first.startswith("OFF") and len(first) > 3:
            counts = first[3:].split()
        else:
            if first != "OFF":
                raise ValueError(f"not an OFF file: {path}")
            counts = f.readline().split()
        n_vertices = int(counts[0])
        verts = np.loadtxt(f, max_rows=n_vertices, dtype=np.float64)
    return verts[:, :3]


class ModelNetCls:
    """ModelNet-style classification set.

    Splits "train", "test", "val" and "train+holdout". Without a val/
    directory, "val" is a 1-in-VAL_EVERY holdout carved from each class's
    sorted train files and "train+holdout" the rest, so train and val stay
    disjoint. Points are drawn by one ``default_rng(seed)`` per dataset,
    in the order the items are fetched, then centred and scaled into the
    unit sphere."""

    VAL_EVERY = 10

    def __init__(self, root: str, split: str = "train", n_points: int = 2048,
                 seed: int = 0):
        self.root = root
        self.split = split
        self.n_points = int(n_points)
        self.classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        have_val_dir = any(
            os.path.isdir(os.path.join(root, c, "val")) for c in self.classes
        )
        carve = None  # None: every file; True: the holdout; False: the rest
        if split == "val" and not have_val_dir:
            split, carve = "train", True
        elif split == "train+holdout":
            split, carve = "train", False
        self.items: List[Tuple[str, int]] = []
        for label, cls in enumerate(self.classes):
            d = os.path.join(root, cls, split)
            if not os.path.isdir(d):
                d = os.path.join(root, cls)
            names = [n for n in sorted(os.listdir(d))
                     if n.endswith((".off", ".ply"))]
            if carve is not None:
                names = [n for i, n in enumerate(names)
                         if (i % self.VAL_EVERY == 0) == carve]
            self.items.extend((os.path.join(d, n), label) for n in names)
        self._rng = np.random.default_rng(seed)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        path, label = self.items[idx]
        verts = read_off(path) if path.endswith(".off") else read_ply(path)[0]
        sel = self._rng.choice(
            verts.shape[0], self.n_points, replace=verts.shape[0] < self.n_points
        )
        pts = verts[sel].astype(np.float32)
        pts -= pts.mean(0)
        pts /= max(np.linalg.norm(pts, axis=1).max(), 1e-9)
        return pts, label
