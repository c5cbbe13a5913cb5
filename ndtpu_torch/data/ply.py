"""Text PLY reading (port of the numpy path of ``ndtpu/data/ply.py``).

The header is parsed up to ``end_header`` and the body loaded with one
``np.loadtxt`` pass. The JAX package first tries its native C++ reader
and falls back to this path; the port has no native reader yet (ROADMAP,
"Data"), so this is its only path.
"""
from __future__ import annotations

import numpy as np


def _parse_header(f) -> int:
    """The vertex count (-1 if none is given) of a PLY file opened in
    binary mode, read up to and including its ``end_header`` line."""
    n_vertices = -1
    if not f.readline().startswith(b"ply"):
        raise ValueError("not a PLY file")
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        if line.startswith(b"element vertex"):
            n_vertices = int(line.split()[-1])
        if line.strip() == b"end_header":
            return n_vertices


def read_ply(path: str):
    """(points [N, 3] float64, classes [N] uint16) of a text PLY; the
    classes are each vertex row's last column (the CARLA layout), zeros
    for a file of bare x y z rows."""
    with open(path, "rb") as f:
        n_vertices = _parse_header(f)
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if n_vertices >= 0:
        data = data[:n_vertices]
    points = data[:, :3]
    if data.shape[1] > 3:
        classes = data[:, -1].astype(np.uint16)
    else:
        classes = np.zeros((data.shape[0],), np.uint16)
    return points, classes
