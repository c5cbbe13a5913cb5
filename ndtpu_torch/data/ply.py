"""Text PLY reading and writing (port of ``ndtpu/data/ply.py``).

``read_ply`` reads through the port's native C++ reader
(``ndtpu_torch/native``), or with ``use_native=False`` parses the header
up to ``end_header`` and loads the body with one ``np.loadtxt`` pass; both
give the same arrays bit for bit. Unlike the JAX reader, a native failure
raises instead of falling back to numpy. ``write_ply`` writes text PLY
with optional RGB colours and a class column; ``count_ply_points`` reads
the vertex count from the header.
"""
from __future__ import annotations

import os

import numpy as np


def _parse_header(f):
    """(bytes up to and including the ``end_header`` line, vertex count or
    -1 if none is given) of a PLY file opened in binary mode, read up to
    there."""
    n_vertices = -1
    line = f.readline()
    offset = len(line)
    if not line.startswith(b"ply"):
        raise ValueError("not a PLY file")
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        offset += len(line)
        if line.startswith(b"element vertex"):
            n_vertices = int(line.split()[-1])
        if line.strip() == b"end_header":
            return offset, n_vertices


def read_ply(path: str, use_native: bool = True):
    """(points [N, 3] float64, classes [N] uint16) of a text PLY; the
    classes are each vertex row's last column (the CARLA layout), zeros
    for a file of bare x y z rows."""
    if use_native:
        from ndtpu_torch.native.io import native_read_ply

        return native_read_ply(path)
    with open(path, "rb") as f:
        _, n_vertices = _parse_header(f)
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if n_vertices >= 0:
        data = data[:n_vertices]
    points = data[:, :3]
    if data.shape[1] > 3:
        classes = data[:, -1].astype(np.uint16)
    else:
        classes = np.zeros((data.shape[0],), np.uint16)
    return points, classes


def write_ply(path: str, points, colors=None, classes=None):
    """Write a text PLY: x y z as ``%.8g``, optional uchar RGB colours (in
    [0, 1] floats or [0, 255] ints) and an optional trailing ushort class
    column. Returns the path."""
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    props = ["property double x", "property double y", "property double z"]
    cols = [points]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype.kind == "f":
            colors = np.clip(colors * 255.0, 0, 255)
        colors = colors.astype(np.uint16)
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
        cols.append(colors)
    if classes is not None:
        props.append("property ushort class")
        cols.append(np.asarray(classes, np.uint16)[:, None])

    header = "\n".join(["ply", "format ascii 1.0", f"element vertex {n}",
                        *props, "end_header", ""])
    body = np.concatenate([np.asarray(c, np.float64) for c in cols], axis=1)
    fmt = ["%.8g"] * 3
    if colors is not None:
        fmt += ["%d"] * 3
    if classes is not None:
        fmt += ["%d"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, body, fmt=" ".join(fmt))
    return path


def count_ply_points(path: str) -> int:
    """The vertex count of the header, or, for a header without
    ``element vertex``, the number of body lines."""
    with open(path, "rb") as f:
        offset, n = _parse_header(f)
        if n >= 0:
            return n
        f.seek(offset)
        return sum(1 for _ in f)
