"""ctypes binding of the port's native text-PLY reader (port of
``ndtpu/native/io.py``).

``src/ply_io.cc`` is compiled with g++ at first use, never at import, into
``build/ndtpu_torch/`` at the repository root under a hash of the source
and flags (``ops/_build.py``). Unlike the JAX binding, which swallows
every native error and lets the caller fall back to numpy, this one
raises: when g++ is missing or fails, and when a file cannot be read.
"""
from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ndtpu_torch.data.ply import _parse_header
from ndtpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "src" / "ply_io.cc"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")


def _compile(src: Path, out: Path):
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native PLY reader cannot be "
                           "built; read_ply(..., use_native=False) reads "
                           "with numpy")
    cmd = [gxx, *GXX_FLAGS, str(src), "-o", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")


@functools.cache
def library() -> ctypes.CDLL:
    """The reader's library, built if needed, with its signatures set."""
    lib = _build.load_library(SOURCE, GXX_FLAGS, _compile)
    lib.ndtpu_ply_open.restype = ctypes.c_void_p
    lib.ndtpu_ply_open.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.ndtpu_ply_read.restype = ctypes.c_int
    lib.ndtpu_ply_read.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_double),
                                   ctypes.POINTER(ctypes.c_uint16)]
    lib.ndtpu_ply_close.restype = None
    lib.ndtpu_ply_close.argtypes = [ctypes.c_void_p]
    return lib


def native_read_ply(path: str):
    """(points [N, 3] float64, classes [N] uint16) of a text PLY, the
    classes being each row's last column (zeros for bare x y z rows).
    A malformed header raises the numpy path's ValueError; a file that
    cannot be opened or holds fewer rows than its header gives, OSError."""
    lib = library()
    n = ctypes.c_int64()
    cols = ctypes.c_int()
    handle = lib.ndtpu_ply_open(str(path).encode(), ctypes.byref(n),
                                ctypes.byref(cols))
    if not handle:
        # the numpy path's header errors (ValueError), else an OSError
        with open(path, "rb") as f:
            _parse_header(f)
        raise OSError(f"native PLY reader cannot read {path}")
    try:
        points = np.empty((n.value, 3), np.float64)
        classes = np.zeros((n.value,), np.uint16)
        rc = lib.ndtpu_ply_read(
            handle, points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            classes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    finally:
        lib.ndtpu_ply_close(handle)
    if rc != 0:
        raise OSError(f"native PLY reader: {path} holds fewer than the "
                      f"{n.value} rows its header gives")
    return points, classes
