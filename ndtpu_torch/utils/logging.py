"""Logging helpers (port of ``ndtpu/utils/logging.py``), including the
reference's matrix debug printer (``core_legacy/src/matrix.c:28-35``)."""
from __future__ import annotations

import logging
import sys

import numpy as np


def get_logger(name: str = "ndtpu_torch") -> logging.Logger:
    """A logger writing ``[name] LEVEL message`` lines to stderr at INFO."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter("[%(name)s] %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def print_matrix(matrix, rows=None, cols=None, file=None):
    """Row-major matrix printer (print_matrix, matrix.c:28-35): one line a
    row, each value as ``%f``. Takes anything ``numpy.asarray`` takes (a
    tensor on the card is copied to the host first)."""
    if hasattr(matrix, "detach"):
        matrix = matrix.detach().cpu()
    m = np.asarray(matrix)
    if rows is not None and cols is not None:
        m = m.reshape(rows, cols)
    for row in np.atleast_2d(m):
        print(" ".join(f"{v:f}" for v in row), file=file or sys.stdout)
