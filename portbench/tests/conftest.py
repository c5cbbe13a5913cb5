"""Fixtures of the benchmark's tests: small cells that run on the CPU."""
from __future__ import annotations

from portbench import spec

SMALL = {
    "ndtnet_seg": {"n_points": 4096, "n_classes": 4, "feature_dim": 32,
                   "train_nds": 128, "serve_nds": 96},
    "ndtnetpp_seg": {"n_points": 4096, "n_classes": 4, "feature_dim": 32,
                     "fine_nds": 128, "coarse_nds": 64},
}


def small_cell(name: str):
    """The cell ``name`` at a size a CPU test run holds: its widths, ND
    counts and batch cut, its traffic and limits as committed."""
    cell = spec.Cell(name)
    cell.cfg = {**cell.cfg, **SMALL[cell.cfg["family"]]}
    t = dict(cell.traffic)
    if "batch" in t:
        t.update(batch=8, split=32)
    else:
        t.update(clouds_per_request=4, pool=2, sample=2, sample_from=4)
    cell.traffic = t
    return cell
