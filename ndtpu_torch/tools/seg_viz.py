"""Segmentation inference with headless output (port of
``tools/seg_viz.py``).

    python -m ndtpu_torch.tools.seg_viz [--model_path <checkpoint dir>]
    python -m ndtpu_torch.tools.seg_viz --device cpu --n_samples 256 \\
        --n_desired_nds 24 --n_classes 6 --feature_dim 32 --out build/seg.ply

The reference's tools/seg_viz.py:74-152: an ``NDTNetSegmentation`` (the
model of a port trainer checkpoint, ``--model_path``, or random weights
from seed 0) predicts the class of each ND of one sample (CarlaSeg under
``--data_path``, else SyntheticSeg), preprocessed to ``--n_desired_nds``
NDs with the reference search; the kept NDs are painted with the 29-colour
palette (seg_viz.py:17-46) and written as one PLY instead of an Open3D
window.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ndtpu_torch.data.ply import write_ply
from ndtpu_torch.preprocessing.batch import ndt_preprocessing_with_state
from ndtpu_torch.tools._common import (
    make_dataset,
    paint_classes,
    segmentation_model,
)
from ndtpu_torch.utils.device import resolve_device


def segment(points, model, n_desired, n_classes):
    """One cloud through the preprocessing and the model on the model's
    device: points [N, 3] (numpy or a tensor) -> (ND means [M, 3], the
    predicted class of each ND [M] (argmax of the log-probabilities), the
    kept mask [M]), all numpy."""
    dev = next(model.parameters()).device
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)[None]
    pcl, covs, _, mask, _ = ndt_preprocessing_with_state(
        n_desired, pts, None, n_classes)
    with torch.no_grad():
        logp = model(pcl, covs)
    return (pcl[0].cpu().numpy(), logp[0].argmax(-1).cpu().numpy(),
            mask[0].cpu().numpy())


def main(argv=None):
    """Write the PLY as the flags say. Returns segment's outputs."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model_path", type=str, default=None,
                   help="port checkpoint dir (random weights when omitted)")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--sample", type=int, default=0)
    p.add_argument("--n_desired_nds", type=int, default=2080)
    p.add_argument("--n_samples", type=int, default=70000)
    p.add_argument("--n_classes", type=int, default=28)
    p.add_argument("--feature_dim", type=int, default=768)
    p.add_argument("--out", type=str, default="out/seg_viz.ply")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    ds = make_dataset(args.n_classes, args.n_samples, args.data_path)
    points, _ = ds[args.sample]
    model = segmentation_model(args.n_classes, args.feature_dim, dev,
                               args.model_path)  # seg_viz.py:100-107
    pcl, pred, kept = segment(points, model, args.n_desired_nds,
                              args.n_classes)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_ply(args.out, pcl[kept], colors=paint_classes(pred[kept]),
              classes=pred[kept])
    print(f"wrote {args.out} ({int(kept.sum())} NDs)")
    return pcl, pred, kept


if __name__ == "__main__":
    main(sys.argv[1:])
