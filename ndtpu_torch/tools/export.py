"""Export a port checkpoint as a torch reference state dict (port of
``tools/export.py``).

    python -m ndtpu_torch.tools.export \\
        --checkpoint out/<run>/ndtnet_segmentation_10 \\
        --task segmentation --n_classes 28 --feature_dim 768 --out ndtnet_seg.pt

A port trainer checkpoint (``python -m ndtpu_torch.tools.train`` or
``train_pointnet``, ``--save_every``) is restored into its model on
``--device``, and ``interop.reference_state_dict`` writes the reference's
layout of it with ``torch.save``: the whole model to ``--out`` and the
backbone alone (``feature_extractor``) to ``<base>_backbone<ext>``, as the
reference trainer saves them (its tools/train.py:186-194). No reference
code is needed; ``ndnet/models/ndtnet.py:166-243`` and
``pointnet.py:137-214`` load the files with ``load_state_dict``.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from ndtpu_torch.interop.export_torch import reference_state_dict
from ndtpu_torch.models import (
    NDTNetClassification,
    NDTNetSegmentation,
    PointNetClassification,
    PointNetSegmentation,
)
from ndtpu_torch.train.loop import make_lr_schedule
from ndtpu_torch.train.state import create_train_state, restore_checkpoint

MODELS = {("ndtnet", "segmentation"): NDTNetSegmentation,
          ("ndtnet", "classification"): NDTNetClassification,
          ("pointnet", "segmentation"): PointNetSegmentation,
          ("pointnet", "classification"): PointNetClassification}


def main(argv=None):
    """Export as the flags say. Returns the written state dict."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint directory written by the trainers")
    ap.add_argument("--task", default="segmentation",
                    choices=["segmentation", "classification"])
    ap.add_argument("--arch", default="ndtnet",
                    choices=["ndtnet", "pointnet"])
    ap.add_argument("--n_classes", type=int, required=True)
    ap.add_argument("--feature_dim", type=int, default=768)
    ap.add_argument("--n_desired_nds", type=int, default=1000,
                    help="the JAX tool's template shape; the port's models "
                         "need none, so any value works")
    ap.add_argument("--out", required=True, help="output .pt path")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    state = create_train_state(args.n_classes, args.feature_dim,
                               make_lr_schedule(1e-3, 1), device=args.device,
                               model=MODELS[args.arch, args.task])
    state = restore_checkpoint(state, args.checkpoint)
    tree = reference_state_dict(state.model)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(tree, args.out)
    base, ext = os.path.splitext(args.out)
    backbone_out = f"{base}_backbone{ext or '.pt'}"
    torch.save(reference_state_dict(state.model.feature_extractor),
               backbone_out)
    print(f"wrote {args.out} (+ backbone: {backbone_out}) "
          f"from step {state.step}")
    return tree


if __name__ == "__main__":
    main(sys.argv[1:])
