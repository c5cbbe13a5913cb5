"""NDT-Net segmentation (``ndtpu_torch.models.ndtnet.NDTNetSegmentation``):
one NDT preprocessing a step, to ``train_nds`` NDs, trained by
``make_ndt_seg_step`` and served by ``serve.py::SegmentationPipeline`` at
``serve_nds``.

A model family's file gives the harness what differs between models:
the ND counts a train step preprocesses to, the parameters' names and
shapes, the forward operations from the shapes, the reference's logits
from NDT states, and the program's model, train step and (where it
serves) pipeline. The program is imported inside the functions that
build it, never by the reference's.
"""
from __future__ import annotations

from portbench import yardstick as ys
from portbench.reference import models as ref
from portbench.reference import ndt as rndt


def resolutions(cfg: dict) -> list:
    """The ND counts a train step preprocesses each cloud to."""
    return [cfg["train_nds"]]


def param_specs(cfg: dict) -> dict:
    specs = {}
    ref.ndtnet_specs(specs, "feature_extractor.", cfg["feature_dim"])
    ref.head_specs(specs, "", cfg["feature_dim"] + 64, cfg["n_classes"])
    return specs


def forward_flops(cfg: dict, batch: int, nds: int | None = None) -> int:
    """The forward operations (2 a multiply-add) over ``nds`` NDs a cloud
    (the training count by default)."""
    nds = cfg["train_nds"] if nds is None else nds
    f = cfg["feature_dim"]
    return 2 * (ys.ndtnet_macs(batch, nds, f)
                + ys.seg_head_macs(batch * nds, f + 64, cfg["n_classes"]))


def reference_logits(cfg: dict, params: dict, states: list, nds: list, train: bool):
    """(logits, one-hot, mask): the reference model on the NDs it prunes
    and emits from ``states``, one NDT state a count of ``nds``."""
    pcl, covs, onehot, mask = rndt.model_inputs(states[0], nds[0], cfg["n_classes"])
    return ref.ndtnet_seg_logits(params, pcl, covs, train), onehot, mask


def program_model(cfg: dict):
    """(the program's model class, its keyword arguments beyond the
    classes and the width)."""
    from ndtpu_torch.models.ndtnet import NDTNetSegmentation

    return NDTNetSegmentation, {}


def train_step(cfg: dict):
    from ndtpu_torch.train.loop import make_ndt_seg_step

    return make_ndt_seg_step(cfg["train_nds"], cfg["n_classes"], cfg["search"])[0]


def pipeline(cfg: dict, weights: dict, device):
    """The serving pipeline (probe search, eval-mode model) with the
    benchmark's weights."""
    from ndtpu_torch.serve import SegmentationPipeline

    pipe = SegmentationPipeline(n_desired=cfg["serve_nds"],
                                num_classes=cfg["n_classes"],
                                feature_dim=cfg["feature_dim"],
                                search=cfg["search"], device=device)
    pipe.model.load_state_dict({k: v.clone() for k, v in weights.items()})
    return pipe
