"""NDT-Net classification (``ndtpu_torch.models.ndtnet.
NDTNetClassification``): one untagged NDT preprocessing a step, to
``train_nds`` NDs, the backbone, a max-pool over every row and a
three-layer head on the pooled rows; trained by
``make_classification_step``. It has no serving pipeline. The functions
are those of ``ndtnet_seg.py``, and ``labels``.

A cloud's class is a function of its NDT state that the program and the
reference both hold exactly (``labels``): the number of voxels it
occupies at the searched size, modulo the class count. The judge hands
the reference NDT states and never the batch, so a label drawn from the
seed could not reach it; the occupied count is an exact integer that
the judge already holds equal (``size_gap`` 0, the same counts).
"""
from __future__ import annotations

import torch

from portbench import yardstick as ys
from portbench.reference import cls as rcls
from portbench.reference import models as ref
from portbench.reference import ndt as rndt


def resolutions(cfg: dict) -> list:
    return [cfg["train_nds"]]


def param_specs(cfg: dict) -> dict:
    specs = {}
    f = cfg["feature_dim"]
    ref.ndtnet_specs(specs, "feature_extractor.", f)
    for name, i, o in (("conv1", f, 512), ("conv2", 512, 256),
                       ("conv3", 256, cfg["n_classes"])):
        ref.dense_spec(specs, name, i, o)
    return specs


def forward_flops(cfg: dict, batch: int, nds: int | None = None) -> int:
    """The backbone over ``nds`` NDs a cloud, then the head on the
    ``batch`` pooled rows (f -> 512 -> 256 -> classes)."""
    nds = cfg["train_nds"] if nds is None else nds
    f = cfg["feature_dim"]
    head = (ys.dense_macs(batch, f, 512) + ys.dense_macs(batch, 512, 256)
            + ys.dense_macs(batch, 256, cfg["n_classes"]))
    return 2 * (ys.ndtnet_macs(batch, nds, f) + head)


def labels(num_valid, n_classes: int):
    """[B, n_classes] float32 one-hot of each cloud's class: its occupied
    voxel count ``num_valid`` [B] modulo ``n_classes``."""
    return torch.nn.functional.one_hot(num_valid.long() % n_classes,
                                       n_classes).to(torch.float32)


def reference_logits(cfg: dict, params: dict, states: list, nds: list, train: bool):
    """(logits [B, C], one-hot [B, C], mask [B] all kept): the reference
    model on the NDs it prunes and emits from the untagged state."""
    st = states[0]
    pcl, covs, _, _ = rndt.model_inputs(st, nds[0], 0)
    onehot = labels(st["num_valid"], cfg["n_classes"])
    mask = torch.ones(onehot.shape[0], dtype=torch.bool, device=onehot.device)
    return rcls.ndtnet_cls_logits(params, pcl, covs, train), onehot, mask


def program_model(cfg: dict):
    from ndtpu_torch.models.ndtnet import NDTNetClassification

    return NDTNetClassification, {}


def train_step(cfg: dict):
    from ndtpu_torch.train.loop import make_classification_step

    return make_classification_step(cfg["train_nds"], cfg["n_classes"], cfg["search"])[0]
