"""NDT-Net++ segmentation (``ndtpu_torch.models.ndtnetpp.
NDTNetPPSegmentation``): a fine and a coarse NDT preprocessing a step,
the fine state pruned to the coarse count inside the forward, two
residual GEMMs over the points axis; trained by
``make_multiscale_seg_step``. It has no serving pipeline. The functions
are those of ``ndtnet_seg.py``.
"""
from __future__ import annotations

from portbench import yardstick as ys
from portbench.reference import models as ref
from portbench.reference import ndt as rndt


def resolutions(cfg: dict) -> list:
    return [cfg["fine_nds"], cfg["coarse_nds"]]


def param_specs(cfg: dict) -> dict:
    specs = {}
    f, fine, coarse = cfg["feature_dim"], cfg["fine_nds"], cfg["coarse_nds"]
    ref.ndtnet_specs(specs, "ndnet.ndtnet1.", f)
    ref.ndtnet_specs(specs, "ndnet.ndtnet2.", f, extra=f)
    ref.dense_spec(specs, "ndnet.residual.conv1", fine, coarse)
    ref.norm_spec(specs, "ndnet.residual.bn1", coarse)
    ref.dense_spec(specs, "ndnet.conv1", f, f)
    ref.norm_spec(specs, "ndnet.bn1", f)
    ref.dense_spec(specs, "residual.conv1", coarse, fine)
    ref.norm_spec(specs, "residual.bn1", fine)
    ref.head_specs(specs, "", f, cfg["n_classes"])
    return specs


def forward_flops(cfg: dict, batch: int, nds: int | None = None) -> int:
    """The forward operations over the configuration's fine and coarse
    NDs (``nds`` is not used: the model takes both)."""
    f, fine, coarse = cfg["feature_dim"], cfg["fine_nds"], cfg["coarse_nds"]
    return 2 * (ys.ndtnet_macs(batch, fine, f)
                + 2 * ys.ndtnet_macs(batch, coarse, f, extra=f)
                + 2 * ys.dense_macs(batch * f, fine, coarse)   # the two residuals
                + ys.dense_macs(batch * coarse, f, f)
                + ys.seg_head_macs(batch * fine, f, cfg["n_classes"]))


def reference_logits(cfg: dict, params: dict, states: list, nds: list, train: bool):
    c = cfg["n_classes"]
    fine = rndt.model_inputs(states[0], nds[0], c)
    coarse = rndt.model_inputs(states[1], nds[1], c)
    logits = ref.ndtnetpp_seg_logits(params, fine[:2], coarse[:2], states[0], nds[1], train)
    return logits, fine[2], fine[3]


def program_model(cfg: dict):
    from ndtpu_torch.models.ndtnetpp import NDTNetPPSegmentation

    return NDTNetPPSegmentation, {"fine_res": cfg["fine_nds"], "coarse_res": cfg["coarse_nds"]}


def train_step(cfg: dict):
    from ndtpu_torch.train.loop import make_multiscale_seg_step

    return make_multiscale_seg_step(cfg["fine_nds"], cfg["coarse_nds"],
                                    cfg["n_classes"], cfg["search"])[0]
