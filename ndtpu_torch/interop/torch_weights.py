"""Reference checkpoints into the port's models (port of
``ndtpu/interop/torch_weights.py``).

Users of the reference (carlostojal/NDT-Net) hold ``torch.save``d state
dicts of its models (``ndnet/models/pointnet.py:7-214``,
``ndtnet.py:65-243``, ``ndtnetpp.py:8-53``). The port's modules carry the
reference's attribute names (``t1``, ``t2``, ``conv1..4``, ``bn1..5``,
``fc1..3``, ``feature_extractor``, ``ndnet``, ``residual``; norm.py,
tnet.py, ndtnetpp.py), so a reference state dict and a port model's
``state_dict()`` have the same keys, and the mapping is a layout map, not
a rename:

  reference Conv1d(k=1).weight [out, in, 1] -> Dense.weight [out, in]
  reference Linear.weight [out, in] (fc1..3) -> Dense.weight [out, in]
  biases, BatchNorm1d weight / bias / running_mean / running_var as they are
  BatchNorm1d num_batches_tracked            -> dropped (the port's
                                               BatchNorm counts nothing)

Each ``map_*(t_model, model)`` takes a reference-layout module, or its
``state_dict()``, and fills the port ``model`` of the same family in
place, each tensor cast to the parameter's type on its device. Returns
the model. Every key of the port model must be in the reference state
with its shape, and the reference state may hold nothing else.
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.models.ndtnet import (
    NDTNet,
    NDTNetClassification,
    NDTNetSegmentation,
)
from ndtpu_torch.models.ndtnetpp import (
    NDTNetPPClassification,
    NDTNetPPSegmentation,
    ResidualConnection,
)
from ndtpu_torch.models.pointnet import (
    PointNet,
    PointNetClassification,
    PointNetSegmentation,
)
from ndtpu_torch.models.tnet import TNet

UNTRACKED = "num_batches_tracked"  # BatchNorm1d's counter, not in the port


def reference_state(src) -> dict:
    """A reference module's ``state_dict()``, or the state dict itself."""
    return src.state_dict() if isinstance(src, nn.Module) else dict(src)


def load_reference_state(model: nn.Module, src) -> nn.Module:
    """Fill ``model`` in place from the reference-layout module or state
    dict ``src`` (the module docstring's layout map). Returns the model."""
    state = {k: v for k, v in reference_state(src).items()
             if k.rsplit(".", 1)[-1] != UNTRACKED}
    own = model.state_dict()
    if state.keys() != own.keys():
        raise KeyError(
            f"reference layout of {type(model).__name__}: missing "
            f"{sorted(own.keys() - state.keys())}, unexpected "
            f"{sorted(state.keys() - own.keys())}")
    with torch.no_grad():
        for key, dst in own.items():
            src_t = state[key].detach()
            if src_t.dim() == dst.dim() + 1 and src_t.shape[-1] == 1:
                src_t = src_t[..., 0]  # Conv1d(k=1) [out, in, 1]
            if tuple(src_t.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: reference shape "
                                 f"{tuple(state[key].shape)} for "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src_t)
    return model


# family -> (the port classes it takes, the reference module it reads)
FAMILIES = {
    "tnet": (TNet, "TNet (pointnet.py:7-62)"),
    "backbone": ((NDTNet, PointNet), "PointNet or NDTNet backbone "
                 "(pointnet.py:65-135, ndtnet.py:100-164)"),
    "pointnet_segmentation": (PointNetSegmentation,
                              "PointNetSegmentation (pointnet.py:169-214)"),
    "pointnet_classification": (PointNetClassification,
                                "PointNetClassification (pointnet.py:137-167)"),
    "ndtnet_segmentation": (NDTNetSegmentation,
                            "NDTNetSegmentation (ndtnet.py:198-243)"),
    "ndtnet_classification": (NDTNetClassification,
                              "NDTNetClassification (ndtnet.py:166-196)"),
    "residual_connection": (ResidualConnection,
                            "ResidualConnection (ndtnetpp.py:8-41)"),
    "ndtnetpp_segmentation": (NDTNetPPSegmentation,
                              "ndnetSegmentation (ndtnetpp.py:180-240; the "
                              "bug-patched module)"),
    "ndtnetpp_classification": (NDTNetPPClassification,
                                "ndnetClassification (ndtnetpp.py:136-178; "
                                "the bug-patched module)"),
}


def check_family(model, family: str):
    """Raise TypeError unless ``model`` is a port model of ``family``."""
    if not isinstance(model, FAMILIES[family][0]):
        raise TypeError(f"{family}: a {type(model).__name__} is not a port "
                        f"{FAMILIES[family][1]}")


def _mapper(family):
    def map_(t_model, model):
        check_family(model, family)
        return load_reference_state(model, t_model)

    map_.__name__ = map_.__qualname__ = f"map_{family}"
    map_.__doc__ = (f"Reference {FAMILIES[family][1]}, a module or its "
                    "state_dict -> the port model, in place "
                    "(``load_reference_state``). Returns the model.")
    return map_


map_tnet = _mapper("tnet")
map_backbone = _mapper("backbone")
map_pointnet_segmentation = _mapper("pointnet_segmentation")
map_pointnet_classification = _mapper("pointnet_classification")
map_ndtnet_segmentation = _mapper("ndtnet_segmentation")
map_ndtnet_classification = _mapper("ndtnet_classification")
map_residual_connection = _mapper("residual_connection")
map_ndtnetpp_segmentation = _mapper("ndtnetpp_segmentation")
map_ndtnetpp_classification = _mapper("ndtnetpp_classification")
