"""The port's models into reference checkpoints (port of
``ndtpu/interop/export_torch.py``), the inverse of ``torch_weights``.

``export_*(model, t_model)`` copies a port model into a reference-layout
module (an instance of the reference's class, e.g. built through
``reference_loader``) in place, so that its ``state_dict()`` can be
``torch.save``d for a reference deployment; the module's
``num_batches_tracked`` counters are left as they are, as the JAX
package's export leaves them. Returns the module.

``reference_state_dict(model)`` builds the same state dict with no
reference code at all: each ``Dense`` weight [out, in] becomes a Conv1d
weight [out, in, 1], except the TNets' ``fc1..3``, which the reference
holds as ``nn.Linear`` [out, in]; every tensor float32 on the CPU, as the
reference holds it (a bfloat16 model's parameters widened exactly); each
BatchNorm followed by its ``num_batches_tracked``, an int64 0, as a fresh
``nn.BatchNorm1d`` has it.
"""
from __future__ import annotations

import collections

import torch
from torch import nn

from ndtpu_torch.interop.torch_weights import (
    FAMILIES,
    UNTRACKED,
    check_family,
)
from ndtpu_torch.models.dense import Dense
from ndtpu_torch.models.norm import BatchNorm


def reference_state_dict(model: nn.Module) -> "collections.OrderedDict":
    """The reference layout of ``model``'s state (module docstring)."""
    modules = dict(model.named_modules())
    out = collections.OrderedDict()
    for key, t in model.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        t = t.detach().to("cpu", torch.float32).clone()
        owner = modules[prefix]
        if (isinstance(owner, Dense) and leaf == "weight"
                and not prefix.rpartition(".")[2].startswith("fc")):
            t = t[..., None]
        out[key] = t
        if isinstance(owner, BatchNorm) and leaf == "running_var":
            out[f"{prefix}.{UNTRACKED}"] = torch.tensor(0, dtype=torch.int64)
    return out


def export_reference(model: nn.Module, t_model: nn.Module) -> nn.Module:
    """Copy ``model`` into the reference-layout module ``t_model`` in
    place: every parameter and running statistic, in the module's types;
    its other entries (``num_batches_tracked``) untouched."""
    dst = t_model.state_dict()
    src = reference_state_dict(model)
    missing = [k for k in src if k.rsplit(".", 1)[-1] != UNTRACKED
               and k not in dst]
    if missing:
        raise KeyError(f"reference module lacks {missing}")
    with torch.no_grad():
        for key, t in src.items():
            if key.rsplit(".", 1)[-1] == UNTRACKED:
                continue
            if tuple(t.shape) != tuple(dst[key].shape):
                raise ValueError(f"{key}: {tuple(t.shape)} for the "
                                 f"reference's {tuple(dst[key].shape)}")
            dst[key].copy_(t)
    return t_model


def _exporter(family):
    def export_(model, t_model):
        check_family(model, family)
        return export_reference(model, t_model)

    export_.__name__ = export_.__qualname__ = f"export_{family}"
    export_.__doc__ = (f"The port model -> the reference {FAMILIES[family][1]}"
                       " module ``t_model``, in place (``export_reference``)."
                       " Returns the module.")
    return export_


export_tnet = _exporter("tnet")
export_backbone = _exporter("backbone")
export_pointnet_segmentation = _exporter("pointnet_segmentation")
export_pointnet_classification = _exporter("pointnet_classification")
export_ndtnet_segmentation = _exporter("ndtnet_segmentation")
export_ndtnet_classification = _exporter("ndtnet_classification")
export_residual_connection = _exporter("residual_connection")
export_ndtnetpp_segmentation = _exporter("ndtnetpp_segmentation")
export_ndtnetpp_classification = _exporter("ndtnetpp_classification")
