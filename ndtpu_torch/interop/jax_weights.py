"""Load the JAX package's flax variables into the port's models.

The other direction of ``ndtpu/interop/torch_weights.py``. The flax tree
``{"params": ..., "batch_stats": ...}`` comes in as numpy arrays (anything
``numpy.asarray`` takes); this module imports neither jax nor flax.

Mapping (flax auto-names, in creation order):
  Dense_k/kernel [in, out]           -> nn.Linear.weight [out, in] (transposed)
  Dense_k/bias                       -> nn.Linear.bias
  BatchNorm_k/{scale, bias}          -> BatchNorm.{weight, bias}
  batch_stats/BatchNorm_k/{mean,var} -> BatchNorm.{running_mean, running_var}
  TNet:    Dense_0..2 = conv1..3, Dense_3..5 = fc1..3, BatchNorm_0..4 = bn1..5
  NDTNet:  TNet_0 = t1, TNet_1 = t2, Dense_0..2 = conv1..3, BatchNorm_0..2
  NDTNetSegmentation: NDTNet_0 = feature_extractor, Dense_0..3 = conv1..4,
           BatchNorm_0..2 = bn1..3
"""
from __future__ import annotations

import numpy as np
import torch

from ndtpu_torch.models.ndtnet import NDTNet, NDTNetSegmentation
from ndtpu_torch.models.tnet import TNet


def _copy(dst: torch.Tensor, src):
    src = torch.from_numpy(np.array(src, dtype=np.float32))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def _linear(lin, p):
    _copy(lin.weight, np.asarray(p["kernel"]).T)
    _copy(lin.bias, p["bias"])


def _bn(bn, p, s):
    _copy(bn.weight, p["scale"])
    _copy(bn.bias, p["bias"])
    _copy(bn.running_mean, s["mean"])
    _copy(bn.running_var, s["var"])


def _layers(model, params, stats, linears, norms):
    for i, name in enumerate(linears):
        _linear(getattr(model, name), params[f"Dense_{i}"])
    for i, name in enumerate(norms):
        _bn(getattr(model, name), params[f"BatchNorm_{i}"],
            stats[f"BatchNorm_{i}"])


def _tnet(m, params, stats):
    _layers(m, params, stats, ["conv1", "conv2", "conv3", "fc1", "fc2", "fc3"],
            ["bn1", "bn2", "bn3", "bn4", "bn5"])


def _ndtnet(m, params, stats):
    _tnet(m.t1, params["TNet_0"], stats["TNet_0"])
    _tnet(m.t2, params["TNet_1"], stats["TNet_1"])
    _layers(m, params, stats, ["conv1", "conv2", "conv3"],
            ["bn1", "bn2", "bn3"])


def load_jax_variables(model, variables):
    """Fill ``model`` (TNet, NDTNet or NDTNetSegmentation) in place from
    the flax variables of its JAX counterpart. Returns the model."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    with torch.no_grad():
        if isinstance(model, NDTNetSegmentation):
            _ndtnet(model.feature_extractor, params["NDTNet_0"],
                    stats["NDTNet_0"])
            _layers(model, params, stats,
                    ["conv1", "conv2", "conv3", "conv4"],
                    ["bn1", "bn2", "bn3"])
        elif isinstance(model, NDTNet):
            _ndtnet(model, params, stats)
        elif isinstance(model, TNet):
            _tnet(model, params, stats)
        else:
            raise TypeError(f"no flax mapping for {type(model).__name__}")
    return model
