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
  NDTNet, PointNet: TNet_0 = t1, TNet_1 = t2, Dense_0..2 = conv1..3,
           BatchNorm_0..2 = bn1..3
  NDTNetSegmentation: NDTNet_0 = feature_extractor, Dense_0..3 = conv1..4,
           BatchNorm_0..2 = bn1..3
  NDTNetClassification: NDTNet_0 = feature_extractor, Dense_0..2 = conv1..3
  PointNetSegmentation, PointNetClassification: as the NDT-Net heads, with
           PointNet_0 = feature_extractor
  ResidualConnection: Dense_0 = conv1 (kernel [in_points, out_points]),
           BatchNorm_0 = bn1
  NDTNetPP: NDTNet_0 = ndtnet1, NDTNet_1 = ndtnet2 (one module, both
           branches), ResidualConnection_0 = residual, Dense_0 = conv1,
           BatchNorm_0 = bn1
  NDTNetPPClassification: NDTNetPP_0 = feature_extractor, Dense_0..2 =
           conv1..3
  NDTNetPPSegmentation: NDTNetPP_0 = ndnet, ResidualConnection_0 =
           residual, Dense_0..3 = conv1..4, BatchNorm_0..2 = bn1..3
The same mapping carries a JAX train state's Adam moments
(``load_jax_train_state``).
"""
from __future__ import annotations

import numpy as np
import torch

from ndtpu_torch.models.ndtnet import (
    NDTNet,
    NDTNetClassification,
    NDTNetSegmentation,
)
from ndtpu_torch.models.ndtnetpp import (
    NDTNetPP,
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
from ndtpu_torch.train.state import place_adam_steps


_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}


def _copy(dst: torch.Tensor, src):
    """dst <- the leaf src. A bfloat16 or float16 leaf fills only a tensor
    of its own type, and such a tensor takes only a leaf of its type, so
    no value is widened or rounded on the way: bfloat16 parameters and
    Adam moments come from bfloat16 leaves, float32 ones from float32
    leaves, and a float64 tensor takes a float64 leaf as it is."""
    src = np.asarray(src)
    half = _HALF.get(src.dtype.name)
    if (half or torch.float32) != dst.dtype and (
            half is not None or dst.dtype in _HALF.values()):
        raise TypeError(f"a {src.dtype.name} leaf for a {dst.dtype} tensor")
    wide = np.float64 if dst.dtype == torch.float64 else np.float32
    src = torch.from_numpy(np.array(src, dtype=wide))
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def _layers(model, params, stats, linears, norms):
    """(tensor, flax leaf) pairs of a module's Dense and BatchNorm layers,
    kernels transposed; the running statistics too unless stats is
    None."""
    for i, name in enumerate(linears):
        lin, p = getattr(model, name), params[f"Dense_{i}"]
        yield lin.weight, np.asarray(p["kernel"]).T
        yield lin.bias, p["bias"]
    for i, name in enumerate(norms):
        bn, p = getattr(model, name), params[f"BatchNorm_{i}"]
        yield bn.weight, p["scale"]
        yield bn.bias, p["bias"]
        if stats is not None:
            s = stats[f"BatchNorm_{i}"]
            yield bn.running_mean, s["mean"]
            yield bn.running_var, s["var"]


def _sub(stats, name):
    return None if stats is None else stats[name]


def _tnet(m, params, stats):
    yield from _layers(m, params, stats,
                       ["conv1", "conv2", "conv3", "fc1", "fc2", "fc3"],
                       ["bn1", "bn2", "bn3", "bn4", "bn5"])


def _backbone(m, params, stats):
    yield from _tnet(m.t1, params["TNet_0"], _sub(stats, "TNet_0"))
    yield from _tnet(m.t2, params["TNet_1"], _sub(stats, "TNet_1"))
    yield from _layers(m, params, stats, ["conv1", "conv2", "conv3"],
                       ["bn1", "bn2", "bn3"])


_SEG_HEAD = (["conv1", "conv2", "conv3", "conv4"], ["bn1", "bn2", "bn3"])
_CLS_HEAD = (["conv1", "conv2", "conv3"], [])

# model type -> (its submodules as (attribute, flax name), (its own
# Linear names, its own BatchNorm names))
_TREES = {
    NDTNetSegmentation: ([("feature_extractor", "NDTNet_0")], _SEG_HEAD),
    NDTNetClassification: ([("feature_extractor", "NDTNet_0")], _CLS_HEAD),
    PointNetSegmentation: ([("feature_extractor", "PointNet_0")], _SEG_HEAD),
    PointNetClassification: ([("feature_extractor", "PointNet_0")],
                             _CLS_HEAD),
    ResidualConnection: ([], (["conv1"], ["bn1"])),
    NDTNetPP: ([("ndtnet1", "NDTNet_0"), ("ndtnet2", "NDTNet_1"),
                ("residual", "ResidualConnection_0")], (["conv1"], ["bn1"])),
    NDTNetPPClassification: ([("feature_extractor", "NDTNetPP_0")], _CLS_HEAD),
    NDTNetPPSegmentation: ([("ndnet", "NDTNetPP_0"),
                            ("residual", "ResidualConnection_0")], _SEG_HEAD),
}


def _pairs(model, params, stats):
    """Every (port tensor, flax leaf) pair of ``model``; the BatchNorm
    buffers only when ``stats`` is given."""
    if isinstance(model, (NDTNet, PointNet)):
        yield from _backbone(model, params, stats)
    elif isinstance(model, TNet):
        yield from _tnet(model, params, stats)
    elif type(model) in _TREES:
        children, (linears, norms) = _TREES[type(model)]
        for attr, name in children:
            yield from _pairs(getattr(model, attr), params[name],
                              _sub(stats, name))
        yield from _layers(model, params, stats, linears, norms)
    else:
        raise TypeError(f"no flax mapping for {type(model).__name__}")


def load_jax_variables(model, variables):
    """Fill ``model`` (TNet, NDTNet, NDTNetSegmentation,
    NDTNetClassification, ResidualConnection, an NDT-Net++ model or a
    PointNet model) in
    place from the flax variables of its JAX counterpart. Returns the
    model."""
    with torch.no_grad():
        for dst, src in _pairs(model, variables["params"],
                               variables.get("batch_stats", {})):
            _copy(dst, src)
    return model


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def load_jax_train_state(state, jax_state):
    """Fill the port's ``TrainState`` (ndtpu_torch.train.state) in place
    from a JAX ``TrainState`` of ``optax.adam(schedule)`` given as numpy
    (``jax.tree_util.tree_map(np.asarray, state)``, or a dict with its
    fields): params and batch_stats as ``load_jax_variables``; the opt
    state ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``
    as Adam's ``exp_avg`` (mu) and ``exp_avg_sq`` (nu), Dense kernels
    transposed like the weights, and each parameter's ``step`` (count),
    placed where the state's optimizer reads it (``place_adam_steps``);
    the step itself. bfloat16 parameters take the bfloat16 moments of a
    bfloat16 JAX state as they are. Returns the state."""
    model, opt = state.model, state.optimizer
    load_jax_variables(model, {"params": _field(jax_state, "params"),
                               "batch_stats": _field(jax_state, "batch_stats")})
    adam = _field(jax_state, "opt_state")[0]
    count = float(np.asarray(_field(adam, "count")))
    mu = _pairs(model, _field(adam, "mu"), None)
    nu = _pairs(model, _field(adam, "nu"), None)
    with torch.no_grad():
        for (p, m), (_, v) in zip(mu, nu):
            exp_avg, exp_avg_sq = torch.empty_like(p), torch.empty_like(p)
            _copy(exp_avg, m)
            _copy(exp_avg_sq, v)
            opt.state[p] = {"step": torch.tensor(count, dtype=torch.float32),
                            "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq}
    state.step = int(np.asarray(_field(jax_state, "step")))
    place_adam_steps(state)
    return state
