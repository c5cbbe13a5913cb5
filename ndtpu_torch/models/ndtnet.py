"""NDT-Net: PointNet on 12-D points, mean + flattened covariance (port of
``ndtpu/models/ndtnet.py``).

Kept as in the JAX package: the input transform rotates each covariance as
t . Sigma (left only, ndtnet.py:55-57), and the first pointwise layer has
BatchNorm but no ReLU (:63). Channels-last [B, N, C] throughout;
attribute names follow the reference modules (t1, t2, conv*, bn*,
feature_extractor).

``dtype`` is every layer's compute type (None: the inputs' and the
parameters', float32 for a float32 model), ``param_dtype`` the type the
parameters and running statistics are held in. Mixed types follow jnp's
promotion, not ``torch.autocast``: the input transform's einsums of a
bfloat16 transform with float32 points compute in float32 (ndtnet.py:51,
57), as ``jnp.einsum`` promotes its operands, and the first ``Dense``
then casts to bfloat16; ``einsum`` of two bfloat16 operands stays
bfloat16 (:67).
"""
from __future__ import annotations

import enum
import functools

import torch
from torch import nn

from ndtpu_torch.models.dense import dense_norm, layers
from ndtpu_torch.models.tnet import TNet
from ndtpu_torch.utils.device import resolve_device
from ndtpu_torch.utils.profiling import span


class AdditionalFeatures(enum.Enum):
    NONE = "none"
    COVARIANCES = "covariances"
    FEATURE_VECTOR = "feature_vector"


def einsum(equation, a, b):
    """``torch.einsum`` with jnp's type promotion: both operands cast to
    their promoted type (torch refuses mixed types)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(equation, a.to(dt), b.to(dt))


def cat(parts):
    """``torch.cat`` on the last axis in the parts' promoted type, as
    ``jnp.concatenate``."""
    dt = functools.reduce(torch.promote_types, [p.dtype for p in parts])
    return torch.cat([p.to(dt) for p in parts], dim=-1)


class NDTNet(nn.Module):
    """Backbone: (points [B, N, 3], covs [B, N, 9][, features [B, N, E]])
    -> (features [B, N, feature_dim], x_t2 [B, N, 64]). ``extra_dim`` is
    E, the width of the feature block of FEATURE_VECTOR inputs."""

    def __init__(self, point_dim: int = 3, feature_dim: int = 768,
                 extra_type: AdditionalFeatures = AdditionalFeatures.COVARIANCES,
                 extra_dim: int = 0, dtype=None, param_dtype=torch.float32):
        super().__init__()
        self.extra_type = extra_type
        in_dim = point_dim
        if extra_type != AdditionalFeatures.NONE:
            in_dim += 9
        if extra_type == AdditionalFeatures.FEATURE_VECTOR:
            in_dim += extra_dim
        dense, norm = layers(dtype, param_dtype)
        self.t1 = TNet(point_dim, dtype, param_dtype)
        self.conv1 = dense(in_dim, 64)
        self.t2 = TNet(64, dtype, param_dtype)
        self.conv2 = dense(64, 128)
        self.conv3 = dense(128, feature_dim)
        self.bn1 = norm(64)
        self.bn2 = norm(128)
        self.bn3 = norm(feature_dim)

    def forward(self, points, covariances=None, features=None):
        b, n, _ = points.shape
        t = self.t1(points)
        parts = [einsum("bij,bnj->bni", t, points)]
        if self.extra_type != AdditionalFeatures.NONE:
            cov = covariances.reshape(b, n, 3, 3)
            parts.append(einsum("bij,bnjk->bnik", t, cov).reshape(b, n, 9))
        if self.extra_type == AdditionalFeatures.FEATURE_VECTOR:
            parts.append(features)
        x = dense_norm(self.conv1, self.bn1, cat(parts), relu=False)
        x = einsum("bnj,bji->bni", x, self.t2(x))
        x_t2 = x
        x = dense_norm(self.conv2, self.bn2, x, relu=False)
        x = dense_norm(self.conv3, self.bn3, x, relu=False)
        return x, x_t2


class NDTNetClassification(nn.Module):
    """ndtnet.py:166-196. Output [B, num_classes]: probabilities, or
    logits with ``return_logits=True``. The pool is the max over all M
    rows, padded rows included, as in the JAX module; the pool and the
    head are the span ``ndtpu.head``. Built on ``device`` (the card unless
    the caller asks for the CPU), in ``dtype`` and ``param_dtype``
    (NDTNet)."""

    def __init__(self, point_dim: int = 3, num_classes: int = 512,
                 feature_dim: int = 768, device="cuda", dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = NDTNet(point_dim, feature_dim, dtype=dtype,
                                        param_dtype=param_dtype)
        classification_head_layers(self, feature_dim, num_classes, dtype,
                                   param_dtype)
        self.to(dev)

    def forward(self, points, covariances, return_logits: bool = False):
        x, _ = self.feature_extractor(points, covariances)
        with span("ndtpu.head"):
            return classification_head(self, x.amax(dim=1), return_logits)


def classification_head_layers(model, in_dim, num_classes, dtype,
                               param_dtype):
    """The classification head's layers on ``model``: conv1..3 (in_dim ->
    512 -> 256 -> num_classes)."""
    dense, _ = layers(dtype, param_dtype)
    model.conv1 = dense(in_dim, 512)
    model.conv2 = dense(512, 256)
    model.conv3 = dense(256, num_classes)


def classification_head(model, pooled, return_logits):
    """ReLU(conv1), ReLU(conv2), conv3 on the pooled [B, F] features, then
    softmax unless logits are asked for (the head of NDTNetClassification
    and NDTNetPPClassification)."""
    x = torch.relu(model.conv1(pooled))
    x = torch.relu(model.conv2(x))
    x = model.conv3(x)
    return x if return_logits else torch.softmax(x, dim=-1)


class NDTNetSegmentation(nn.Module):
    """ndtnet.py:198-243. Output [B, N, num_classes + 1]: log-probabilities,
    or logits with ``return_logits=True``. Built on ``device`` (the card
    unless the caller asks for the CPU), in ``dtype`` and ``param_dtype``
    (NDTNet)."""

    def __init__(self, point_dim: int = 3, num_classes: int = 16,
                 feature_dim: int = 1024, device="cuda", dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = NDTNet(point_dim, feature_dim, dtype=dtype,
                                        param_dtype=param_dtype)
        segmentation_head_layers(self, feature_dim + 64, num_classes, dtype,
                                 param_dtype)
        self.to(dev)

    def forward(self, points, covariances, return_logits: bool = False):
        x, x_t2 = self.feature_extractor(points, covariances)
        return segmentation_head(self, x, x_t2, return_logits)


def segmentation_head_layers(model, in_dim, num_classes, dtype, param_dtype):
    """The per-point head's layers on ``model``: conv1..4 (in_dim -> 512
    -> 256 -> 128 -> num_classes + 1) and bn1..3."""
    dense, norm = layers(dtype, param_dtype)
    model.conv1 = dense(in_dim, 512)
    model.conv2 = dense(512, 256)
    model.conv3 = dense(256, 128)
    model.conv4 = dense(128, num_classes + 1)
    model.bn1 = norm(512)
    model.bn2 = norm(256)
    model.bn3 = norm(128)


def segmentation_head(model, x, x_t2, return_logits):
    """The per-point head on the backbone's features [B, N, F] and x_t2
    [B, N, 64]: the max-pooled features broadcast beside x_t2, ReLU(BN(
    conv)) three times, conv4, then log-softmax unless logits are asked
    for (the head of NDTNetSegmentation and PointNetSegmentation)."""
    pooled = x.amax(dim=1, keepdim=True).expand_as(x)
    x = cat([x_t2, pooled])
    x = dense_norm(model.conv1, model.bn1, x, relu=True)
    x = dense_norm(model.conv2, model.bn2, x, relu=True)
    x = dense_norm(model.conv3, model.bn3, x, relu=True)
    x = model.conv4(x)
    return x if return_logits else torch.log_softmax(x, dim=-1)
