"""NDT-Net: PointNet on 12-D points, mean + flattened covariance (port of
``ndtpu/models/ndtnet.py``).

Kept as in the JAX package: the input transform rotates each covariance as
t . Sigma (left only, ndtnet.py:55-57), and the first pointwise layer has
BatchNorm but no ReLU (:63). Channels-last [B, N, C] throughout;
attribute names follow the reference modules (t1, t2, conv*, bn*,
feature_extractor).
"""
from __future__ import annotations

import enum

import torch
from torch import nn

from ndtpu_torch.models.norm import BatchNorm
from ndtpu_torch.models.tnet import TNet
from ndtpu_torch.utils.device import resolve_device


class AdditionalFeatures(enum.Enum):
    NONE = "none"
    COVARIANCES = "covariances"
    FEATURE_VECTOR = "feature_vector"


class NDTNet(nn.Module):
    """Backbone: (points [B, N, 3], covs [B, N, 9][, features [B, N, E]])
    -> (features [B, N, feature_dim], x_t2 [B, N, 64]). ``extra_dim`` is
    E, the width of the feature block of FEATURE_VECTOR inputs."""

    def __init__(self, point_dim: int = 3, feature_dim: int = 768,
                 extra_type: AdditionalFeatures = AdditionalFeatures.COVARIANCES,
                 extra_dim: int = 0):
        super().__init__()
        self.extra_type = extra_type
        in_dim = point_dim
        if extra_type != AdditionalFeatures.NONE:
            in_dim += 9
        if extra_type == AdditionalFeatures.FEATURE_VECTOR:
            in_dim += extra_dim
        self.t1 = TNet(point_dim)
        self.conv1 = nn.Linear(in_dim, 64)
        self.t2 = TNet(64)
        self.conv2 = nn.Linear(64, 128)
        self.conv3 = nn.Linear(128, feature_dim)
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(128)
        self.bn3 = BatchNorm(feature_dim)

    def forward(self, points, covariances=None, features=None):
        b, n, _ = points.shape
        t = self.t1(points)
        parts = [torch.einsum("bij,bnj->bni", t, points)]
        if self.extra_type != AdditionalFeatures.NONE:
            cov = covariances.reshape(b, n, 3, 3)
            parts.append(torch.einsum("bij,bnjk->bnik", t, cov).reshape(b, n, 9))
        if self.extra_type == AdditionalFeatures.FEATURE_VECTOR:
            parts.append(features)
        x = self.bn1(self.conv1(torch.cat(parts, dim=-1)))  # no ReLU
        x = torch.einsum("bnj,bji->bni", x, self.t2(x))
        x_t2 = x
        x = self.bn2(self.conv2(x))
        x = self.bn3(self.conv3(x))
        return x, x_t2


class NDTNetClassification(nn.Module):
    """ndtnet.py:166-196. Output [B, num_classes]: probabilities, or
    logits with ``return_logits=True``. The pool is the max over all M
    rows, padded rows included, as in the JAX module. Built on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, point_dim: int = 3, num_classes: int = 512,
                 feature_dim: int = 768, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = NDTNet(point_dim, feature_dim)
        self.conv1 = nn.Linear(feature_dim, 512)
        self.conv2 = nn.Linear(512, 256)
        self.conv3 = nn.Linear(256, num_classes)
        self.to(dev)

    def forward(self, points, covariances, return_logits: bool = False):
        x, _ = self.feature_extractor(points, covariances)
        return classification_head(self, x.amax(dim=1), return_logits)


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
    unless the caller asks for the CPU)."""

    def __init__(self, point_dim: int = 3, num_classes: int = 16,
                 feature_dim: int = 1024, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = NDTNet(point_dim, feature_dim)
        self.conv1 = nn.Linear(feature_dim + 64, 512)
        self.conv2 = nn.Linear(512, 256)
        self.conv3 = nn.Linear(256, 128)
        self.conv4 = nn.Linear(128, num_classes + 1)
        self.bn1 = BatchNorm(512)
        self.bn2 = BatchNorm(256)
        self.bn3 = BatchNorm(128)
        self.to(dev)

    def forward(self, points, covariances, return_logits: bool = False):
        x, x_t2 = self.feature_extractor(points, covariances)
        return segmentation_head(self, x, x_t2, return_logits)


def segmentation_head(model, x, x_t2, return_logits):
    """The per-point head on the backbone's features [B, N, F] and x_t2
    [B, N, 64]: the max-pooled features broadcast beside x_t2, ReLU(BN(
    conv)) three times, conv4, then log-softmax unless logits are asked
    for (the head of NDTNetSegmentation and PointNetSegmentation)."""
    pooled = x.amax(dim=1, keepdim=True).expand_as(x)
    x = torch.cat([x_t2, pooled], dim=-1)
    x = torch.relu(model.bn1(model.conv1(x)))
    x = torch.relu(model.bn2(model.conv2(x)))
    x = torch.relu(model.bn3(model.conv3(x)))
    x = model.conv4(x)
    return x if return_logits else torch.log_softmax(x, dim=-1)
