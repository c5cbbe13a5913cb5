"""PointNet backbone and heads, the FPS baseline family (port of
``ndtpu/models/pointnet.py``).

Kept as in the JAX package: ``nan_to_num`` after the input transform, the
backbone's pointwise layers with BatchNorm and no ReLU, the segmentation
head's concatenation of x_t2 (64) with the pooled features, softmax at
the end of classification and log-softmax at the end of segmentation
(logits with ``return_logits=True``). Channels-last [B, N, C]; attribute
names follow the reference modules (``feature_extractor`` with t1, t2,
conv1..3 and bn1..3; the heads' conv* and bn*). ``dtype`` and
``param_dtype`` as in NDTNet: the input transform's einsum of a bfloat16
transform with float32 points computes in float32, then ``nan_to_num``
(pointnet.py:35-37).
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.models.ndtnet import (
    classification_head,
    classification_head_layers,
    einsum,
    segmentation_head,
    segmentation_head_layers,
)
from ndtpu_torch.models.dense import dense_norm, layers
from ndtpu_torch.models.tnet import TNet
from ndtpu_torch.utils.device import resolve_device


class PointNet(nn.Module):
    """Backbone: points [B, N, point_dim] -> (features [B, N,
    feature_dim], x_t2 [B, N, 64])."""

    def __init__(self, point_dim: int = 3, feature_dim: int = 768,
                 dtype=None, param_dtype=torch.float32):
        super().__init__()
        dense, norm = layers(dtype, param_dtype)
        self.t1 = TNet(point_dim, dtype, param_dtype)
        self.conv1 = dense(point_dim, 64)
        self.t2 = TNet(64, dtype, param_dtype)
        self.conv2 = dense(64, 128)
        self.conv3 = dense(128, feature_dim)
        self.bn1 = norm(64)
        self.bn2 = norm(128)
        self.bn3 = norm(feature_dim)

    def forward(self, x):
        x = torch.nan_to_num(einsum("bij,bnj->bni", self.t1(x), x))
        x = dense_norm(self.conv1, self.bn1, x, relu=False)
        x = einsum("bnj,bji->bni", x, self.t2(x))
        x_t2 = x
        x = dense_norm(self.conv2, self.bn2, x, relu=False)
        x = dense_norm(self.conv3, self.bn3, x, relu=False)
        return x, x_t2


class PointNetClassification(nn.Module):
    """pointnet.py:137-167. points [B, N, 3] -> [B, num_classes]:
    probabilities, or logits with ``return_logits=True``. Built on
    ``device`` (the card unless the caller asks for the CPU), in ``dtype``
    and ``param_dtype``."""

    def __init__(self, point_dim: int = 3, num_classes: int = 512,
                 feature_dim: int = 768, device="cuda", dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = PointNet(point_dim, feature_dim, dtype,
                                          param_dtype)
        classification_head_layers(self, feature_dim, num_classes, dtype,
                                   param_dtype)
        self.to(dev)

    def forward(self, points, return_logits: bool = False):
        x, _ = self.feature_extractor(points)
        return classification_head(self, x.amax(dim=1), return_logits)


class PointNetSegmentation(nn.Module):
    """pointnet.py:169-214. points [B, N, 3] -> [B, N, num_classes + 1]:
    log-probabilities, or logits with ``return_logits=True``. Built on
    ``device`` (the card unless the caller asks for the CPU), in ``dtype``
    and ``param_dtype``."""

    def __init__(self, point_dim: int = 3, num_classes: int = 16,
                 feature_dim: int = 768, device="cuda", dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = PointNet(point_dim, feature_dim, dtype,
                                          param_dtype)
        segmentation_head_layers(self, feature_dim + 64, num_classes, dtype,
                                 param_dtype)
        self.to(dev)

    def forward(self, points, return_logits: bool = False):
        x, x_t2 = self.feature_extractor(points)
        return segmentation_head(self, x, x_t2, return_logits)
