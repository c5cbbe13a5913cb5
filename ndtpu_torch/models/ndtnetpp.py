"""NDT-Net++, the two-resolution family (port of
``ndtpu/models/ndtnetpp.py``).

Branch 1 runs ``ndtnet1`` on the fine NDs, prunes the fine NDT state to
the coarse count inside the forward (``core/ndt.py::ndt_prune``, batched,
without a gradient: the state comes from the preprocessing), maps the fine
feature rows onto the coarse ones (``ResidualConnection``) and runs
``ndtnet2`` on the pruned NDs with those features. Branch 2 runs the same
``ndtnet2`` on the coarse NDs with a zero feature block of width
feature_dim (the JAX package's completion of the reference's shape bug).
One module serves both branches: in train mode its BatchNorms move their
running statistics twice a forward, branch 1 first, as in flax. Attribute
names follow the reference modules (ndtnet1, ndtnet2, residual, ndnet,
feature_extractor, conv*, bn*). ``dtype`` and ``param_dtype`` as in
NDTNet: the pruned fine state goes into ``ndtnet2`` cast to ``dtype``
(ndtnetpp.py:84-85), and branch 2's zero feature block is made in it
(:94-96).
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.core.ndt import NDTResult, ndt_prune
from ndtpu_torch.models.ndtnet import (
    AdditionalFeatures,
    NDTNet,
    classification_head,
    classification_head_layers,
    segmentation_head_layers,
)
from ndtpu_torch.models.dense import dense_norm, layers
from ndtpu_torch.utils.device import resolve_device


class ResidualConnection(nn.Module):
    """[B, in_points, F] -> [B, out_points, F]: a Linear over the points
    axis, then BatchNorm of each output point row over (B, F), then ReLU
    (ndtnetpp.py:8-41)."""

    def __init__(self, in_points: int, out_points: int, dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        dense, norm = layers(dtype, param_dtype)
        self.conv1 = dense(in_points, out_points)
        self.bn1 = norm(out_points)

    def forward(self, x):
        h = dense_norm(self.conv1, self.bn1, x.transpose(1, 2), relu=True)
        return h.transpose(1, 2)


class NDTNetPP(nn.Module):
    """The two-branch extractor (``ndnet``, ndtnetpp.py:55-134):
    (points1 [B, N1, 3], covs1 [B, N1, 9], state1: the fine NDTResult,
    points2 [B, N2, 3], covs2 [B, N2, 9]) -> (feat [B, N2, F],
    feat1 [B, N1, F]), N1 = fine_res, N2 = coarse_res."""

    def __init__(self, point_dim: int = 3, fine_res: int = 8160,
                 coarse_res: int = 4080, feature_dim: int = 1024, dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.coarse_res = coarse_res
        self.feature_dim = feature_dim
        self.dtype = dtype
        dense, norm = layers(dtype, param_dtype)
        self.ndtnet1 = NDTNet(point_dim, feature_dim,
                              AdditionalFeatures.COVARIANCES, dtype=dtype,
                              param_dtype=param_dtype)
        self.ndtnet2 = NDTNet(point_dim, feature_dim,
                              AdditionalFeatures.FEATURE_VECTOR,
                              extra_dim=feature_dim, dtype=dtype,
                              param_dtype=param_dtype)
        self.residual = ResidualConnection(fine_res, coarse_res, dtype,
                                           param_dtype)
        self.conv1 = dense(feature_dim, feature_dim)
        self.bn1 = norm(feature_dim)

    def forward(self, points1, covariances1, state1: NDTResult, points2,
                covariances2):
        feat1, _ = self.ndtnet1(points1, covariances1)
        with torch.no_grad():
            down1, downcov1, _, _ = ndt_prune(state1, self.coarse_res)
        if self.dtype is not None:
            down1, downcov1 = down1.to(self.dtype), downcov1.to(self.dtype)
        feat1_, _ = self.ndtnet2(down1, downcov1, self.residual(feat1))
        zeros = points2.new_zeros(points2.shape[:2] + (self.feature_dim,),
                                  dtype=self.dtype or points2.dtype)
        feat2, _ = self.ndtnet2(points2, covariances2, zeros)
        return dense_norm(self.conv1, self.bn1, feat1_ + feat2,
                          relu=False), feat1


class NDTNetPPClassification(nn.Module):
    """ndtnetpp.py:136-178: [B, num_classes] probabilities, or logits with
    ``return_logits=True``. Built on ``device`` (the card by default), in
    ``dtype`` and ``param_dtype``."""

    def __init__(self, point_dim: int = 3, num_classes: int = 512,
                 fine_res: int = 8160, coarse_res: int = 4080,
                 feature_dim: int = 1024, device="cuda", dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = NDTNetPP(point_dim, fine_res, coarse_res,
                                          feature_dim, dtype, param_dtype)
        classification_head_layers(self, feature_dim, num_classes, dtype,
                                   param_dtype)
        self.to(dev)

    def forward(self, points1, covariances1, state1, points2, covariances2,
                return_logits: bool = False):
        x, _ = self.feature_extractor(points1, covariances1, state1, points2,
                                      covariances2)
        return classification_head(self, x.amax(dim=1), return_logits)


class NDTNetPPSegmentation(nn.Module):
    """ndtnetpp.py:180-240: [B, N1, num_classes + 1] probabilities (a plain
    softmax, ndtnetpp.py:236, not the log-softmax of NDTNetSegmentation),
    or logits with ``return_logits=True``. The coarse features are mapped
    back to the fine rows and added to branch 1's. Built on ``device``
    (the card by default), in ``dtype`` and ``param_dtype``."""

    def __init__(self, point_dim: int = 3, num_classes: int = 16,
                 fine_res: int = 8160, coarse_res: int = 4080,
                 feature_dim: int = 1024, device="cuda", dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.ndnet = NDTNetPP(point_dim, fine_res, coarse_res, feature_dim,
                              dtype, param_dtype)
        self.residual = ResidualConnection(coarse_res, fine_res, dtype,
                                           param_dtype)
        segmentation_head_layers(self, feature_dim, num_classes, dtype,
                                 param_dtype)
        self.to(dev)

    def forward(self, points1, covariances1, state1, points2, covariances2,
                return_logits: bool = False):
        x, x1 = self.ndnet(points1, covariances1, state1, points2,
                           covariances2)
        x = self.residual(x) + x1
        x = dense_norm(self.conv1, self.bn1, x, relu=True)
        x = dense_norm(self.conv2, self.bn2, x, relu=True)
        x = dense_norm(self.conv3, self.bn3, x, relu=True)
        x = self.conv4(x)
        return x if return_logits else torch.softmax(x, dim=-1)
