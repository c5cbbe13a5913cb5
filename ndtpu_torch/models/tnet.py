"""T-Net, the PointNet transform regressor (port of ``ndtpu/models/tnet.py``).

Three pointwise layers (64, 128, 1024) with BN + ReLU, a max-pool over the
points, FCs 512 -> 256 -> in_dim**2, plus the identity. Channels-last: the
reference's 1x1 convolutions are ``Dense`` layers on [B, N, C]. Attribute
names follow the reference module (conv1..3, fc1..3, bn1..5). ``dtype``
is the compute type of every layer (None: the inputs' and parameters'),
``param_dtype`` the parameters' type; the identity is added in the
output's type (tnet.py:38).
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.models.dense import dense_norm, layers


class TNet(nn.Module):
    def __init__(self, in_dim: int = 64, dtype=None,
                 param_dtype=torch.float32):
        super().__init__()
        self.in_dim = in_dim
        dense, norm = layers(dtype, param_dtype)
        self.conv1 = dense(in_dim, 64)
        self.conv2 = dense(64, 128)
        self.conv3 = dense(128, 1024)
        self.fc1 = dense(1024, 512)
        self.fc2 = dense(512, 256)
        self.fc3 = dense(256, in_dim * in_dim)
        self.bn1 = norm(64)
        self.bn2 = norm(128)
        self.bn3 = norm(1024)
        self.bn4 = norm(512)
        self.bn5 = norm(256)

    def forward(self, x):
        """x: [B, N, in_dim] -> transform [B, in_dim, in_dim]."""
        h = dense_norm(self.conv1, self.bn1, x, relu=True)
        h = dense_norm(self.conv2, self.bn2, h, relu=True)
        h = dense_norm(self.conv3, self.bn3, h, relu=True)
        h = h.amax(dim=1)
        h = dense_norm(self.fc1, self.bn4, h, relu=True)
        h = dense_norm(self.fc2, self.bn5, h, relu=True)
        h = self.fc3(h)
        eye = torch.eye(self.in_dim, dtype=h.dtype, device=h.device)
        return (h + eye.reshape(-1)).reshape(-1, self.in_dim, self.in_dim)
