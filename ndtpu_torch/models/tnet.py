"""T-Net, the PointNet transform regressor (port of ``ndtpu/models/tnet.py``).

Three pointwise layers (64, 128, 1024) with BN + ReLU, a max-pool over the
points, FCs 512 -> 256 -> in_dim**2, plus the identity. Channels-last: the
reference's 1x1 convolutions are ``nn.Linear`` on [B, N, C]. Attribute
names follow the reference module (conv1..3, fc1..3, bn1..5).
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.models.norm import BatchNorm


class TNet(nn.Module):
    def __init__(self, in_dim: int = 64):
        super().__init__()
        self.in_dim = in_dim
        self.conv1 = nn.Linear(in_dim, 64)
        self.conv2 = nn.Linear(64, 128)
        self.conv3 = nn.Linear(128, 1024)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, in_dim * in_dim)
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(128)
        self.bn3 = BatchNorm(1024)
        self.bn4 = BatchNorm(512)
        self.bn5 = BatchNorm(256)

    def forward(self, x):
        """x: [B, N, in_dim] -> transform [B, in_dim, in_dim]."""
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = torch.relu(self.bn3(self.conv3(h)))
        h = h.amax(dim=1)
        h = torch.relu(self.bn4(self.fc1(h)))
        h = torch.relu(self.bn5(self.fc2(h)))
        h = self.fc3(h)
        eye = torch.eye(self.in_dim, dtype=h.dtype, device=h.device)
        return (h + eye.reshape(-1)).reshape(-1, self.in_dim, self.in_dim)
