"""NDT-Net classification in plain PyTorch: the benchmark's reference of
the model half of a classification step, on the layers of
``models.py`` (``Net``: the same weights dict, the same BatchNorm).

The published model (carlostojal/NDT-Net ``ndtnet.py:166-196``, as the
JAX package states it): the NDT-Net backbone over the M emitted NDs, a
max-pool over the points axis (:186), then conv1 -> ReLU -> conv2 ->
ReLU -> conv3 on the pooled [B, F] rows, then a softmax (:194).
Departures, as the program makes them:

- the pool is the max over all M rows, padded rows included (their
  features are what the backbone makes of zero inputs), as the JAX
  package pools;
- the output is the logits, not the softmax, and the loss is the
  softmax cross-entropy from the logits (``models.py::
  masked_cross_entropy`` with every cloud kept), as ``ndtpu`` trains:
  the reference trainer feeds the softmax-ed output to a cross-entropy
  that applies a softmax again.
"""
from __future__ import annotations

import torch

from portbench.reference.models import Net


def ndtnet_cls_logits(p, points, covs, train):
    """NDT-Net classification: logits [B, C] from points [B, M, 3] and
    covariances [B, M, 9]."""
    net = Net(p, train)
    x, _ = net.ndtnet("feature_extractor.", points, covs)
    x = torch.relu(net.dense("conv1", x.amax(dim=1)))
    x = torch.relu(net.dense("conv2", x))
    return net.dense("conv3", x)
