"""BatchNorm over the last axis (port of ``ndtpu/models/norm.py``, eval
mode).

The JAX module normalises with the running statistics as
``(x - mean) / sqrt(var + eps) * scale + bias`` (norm.py:91-92); this
module computes exactly that expression on channels-last input. The
train-mode batch statistics and their running update belong to the
training slice, so a module in training mode raises.
"""
from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm on [..., C]. Parameters and buffers carry
    ``nn.BatchNorm1d``'s names (weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm: only eval mode is ported; call .eval() first"
            )
        y = (x - self.running_mean) / torch.sqrt(self.running_var + self.eps)
        return y * self.weight + self.bias
