"""BatchNorm over the last axis (port of ``ndtpu/models/norm.py``).

Both modes compute the JAX module's expressions on channels-last input:

- eval: ``(x - running_mean) / sqrt(running_var + eps) * scale + bias``
  (norm.py:91-92);
- train (norm.py:58-92): the batch statistics over every leading axis
  (all B * M rows of a [B, M, C] input, padded rows included, as
  ``jnp.mean`` takes them), the two-pass biased variance clamped with
  ``torch.maximum`` (which, like ``jnp.maximum``, splits the gradient at a
  tie), normalisation by dividing by ``sqrt(var + eps)``, and the running
  statistics updated without a gradient as ``0.9 * running + 0.1 *
  batch`` with the unbiased variance ``var * n / max(n - 1, 1)``.

``F.batch_norm`` is not used: it rounds differently, and the port is held
to the JAX module's arithmetic.
"""
from __future__ import annotations

import torch
from torch import nn

MOMENTUM = 0.9  # decay of the running statistics (the JAX module's momentum)


class BatchNorm(nn.Module):
    """BatchNorm on [..., C]. Parameters and buffers carry
    ``nn.BatchNorm1d``'s names (weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.maximum((x - mean).square().mean(axes),
                                torch.zeros_like(mean))
            with torch.no_grad():
                n = x.numel() // x.shape[-1]
                unbiased = var * (n / max(n - 1, 1))
                m = MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * unbiased)
        y = (x - mean) / torch.sqrt(var + self.eps)
        return y * self.weight + self.bias
