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

The types follow the JAX module too: the statistics and the normalisation
are computed in ``promote_types(x.dtype, float32)`` (float32 for a
bfloat16 input, norm.py:46), only the output is cast to ``dtype`` (None
leaves it in the promoted type of the statistics and the parameters); the
weight, bias and running statistics are held in ``param_dtype``, and the
running statistics are updated in the statistics' type and then cast to
it (norm.py:69-76).

Under a data group (``parallel/collectives.py``) the train-mode
statistics are the global batch's, as ``jnp.mean`` over a batch-sharded
input gives them under a mesh (norm.py:20-23): the two-pass form on the
global batch, with the row count and each pass's sums all-reduced by
``all_reduce_sum`` (gradients flow back through both sums to every
rank), and the global count in the unbiased running variance. Without a
group the module computes the single-process expressions above.

``F.batch_norm`` and ``nn.SyncBatchNorm`` are not used: they round
differently, and the port is held to the JAX module's arithmetic.
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.parallel.collectives import all_reduce_sum
from ndtpu_torch.parallel.mesh import data_group

MOMENTUM = 0.9  # decay of the running statistics (the JAX module's momentum)


class BatchNorm(nn.Module):
    """BatchNorm on [..., C]. Parameters and buffers carry
    ``nn.BatchNorm1d``'s names (weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=param_dtype))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, dtype=param_dtype))
        self.register_buffer("running_var",
                             torch.ones(num_features, dtype=param_dtype))

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            if data_group() is not None:
                mean, var, bessel = _global_stats(xf, axes)
            else:
                mean = xf.mean(axes)
                var = torch.maximum((xf - mean).square().mean(axes),
                                    torch.zeros_like(mean))
                n = x.numel() // x.shape[-1]
                bessel = n / max(n - 1, 1)
            with torch.no_grad():
                unbiased = var * bessel
                m, pdt = MOMENTUM, self.running_mean.dtype
                self.running_mean.copy_(
                    (m * self.running_mean + (1.0 - m) * mean).to(pdt))
                self.running_var.copy_(
                    (m * self.running_var + (1.0 - m) * unbiased).to(pdt))
        y = (xf - mean) / torch.sqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y if self.dtype is None else y.to(self.dtype)


def _global_stats(xf, axes):
    """(mean, clamped biased variance, n / max(n - 1, 1)) over the global
    batch's n rows: one all-reduce of [the sum of x, the rows], then one of
    the sum of (x - mean)^2."""
    rows = xf.numel() // xf.shape[-1]
    first = all_reduce_sum(torch.cat([xf.sum(axes), xf.new_full((1,), rows)]))
    n = first[-1].detach()
    mean = first[:-1] / n
    var = all_reduce_sum((xf - mean).square().sum(axes)) / n
    return (mean, torch.maximum(var, torch.zeros_like(mean)),
            n / torch.clamp(n - 1, min=1))
