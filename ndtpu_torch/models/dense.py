"""The pointwise layer of every model: flax's ``nn.Dense(dtype,
param_dtype)`` as an ``nn.Linear`` (weight [out, in], bias [out]).

The weight and bias are held in ``param_dtype``. The forward casts the
input, the weight and the bias to the compute ``dtype`` (None: the
promoted type of the input and the weight, so a model cast with
``.double()`` computes in float64), takes ``x @ W.T`` and then adds the
bias as an op of its own, as flax rounds the product and then the sum.
``F.linear`` would fuse the bias into the GEMM and round once: in
float32 the difference lies below the tests' tolerances, in bfloat16 it
is a whole ulp.
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.models.norm import BatchNorm


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


def layers(dtype, param_dtype):
    """(dense, norm): constructors of a model's Dense(in, out) and
    BatchNorm(channels) layers in its types."""
    return (lambda i, o: Dense(i, o, dtype, param_dtype),
            lambda c: BatchNorm(c, dtype=dtype, param_dtype=param_dtype))
