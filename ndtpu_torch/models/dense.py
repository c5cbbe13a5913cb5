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

``dense_norm`` runs a Dense -> BatchNorm (-> ReLU) site of the models. In
eval mode without gradients, on the card in float32, it takes the product
from ``torch.matmul`` and the rest of the chain in one pass of
``ops/epilogue.py::dense_bn_act``, bit-identical to the modules' ops;
everywhere else (training, gradients, other types, the CPU) it runs the
modules as they are.
"""
from __future__ import annotations

import torch
from torch import nn

from ndtpu_torch.models.norm import BatchNorm
from ndtpu_torch.ops.epilogue import dense_bn_act


class Dense(nn.Linear):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype | None = None,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, dtype=param_dtype)
        self.compute_dtype = dtype

    def compute_type(self, x):
        return self.compute_dtype or torch.promote_types(x.dtype,
                                                         self.weight.dtype)

    def product(self, x):
        """``x @ W.T`` in the compute type, rounded before any bias."""
        dt = self.compute_type(x)
        return torch.matmul(x.to(dt), self.weight.to(dt).t())

    def forward(self, x):
        y = self.product(x)
        return y + self.bias.to(y.dtype)


def takes_kernel(conv: Dense, bn: BatchNorm, x) -> bool:
    """Whether ``dense_bn_act`` computes ``bn(conv(x))`` (then ReLU) bit
    for bit: ``x`` on the card, BatchNorm in eval mode, no gradient
    recorded, the product, the statistics and the output all float32, C a
    multiple of 4."""
    f32 = torch.float32
    return (x.is_cuda and not bn.training and not torch.is_grad_enabled()
            and conv.compute_type(x) == f32 and bn.dtype in (None, f32)
            and all(t.dtype == f32 for t in (bn.running_mean, bn.running_var,
                                             bn.weight, bn.bias))
            and conv.out_features % 4 == 0)


def dense_norm(conv: Dense, bn: BatchNorm, x, relu: bool):
    """``bn(conv(x))``, then ``torch.relu`` where ``relu``. Where
    ``takes_kernel``: the product, then ``dense_bn_act`` (one launch);
    else the modules' ops."""
    if takes_kernel(conv, bn, x):
        y = conv.product(x)
        return dense_bn_act(y, conv.bias.to(y.dtype), bn.running_mean,
                            torch.sqrt(bn.running_var + bn.eps), bn.weight,
                            bn.bias, relu)
    y = bn(conv(x))
    return torch.relu(y) if relu else y


def layers(dtype, param_dtype):
    """(dense, norm): constructors of a model's Dense(in, out) and
    BatchNorm(channels) layers in its types."""
    return (lambda i, o: Dense(i, o, dtype, param_dtype),
            lambda c: BatchNorm(c, dtype=dtype, param_dtype=param_dtype))
