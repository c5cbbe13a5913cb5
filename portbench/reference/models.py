"""NDT-Net and NDT-Net++ segmentation in plain PyTorch, with their loss
and Adam: the benchmark's reference of the model half of a step.

Functional: a model is a dict of tensors keyed by the names the
program's modules give their parameters and buffers (``param_specs``),
so the benchmark can draw one set of weights and hand the same values
to the program and to this reference. A model family's
``param_specs`` (``portbench/families/``) lists them with the helpers
here: name -> (kind, shape), kind "dense" (a weight [out, in], drawn
N(0, 1 / in)), "zero", "one" (parameters), "buffer_zero",
"buffer_one" (BatchNorm's running statistics), in the program's order. The layers follow the published
description as the JAX package states it (NDT-Net: a PointNet on
12-D points, mean and flattened covariance; the input transform rotates
each covariance from the left only; the first pointwise layer has
BatchNorm and no ReLU): ``x @ W.T`` and then the bias; BatchNorm over
every leading axis, in train mode with the batch's biased variance, in
eval mode with the running statistics, eps 1e-5.
"""
from __future__ import annotations

import torch

from portbench.reference.ndt import emit

EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def dense_spec(specs, name, i, o):
    specs[name + ".weight"] = ("dense", (o, i))
    specs[name + ".bias"] = ("zero", (o,))


def norm_spec(specs, name, c):
    specs[name + ".weight"] = ("one", (c,))
    specs[name + ".bias"] = ("zero", (c,))
    specs[name + ".running_mean"] = ("buffer_zero", (c,))
    specs[name + ".running_var"] = ("buffer_one", (c,))


def _tnet_specs(specs, pre, d):
    for name, i, o in (("conv1", d, 64), ("conv2", 64, 128), ("conv3", 128, 1024),
                       ("fc1", 1024, 512), ("fc2", 512, 256), ("fc3", 256, d * d)):
        dense_spec(specs, pre + name, i, o)
    for name, c in (("bn1", 64), ("bn2", 128), ("bn3", 1024), ("bn4", 512), ("bn5", 256)):
        norm_spec(specs, pre + name, c)


def ndtnet_specs(specs, pre, f, extra=0):
    """The NDT-Net backbone's entries under the prefix ``pre``; ``extra``
    input features beside the 12 of an ND."""
    _tnet_specs(specs, pre + "t1.", 3)
    dense_spec(specs, pre + "conv1", 12 + extra, 64)
    _tnet_specs(specs, pre + "t2.", 64)
    dense_spec(specs, pre + "conv2", 64, 128)
    dense_spec(specs, pre + "conv3", 128, f)
    for name, c in (("bn1", 64), ("bn2", 128), ("bn3", f)):
        norm_spec(specs, pre + name, c)


def head_specs(specs, pre, i, n_classes):
    """The segmentation head's entries over ``i`` input features."""
    for name, a, b in (("conv1", i, 512), ("conv2", 512, 256), ("conv3", 256, 128),
                       ("conv4", 128, n_classes + 1)):
        dense_spec(specs, pre + name, a, b)
    for name, c in (("bn1", 512), ("bn2", 256), ("bn3", 128)):
        norm_spec(specs, pre + name, c)


class Net:
    """The weights ``p`` (name -> tensor) and the BatchNorm mode."""

    def __init__(self, p, train: bool):
        self.p, self.train = p, train

    def dense(self, name, x):
        return torch.matmul(x, self.p[name + ".weight"].t()) + self.p[name + ".bias"]

    def bn(self, name, x):
        if self.train:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp((x - mean).square().mean(axes), min=0.0)
        else:
            mean, var = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        return (x - mean) / torch.sqrt(var + EPS) * self.p[name + ".weight"] + self.p[name + ".bias"]

    def tnet(self, pre, x):
        d = x.shape[-1]
        h = torch.relu(self.bn(pre + "bn1", self.dense(pre + "conv1", x)))
        h = torch.relu(self.bn(pre + "bn2", self.dense(pre + "conv2", h)))
        h = torch.relu(self.bn(pre + "bn3", self.dense(pre + "conv3", h))).amax(dim=1)
        h = torch.relu(self.bn(pre + "bn4", self.dense(pre + "fc1", h)))
        h = torch.relu(self.bn(pre + "bn5", self.dense(pre + "fc2", h)))
        h = self.dense(pre + "fc3", h)
        eye = torch.eye(d, dtype=h.dtype, device=h.device)
        return (h + eye.reshape(-1)).reshape(-1, d, d)

    def ndtnet(self, pre, points, covs, features=None):
        """(features [B, N, F], the transformed 64-wide rows x_t2)."""
        b, n, _ = points.shape
        t = self.tnet(pre + "t1.", points)
        parts = [torch.einsum("bij,bnj->bni", t, points),
                 torch.einsum("bij,bnjk->bnik", t, covs.reshape(b, n, 3, 3)).reshape(b, n, 9)]
        if features is not None:
            parts.append(features)
        x = self.bn(pre + "bn1", self.dense(pre + "conv1", torch.cat(parts, -1)))
        x = torch.einsum("bnj,bji->bni", x, self.tnet(pre + "t2.", x))
        x_t2 = x
        x = self.bn(pre + "bn2", self.dense(pre + "conv2", x))
        return self.bn(pre + "bn3", self.dense(pre + "conv3", x)), x_t2

    def head(self, x):
        for i in (1, 2, 3):
            x = torch.relu(self.bn(f"bn{i}", self.dense(f"conv{i}", x)))
        return self.dense("conv4", x)

    def residual(self, pre, x):
        """A Linear over the points axis, BatchNorm of each output point
        over (B, F), ReLU."""
        h = torch.relu(self.bn(pre + "bn1", self.dense(pre + "conv1", x.transpose(1, 2))))
        return h.transpose(1, 2)


def ndtnet_seg_logits(p, points, covs, train):
    """NDT-Net segmentation: logits [B, M, C + 1]."""
    net = Net(p, train)
    x, x_t2 = net.ndtnet("feature_extractor.", points, covs)
    pooled = x.amax(dim=1, keepdim=True).expand_as(x)
    return net.head(torch.cat([x_t2, pooled], -1))


def ndtnetpp_seg_logits(p, fine, coarse, fine_state, coarse_nds, train):
    """NDT-Net++ segmentation: logits [B, fine NDs, C + 1] from the fine
    and the coarse (points, covs) and the fine NDT state, which is pruned
    to the coarse count inside the forward."""
    net = Net(p, train)
    feat1, _ = net.ndtnet("ndnet.ndtnet1.", *fine)
    with torch.no_grad():
        down, down_cov, _, _ = emit(fine_state, coarse_nds)
    feat1_, _ = net.ndtnet("ndnet.ndtnet2.", down, down_cov,
                           net.residual("ndnet.residual.", feat1))
    points2, covs2 = coarse
    zeros = points2.new_zeros(points2.shape[:2] + (feat1.shape[-1],))
    feat2, _ = net.ndtnet("ndnet.ndtnet2.", points2, covs2, zeros)
    x = net.bn("ndnet.bn1", net.dense("ndnet.conv1", feat1_ + feat2))
    return net.head(net.residual("residual.", x) + feat1)


def masked_cross_entropy(logits, onehot, mask):
    """Mean softmax cross-entropy over the kept rows."""
    ce = -(onehot * torch.log_softmax(logits, dim=-1)).sum(-1)
    return torch.where(mask, ce, 0.0).sum() / torch.clamp(mask.sum(), min=1)


def adam_step(params, grads, state, lr):
    """One Adam update in place (b1 0.9, b2 0.999, eps 1e-8; the bias
    corrections count this update)."""
    state["t"] = t = state.get("t", 0) + 1
    for name, g in grads.items():
        m, v = state.setdefault(name, (torch.zeros_like(g), torch.zeros_like(g)))
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        state[name] = (m, v)
        m_hat = m / (1 - ADAM_B1 ** t)
        v_hat = v / (1 - ADAM_B2 ** t)
        params[name] = params[name] - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
